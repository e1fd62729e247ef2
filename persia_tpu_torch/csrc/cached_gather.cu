// The cache tier's gather-pool (K13): the cached rows a step's positions
// name, pooled per sample or not.
//
// Input: a group's table T (R = C+1 rows, dim) f32, whose last row C is the
// zero pad; rows (S, B, L) int32; optionally the eval miss table M (Mr,
// dim) f32 and the scale (S, B) f32. A position's value is
//   without M: T[clamp(r, 0, C)]
//   with M:    r > C ? M[clamp(r - (C+1), 0, Mr - 1)] : T[clamp(r, 0, C)]
// and its mask r != C. Modes:
//   pool:  out[s, b, :] = (sum over l in order of the unmasked values)
//          * scale[s, b] (no scale: as it is), f32;
//   rows:  out[s, b, l, :] = the value (unmasked: the model masks),
//          mask[s, b, l] = r != C (one byte);
// and, where asked (training), keys[s, b, l] = r < C ? r : INT32_MAX, the
// row the position's gradient updates (K5's sentinel for the pad).
//
// Replaces: persia_tpu/embedding/hbm_cache/step.py:154-162 (the gather
// tables[g][rows]) with groups.py:160-193 (_model_emb_from_gathered: the
// mask rows != C, the sum over L, stacked_scale), the routing of the
// update rows (step.py:307-333, the mask to the sentinel), and eval's
// _gather_ext (step.py:435-440); XLA gathers, selects and reductions, no
// Pallas kernel.
//
// Bound on the H100: bytes (the rows, each position's row read once, the
// output written once, the keys; L adds a dim a position).
//
// Design: one thread a (sample, 16-byte vector) for pool, a (position,
// vector) for rows, the vector 4 floats where dim and the pointers allow
// (else one float); a sample's L positions in order, so its sum is the
// plain version's. The key and the mask are the vector-0 thread's.

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename V>
__device__ __forceinline__ V vadd(V a, V b);
template <>
__device__ __forceinline__ float vadd(float a, float b) { return a + b; }
template <>
__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
template <typename V>
__device__ __forceinline__ V vscale(V a, float s);
template <>
__device__ __forceinline__ float vscale(float a, float s) { return a * s; }
template <>
__device__ __forceinline__ float4 vscale(float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}
template <typename V>
__device__ __forceinline__ V vzero();
template <>
__device__ __forceinline__ float vzero() { return 0.0f; }
template <>
__device__ __forceinline__ float4 vzero() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }

template <typename V>
__device__ __forceinline__ V value_of(const V* __restrict__ table, const V* __restrict__ miss, long long C,
                                      long long miss_rows, int32_t r, int vpr, int v) {
  const long long rr = r;
  if (miss != nullptr && rr > C) {
    long long m = rr - (C + 1);
    m = m >= miss_rows ? miss_rows - 1 : m;
    return miss[m * vpr + v];
  }
  const long long t = rr < 0 ? 0 : (rr > C ? C : rr);
  return table[t * vpr + v];
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
    cached_pool_kernel(const V* __restrict__ table, const V* __restrict__ miss, long long C, long long miss_rows,
                       const int32_t* __restrict__ rows, long long samples, int L, const float* __restrict__ scale,
                       int vpr, V* __restrict__ out, int32_t* __restrict__ keys) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= samples * vpr) return;
  const long long sb = t / vpr;
  const int v = static_cast<int>(t - sb * vpr);
  const int32_t* r = rows + sb * L;
  V acc = vzero<V>();
  for (int l = 0; l < L; ++l) {
    const int32_t row = r[l];
    if (keys != nullptr && v == 0) keys[sb * L + l] = row >= 0 && row < C ? row : INT_MAX;
    if (row == C) continue;
    const V x = value_of(table, miss, C, miss_rows, row, vpr, v);
    acc = l == 0 ? x : vadd(acc, x);
  }
  out[t] = scale != nullptr ? vscale(acc, scale[sb]) : acc;
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
    cached_rows_kernel(const V* __restrict__ table, const V* __restrict__ miss, long long C, long long miss_rows,
                       const int32_t* __restrict__ rows, long long positions, int vpr, V* __restrict__ out,
                       int32_t* __restrict__ keys, uint8_t* __restrict__ mask) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= positions * vpr) return;
  const long long p = t / vpr;
  const int v = static_cast<int>(t - p * vpr);
  const int32_t row = rows[p];
  if (v == 0) {
    mask[p] = row != C;
    if (keys != nullptr) keys[p] = row >= 0 && row < C ? row : INT_MAX;
  }
  out[t] = value_of(table, miss, C, miss_rows, row, vpr, v);
}

template <typename V>
int launch(const float* table, const float* miss, long long C, long long miss_rows, const int32_t* rows,
           long long samples, int L, const float* scale, int pool, int dim, float* out, int32_t* keys,
           uint8_t* mask, cudaStream_t st) {
  const int vpr = dim / static_cast<int>(sizeof(V) / sizeof(float));
  const long long items = (pool ? samples : samples * L) * vpr;
  const long long grid = (items + kThreads - 1) / kThreads;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (grid == 0) return cudaSuccess;
  const V* t = reinterpret_cast<const V*>(table);
  const V* m = reinterpret_cast<const V*>(miss);
  V* o = reinterpret_cast<V*>(out);
  if (pool) {
    cached_pool_kernel<V><<<static_cast<unsigned>(grid), kThreads, 0, st>>>(t, m, C, miss_rows, rows, samples, L,
                                                                            scale, vpr, o, keys);
  } else {
    cached_rows_kernel<V><<<static_cast<unsigned>(grid), kThreads, 0, st>>>(t, m, C, miss_rows, rows, samples * L,
                                                                            vpr, o, keys, mask);
  }
  return cudaGetLastError();
}

}  // namespace

// table (table_rows, dim) f32; miss: null or (miss_rows, dim) f32; rows
// (samples, L) int32; scale: null or (samples,) f32 (pool only); out
// (samples, dim) for pool, else (samples * L, dim); keys: null or
// (samples * L,) int32; mask (samples * L,) bytes for rows mode.
extern "C" int persia_cached_gather(const float* table, long long table_rows, int dim, const float* miss,
                                    long long miss_rows, const int32_t* rows, long long samples, int L,
                                    const float* scale, int pool, float* out, int32_t* keys, uint8_t* mask,
                                    void* stream) {
  if (table == nullptr || table_rows < 1 || table_rows - 1 > INT_MAX || dim < 1 || samples < 0 || L < 1 ||
      out == nullptr || (samples > 0 && rows == nullptr) || (miss != nullptr && miss_rows < 1) ||
      (!pool && (mask == nullptr || scale != nullptr))) {
    return cudaErrorInvalidValue;
  }
  const long long C = table_rows - 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t align = reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(miss) |
                          reinterpret_cast<uintptr_t>(out);
  if (dim % 4 == 0 && align % 16 == 0) {
    return launch<float4>(table, miss, C, miss_rows, rows, samples, L, scale, pool, dim, out, keys, mask, st);
  }
  return launch<float>(table, miss, C, miss_rows, rows, samples, L, scale, pool, dim, out, keys, mask, st);
}
