// The cache tier's gather-pool (K13): the cached rows a step's positions
// name, pooled per sample or not.
//
// Input: a group's table T (R = C+1 rows, dim) f32 or bf16 (the pool's
// dtype), whose last row C is the zero pad; rows (S, B, L) int32;
// optionally the eval miss table M (Mr, dim) f32 and the scale (S, B) f32.
// A position's value, in f32, is
//   without M: T[clamp(r, 0, C)] (a bf16 row widened, exactly)
//   with M:    r > C ? M[clamp(r - (C+1), 0, Mr - 1)] rounded to the
//              table's dtype (to nearest, ties to even) : T[clamp(r, 0, C)]
// and its mask r != C. Modes:
//   pool:  out[s, b, :] = (sum over l in order of the unmasked values)
//          * scale[s, b] (no scale: as it is), f32 (pooled in f32 at
//          either table dtype);
//   rows:  out[s, b, l, :] = the value (unmasked: the model masks), f32,
//          mask[s, b, l] = r != C (one byte);
// and, where asked (training), keys[s, b, l] = r < C ? r : INT32_MAX, the
// row the position's gradient updates (K5's sentinel for the pad).
//
// Replaces: persia_tpu/embedding/hbm_cache/step.py:154-162 (the gather
// tables[g][rows]) with groups.py:160-193 (_model_emb_from_gathered: the
// mask rows != C, the sum over L, stacked_scale), the routing of the
// update rows (step.py:307-333, the mask to the sentinel), and eval's
// _gather_ext (step.py:435-440, the miss rows cast to the table's dtype);
// XLA gathers, selects and reductions, no Pallas kernel.
//
// Bound on the H100: bytes (the rows, each position's row read once, the
// output written once, the keys; L adds a dim a position).
//
// Design: one thread a (sample, 4 columns) for pool, a (position, 4
// columns) for rows: a float4 of an f32 table's row, 8 bytes of a bf16
// one, where dim and the pointers allow, else one element; the table's
// dtype a template argument (TB), so the f32 pool's code has no branch on
// it; a sample's L positions in order, in f32, so its sum is the plain
// version's. The thread writes its columns as one float4: a
// warp's stores are contiguous at either dtype. (A first plan gave a bf16
// row's thread a 16-byte vector of 8 bf16, writing two float4 32 bytes
// apart: 1.28x the f32 pool's time on the same rows.) The key and the mask
// are the column-0 thread's.

#include <climits>
#include <cstdint>

#include "cache_entry.cuh"
#include "common.cuh"

namespace {

using persia_cache::load_f32;
using persia_cache::load_wire;
using persia_cache::store_f32;

constexpr int kThreads = 256;

// a position's V values from column col, widened to f32 (see the head)
template <int V, bool TB>
__device__ __forceinline__ void value_of(const void* __restrict__ table, const float* __restrict__ miss,
                                         long long C, long long miss_rows, int dim, int32_t r, int col,
                                         float (&x)[V]) {
  const long long rr = r;
  if (miss != nullptr && rr > C) {
    long long m = rr - (C + 1);
    m = m >= miss_rows ? miss_rows - 1 : m;
    load_f32<V>(miss + m * dim + col, x);
    if constexpr (TB) {
#pragma unroll
      for (int i = 0; i < V; ++i) x[i] = __bfloat162float(__float2bfloat16_rn(x[i]));
    }
    return;
  }
  const long long t = rr < 0 ? 0 : (rr > C ? C : rr);
  load_wire<V>(table, TB, t * dim + col, x);
}

template <int V, bool TB>
__global__ void __launch_bounds__(kThreads)
    cached_pool_kernel(const void* __restrict__ table, const float* __restrict__ miss, long long C,
                       long long miss_rows, const int32_t* __restrict__ rows, long long samples, int L,
                       const float* __restrict__ scale, int dim, float* __restrict__ out,
                       int32_t* __restrict__ keys) {
  const int vpr = dim / V;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= samples * vpr) return;
  const long long sb = t / vpr;
  const int col = static_cast<int>(t - sb * vpr) * V;
  const int32_t* r = rows + sb * L;
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.0f;
  for (int l = 0; l < L; ++l) {
    const int32_t row = r[l];
    if (keys != nullptr && col == 0) keys[sb * L + l] = row >= 0 && row < C ? row : INT_MAX;
    if (row == C) continue;
    float x[V];
    value_of<V, TB>(table, miss, C, miss_rows, dim, row, col, x);
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = l == 0 ? x[i] : acc[i] + x[i];
  }
  if (scale != nullptr) {
    const float s = scale[sb];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] *= s;
  }
  store_f32<V>(out + sb * dim + col, acc);
}

template <int V, bool TB>
__global__ void __launch_bounds__(kThreads)
    cached_rows_kernel(const void* __restrict__ table, const float* __restrict__ miss, long long C,
                       long long miss_rows, const int32_t* __restrict__ rows, long long positions, int dim,
                       float* __restrict__ out, int32_t* __restrict__ keys, uint8_t* __restrict__ mask) {
  const int vpr = dim / V;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= positions * vpr) return;
  const long long p = t / vpr;
  const int col = static_cast<int>(t - p * vpr) * V;
  const int32_t row = rows[p];
  if (col == 0) {
    mask[p] = row != C;
    if (keys != nullptr) keys[p] = row >= 0 && row < C ? row : INT_MAX;
  }
  float x[V];
  value_of<V, TB>(table, miss, C, miss_rows, dim, row, col, x);
  store_f32<V>(out + p * dim + col, x);
}

template <int V, bool TB>
int launch(const void* table, const float* miss, long long C, long long miss_rows, const int32_t* rows,
           long long samples, int L, const float* scale, int pool, int dim, float* out, int32_t* keys,
           uint8_t* mask, cudaStream_t st) {
  const long long items = (pool ? samples : samples * L) * (dim / V);
  const long long grid = (items + kThreads - 1) / kThreads;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (grid == 0) return cudaSuccess;
  if (pool) {
    cached_pool_kernel<V, TB><<<static_cast<unsigned>(grid), kThreads, 0, st>>>(table, miss, C, miss_rows, rows,
                                                                                samples, L, scale, dim, out, keys);
  } else {
    cached_rows_kernel<V, TB><<<static_cast<unsigned>(grid), kThreads, 0, st>>>(table, miss, C, miss_rows, rows,
                                                                                samples * L, dim, out, keys, mask);
  }
  return cudaGetLastError();
}

}  // namespace

// table (table_rows, dim) f32 or bf16 (table_dtype: persia::DType); miss:
// null or (miss_rows, dim) f32; rows (samples, L) int32; scale: null or
// (samples,) f32 (pool only); out (samples, dim) f32 for pool, else
// (samples * L, dim); keys: null or (samples * L,) int32; mask (samples *
// L,) bytes for rows mode.
extern "C" int persia_cached_gather(const void* table, int table_dtype, long long table_rows, int dim,
                                    const float* miss, long long miss_rows, const int32_t* rows, long long samples,
                                    int L, const float* scale, int pool, float* out, int32_t* keys, uint8_t* mask,
                                    void* stream) {
  if (table == nullptr || table_rows < 1 || table_rows - 1 > INT_MAX || dim < 1 || samples < 0 || L < 1 ||
      out == nullptr || (samples > 0 && rows == nullptr) || (miss != nullptr && miss_rows < 1) ||
      (!pool && (mask == nullptr || scale != nullptr)) ||
      (table_dtype != persia::kFloat32 && table_dtype != persia::kBFloat16)) {
    return cudaErrorInvalidValue;
  }
  const bool bf16 = table_dtype == persia::kBFloat16;
  const uintptr_t align = reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(miss) |
                          reinterpret_cast<uintptr_t>(out);
  const long long C = table_rows - 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool v4 = dim % 4 == 0 && align % 16 == 0;
  if (bf16) {
    return v4 ? launch<4, true>(table, miss, C, miss_rows, rows, samples, L, scale, pool, dim, out, keys, mask, st)
              : launch<1, true>(table, miss, C, miss_rows, rows, samples, L, scale, pool, dim, out, keys, mask, st);
  }
  return v4 ? launch<4, false>(table, miss, C, miss_rows, rows, samples, L, scale, pool, dim, out, keys, mask, st)
            : launch<1, false>(table, miss, C, miss_rows, rows, samples, L, scale, pool, dim, out, keys, mask, st);
}
