// The cache tier's aux program (K12): one cache group's eviction payload,
// warm entries and cold seeds, a step.
//
// Input: the group's table T (R = C+1 rows, dim) f32 and its optimizer
// state columns, at most two (s0: Adagrad acc (R, w0) or Adam m (R, dim);
// s1: Adam v (R, dim)), which an entry [emb | s0 | s1] (E = dim + w0 + w1
// floats) lays out in that order.
//  (a) payload[k, :] = entry of row clamp(ev_rows[k], 0, R - 1), f32 or
//      rounded to bf16 (to nearest, ties to even);
//  (b) for each warm k with 0 <= m_rows[k] < R: the entry of m_rows[k] =
//      m_entries[k, :] (f32 or bf16, widened);
//  (c) for each cold k with 0 <= c_rows[k] < R: T[c_rows[k], :] =
//      c_emb[k, :] (f32 or bf16, widened), s0 and s1 of the row = c0, c1.
// Rows outside [0, R) are dropped by (b) and (c): the host pads with R.
// The rows of (b) and (c) are distinct, so no float is written twice.
//
// Replaces: persia_tpu/embedding/hbm_cache/groups.py:260-293 (_apply_aux)
// and :240-248 (_gather_entry_rows, (a) alone in f32), XLA gathers and
// scatters; no Pallas kernel.
//
// Bound on the H100: bytes (the row indices; (a) reads K_ev entries and
// writes the payload, (b) reads K_w entries and writes them, (c) reads K_c
// seeds and writes K_c entries; no arithmetic).
//
// Design: two kernels in stream order, one thread a float. (a) must read
// every evicted row before (b) and (c) write: a row evicted this step is
// usually the row one of this step's misses takes. Stream order gives that
// without a grid-wide barrier; (b) and (c) share one launch.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float column(const float* __restrict__ table, const float* __restrict__ s0,
                                        const float* __restrict__ s1, long long r, int dim, int w0, int w1, int e) {
  if (e < dim) return table[r * dim + e];
  e -= dim;
  if (e < w0) return s0[r * w0 + e];
  return s1[r * w1 + (e - w0)];
}

__device__ __forceinline__ void set_column(float* __restrict__ table, float* __restrict__ s0, float* __restrict__ s1,
                                           long long r, int dim, int w0, int w1, int e, float v) {
  if (e < dim) {
    table[r * dim + e] = v;
    return;
  }
  e -= dim;
  if (e < w0) {
    s0[r * w0 + e] = v;
    return;
  }
  s1[r * w1 + (e - w0)] = v;
}

__device__ __forceinline__ float load(const void* p, int bf16, long long i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]) : static_cast<const float*>(p)[i];
}

__global__ void __launch_bounds__(kThreads)
    cache_payload_kernel(const float* __restrict__ table, const float* __restrict__ s0, const float* __restrict__ s1,
                         long long rows, int dim, int w0, int w1, const int32_t* __restrict__ ev, int n,
                         void* __restrict__ out, int out_bf16) {
  const int E = dim + w0 + w1;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<long long>(n) * E) return;
  const int k = static_cast<int>(t / E);
  const int e = static_cast<int>(t - static_cast<long long>(k) * E);
  long long r = ev[k];
  r = r < 0 ? 0 : (r >= rows ? rows - 1 : r);
  const float v = column(table, s0, s1, r, dim, w0, w1, e);
  if (out_bf16) {
    static_cast<__nv_bfloat16*>(out)[t] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(out)[t] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
    cache_scatter_kernel(float* __restrict__ table, float* __restrict__ s0, float* __restrict__ s1, long long rows,
                         int dim, int w0, int w1, const int32_t* __restrict__ m_rows, int n_m,
                         const void* __restrict__ m_entries, int m_bf16, const int32_t* __restrict__ c_rows, int n_c,
                         const void* __restrict__ c_emb, int c_bf16, float c0, float c1) {
  const int E = dim + w0 + w1;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long warm = static_cast<long long>(n_m) * E;
  if (t < warm) {
    const int k = static_cast<int>(t / E);
    const int e = static_cast<int>(t - static_cast<long long>(k) * E);
    const long long r = m_rows[k];
    if (r < 0 || r >= rows) return;
    set_column(table, s0, s1, r, dim, w0, w1, e, load(m_entries, m_bf16, t));
    return;
  }
  const long long u = t - warm;
  if (u >= static_cast<long long>(n_c) * E) return;
  const int k = static_cast<int>(u / E);
  const int e = static_cast<int>(u - static_cast<long long>(k) * E);
  const long long r = c_rows[k];
  if (r < 0 || r >= rows) return;
  const float v = e < dim ? load(c_emb, c_bf16, static_cast<long long>(k) * dim + e) : (e < dim + w0 ? c0 : c1);
  set_column(table, s0, s1, r, dim, w0, w1, e, v);
}

unsigned grid_of(long long items) { return static_cast<unsigned>((items + kThreads - 1) / kThreads); }

}  // namespace

// payload: (n_ev, E) f32 or bf16 (payload_dtype); m_entries (n_m, E) and
// c_emb (n_c, dim) f32 or bf16. A piece with no rows may pass null.
extern "C" int persia_cache_aux(float* table, long long rows, int dim, float* s0, int w0, float* s1, int w1,
                                const int32_t* ev_rows, int n_ev, void* payload, int payload_dtype,
                                const int32_t* m_rows, int n_m, const void* m_entries, int m_dtype,
                                const int32_t* c_rows, int n_c, const void* c_emb, int c_dtype, float c0, float c1,
                                void* stream) {
  if (table == nullptr || rows < 1 || dim < 1 || w0 < 0 || w1 < 0 || (w0 > 0 && s0 == nullptr) ||
      (w1 > 0 && (s1 == nullptr || w0 == 0)) || n_ev < 0 || n_m < 0 || n_c < 0) {
    return cudaErrorInvalidValue;
  }
  const auto dtype_ok = [](int d) { return d == persia::kFloat32 || d == persia::kBFloat16; };
  if ((n_ev > 0 && (ev_rows == nullptr || payload == nullptr || !dtype_ok(payload_dtype))) ||
      (n_m > 0 && (m_rows == nullptr || m_entries == nullptr || !dtype_ok(m_dtype))) ||
      (n_c > 0 && (c_rows == nullptr || c_emb == nullptr || !dtype_ok(c_dtype)))) {
    return cudaErrorInvalidValue;
  }
  const long long E = static_cast<long long>(dim) + w0 + w1;
  const long long payload_items = n_ev * E;
  const long long scatter_items = (static_cast<long long>(n_m) + n_c) * E;
  if ((payload_items + kThreads - 1) / kThreads > 0x7fffffffLL ||
      (scatter_items + kThreads - 1) / kThreads > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (payload_items > 0) {
    cache_payload_kernel<<<grid_of(payload_items), kThreads, 0, st>>>(
        table, s0, s1, rows, dim, w0, w1, ev_rows, n_ev, payload, payload_dtype == persia::kBFloat16);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (scatter_items > 0) {
    cache_scatter_kernel<<<grid_of(scatter_items), kThreads, 0, st>>>(
        table, s0, s1, rows, dim, w0, w1, m_rows, n_m, m_entries, m_dtype == persia::kBFloat16, c_rows, n_c, c_emb,
        c_dtype == persia::kBFloat16, c0, c1);
  }
  return cudaGetLastError();
}
