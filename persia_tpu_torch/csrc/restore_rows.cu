// The cache tier's restore (K14): rows whose eviction write-back is still in
// flight, re-admitted from the group's device ring instead of the servers.
//
// Input: the group's table T (R = C+1 rows, dim) f32 and its optimizer state
// columns, at most two (s0: Adagrad acc (R, w0) or Adam m (R, dim); s1: Adam
// v (R, dim)), which an entry [emb | s0 | s1] (E = dim + w0 + w1 floats) lays
// out in that order; the ring (ring_rows, E), f32 or bf16 (the write-back
// wire); src (n,) and dst (n,) int32.
//   for each k with 0 <= dst[k] < R: the entry of row dst[k] =
//   ring[clamp(src[k], 0, ring_rows - 1), :], widened to f32.
// Rows outside [0, R) are dropped (the host pads dst with R); a source is
// clamped as XLA's gather clamps it (the host pads src with 0). No dst row
// repeats within a call (the directory gives each miss its own row), so no
// float is written twice.
//
// Replaces: persia_tpu/embedding/hbm_cache/groups.py:250-256 (_restore_rows,
// through _scatter_entry_block :225-236), an XLA gather and three scatters;
// no Pallas kernel.
//
// Bound on the H100: bytes (the two index arrays; n live entries read from
// the ring and written to the pool; no arithmetic).
//
// Design: the one-thread-a-vector walk of K12 (cache_aux.cu), over one item
// space: a thread owns one vector of `vec` columns of one entry (8 where the
// ring is bf16: 16 bytes of it; 4 otherwise: a float4; 1 for widths that are
// no multiple of it), loads it from the ring, widens it and stores it to the
// row. One launch a call, over every restore of the group's step
// concatenated; none for a call without rows.

#include <cstdint>

#include "cache_entry.cuh"
#include "common.cuh"

using namespace persia_cache;

namespace {

constexpr int kThreads = 256;

template <int V>
__global__ void __launch_bounds__(kThreads)
    restore_rows_kernel(const Pool p, int units, const void* __restrict__ ring, bool ring_bf16, long long ring_rows,
                        const int32_t* __restrict__ src, const int32_t* __restrict__ dst, int n) {
  const int t = blockIdx.x * kThreads + threadIdx.x;  // the entry point keeps n * units < 2^31
  const int k = t / units;
  if (k >= n) return;
  const long long r = dst[k];
  if (r < 0 || r >= p.rows) return;  // a dropped row (a pad)
  long long s = src[k];
  s = s < 0 ? 0 : (s >= ring_rows ? ring_rows - 1 : s);
  const int col = (t - k * units) * V;
  float x[V];
  load_wire<V>(ring, ring_bf16, s * (p.dim + p.w0 + p.w1) + col, x);
  store_f32<V>(entry_at(p, r, col), x);
}

}  // namespace

// ring (ring_rows, E) f32 or bf16 (ring_dtype); src and dst (n,) int32. vec:
// columns a thread (1, 4 or 8; 8 only for a bf16 ring). One launch, none for
// n = 0.
extern "C" int persia_restore_rows(float* table, long long rows, int dim, float* s0, int w0, float* s1, int w1,
                                   int vec, const void* ring, long long ring_rows, int ring_dtype,
                                   const int32_t* src, const int32_t* dst, int n, void* stream) {
  const Pool pool{table, s0, s1, rows, dim, w0, w1};
  if (!pool_ok(pool, vec) || n < 0 || (ring_dtype != persia::kFloat32 && ring_dtype != persia::kBFloat16) ||
      (vec == 8 && ring_dtype != persia::kBFloat16)) {
    return cudaErrorInvalidValue;
  }
  if (n > 0 &&
      (ring == nullptr || ring_rows < 1 || src == nullptr || dst == nullptr || (vec > 1 && !aligned16(ring)))) {
    return cudaErrorInvalidValue;
  }
  const int units = (dim + w0 + w1) / vec;
  const long long items = static_cast<long long>(n) * units;
  if (items + kThreads > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (items == 0) return cudaSuccess;
  const bool bf16 = ring_dtype == persia::kBFloat16;
  const unsigned grid = static_cast<unsigned>((items + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 8) {
    restore_rows_kernel<8><<<grid, kThreads, 0, st>>>(pool, units, ring, bf16, ring_rows, src, dst, n);
  } else if (vec == 4) {
    restore_rows_kernel<4><<<grid, kThreads, 0, st>>>(pool, units, ring, bf16, ring_rows, src, dst, n);
  } else {
    restore_rows_kernel<1><<<grid, kThreads, 0, st>>>(pool, units, ring, bf16, ring_rows, src, dst, n);
  }
  return cudaGetLastError();
}
