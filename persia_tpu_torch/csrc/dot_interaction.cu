// DLRM dot interaction: feats (B, n, d) -> out (B, n(n-1)/2), the strict
// upper triangle of feats @ feats^T per batch row, in row-major pair order
// (numpy/jax triu_indices(n, k=1)).
//
// Replaces: persia_tpu/models/dlrm.py:49-53, where XLA computes the full
// einsum('bnd,bmd->bnm') and then gathers the triangle; there is no Pallas
// kernel for it.
//
// Bound on the H100: bytes. At the serving shape (B=4096, n=27, d=16, bf16)
// the function reads 3.5 MB and writes 2.9 MB but does only 46 MFLOP, about
// 7 FLOP per byte, far below the card's ~295 FLOP/byte balance point.
//
// Design: one block handles ROWS batch rows. It stages their n x d
// features in shared memory as f32 (one coalesced read of a contiguous
// span), builds the (i, j) pair table once, and each thread then writes
// consecutive outputs of the block's contiguous output span, so the only
// device-memory traffic is one read of the input and one write of the
// output, both coalesced; the (B, n, n) matrix is never formed. Dots
// accumulate in f32 in order over d and round once to the output type.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 8;
constexpr int kSmemLimit = 48 * 1024;

template <typename T>
__global__ void __launch_bounds__(kThreads)
dot_interaction_kernel(const T* __restrict__ feats, T* __restrict__ out,
                       int batch, int n, int d, int rows_per_block) {
  extern __shared__ float smem[];
  const int nd = n * d;
  const int pairs = n * (n - 1) / 2;
  float* f = smem;                                             // rows * n * d
  int* pair_ij = reinterpret_cast<int*>(smem + rows_per_block * nd);  // pairs

  const int b0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, batch - b0);

  const T* src = feats + static_cast<size_t>(b0) * nd;
  for (int e = threadIdx.x; e < rows * nd; e += kThreads) f[e] = persia::to_f32(src[e]);
  for (int i = threadIdx.x; i < n - 1; i += kThreads) {
    const int first = i * (2 * n - i - 1) / 2;  // pairs of rows before i
    for (int j = i + 1; j < n; ++j) pair_ij[first + j - i - 1] = (i << 16) | j;
  }
  __syncthreads();

  T* dst = out + static_cast<size_t>(b0) * pairs;
  for (int e = threadIdx.x; e < rows * pairs; e += kThreads) {
    const int r = e / pairs;
    const int ij = pair_ij[e - r * pairs];
    const float* a = f + (r * n + (ij >> 16)) * d;
    const float* c = f + (r * n + (ij & 0xFFFF)) * d;
    float acc = 0.f;
    for (int t = 0; t < d; ++t) acc = fmaf(a[t], c[t], acc);
    persia::store_f32(dst + e, acc);
  }
}

}  // namespace

// Rows per block: up to kMaxRows, as many as fit the 48 KB of static-size
// shared memory beside the pair table. Returns 0 when one row does not fit.
extern "C" int persia_dot_interaction_rows_per_block(int n, int d) {
  const long long pair_bytes = 4LL * n * (n - 1) / 2;
  const long long row_bytes = 4LL * n * d;
  long long rows = (kSmemLimit - pair_bytes) / row_bytes;
  if (rows < 1) return 0;
  return static_cast<int>(rows < kMaxRows ? rows : kMaxRows);
}

extern "C" int persia_dot_interaction(const void* feats, void* out, int batch, int n, int d,
                                      int dtype, void* stream) {
  const int rows = persia_dot_interaction_rows_per_block(n, d);
  if (rows == 0 || n < 2 || batch <= 0) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (static_cast<size_t>(rows) * n * d + n * (n - 1) / 2);
  const dim3 grid((batch + rows - 1) / rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == persia::kFloat32) {
    dot_interaction_kernel<float><<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(feats), static_cast<float*>(out), batch, n, d, rows);
  } else if (dtype == persia::kBFloat16) {
    dot_interaction_kernel<__nv_bfloat16><<<grid, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(feats), static_cast<__nv_bfloat16*>(out), batch, n, d,
        rows);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
