// The raw-slot gather (K6) and its scatter-add backward (K7).
//
// Forward (raw_gather_fwd): for each slot s of a group (one row dtype, one
// dim, one count n = B * L of positions) and each position k,
//   out[slot0 + s, k, :] = rows_s[index_s[k], :]
// out (out_slots, n, dim) in the rows' dtype: slot-major, so each slot's
// (B, L, dim) is contiguous. The rows are copied as bits. An index outside
// [0, P_s) stops the kernel with a device-side assert (check_row; the host
// range-checks every index before it stages the batch).
// Backward (raw_gather_bwd): for each slot s and each of its P_s rows r
// but the pad row P_s - 1, whose positions the model masks,
//   grad_rows_s[r, :] = sum over positions k with index_s[k] == r of
//                       g[slot0 + s, k, :]
// and grad_rows_s[P_s - 1, :] = 0 (the CSR leaves its positions out)
// g (out_slots, n, dim) in the rows' dtype, summed in f32 over a row's
// positions taken in stream order (a fixed tree across the lanes and
// chunks) and rounded once to the rows' dtype: the two-pass segment-sum of
// csrc/segment_sum.cuh, with each position carrying its own gradient.
//
// Replaces: persia_tpu/parallel/train_step.py:88-91, the raw branch of
// _embedding_model_inputs: XLA's gather `diff[index]` and its autodiff
// scatter-add onto the distinct rows, which sums in the wire dtype; there
// is no Pallas kernel for it.
//
// Bound on the H100: bytes. At DIN's Taobao shape (B=1024, L=50, dim 16,
// two slots) the forward reads each slot's index (0.2 MB) and writes 1.6 MB
// of bf16 rows (3.3 MB f32); the backward reads that much gradient and the
// CSR and writes the distinct rows. No arithmetic to speak of.
//
// Design: the forward is one launch for the group, one thread per (slot on
// grid y, position, 16-byte unit of the row), the units fastest: a lane
// group copies one row with 16-byte loads and the warp's stores are one
// contiguous span. A row whose bytes are no multiple of 16, or unaligned,
// is copied element by element. The backward walks only the live
// positions, and its hot rows (an item repeated across a batch) cost no
// more than cold ones: a row over all n positions is 1/C of each chunk of
// C plus one pass-2 sum of n / C partials. Geometry comes from
// ops/plans.py (raw_gather_plan, pool_plan) and is checked here.

#include "segment_sum.cuh"

namespace {

template <typename U>
__global__ void __launch_bounds__(kMaxThreads)
raw_gather_fwd_kernel(const __grid_constant__ PoolSlotsParams p, U* __restrict__ out, int positions,
                      int row_units, int slot0) {
  const int s = blockIdx.y;
  const long long t = 1LL * blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 1LL * positions * row_units) return;
  const int k = static_cast<int>(t / row_units);
  const int u = static_cast<int>(t - 1LL * k * row_units);
  const int r = __ldg(p.index[s] + k);
  check_row(r, p.num_rows[s]);
  out[(1LL * (slot0 + s) * positions + k) * row_units + u] =
      __ldg(static_cast<const U*>(p.rows[s]) + 1LL * r * row_units + u);
}

}  // namespace

// Forward: each slot's index is n = positions int32 (ids_per_sample 1 in
// the params); elem_bytes 2 or 4; unit_bytes 16 (the row's bytes a multiple
// of 16, every rows pointer and out 16-byte aligned) or elem_bytes. Grid
// (grid_x, nslots) of threads threads, one per (position, unit). Returns a
// CUDA error code.
extern "C" int persia_raw_gather_fwd(const PoolSlotsParams* p, void* out, int elem_bytes, int nslots,
                                     int positions, int dim, int out_slots, int slot0, int unit_bytes,
                                     int threads, int grid_x, void* stream) {
  int rc = check_group(p, nslots, positions, dim, out_slots, slot0, false);
  if (rc != cudaSuccess) return rc;
  if ((elem_bytes != 2 && elem_bytes != 4) || (unit_bytes != 16 && unit_bytes != elem_bytes) ||
      out == nullptr) {
    return cudaErrorInvalidValue;
  }
  const long long row_bytes = 1LL * dim * elem_bytes;
  if (row_bytes % unit_bytes != 0) return cudaErrorInvalidValue;
  if (unit_bytes == 16) {
    if (!aligned(out, 16)) return cudaErrorInvalidValue;
    for (int s = 0; s < nslots; ++s) {
      if (!aligned(p->rows[s], 16)) return cudaErrorInvalidValue;
    }
  }
  const int row_units = static_cast<int>(row_bytes / unit_bytes);
  const long long items = 1LL * positions * row_units;
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 || 1LL * grid_x * threads < items ||
      1LL * (grid_x - 1) * threads >= items) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(grid_x, nslots);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (unit_bytes == 16) {
    raw_gather_fwd_kernel<uint4><<<grid, threads, 0, st>>>(*p, static_cast<uint4*>(out), positions, row_units,
                                                           slot0);
  } else if (unit_bytes == 4) {
    raw_gather_fwd_kernel<unsigned><<<grid, threads, 0, st>>>(*p, static_cast<unsigned*>(out), positions,
                                                              row_units, slot0);
  } else {
    raw_gather_fwd_kernel<unsigned short><<<grid, threads, 0, st>>>(*p, static_cast<unsigned short*>(out),
                                                                    positions, row_units, slot0);
  }
  return static_cast<int>(cudaGetLastError());
}

// Backward, both passes on one stream (see segment_sum in
// csrc/segment_sum.cuh for the geometry): grad is (out_slots, positions,
// dim) in the rows' dtype, each slot's CSR over its positions but the pad
// row's (order (positions,), offsets[P] <= positions). Returns a CUDA
// error code.
extern "C" int persia_raw_gather_bwd(const PoolSlotsParams* p, void* grad, void* partials, int dtype,
                                     int nslots, int positions, int dim, int out_slots, int slot0, int vec,
                                     int lanes_per_pos, int col_tiles, int max_chunks, int chunk_warps,
                                     int chunk_grid_x, int row_block_x, int row_block_y, int row_grid_x,
                                     void* stream) {
  return segment_sum<true>(p, grad, partials, dtype, nslots, positions, dim, out_slots, slot0, vec, lanes_per_pos,
                           col_tiles, max_chunks, chunk_warps, chunk_grid_x, row_block_x, row_block_y,
                           row_grid_x, static_cast<cudaStream_t>(stream));
}
