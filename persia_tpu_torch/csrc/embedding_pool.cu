// Grouped gather-pool of device-pooled embedding slots, forward and backward.
//
// Forward (gather_pool_fwd): for each slot s of a group (one dim, one row
// dtype T) and each sample b,
//   out[b, slot0 + s, :] = scale_s[b] * sum_l rows_s[index_s[b, l], :]
// summed in f32 in l order, out (B, out_slots, dim) f32, scale_s[b] =
// rsqrt(max(counts_s[b], 1)) where the slot has counts, else 1.
// Backward (gather_pool_bwd): for each slot s and each of its P_s rows r,
//   grad_rows_s[r, :] = sum over (b, l) with index_s[b, l] == r of
//                       scale_s[b] * g[b, slot0 + s, :]
// summed in f32 and rounded once to T. A CSR of the index, built on the
// host, lists the positions b * L + l sorted by row (order_s) and each row's
// span in that list (offsets_s).
//
// Replaces: persia_tpu/parallel/train_step.py:69-87, the device-pooled
// branch of _embedding_model_inputs, where XLA gathers and sums each slot
// in its own fusion and autodiff transposes the gather into a scatter-add
// in the wire dtype; there is no Pallas kernel for it.
//
// Bound on the H100: bytes. At the bench shape (B=4096, 26 slots, L=1,
// dim 16, bf16 rows) the forward reads the index (0.4 MB) and the rows it
// gathers and writes 6.8 MB of f32; the backward reads that much gradient
// and writes the rows. A handful of FLOP per byte.
//
// Design: one launch for the whole group each way (at most kMaxSlots
// slots; a wider group is cut into several launches by the wrapper).
// Per-slot pointers, row counts and ids per sample ride in a parameter
// struct passed by value (__grid_constant__). Index math is 32-bit (the
// entry points check the ranges). Geometry comes from
// ops/plans.py::pool_plan and is checked here.
//
// - Forward: one thread per (sample, slot, VEC columns), in that order, so
//   a warp's stores cover one contiguous span of out (a sample's slots are
//   adjacent there): one 16-byte load per id (8 bf16 or 4 f32) and 16-byte
//   stores. The slot then varies within a warp, so each block copies the
//   slots' fields from the parameter struct into shared memory first. Other
//   dims and alignments take VEC = 1.
// - Backward, two launches, no float atomics, every row written once: the
//   two-pass segment-sum of csrc/segment_sum.cuh, where a position (b, l)
//   carries its sample's scaled gradient. The time does not
//   follow the longest segment: a row holding all B positions costs 1/C of
//   them in each chunk of C plus one pass-2 sum of B / C partials. Pads
//   point at row D and sum there, as the reference's autodiff does; the
//   host drops that row.

#include "segment_sum.cuh"

namespace {

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
gather_pool_fwd_kernel(const __grid_constant__ PoolSlotsParams p, float* __restrict__ out, int batch,
                       int dim, int nslots, int out_slots, int slot0) {
  // the slot varies within a warp, so its fields come from shared memory
  // (parameter memory serialises a warp's distinct addresses)
  __shared__ const T* s_rows[kMaxSlots];
  __shared__ const int32_t* s_index[kMaxSlots];
  __shared__ const int32_t* s_counts[kMaxSlots];
  __shared__ int s_ids[kMaxSlots];
  for (int i = threadIdx.x; i < nslots; i += blockDim.x) {
    s_rows[i] = static_cast<const T*>(p.rows[i]);
    s_index[i] = p.index[i];
    s_counts[i] = p.counts[i];
    s_ids[i] = p.ids_per_sample[i];
  }
  __syncthreads();
  const int row_vecs = dim / VEC;
  const int per_sample = nslots * row_vecs;  // (slot, column vector) items of a sample
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= batch * per_sample) return;
  const int b = t / per_sample;
  const int item = t - b * per_sample;
  const int s = item / row_vecs;
  const int c = (item - s * row_vecs) * VEC;
  const int L = s_ids[s];
  const int32_t* idx = s_index[s] + b * L;
  const T* rows = s_rows[s];
  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
#pragma unroll 4
  for (int l = 0; l < L; ++l) {
    float v[VEC];
    load_f32(rows + __ldg(idx + l) * dim + c, v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = __fadd_rn(acc[j], v[j]);
  }
  const float scale = sample_scale(s_counts[s], b);
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = __fmul_rn(acc[j], scale);
  // a sample's slots slot0.. are contiguous in out: item * VEC is the offset
  store_as(out + (b * out_slots + slot0) * dim + item * VEC, acc);
}
}  // namespace

// Forward: vec = 8 (bf16) or 4 (f32) for 16-byte loads and stores (dim a
// multiple of vec, every rows pointer 16-byte aligned), else 1. One thread
// per (sample, slot, vec columns), threads a block, grid blocks. Returns a
// CUDA error code.
extern "C" int persia_gather_pool_fwd(const PoolSlotsParams* p, void* out, int dtype, int nslots,
                                      int batch, int dim, int out_slots, int slot0, int vec,
                                      int threads, int grid, void* stream) {
  int rc = check_group(p, nslots, batch, dim, out_slots, slot0, false);
  if (rc != cudaSuccess) return rc;
  if (dtype != persia::kFloat32 && dtype != persia::kBFloat16) return cudaErrorInvalidValue;
  const int wide = dtype == persia::kFloat32 ? 4 : 8;
  if (vec != 1 && vec != wide) return cudaErrorInvalidValue;
  if (vec > 1) {
    if (dim % vec != 0 || !aligned(out, 16)) return cudaErrorInvalidValue;
    for (int s = 0; s < nslots; ++s) {
      if (!aligned(p->rows[s], 16)) return cudaErrorInvalidValue;
    }
  }
  const long long items = 1LL * batch * nslots * (dim / vec);
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 || 1LL * grid * threads < items ||
      1LL * (grid - 1) * threads >= items) {
    return cudaErrorInvalidValue;
  }
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == persia::kFloat32 && vec == 4) {
    gather_pool_fwd_kernel<float, 4><<<grid, threads, 0, st>>>(*p, o, batch, dim, nslots, out_slots, slot0);
  } else if (dtype == persia::kFloat32) {
    gather_pool_fwd_kernel<float, 1><<<grid, threads, 0, st>>>(*p, o, batch, dim, nslots, out_slots, slot0);
  } else if (vec == 8) {
    gather_pool_fwd_kernel<__nv_bfloat16, 8><<<grid, threads, 0, st>>>(*p, o, batch, dim, nslots, out_slots,
                                                                        slot0);
  } else {
    gather_pool_fwd_kernel<__nv_bfloat16, 1><<<grid, threads, 0, st>>>(*p, o, batch, dim, nslots, out_slots,
                                                                        slot0);
  }
  return static_cast<int>(cudaGetLastError());
}

// Backward, both passes on one stream (see segment_sum in
// csrc/segment_sum.cuh for the geometry): grad is (B, out_slots, dim) f32.
// Returns a CUDA error code.
extern "C" int persia_gather_pool_bwd(const PoolSlotsParams* p, void* grad, void* partials, int dtype,
                                      int nslots, int batch, int dim, int out_slots, int slot0, int vec,
                                      int lanes_per_pos, int col_tiles, int max_chunks, int chunk_warps,
                                      int chunk_grid_x, int row_block_x, int row_block_y,
                                      int row_grid_x, void* stream) {
  return segment_sum(p, grad, partials, dtype, nslots, batch, dim, out_slots, slot0, vec, lanes_per_pos,
                     col_tiles, max_chunks, chunk_warps, chunk_grid_x, row_block_x, row_block_y, row_grid_x,
                     static_cast<cudaStream_t>(stream));
}
