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
// summed in f32 over a CSR of the index (row r's positions b * L + l,
// ascending: order_s[offsets_s[r] .. offsets_s[r + 1]]), rounded once to T.
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
// Design: one launch for the whole group (at most kMaxSlots slots; a wider
// group is cut into several launches by the wrapper). Per-slot pointers,
// row counts and ids per sample ride in a parameter struct passed by value
// (__grid_constant__), so a slot's fields are read from parameter memory
// with no extra device allocation or copy. One thread per output element:
// - forward: thread (b, s, c) walks its sample's L ids; the dim threads of
//   one (b, s) read one index (a broadcast) and one contiguous row, and the
//   block's stores are contiguous (slot-major within a sample, as out is);
// - backward: grid.y is the slot; thread (r, c) walks row r's CSR segment,
//   so every gradient row is written exactly once (no zeroing pass, no
//   atomics: the sum order is fixed and two runs agree bit for bit). Pad
//   positions point at row D and sum there, as the reference's autodiff
//   does; the host drops that row.

#include <algorithm>
#include <cstdint>

#include "common.cuh"

// outside the anonymous namespace: the C entry points take it, and a
// parameter of an internal type would give them internal linkage too
constexpr int kMaxSlots = 64;

struct PoolSlotsParams {
  void* rows[kMaxSlots];  // (P, dim) T: the forward reads them, the backward writes its output here
  const int32_t* index[kMaxSlots];  // (B, L)
  const int32_t* counts[kMaxSlots];  // (B,) or null: no sqrt scaling
  const int32_t* order[kMaxSlots];  // backward: (B * L,) positions sorted by row
  const int32_t* offsets[kMaxSlots];  // backward: (P + 1,)
  int num_rows[kMaxSlots];  // P
  int ids_per_sample[kMaxSlots];  // L
};

namespace {


__device__ __forceinline__ float sample_scale(const int32_t* counts, int b) {
  return counts == nullptr ? 1.f : rsqrtf(static_cast<float>(max(counts[b], 1)));
}

template <typename T>
__global__ void gather_pool_fwd_kernel(const __grid_constant__ PoolSlotsParams p,
                                       float* __restrict__ out, int batch, int dim, int nslots,
                                       int out_slots, int slot0) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long per_sample = static_cast<long long>(nslots) * dim;
  if (t >= per_sample * batch) return;
  const int b = static_cast<int>(t / per_sample);
  const int rem = static_cast<int>(t - b * per_sample);
  const int s = rem / dim;
  const int c = rem - s * dim;
  const int L = p.ids_per_sample[s];
  const int32_t* idx = p.index[s] + static_cast<long long>(b) * L;
  const T* rows = static_cast<const T*>(p.rows[s]);
  float acc = 0.f;
  for (int l = 0; l < L; ++l) {
    acc += persia::to_f32(rows[static_cast<long long>(idx[l]) * dim + c]);
  }
  out[(static_cast<long long>(b) * out_slots + slot0 + s) * dim + c] =
      __fmul_rn(acc, sample_scale(p.counts[s], b));
}

template <typename T>
__global__ void gather_pool_bwd_kernel(const __grid_constant__ PoolSlotsParams p,
                                       const float* __restrict__ grad, int dim, int out_slots,
                                       int slot0) {
  const int s = blockIdx.y;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(p.num_rows[s]) * dim) return;
  const int r = static_cast<int>(t / dim);
  const int c = static_cast<int>(t - static_cast<long long>(r) * dim);
  const int L = p.ids_per_sample[s];
  const int32_t* order = p.order[s];
  const int32_t* counts = p.counts[s];
  const int end = p.offsets[s][r + 1];
  float acc = 0.f;
  for (int k = p.offsets[s][r]; k < end; ++k) {
    const int b = order[k] / L;
    const float g = grad[(static_cast<long long>(b) * out_slots + slot0 + s) * dim + c];
    acc = __fadd_rn(acc, __fmul_rn(g, sample_scale(counts, b)));
  }
  persia::store_f32(static_cast<T*>(p.rows[s]) + t, acc);
}

int check_group(const PoolSlotsParams* p, int nslots, int batch, int dim, int out_slots,
                int slot0, int threads, bool backward) {
  if (p == nullptr || nslots < 1 || nslots > kMaxSlots || batch < 1 || dim < 1 ||
      slot0 < 0 || slot0 + nslots > out_slots || threads < 32 || threads > 1024 ||
      threads % 32 != 0) {
    return cudaErrorInvalidValue;
  }
  for (int s = 0; s < nslots; ++s) {
    if (p->rows[s] == nullptr || p->index[s] == nullptr || p->num_rows[s] < 1 ||
        p->ids_per_sample[s] < 1) {
      return cudaErrorInvalidValue;
    }
    if (backward && (p->order[s] == nullptr || p->offsets[s] == nullptr)) {
      return cudaErrorInvalidValue;
    }
  }
  return cudaSuccess;
}

}  // namespace

// Launch geometry from ops/plans.py::pool_plan (checked here); the struct
// is copied into the kernel's parameters. Returns a CUDA error code.
extern "C" int persia_gather_pool_fwd(const PoolSlotsParams* p, void* out, int dtype, int nslots,
                                      int batch, int dim, int out_slots, int slot0, int grid,
                                      int threads, void* stream) {
  int rc = check_group(p, nslots, batch, dim, out_slots, slot0, threads, false);
  if (rc != cudaSuccess) return rc;
  const long long total = 1LL * batch * nslots * dim;
  if (1LL * grid * threads < total || 1LL * (grid - 1) * threads >= total) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (dtype == persia::kFloat32) {
    gather_pool_fwd_kernel<float><<<grid, threads, 0, s>>>(*p, o, batch, dim, nslots, out_slots, slot0);
  } else if (dtype == persia::kBFloat16) {
    gather_pool_fwd_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(*p, o, batch, dim, nslots,
                                                                    out_slots, slot0);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int persia_gather_pool_bwd(const PoolSlotsParams* p, void* grad, int dtype, int nslots,
                                      int batch, int dim, int out_slots, int slot0, int grid_x,
                                      int threads, void* stream) {
  int rc = check_group(p, nslots, batch, dim, out_slots, slot0, threads, true);
  if (rc != cudaSuccess) return rc;
  long long max_rows = 0;
  for (int i = 0; i < nslots; ++i) max_rows = std::max(max_rows, static_cast<long long>(p->num_rows[i]));
  const long long total = max_rows * dim;
  if (1LL * grid_x * threads < total || 1LL * (grid_x - 1) * threads >= total) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(grid_x, nslots);
  const float* g = static_cast<const float*>(grad);
  if (dtype == persia::kFloat32) {
    gather_pool_bwd_kernel<float><<<grid, threads, 0, s>>>(*p, g, dim, out_slots, slot0);
  } else if (dtype == persia::kBFloat16) {
    gather_pool_bwd_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(*p, g, dim, out_slots, slot0);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
