// flax's BatchNorm over (B, C) activations: the forward in train mode and
// with the running statistics (K10), and its backward (K11).
//
// Forward, train mode (batch_norm_fwd, train = 1), per column c over the B
// rows, x widened to f32 (bf16 or f32 in, y in x's dtype):
//   mean = sum(x) / B, ex2 = sum(x * x) / B, v = ex2 - mean * mean
//   var = max(0, v), rstd = 1 / sqrt(var + eps), m = rstd * scale[c]
//   y = (x - mean) * m + bias[c]                    (f32, one rounding)
//   running_mean = momentum * running_mean + (1 - momentum) * mean
//   running_var = momentum * running_var + (1 - momentum) * var  (in place)
//   saved = (mean, rstd, gate) with gate = 1 where v > 0, 0.5 where v == 0,
//   0 where v < 0: the derivative of max(0, v) as jax takes it.
// With the running statistics (train = 0): mean = running_mean, var =
// running_var, gate = 0, nothing updated.
// Backward (batch_norm_bwd), from dy in x's dtype and saved:
//   sdy = sum(dy), dm = sum(dy * (x - mean)), dbias = sdy, dscale = dm * rstd
//   train: dv = -0.5 * dm * scale * rstd^3 * gate, k1 = m * sdy / B,
//          k2 = 2 * dv / B; else k1 = k2 = 0
//   dx = (dy * m - k1) + k2 * (x - mean)            (f32, one rounding)
// which is the autodiff of the fast-variance formula above, the batch
// statistics' dependence on x included. Every product and sum is a
// rounded intrinsic, never contracted into an FMA: the plain version in
// ops/batch_norm.py computes the same expressions in the same order, so
// the two differ only in the order of the column sums. With B = 1, v is
// exactly 0, x - mean is 0 and y = bias, as in flax.
//
// Replaces: flax.linen.BatchNorm as persia_tpu/models/dnn.py:39,41 calls it
// (use_fast_variance, momentum 0.99, epsilon 1e-5, f32 statistics over a
// bf16 input), which XLA fuses, and its autodiff; there is no Pallas
// kernel for it.
//
// Bound on the H100: bytes. At the serving bench's width (B=4096, C=128,
// bf16) the forward must read 1 MB and write 1 MB; a few operations a byte.
//
// Design: a cluster of S blocks (S up to 8, a portable cluster) owns 16
// bytes of columns (one vector of 8 bf16 or 4 f32 columns, or 8 / 4
// scalar columns when C is not a multiple of the vector or a pointer is
// not 16-byte aligned); block s of the cluster walks the s-th of S equal
// spans of the B rows, R row lanes a block (up to 256 threads), each lane
// every R-th row of its span, four rows in flight in both passes. S is
// chosen so that the grid holds about one block an SM (16 column groups x
// 8 at C = 128 bf16), where one block a column group left 116 of the 132
// SMs idle.
// Pass 1 sums in f32; the lanes' sums meet in a shuffle tree inside each
// warp and then, in warp order, in shared memory; the blocks' sums then
// meet through distributed shared memory, every block adding the ranks'
// sums in rank order, so every block and every run has the same bits (no
// atomics). One thread a column computes the statistics; block 0 writes
// saved and the running statistics. Pass 2 re-reads the block's rows,
// which at these sizes come from L2, and writes y (dx). One launch a
// layer and a direction. Geometry comes from ops/plans.py::batch_norm_plan
// and is checked here.

#include <cooperative_groups.h>

#include <cstdint>
#include <initializer_list>

#include "cluster.cuh"
#include "vec.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxBnThreads = 256;  // plans.BN_THREADS
constexpr int kMaxBnWarps = kMaxBnThreads / 32;
constexpr int kMaxBnCols = 8;  // columns a block: 16 bytes of bf16
constexpr int kRowsAhead = 4;  // plans.BN_ROWS_A_LANE
constexpr int kMaxBnSlices = 8;  // plans.BN_MAX_SLICES: blocks a cluster

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// the R row lanes' sums of each of the block's columns, in a fixed order:
// a shuffle tree over a warp's row lanes (offsets 16 .. groups), then the
// warps in order; out[col] (col < groups * VEC) valid after the call
template <int VEC>
__device__ __forceinline__ void block_column_sums(float (&a)[VEC], float (&b)[VEC], int groups,
                                                  float (*part_a)[kMaxBnCols], float (*part_b)[kMaxBnCols],
                                                  float* out_a, float* out_b) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    for (int off = 16; off >= groups; off >>= 1) {
      a[j] = __fadd_rn(a[j], __shfl_xor_sync(kFull, a[j], off));
      b[j] = __fadd_rn(b[j], __shfl_xor_sync(kFull, b[j], off));
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane < groups) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      part_a[warp][lane * VEC + j] = a[j];
      part_b[warp][lane * VEC + j] = b[j];
    }
  }
  __syncthreads();
  const int cols = groups * VEC;
  if (threadIdx.x < cols) {
    float sa = 0.f, sb = 0.f;
    const int warps = blockDim.x >> 5;
    for (int w = 0; w < warps; ++w) {
      sa = __fadd_rn(sa, part_a[w][threadIdx.x]);
      sb = __fadd_rn(sb, part_b[w][threadIdx.x]);
    }
    out_a[threadIdx.x] = sa;
    out_b[threadIdx.x] = sb;
  }
}

// this block's span of the rows: the blockIdx.y-th of gridDim.y equal
// spans (the block's rank in its cluster; the last may be shorter or empty)
__device__ __forceinline__ void slice_rows(int rows, int& begin, int& end) {
  const int span = (rows + static_cast<int>(gridDim.y) - 1) / static_cast<int>(gridDim.y);
  begin = min(rows, static_cast<int>(blockIdx.y) * span);
  end = min(rows, begin + span);
}

// the cluster's column sums from each block's (sum_*[col], col < cols):
// rank 0's, then ranks 1 .. S-1 added in order, read from their shared
// memory, so that every block gets the same bits; sum_* hold the totals
// after the call. The second barrier keeps every block's shared memory
// alive until all have read it.
__device__ __forceinline__ void cluster_column_sums(float* sum_a, float* sum_b, int cols) {
  if (gridDim.y == 1) return;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  float ta = 0.f, tb = 0.f;
  if (threadIdx.x < cols) {
    ta = cluster.map_shared_rank(sum_a, 0)[threadIdx.x];
    tb = cluster.map_shared_rank(sum_b, 0)[threadIdx.x];
    for (unsigned s = 1; s < gridDim.y; ++s) {
      ta = __fadd_rn(ta, cluster.map_shared_rank(sum_a, s)[threadIdx.x]);
      tb = __fadd_rn(tb, cluster.map_shared_rank(sum_b, s)[threadIdx.x]);
    }
  }
  cluster.sync();
  if (threadIdx.x < cols) {
    sum_a[threadIdx.x] = ta;
    sum_b[threadIdx.x] = tb;
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxBnThreads)
batch_norm_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ scale,
                      const float* __restrict__ bias, float* __restrict__ run_mean, float* __restrict__ run_var,
                      float* __restrict__ saved, int rows, int cols, int train, float momentum, float one_minus,
                      float eps, int groups) {
  __shared__ float part_a[kMaxBnWarps][kMaxBnCols], part_b[kMaxBnWarps][kMaxBnCols];
  __shared__ float sum_a[kMaxBnCols], sum_b[kMaxBnCols];
  __shared__ float s_mean[kMaxBnCols], s_mul[kMaxBnCols], s_bias[kMaxBnCols];
  const int g = threadIdx.x % groups;
  const int lanes = blockDim.x / groups;
  const int r0 = threadIdx.x / groups;
  const int c0 = blockIdx.x * groups * VEC + g * VEC;  // this thread's first column
  const bool live = c0 < cols;
  const bool lead = blockIdx.y == 0;  // the block that writes the statistics
  const T* xc = x + c0;
  int begin, end;
  slice_rows(rows, begin, end);

  if (train) {
    float a[VEC], b[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) a[j] = b[j] = 0.f;
    if (live) {
      int r = begin + r0;
      for (; r + (kRowsAhead - 1) * lanes < end; r += kRowsAhead * lanes) {
        float v[kRowsAhead][VEC];
#pragma unroll
        for (int k = 0; k < kRowsAhead; ++k) load_f32(xc + static_cast<long long>(r + k * lanes) * cols, v[k]);
#pragma unroll
        for (int k = 0; k < kRowsAhead; ++k) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            a[j] = __fadd_rn(a[j], v[k][j]);
            b[j] = __fadd_rn(b[j], __fmul_rn(v[k][j], v[k][j]));
          }
        }
      }
      for (; r < end; r += lanes) {
        float v[VEC];
        load_f32(xc + static_cast<long long>(r) * cols, v);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          a[j] = __fadd_rn(a[j], v[j]);
          b[j] = __fadd_rn(b[j], __fmul_rn(v[j], v[j]));
        }
      }
    }
    block_column_sums<VEC>(a, b, groups, part_a, part_b, sum_a, sum_b);
    cluster_column_sums(sum_a, sum_b, groups * VEC);
  }
  const int tc = blockIdx.x * groups * VEC + threadIdx.x;  // the column this thread finishes
  if (threadIdx.x < groups * VEC && tc < cols) {
    float mean, var, gate;
    if (train) {
      const float n = static_cast<float>(rows);
      mean = __fdiv_rn(sum_a[threadIdx.x], n);
      const float v = __fsub_rn(__fdiv_rn(sum_b[threadIdx.x], n), __fmul_rn(mean, mean));
      gate = v > 0.f ? 1.f : (v == 0.f ? 0.5f : 0.f);
      var = v < 0.f ? 0.f : v;  // max(0, v); a NaN stays NaN
      if (lead) {
        run_mean[tc] = __fadd_rn(__fmul_rn(momentum, run_mean[tc]), __fmul_rn(one_minus, mean));
        run_var[tc] = __fadd_rn(__fmul_rn(momentum, run_var[tc]), __fmul_rn(one_minus, var));
      }
    } else {
      mean = run_mean[tc];
      var = run_var[tc];
      gate = 0.f;
    }
    const float rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
    if (saved != nullptr && lead) {
      saved[tc] = mean;
      saved[cols + tc] = rstd;
      saved[2 * cols + tc] = gate;
    }
    s_mean[threadIdx.x] = mean;
    s_mul[threadIdx.x] = __fmul_rn(rstd, scale[tc]);
    s_bias[threadIdx.x] = bias[tc];
  }
  __syncthreads();
  if (!live) return;
  float mu[VEC], mul[VEC], bi[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    mu[j] = s_mean[g * VEC + j];
    mul[j] = s_mul[g * VEC + j];
    bi[j] = s_bias[g * VEC + j];
  }
  T* yc = y + c0;
  int r = begin + r0;
  for (; r + (kRowsAhead - 1) * lanes < end; r += kRowsAhead * lanes) {
    float v[kRowsAhead][VEC];
#pragma unroll
    for (int k = 0; k < kRowsAhead; ++k) load_f32(xc + static_cast<long long>(r + k * lanes) * cols, v[k]);
#pragma unroll
    for (int k = 0; k < kRowsAhead; ++k) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[k][j] = __fadd_rn(__fmul_rn(__fsub_rn(v[k][j], mu[j]), mul[j]), bi[j]);
      store_as(yc + static_cast<long long>(r + k * lanes) * cols, v[k]);
    }
  }
  for (; r < end; r += lanes) {
    float v[VEC];
    load_f32(xc + static_cast<long long>(r) * cols, v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = __fadd_rn(__fmul_rn(__fsub_rn(v[j], mu[j]), mul[j]), bi[j]);
    store_as(yc + static_cast<long long>(r) * cols, v);
  }
}

// (one block an SM is all the card holds at the path's widths: the bound
// lets the compiler keep the four rows of dy and x in flight in registers,
// where 256 threads a block alone made it spill)
template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxBnThreads, 1)
batch_norm_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ saved, T* __restrict__ dx, float* __restrict__ dscale,
                      float* __restrict__ dbias, int rows, int cols, int train, int groups) {
  __shared__ float part_a[kMaxBnWarps][kMaxBnCols], part_b[kMaxBnWarps][kMaxBnCols];
  __shared__ float sum_a[kMaxBnCols], sum_b[kMaxBnCols];
  __shared__ float s_mul[kMaxBnCols], s_k1[kMaxBnCols], s_k2[kMaxBnCols];
  const int g = threadIdx.x % groups;
  const int lanes = blockDim.x / groups;
  const int r0 = threadIdx.x / groups;
  const int c0 = blockIdx.x * groups * VEC + g * VEC;
  const bool live = c0 < cols;
  const T* xc = x + c0;
  const T* dyc = dy + c0;
  int begin, end;
  slice_rows(rows, begin, end);

  float mu[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) mu[j] = live ? saved[c0 + j] : 0.f;
  float a[VEC], b[VEC];  // sum(dy), sum(dy * (x - mean))
#pragma unroll
  for (int j = 0; j < VEC; ++j) a[j] = b[j] = 0.f;
  if (live) {
    int r = begin + r0;
    for (; r + (kRowsAhead - 1) * lanes < end; r += kRowsAhead * lanes) {
      float d[kRowsAhead][VEC], v[kRowsAhead][VEC];
#pragma unroll
      for (int k = 0; k < kRowsAhead; ++k) {
        load_f32(dyc + static_cast<long long>(r + k * lanes) * cols, d[k]);
        load_f32(xc + static_cast<long long>(r + k * lanes) * cols, v[k]);
      }
#pragma unroll
      for (int k = 0; k < kRowsAhead; ++k) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          a[j] = __fadd_rn(a[j], d[k][j]);
          b[j] = __fadd_rn(b[j], __fmul_rn(d[k][j], __fsub_rn(v[k][j], mu[j])));
        }
      }
    }
    for (; r < end; r += lanes) {
      float d[VEC], v[VEC];
      load_f32(dyc + static_cast<long long>(r) * cols, d);
      load_f32(xc + static_cast<long long>(r) * cols, v);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        a[j] = __fadd_rn(a[j], d[j]);
        b[j] = __fadd_rn(b[j], __fmul_rn(d[j], __fsub_rn(v[j], mu[j])));
      }
    }
  }
  block_column_sums<VEC>(a, b, groups, part_a, part_b, sum_a, sum_b);
  cluster_column_sums(sum_a, sum_b, groups * VEC);
  const int tc = blockIdx.x * groups * VEC + threadIdx.x;
  if (threadIdx.x < groups * VEC && tc < cols) {
    const float sdy = sum_a[threadIdx.x], dm = sum_b[threadIdx.x];
    const float rstd = saved[cols + tc], gate = saved[2 * cols + tc], sc = scale[tc];
    const float m = __fmul_rn(rstd, sc);
    if (blockIdx.y == 0) {
      dbias[tc] = sdy;
      dscale[tc] = __fmul_rn(dm, rstd);
    }
    float k1 = 0.f, k2 = 0.f;
    if (train) {
      const float n = static_cast<float>(rows);
      const float r3 = __fmul_rn(__fmul_rn(rstd, rstd), rstd);
      const float dv = __fmul_rn(__fmul_rn(__fmul_rn(-0.5f, __fmul_rn(dm, sc)), r3), gate);
      k1 = __fdiv_rn(__fmul_rn(m, sdy), n);
      k2 = __fdiv_rn(__fmul_rn(2.f, dv), n);
    }
    s_mul[threadIdx.x] = m;
    s_k1[threadIdx.x] = k1;
    s_k2[threadIdx.x] = k2;
  }
  __syncthreads();
  if (!live) return;
  float mul[VEC], k1[VEC], k2[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    mul[j] = s_mul[g * VEC + j];
    k1[j] = s_k1[g * VEC + j];
    k2[j] = s_k2[g * VEC + j];
  }
  T* dxc = dx + c0;
  int r = begin + r0;
  for (; r + (kRowsAhead - 1) * lanes < end; r += kRowsAhead * lanes) {
    float d[kRowsAhead][VEC], v[kRowsAhead][VEC];
#pragma unroll
    for (int k = 0; k < kRowsAhead; ++k) {
      load_f32(dyc + static_cast<long long>(r + k * lanes) * cols, d[k]);
      load_f32(xc + static_cast<long long>(r + k * lanes) * cols, v[k]);
    }
#pragma unroll
    for (int k = 0; k < kRowsAhead; ++k) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        d[k][j] = __fadd_rn(__fsub_rn(__fmul_rn(d[k][j], mul[j]), k1[j]),
                            __fmul_rn(k2[j], __fsub_rn(v[k][j], mu[j])));
      }
      store_as(dxc + static_cast<long long>(r + k * lanes) * cols, d[k]);
    }
  }
  for (; r < end; r += lanes) {
    float d[VEC], v[VEC];
    load_f32(dyc + static_cast<long long>(r) * cols, d);
    load_f32(xc + static_cast<long long>(r) * cols, v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      d[j] = __fadd_rn(__fsub_rn(__fmul_rn(d[j], mul[j]), k1[j]), __fmul_rn(k2[j], __fsub_rn(v[j], mu[j])));
    }
    store_as(dxc + static_cast<long long>(r) * cols, d);
  }
}

// the plan's numbers against what the kernels were compiled for: vec 16
// bytes of x (8 bf16, 4 f32; C a multiple of it, the row pointers 16-byte
// aligned) or 1; groups column vectors a block, together 16 bytes of a
// row; threads a power of two from 32 to kMaxBnThreads; grid clusters
// cover the columns exactly; slices blocks a cluster, 1 to kMaxBnSlices
int check_plan(int dtype, int rows, int cols, int vec, int groups, int threads, int grid, int slices,
               std::initializer_list<const void*> rows_ptrs) {
  if (dtype != persia::kFloat32 && dtype != persia::kBFloat16) return cudaErrorInvalidValue;
  const int elem = dtype == persia::kFloat32 ? 4 : 2;
  const int wide = 16 / elem;
  if (rows < 1 || cols < 1 || 1LL * rows * cols > (1LL << 40)) return cudaErrorInvalidValue;
  if (vec != 1 && vec != wide) return cudaErrorInvalidValue;
  if (vec > 1) {
    if (cols % vec != 0) return cudaErrorInvalidValue;
    for (const void* p : rows_ptrs) {
      if (!aligned16(p)) return cudaErrorInvalidValue;
    }
  }
  if (groups * vec * elem != 16) return cudaErrorInvalidValue;
  if (threads < 32 || threads > kMaxBnThreads || (threads & (threads - 1)) != 0) return cudaErrorInvalidValue;
  const int per_block = groups * vec;
  if (grid < 1 || 1LL * grid * per_block < cols || 1LL * (grid - 1) * per_block >= cols) {
    return cudaErrorInvalidValue;
  }
  if (slices < 1 || slices > kMaxBnSlices || slices > rows) return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

// K10. saved (3, C) f32 may be null (nothing for a backward to read).
// Returns a CUDA error code.
extern "C" int persia_batch_norm_fwd(const void* x, void* y, const float* scale, const float* bias, float* run_mean,
                                     float* run_var, float* saved, int dtype, int rows, int cols, int train,
                                     float momentum, float one_minus, float eps, int vec, int groups, int threads,
                                     int grid, int slices, void* stream) {
  int rc = check_plan(dtype, rows, cols, vec, groups, threads, grid, slices, {x, y});
  if (rc != cudaSuccess) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PERSIA_BN_FWD(T, V)                                                                                 \
  rc = launch_clusters(batch_norm_fwd_kernel<T, V>, grid, slices, threads, st, static_cast<const T*>(x),      \
                       static_cast<T*>(y), scale, bias, run_mean, run_var, saved, rows, cols, train, momentum, \
                       one_minus, eps, groups)
  if (dtype == persia::kFloat32) {
    if (vec == 4) PERSIA_BN_FWD(float, 4); else PERSIA_BN_FWD(float, 1);
  } else {
    if (vec == 8) PERSIA_BN_FWD(__nv_bfloat16, 8); else PERSIA_BN_FWD(__nv_bfloat16, 1);
  }
#undef PERSIA_BN_FWD
  return rc != cudaSuccess ? rc : static_cast<int>(cudaGetLastError());
}

// K11. Returns a CUDA error code.
extern "C" int persia_batch_norm_bwd(const void* dy, const void* x, const float* scale, const float* saved, void* dx,
                                     float* dscale, float* dbias, int dtype, int rows, int cols, int train, int vec,
                                     int groups, int threads, int grid, int slices, void* stream) {
  int rc = check_plan(dtype, rows, cols, vec, groups, threads, grid, slices, {dy, x, dx});
  if (rc != cudaSuccess) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PERSIA_BN_BWD(T, V)                                                                                   \
  rc = launch_clusters(batch_norm_bwd_kernel<T, V>, grid, slices, threads, st, static_cast<const T*>(dy),       \
                       static_cast<const T*>(x), scale, saved, static_cast<T*>(dx), dscale, dbias, rows, cols, \
                       train, groups)
  if (dtype == persia::kFloat32) {
    if (vec == 4) PERSIA_BN_BWD(float, 4); else PERSIA_BN_BWD(float, 1);
  } else {
    if (vec == 8) PERSIA_BN_BWD(__nv_bfloat16, 8); else PERSIA_BN_BWD(__nv_bfloat16, 1);
  }
#undef PERSIA_BN_BWD
  return rc != cudaSuccess ? rc : static_cast<int>(cudaGetLastError());
}
