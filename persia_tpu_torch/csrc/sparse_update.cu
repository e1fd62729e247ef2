// Sparse optimizer update of a table resident in device memory (K5).
//
// Input: the ids of one step's positions, padding already routed to the
// INT32_MAX sentinel, sorted stably (sorted_ids (N,) int32 and the
// permutation perm (N,) int64, from torch.sort), the positions' gradients
// grads (N, dim) f32 in stream order, the table (V, dim) T, its optimizer
// state (f32: Adagrad acc (V, dim) or (V, 1); Adam m and v (V, dim)) and
// the batch's beta powers (f32[2], on the device, advanced by the caller).
// For every run of equal ids (a segment) with 0 <= id < V:
//   g      = sum of the segment's gradient rows, in f32, in sorted order
//            (stable, so stream order), starting from 0
//   g     += wd * w                          (SGD and Adagrad only)
//   SGD:     new_w = w - lr * g
//   Adagrad: acc' = acc * mom + g * g        (vectorwise: + mean(g * g))
//            new_w = w - lr * g / sqrt(acc' + eps)
//   Adam:    m' = m * b1 + (1 - b1) * g;  v' = v * b2 + (1 - b2) * g * g
//            new_w = w - lr * (m' / (1 - b1^t)) / (sqrt(v' / (1 - b2^t)) + eps)
// and the row is written as w + (new_w - w) (the delta rounded to T first),
// the state as st + (st' - st): the reference's scatter-add write-back.
// The sentinel's segment, and any id outside [0, V), touches nothing.
//
// Replaces: persia_tpu/ops/sparse_update.py:55-158 (dedup_gradients,
// _apply_rows and sparse_update's scatter-add, lowered by XLA; no Pallas
// kernel). The sort stays torch.sort, as the reference's argsort is XLA's.
//
// Bound on the H100: bytes. It reads the sorted ids, the permutation and
// the gradients once, and reads and writes each touched row and its state
// once; a few dozen FLOP a row.
//
// Design: one thread per sorted position. A thread whose position heads a
// segment walks the segment serially, summing its gradient rows 16 columns
// at a time in registers (float4 loads where dim % 4 == 0), applies the
// optimizer and writes the row once. Distinct segments name distinct rows,
// so there are no atomics and untouched rows keep their bits. Every
// operation is an explicitly rounded intrinsic (__fadd_rn, __fmul_rn,
// __fdiv_rn, __fsqrt_rn): the build's --fmad=true would otherwise contract
// the optimizer's multiply-adds and change its bits. A segment's time
// follows its length, so a hot row (zipf) serialises on one thread; the
// two-pass chunked segment-sum of gather_pool_bwd is the remedy, later.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kSgd = 0;
constexpr int kAdagrad = 1;
constexpr int kAdam = 2;
constexpr int kChunk = 16;  // gradient columns summed in registers at a time
constexpr int kThreads = 256;

struct OptParams {
  int kind;
  int vectorwise;
  float lr, wd, mom, eps, b1, omb1, b2, omb2;
};

// acc[j] = sum over the segment's positions of grads[perm[q], c0 + j], j < nc
template <bool kVec4>
__device__ __forceinline__ void segment_sum(float (&acc)[kChunk], const float* __restrict__ grads,
                                            const int64_t* __restrict__ perm, int begin, int end, int dim,
                                            int c0, int nc) {
#pragma unroll
  for (int j = 0; j < kChunk; ++j) acc[j] = 0.f;
  for (int q = begin; q < end; ++q) {
    const float* g = grads + perm[q] * static_cast<int64_t>(dim) + c0;
    if (kVec4) {
#pragma unroll
      for (int j = 0; j < kChunk; j += 4) {
        if (j < nc) {
          const float4 v = *reinterpret_cast<const float4*>(g + j);
          acc[j] = __fadd_rn(acc[j], v.x);
          acc[j + 1] = __fadd_rn(acc[j + 1], v.y);
          acc[j + 2] = __fadd_rn(acc[j + 2], v.z);
          acc[j + 3] = __fadd_rn(acc[j + 3], v.w);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (j < nc) acc[j] = __fadd_rn(acc[j], g[j]);
      }
    }
  }
}

// w + (new_w - w), the delta rounded to T before the add, as the
// reference's scatter-add of a T-typed delta
__device__ __forceinline__ void write_back(float* p, float w, float new_w) {
  *p = __fadd_rn(w, __fsub_rn(new_w, w));
}
__device__ __forceinline__ void write_back(__nv_bfloat16* p, float w, float new_w) {
  const float delta = __bfloat162float(__float2bfloat16(__fsub_rn(new_w, w)));
  *p = __float2bfloat16(__fadd_rn(w, delta));
}

__device__ __forceinline__ void write_state(float* p, float st, float new_st) {
  *p = __fadd_rn(st, __fsub_rn(new_st, st));
}

template <typename T, bool kVec4>
__global__ void __launch_bounds__(kThreads)
    sparse_update_kernel(T* __restrict__ table, float* __restrict__ s0, float* __restrict__ s1,
                         const int32_t* __restrict__ sorted_ids, const int64_t* __restrict__ perm,
                         const float* __restrict__ grads, int n, int64_t num_rows, int dim,
                         const float* __restrict__ batch_state, OptParams o) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= n) return;
  const int id = sorted_ids[p];
  if (p > 0 && sorted_ids[p - 1] == id) return;  // not a segment head
  if (id < 0 || id >= num_rows) return;         // the padding sentinel, or dropped
  int end = p + 1;
  while (end < n && sorted_ids[end] == id) ++end;

  T* w = table + static_cast<int64_t>(id) * dim;
  const bool decay = o.wd != 0.f && o.kind != kAdam;
  float bc1 = 1.f, bc2 = 1.f;
  if (o.kind == kAdam) {
    bc1 = __fsub_rn(1.f, batch_state[0]);
    bc2 = __fsub_rn(1.f, batch_state[1]);
  }
  float acc[kChunk];
  // vectorwise Adagrad: the row's one accumulator needs the mean of g^2
  // over all its columns before any column is updated
  float shared_acc = 0.f;
  if (o.kind == kAdagrad && o.vectorwise) {
    float sq = 0.f;
    for (int c0 = 0; c0 < dim; c0 += kChunk) {
      const int nc = min(kChunk, dim - c0);
      segment_sum<kVec4>(acc, grads, perm, p, end, dim, c0, nc);
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (j < nc) {
          float g = acc[j];
          if (decay) g = __fadd_rn(g, __fmul_rn(o.wd, persia::to_f32(w[c0 + j])));
          sq = __fadd_rn(sq, __fmul_rn(g, g));
        }
      }
    }
    const float st = s0[id];
    shared_acc = __fadd_rn(__fmul_rn(st, o.mom), __fdiv_rn(sq, static_cast<float>(dim)));
    write_state(s0 + id, st, shared_acc);
  }
  for (int c0 = 0; c0 < dim; c0 += kChunk) {
    const int nc = min(kChunk, dim - c0);
    segment_sum<kVec4>(acc, grads, perm, p, end, dim, c0, nc);
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (j >= nc) continue;
      const int c = c0 + j;
      const int64_t e = static_cast<int64_t>(id) * dim + c;
      const float wf = persia::to_f32(w[c]);
      float g = acc[j];
      if (decay) g = __fadd_rn(g, __fmul_rn(o.wd, wf));
      float new_w;
      if (o.kind == kSgd) {
        new_w = __fsub_rn(wf, __fmul_rn(o.lr, g));
      } else if (o.kind == kAdagrad) {
        float a = shared_acc;
        if (!o.vectorwise) {
          const float st = s0[e];
          a = __fadd_rn(__fmul_rn(st, o.mom), __fmul_rn(g, g));
          write_state(s0 + e, st, a);
        }
        new_w = __fsub_rn(wf, __fdiv_rn(__fmul_rn(o.lr, g), __fsqrt_rn(__fadd_rn(a, o.eps))));
      } else {
        const float m0 = s0[e], v0 = s1[e];
        const float m = __fadd_rn(__fmul_rn(m0, o.b1), __fmul_rn(o.omb1, g));
        const float v = __fadd_rn(__fmul_rn(v0, o.b2), __fmul_rn(__fmul_rn(o.omb2, g), g));
        const float m_hat = __fdiv_rn(m, bc1);
        const float v_hat = __fdiv_rn(v, bc2);
        new_w = __fsub_rn(wf, __fdiv_rn(__fmul_rn(o.lr, m_hat), __fadd_rn(__fsqrt_rn(v_hat), o.eps)));
        write_state(s0 + e, m0, m);
        write_state(s1 + e, v0, v);
      }
      write_back(w + c, wf, new_w);
    }
  }
}

template <typename T>
void launch(void* table, void* s0, void* s1, const void* sorted_ids, const void* perm, const void* grads, int n,
            long long num_rows, int dim, const void* batch_state, const OptParams& o, bool vec4,
            cudaStream_t stream) {
  const int grid = (n + kThreads - 1) / kThreads;
  auto* t = static_cast<T*>(table);
  auto* a = static_cast<float*>(s0);
  auto* b = static_cast<float*>(s1);
  auto* ids = static_cast<const int32_t*>(sorted_ids);
  auto* pm = static_cast<const int64_t*>(perm);
  auto* g = static_cast<const float*>(grads);
  auto* bs = static_cast<const float*>(batch_state);
  if (vec4) {
    sparse_update_kernel<T, true><<<grid, kThreads, 0, stream>>>(t, a, b, ids, pm, g, n, num_rows, dim, bs, o);
  } else {
    sparse_update_kernel<T, false><<<grid, kThreads, 0, stream>>>(t, a, b, ids, pm, g, n, num_rows, dim, bs, o);
  }
}

}  // namespace

extern "C" int persia_sparse_update(void* table, int dtype, long long num_rows, int dim, void* s0, void* s1,
                                    const void* sorted_ids, const void* perm, const void* grads, int n,
                                    const void* batch_state, int kind, int vectorwise, float lr, float wd,
                                    float mom, float eps, float b1, float omb1, float b2, float omb2,
                                    void* stream) {
  if (table == nullptr || sorted_ids == nullptr || perm == nullptr || grads == nullptr ||
      batch_state == nullptr || n < 0 || dim < 1 || num_rows < 0) {
    return cudaErrorInvalidValue;
  }
  if ((dtype != persia::kFloat32 && dtype != persia::kBFloat16) || kind < kSgd || kind > kAdam) {
    return cudaErrorInvalidValue;
  }
  if ((kind == kAdagrad && s0 == nullptr) || (kind == kAdam && (s0 == nullptr || s1 == nullptr))) {
    return cudaErrorInvalidValue;
  }
  if (n == 0) return cudaSuccess;
  const OptParams o{kind, vectorwise, lr, wd, mom, eps, b1, omb1, b2, omb2};
  const bool vec4 = dim % 4 == 0 && reinterpret_cast<uintptr_t>(grads) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == persia::kFloat32) {
    launch<float>(table, s0, s1, sorted_ids, perm, grads, n, num_rows, dim, batch_state, o, vec4, st);
  } else {
    launch<__nv_bfloat16>(table, s0, s1, sorted_ids, perm, grads, n, num_rows, dim, batch_state, o, vec4, st);
  }
  return cudaGetLastError();
}
