// Sparse optimizer update of a table resident in device memory (K5), and
// the routing of a table's update ids that comes before it.
//
// K5. Input: the ids of one step's positions, padding already routed to the
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
//   Adagrad: acc' = acc * mom + g * g        (vectorwise: + mean(g * g),
//                                             g * g summed in column order)
//            new_w = w - lr * g / sqrt(acc' + eps)
//   Adam:    m' = m * b1 + (1 - b1) * g;  v' = v * b2 + (1 - b2) * g * g
//            new_w = w - lr * (m' / (1 - b1^t)) / (sqrt(v' / (1 - b2^t)) + eps)
// and the row is written as w + (new_w - w) (the delta rounded to T first),
// the state as st + (st' - st): the reference's scatter-add write-back.
// The sentinel's segment, and any id outside [0, V), touches nothing.
//
// Routing (update_keys): for a group of slots of one table, each with its
// ids (int32, -1 = padding), its first row in the table (offset) and its
// vocab, the flat update keys slot after slot: id + offset where
// 0 <= id < vocab, else INT32_MAX. The fused step does not launch it: K4
// (csrc/fused_gather.cu) writes the same keys as it gathers. It serves
// routing without a gather (the graph step's warm-up).
//
// Replaces: persia_tpu/ops/sparse_update.py:55-158 (dedup_gradients,
// _apply_rows and sparse_update's scatter-add, lowered by XLA; no Pallas
// kernel) and the routing of persia_tpu/parallel/fused_step.py:389-399
// with sparse_update.py:69-71 (the mask to the sentinel). The sort stays
// torch.sort, as the reference's argsort is XLA's.
//
// Bound on the H100: bytes. K5 reads the sorted ids, the permutation and
// the gradients once, and reads and writes each touched row and its state
// once; a few dozen FLOP a row. The routing reads the ids and writes the
// keys.
//
// Design of K5: four steps on the stream, all sized from N alone, so a
// CUDA graph replays them without the host.
//  0. the two list counters are zeroed (cudaMemsetAsync);
//  1. sparse_update_segments_kernel, a thread per sorted position: a
//     position that heads a segment with an id in [0, V) finds the
//     segment's end (galloping, then bisection) and appends (start, length)
//     to the short list (length < kLongMin) or the long list. A block
//     counts its entries with ballots and reserves room with one atomicAdd
//     a list; the lists' order changes no bit, since each segment writes
//     only its own row. No float is summed with atomics.
//  2. sparse_update_long_kernel, a block a long segment (grid-stride): the
//     block stages the segment's gradient rows into shared memory with
//     cp.async, tiles of tile_rows rows, kStages tiles in the ring (two in
//     flight while one is summed), each tile's perm read coalesced one tile
//     ahead into registers. The threads that own a column unit (4 columns,
//     or 1 on the scalar path) add the staged rows in sorted order. So a
//     hot zipf row's loads run in parallel and only its adds are serial.
//  3. sparse_update_short_kernel, a group of `group` lanes a short segment
//     (grid-stride): the group reads its segment's perm coalesced, kWalk
//     entries at a time, broadcasts them by shuffles and loads kWalk rows
//     before adding them in order; each lane owns vec columns a tile. The
//     lane that writes vectorwise Adagrad's accumulator computes it alone
//     and broadcasts it, so no lane reads the accumulator after its store.
//  Rows, gradients and state move as 16-byte accesses (8 bytes for a bf16
//  row) where dim % 4 == 0 and every such pointer is aligned; else as
//  scalars. Vectorwise Adagrad sums g * g in column order: by shuffles in
//  column order across the group, or one thread over shared memory in the
//  long kernel; never by a tree. Every operation is an explicitly rounded
//  intrinsic (__fadd_rn, __fmul_rn, __fdiv_rn, __fsqrt_rn): the build's
//  --fmad=true would otherwise contract the optimizer's multiply-adds and
//  change its bits. ops/plans.py::sparse_update_plan chooses vec (by the
//  pointers' alignment) and tile_rows; the groups and grids follow here
//  from N, dim and vec, and the scratch is sized by the caller
//  (plans.SparseUpdatePlan.scratch_ints).
//
// Design of the routing: one thread per position; each finds its slot by a
// binary search over the start offsets in the parameter struct, as K4.

#include <algorithm>
#include <climits>
#include <cstdint>

#include "common.cuh"

// outside the anonymous namespace: the C entry point takes it
constexpr int kMaxUpdateSlots = 128;

struct UpdateSlots {
  const int32_t* ids[kMaxUpdateSlots];
  int start[kMaxUpdateSlots + 1];  // first key of each slot; start[nslots] = total
  int offset[kMaxUpdateSlots];     // the slot's first row in the table
  int vocab[kMaxUpdateSlots];      // the slot's rows
};

namespace {

constexpr int kSgd = 0;
constexpr int kAdagrad = 1;
constexpr int kAdam = 2;
constexpr int kThreads = 256;     // every block of K5 and of the routing pass
constexpr int kLongMin = 32;      // plans.K5_LONG_MIN: positions from which a segment is long
constexpr int kWalk = 4;          // rows a short segment's group has in flight
constexpr int kStages = 3;        // staged tiles of a long segment (two in flight while one is summed)
constexpr int kTileRowsMax = 128;  // plans.K5_TILE_ROWS_MAX
constexpr int kTileChunks = 1024;  // plans.K5_TILE_CHUNKS
constexpr int kChunksPerThread = kTileChunks / kThreads;
constexpr int kMaxUnits = 256;  // plans.K5_MAX_UNITS: one per thread of the long kernel
constexpr int kMaxTiles = 8;
constexpr int kResidentBlocks = 132 * 8;  // 256-thread blocks the H100 holds at once

struct OptParams {
  int kind;
  int vectorwise;
  float lr, wd, mom, eps, b1, omb1, b2, omb2;
};

// ---------------------------------------------------------------- row access

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
    x[0] = *p;
  }
}
template <int VEC>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    x[0] = __low2float(lo);
    x[1] = __high2float(lo);
    x[2] = __low2float(hi);
    x[3] = __high2float(hi);
  } else {
    x[0] = __bfloat162float(*p);
  }
}
template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *p = x[0];
  }
}

// st + (new - st), the reference's scatter-add of a delta, per column
template <int VEC>
__device__ __forceinline__ void write_state(float* p, const float (&st)[VEC], const float (&nw)[VEC]) {
  float out[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) out[j] = __fadd_rn(st[j], __fsub_rn(nw[j], st[j]));
  store_vec<VEC>(p, out);
}

// w + (new_w - w), the delta rounded to T before the add
template <int VEC>
__device__ __forceinline__ void write_row(float* p, const float (&w)[VEC], const float (&nw)[VEC]) {
  write_state<VEC>(p, w, nw);
}
template <int VEC>
__device__ __forceinline__ void write_row(__nv_bfloat16* p, const float (&w)[VEC], const float (&nw)[VEC]) {
  __nv_bfloat16 out[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float delta = __bfloat162float(__float2bfloat16(__fsub_rn(nw[j], w[j])));
    out[j] = __float2bfloat16(__fadd_rn(w[j], delta));
  }
  if constexpr (VEC == 4) {
    uint2 raw;
    raw.x = static_cast<uint32_t>(__bfloat16_as_ushort(out[0])) |
            (static_cast<uint32_t>(__bfloat16_as_ushort(out[1])) << 16);
    raw.y = static_cast<uint32_t>(__bfloat16_as_ushort(out[2])) |
            (static_cast<uint32_t>(__bfloat16_as_ushort(out[3])) << 16);
    *reinterpret_cast<uint2*>(p) = raw;
  } else {
    *p = out[0];
  }
}

// ------------------------------------------------------------ the optimizer

// g += wd * w for SGD and Adagrad (Adam rows take no decay)
template <int VEC>
__device__ __forceinline__ void add_decay(float (&g)[VEC], const float (&w)[VEC], const OptParams& o) {
  if (o.wd != 0.f && o.kind != kAdam) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) g[j] = __fadd_rn(g[j], __fmul_rn(o.wd, w[j]));
  }
}

// The update of VEC columns at element e = id * dim + c of a row whose
// columns are w and whose gradient sum (decay included) is g. shared_acc:
// vectorwise Adagrad's new accumulator of the row (already written).
template <typename T, int VEC>
__device__ __forceinline__ void apply_columns(T* __restrict__ table, float* __restrict__ s0, float* __restrict__ s1,
                                              int64_t e, const float (&g)[VEC], const float (&w)[VEC],
                                              float shared_acc, float bc1, float bc2, const OptParams& o) {
  float nw[VEC];
  if (o.kind == kSgd) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) nw[j] = __fsub_rn(w[j], __fmul_rn(o.lr, g[j]));
  } else if (o.kind == kAdagrad) {
    float a[VEC];
    if (o.vectorwise) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) a[j] = shared_acc;
    } else {
      float st[VEC];
      load_vec<VEC>(s0 + e, st);
#pragma unroll
      for (int j = 0; j < VEC; ++j) a[j] = __fadd_rn(__fmul_rn(st[j], o.mom), __fmul_rn(g[j], g[j]));
      write_state<VEC>(s0 + e, st, a);
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      nw[j] = __fsub_rn(w[j], __fdiv_rn(__fmul_rn(o.lr, g[j]), __fsqrt_rn(__fadd_rn(a[j], o.eps))));
    }
  } else {
    float m0[VEC], v0[VEC], m[VEC], v[VEC];
    load_vec<VEC>(s0 + e, m0);
    load_vec<VEC>(s1 + e, v0);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      m[j] = __fadd_rn(__fmul_rn(m0[j], o.b1), __fmul_rn(o.omb1, g[j]));
      v[j] = __fadd_rn(__fmul_rn(v0[j], o.b2), __fmul_rn(__fmul_rn(o.omb2, g[j]), g[j]));
      const float m_hat = __fdiv_rn(m[j], bc1);
      const float v_hat = __fdiv_rn(v[j], bc2);
      nw[j] = __fsub_rn(w[j], __fdiv_rn(__fmul_rn(o.lr, m_hat), __fadd_rn(__fsqrt_rn(v_hat), o.eps)));
    }
    write_state<VEC>(s0 + e, m0, m);
    write_state<VEC>(s1 + e, v0, v);
  }
  write_row<VEC>(table + e, w, nw);
}

// vectorwise Adagrad: acc' = acc * mom + (sum of g^2 in column order) / dim,
// read and written by one thread, which shares it with the row's others
__device__ __forceinline__ float shared_accumulator(float* __restrict__ s0, int id, float sq, int dim,
                                                    const OptParams& o) {
  const float st = s0[id];
  const float a = __fadd_rn(__fmul_rn(st, o.mom), __fdiv_rn(sq, static_cast<float>(dim)));
  s0[id] = __fadd_rn(st, __fsub_rn(a, st));
  return a;
}

__device__ __forceinline__ void bias_corrections(const float* __restrict__ batch_state, const OptParams& o,
                                                 float& bc1, float& bc2) {
  bc1 = 1.f;
  bc2 = 1.f;
  if (o.kind == kAdam) {
    bc1 = __fsub_rn(1.f, batch_state[0]);
    bc2 = __fsub_rn(1.f, batch_state[1]);
  }
}

// ------------------------------------------------- 1. the segment lists

__global__ void __launch_bounds__(kThreads)
    sparse_update_segments_kernel(const int32_t* __restrict__ sorted_ids, int n, long long num_rows,
                                  int2* __restrict__ short_list, int2* __restrict__ long_list,
                                  int* __restrict__ counts) {
  __shared__ int warp_short[kThreads / 32];
  __shared__ int warp_long[kThreads / 32];
  __shared__ int base[2];
  const int p = blockIdx.x * kThreads + threadIdx.x;
  bool is_short = false, is_long = false;
  int len = 0;
  if (p < n) {
    const int id = sorted_ids[p];
    if (id >= 0 && id < num_rows && (p == 0 || sorted_ids[p - 1] != id)) {
      // the segment's end: gallop until an id differs, then bisect
      int known = p;  // sorted_ids[known] == id
      int hi = n;     // n, or a position whose id differs
      for (int step = 1;; step <<= 1) {
        const int probe = known + step;
        if (probe >= n || sorted_ids[probe] != id) {
          hi = min(probe, n);
          break;
        }
        known = probe;
      }
      while (hi - known > 1) {
        const int mid = known + (hi - known) / 2;
        if (sorted_ids[mid] == id) {
          known = mid;
        } else {
          hi = mid;
        }
      }
      len = hi - p;
      is_long = len >= kLongMin;
      is_short = !is_long;
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned sb = __ballot_sync(0xffffffffu, is_short);
  const unsigned lb = __ballot_sync(0xffffffffu, is_long);
  const unsigned below = (1u << lane) - 1u;
  if (lane == 0) {
    warp_short[warp] = __popc(sb);
    warp_long[warp] = __popc(lb);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int ts = 0, tl = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      const int a = warp_short[w], b = warp_long[w];
      warp_short[w] = ts;
      warp_long[w] = tl;
      ts += a;
      tl += b;
    }
    base[0] = ts ? atomicAdd(counts, ts) : 0;
    base[1] = tl ? atomicAdd(counts + 1, tl) : 0;
  }
  __syncthreads();
  if (is_short) short_list[base[0] + warp_short[warp] + __popc(sb & below)] = make_int2(p, len);
  if (is_long) long_list[base[1] + warp_long[warp] + __popc(lb & below)] = make_int2(p, len);
}

// ------------------------------------------------- 2. long segments

__device__ __forceinline__ void cp_async(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    sparse_update_long_kernel(T* __restrict__ table, float* __restrict__ s0, float* __restrict__ s1,
                              const int32_t* __restrict__ sorted_ids, const int64_t* __restrict__ perm,
                              const float* __restrict__ grads, int dim, int units, int tile_rows,
                              const int2* __restrict__ list, const int* __restrict__ counts,
                              const float* __restrict__ batch_state, OptParams o) {
  extern __shared__ __align__(16) float stage[];  // kStages tiles of tile_rows x dim
  const int count = counts[1];
  const int tid = threadIdx.x;
  const int tile_floats = tile_rows * dim;
  const int tile_chunks = tile_rows * units;
  // the (row, unit) of each chunk this thread copies: the same in every tile
  int c_row[kChunksPerThread], c_off[kChunksPerThread];
#pragma unroll
  for (int i = 0; i < kChunksPerThread; ++i) {
    const int c = tid + i * kThreads;
    c_row[i] = c < tile_chunks ? c / units : INT_MAX;
    c_off[i] = c < tile_chunks ? (c - c_row[i] * units) * VEC : 0;
  }
  float bc1, bc2;
  bias_corrections(batch_state, o, bc1, bc2);
  const bool owner = tid < units;
  for (int s = blockIdx.x; s < count; s += gridDim.x) {
    const int2 seg = list[s];
    const int start = seg.x, len = seg.y;
    const int id = sorted_ids[start];
    const int ntiles = (len + tile_rows - 1) / tile_rows;
    int64_t pq[kChunksPerThread];  // perm of the next tile to issue, per chunk
    auto load_perm = [&](int tile) {
#pragma unroll
      for (int i = 0; i < kChunksPerThread; ++i) {
        const long long pos = static_cast<long long>(tile) * tile_rows + c_row[i];
        pq[i] = pos < len ? perm[start + pos] : 0;
      }
    };
    auto issue = [&](int tile) {
      float* dst = stage + (tile % kStages) * tile_floats;
#pragma unroll
      for (int i = 0; i < kChunksPerThread; ++i) {
        const long long pos = static_cast<long long>(tile) * tile_rows + c_row[i];
        if (pos < len) cp_async(dst + c_row[i] * dim + c_off[i], grads + pq[i] * dim + c_off[i], VEC * 4);
      }
      cp_async_commit();  // a group a tile, empty past the last, so the count stays uniform
    };
    load_perm(0);
#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) {
      issue(t);
      load_perm(t + 1);
    }
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
    for (int t = 0; t < ntiles; ++t) {
      issue(t + kStages - 1);  // into the stage summed in the last round
      load_perm(t + kStages);
      cp_async_wait<kStages - 1>();
      __syncthreads();
      if (owner) {
        const float* src = stage + (t % kStages) * tile_floats + tid * VEC;
        const int rows = min(tile_rows, len - t * tile_rows);
        int r = 0;
        for (; r + 8 <= rows; r += 8) {
          float x[8][VEC];
#pragma unroll
          for (int k = 0; k < 8; ++k) load_vec<VEC>(src + (r + k) * dim, x[k]);
#pragma unroll
          for (int k = 0; k < 8; ++k) {
#pragma unroll
            for (int j = 0; j < VEC; ++j) acc[j] = __fadd_rn(acc[j], x[k][j]);
          }
        }
        for (; r < rows; ++r) {
          float x[VEC];
          load_vec<VEC>(src + r * dim, x);
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[j] = __fadd_rn(acc[j], x[j]);
        }
      }
      __syncthreads();
    }
    cp_async_wait<0>();  // only empty groups remain
    const int64_t e = static_cast<int64_t>(id) * dim + tid * VEC;
    float w[VEC];
    if (owner) {
      load_vec<VEC>(table + e, w);
      add_decay<VEC>(acc, w, o);
    }
    float shared_acc = 0.f;
    if (o.kind == kAdagrad && o.vectorwise) {
      // g^2 per column into shared memory, then one thread sums them in order
      if (owner) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) stage[tid * VEC + j] = __fmul_rn(acc[j], acc[j]);
      }
      __syncthreads();
      if (tid == 0) {
        float sq = 0.f;
        for (int c = 0; c < dim; ++c) sq = __fadd_rn(sq, stage[c]);
        stage[dim] = shared_accumulator(s0, id, sq, dim, o);
      }
      __syncthreads();
      shared_acc = stage[dim];
    }
    if (owner) apply_columns<T, VEC>(table, s0, s1, e, acc, w, shared_acc, bc1, bc2, o);
    __syncthreads();  // the stage is free for the next segment
  }
}

// ------------------------------------------------- 3. short segments

template <typename T, int VEC, int TILES>
__global__ void __launch_bounds__(kThreads, TILES == 1 ? 3 : 1)
    sparse_update_short_kernel(T* __restrict__ table, float* __restrict__ s0, float* __restrict__ s1,
                               const int32_t* __restrict__ sorted_ids, const int64_t* __restrict__ perm,
                               const float* __restrict__ grads, int dim, int units, int group,
                               const int2* __restrict__ list, const int* __restrict__ counts,
                               const float* __restrict__ batch_state, OptParams o) {
  const int count = counts[0];
  const int lane = threadIdx.x & 31;
  const int glane = lane & (group - 1);
  const unsigned gmask = group == 32 ? 0xffffffffu : ((1u << group) - 1u) << (lane & ~(group - 1));
  const int per_block = kThreads / group;
  float bc1, bc2;
  bias_corrections(batch_state, o, bc1, bc2);
  for (int s = blockIdx.x * per_block + threadIdx.x / group; s < count; s += gridDim.x * per_block) {
    const int2 seg = list[s];
    const int start = seg.x, len = seg.y;
    const int id = sorted_ids[start];
    float acc[TILES][VEC];
#pragma unroll
    for (int t = 0; t < TILES; ++t) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[t][j] = 0.f;
    }
    for (int b = 0; b < len; b += kWalk) {
      // the group reads kWalk perm entries side by side, then shares them
      // (positions < N <= INT_MAX: 32 bits)
      int mine[kWalk], q[kWalk];
#pragma unroll
      for (int i = 0; i < kWalk; ++i) {
        mine[i] = 0;
        if ((i & (group - 1)) == glane && b + i < len) mine[i] = static_cast<int>(perm[start + b + i]);
      }
#pragma unroll
      for (int i = 0; i < kWalk; ++i) q[i] = __shfl_sync(gmask, mine[i], i & (group - 1), group);
#pragma unroll
      for (int t = 0; t < TILES; ++t) {
        const int u = t * group + glane;
        if (u >= units) continue;
        float x[kWalk][VEC];
#pragma unroll
        for (int i = 0; i < kWalk; ++i) {
          if (b + i < len) load_vec<VEC>(grads + static_cast<int64_t>(q[i]) * dim + u * VEC, x[i]);
        }
#pragma unroll
        for (int i = 0; i < kWalk; ++i) {
          if (b + i < len) {
#pragma unroll
            for (int j = 0; j < VEC; ++j) acc[t][j] = __fadd_rn(acc[t][j], x[i][j]);
          }
        }
      }
    }
    float w[TILES][VEC];
#pragma unroll
    for (int t = 0; t < TILES; ++t) {
      const int u = t * group + glane;
      if (u < units) {
        load_vec<VEC>(table + static_cast<int64_t>(id) * dim + u * VEC, w[t]);
        add_decay<VEC>(acc[t], w[t], o);
      }
    }
    float shared_acc = 0.f;
    if (o.kind == kAdagrad && o.vectorwise) {
      // sum of g^2 in column order (tile, lane, column), every lane the same
      float sq = 0.f;
#pragma unroll
      for (int t = 0; t < TILES; ++t) {
        float g2[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) g2[j] = __fmul_rn(acc[t][j], acc[t][j]);
        for (int k = 0; k < group; ++k) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float v = __shfl_sync(gmask, g2[j], k, group);
            if (t * group + k < units) sq = __fadd_rn(sq, v);
          }
        }
      }
      float a = 0.f;
      if (glane == 0) a = shared_accumulator(s0, id, sq, dim, o);
      shared_acc = __shfl_sync(gmask, a, 0, group);
    }
#pragma unroll
    for (int t = 0; t < TILES; ++t) {
      const int u = t * group + glane;
      if (u < units) {
        apply_columns<T, VEC>(table, s0, s1, static_cast<int64_t>(id) * dim + u * VEC, acc[t], w[t], shared_acc,
                              bc1, bc2, o);
      }
    }
  }
}

// ------------------------------------------------- the routing pass

__global__ void __launch_bounds__(kThreads)
    update_keys_kernel(const __grid_constant__ UpdateSlots p, int nslots, int32_t* __restrict__ out) {
  const int pos = blockIdx.x * kThreads + threadIdx.x;
  if (pos >= p.start[nslots]) return;
  int lo = 0, hi = nslots - 1;  // the last slot whose start <= pos
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (p.start[mid] <= pos) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const int id = p.ids[lo][pos - p.start[lo]];
  out[pos] = id >= 0 && id < p.vocab[lo] ? id + p.offset[lo] : INT_MAX;
}

// ------------------------------------------------- launches

struct Geometry {
  int group, tiles, tile_rows, seg_grid, short_grid, long_grid;
};

template <typename T, int VEC, int TILES>
cudaError_t launch_short(const Geometry& g, T* table, float* s0, float* s1, const int32_t* sids,
                         const int64_t* perm, const float* grads, int dim, const int2* list, const int* counts,
                         const float* bs, const OptParams& o, cudaStream_t st) {
  sparse_update_short_kernel<T, VEC, TILES><<<g.short_grid, kThreads, 0, st>>>(
      table, s0, s1, sids, perm, grads, dim, dim / VEC, g.group, list, counts, bs, o);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_all(const Geometry& g, void* table_, float* s0, float* s1, const int32_t* sids,
                       const int64_t* perm, const float* grads, int n, long long num_rows, int dim, int* scratch,
                       const float* bs, const OptParams& o, cudaStream_t st) {
  T* table = static_cast<T*>(table_);
  int* counts = scratch;
  int2* short_list = reinterpret_cast<int2*>(scratch + 4);
  int2* long_list = reinterpret_cast<int2*>(scratch + 4 + 2 * static_cast<long long>(n));
  cudaError_t rc = cudaMemsetAsync(counts, 0, 2 * sizeof(int), st);
  if (rc != cudaSuccess) return rc;
  sparse_update_segments_kernel<<<g.seg_grid, kThreads, 0, st>>>(sids, n, num_rows, short_list, long_list,
                                                                 counts);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  const size_t smem = static_cast<size_t>(kStages) * g.tile_rows * dim * sizeof(float);
  sparse_update_long_kernel<T, VEC><<<g.long_grid, kThreads, smem, st>>>(
      table, s0, s1, sids, perm, grads, dim, dim / VEC, g.tile_rows, long_list, counts, bs, o);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  switch (g.tiles) {
    case 1:
      return launch_short<T, VEC, 1>(g, table, s0, s1, sids, perm, grads, dim, short_list, counts, bs, o, st);
    case 2:
      return launch_short<T, VEC, 2>(g, table, s0, s1, sids, perm, grads, dim, short_list, counts, bs, o, st);
    case 4:
      return launch_short<T, VEC, 4>(g, table, s0, s1, sids, perm, grads, dim, short_list, counts, bs, o, st);
    default:
      return launch_short<T, VEC, kMaxTiles>(g, table, s0, s1, sids, perm, grads, dim, short_list, counts, bs,
                                             o, st);
  }
}

bool aligned(const void* p, uintptr_t bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

int pow2_ceil(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

}  // namespace

extern "C" int persia_sparse_update(void* table, int dtype, long long num_rows, int dim, void* s0, void* s1,
                                    const void* sorted_ids, const void* perm, const void* grads, int n,
                                    const void* batch_state, int kind, int vectorwise, float lr, float wd,
                                    float mom, float eps, float b1, float omb1, float b2, float omb2,
                                    void* scratch, int vec, int tile_rows, void* stream) {
  if (table == nullptr || sorted_ids == nullptr || perm == nullptr || grads == nullptr ||
      batch_state == nullptr || scratch == nullptr || n < 0 || dim < 1 || num_rows < 0) {
    return cudaErrorInvalidValue;
  }
  if ((dtype != persia::kFloat32 && dtype != persia::kBFloat16) || kind < kSgd || kind > kAdam) {
    return cudaErrorInvalidValue;
  }
  if ((kind == kAdagrad && s0 == nullptr) || (kind == kAdam && (s0 == nullptr || s1 == nullptr))) {
    return cudaErrorInvalidValue;
  }
  if (n == 0) return cudaSuccess;
  // the plan (ops/plans.py::sparse_update_plan), checked against what the
  // kernels were compiled for; the groups and grids follow from it
  const int elem = dtype == persia::kFloat32 ? 4 : 2;
  if (vec == 4) {
    const bool per_column = kind == kAdam || (kind == kAdagrad && !vectorwise);
    if (dim % 4 != 0 || !aligned(grads, 16) || !aligned(table, 4 * elem) ||
        (per_column && !aligned(s0, 16)) || (kind == kAdam && !aligned(s1, 16))) {
      return cudaErrorInvalidValue;
    }
  } else if (vec != 1) {
    return cudaErrorInvalidValue;
  }
  const int units = dim / vec;
  if (units > kMaxUnits || tile_rows < 1 || tile_rows > kTileRowsMax || tile_rows * units > kTileChunks ||
      !aligned(scratch, 16)) {
    return cudaErrorInvalidValue;
  }
  Geometry g;
  g.group = std::min(pow2_ceil(units), 32);  // lanes of a short segment, each vec columns a tile
  g.tiles = pow2_ceil((units + g.group - 1) / g.group);  // <= kMaxTiles, as units <= kMaxUnits
  g.tile_rows = tile_rows;
  g.seg_grid = (n + kThreads - 1) / kThreads;  // a thread a sorted position
  const int per_block = kThreads / g.group;     // short segments a block
  g.short_grid = std::max(1, std::min((n + per_block - 1) / per_block, kResidentBlocks));
  g.long_grid = std::max(1, std::min(n / kLongMin, kResidentBlocks));  // a block a long segment
  const OptParams o{kind, vectorwise, lr, wd, mom, eps, b1, omb1, b2, omb2};
  auto* a = static_cast<float*>(s0);
  auto* b = static_cast<float*>(s1);
  auto* ids = static_cast<const int32_t*>(sorted_ids);
  auto* pm = static_cast<const int64_t*>(perm);
  auto* gr = static_cast<const float*>(grads);
  auto* bs = static_cast<const float*>(batch_state);
  auto* sc = static_cast<int*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == persia::kFloat32) {
    return vec == 4 ? launch_all<float, 4>(g, table, a, b, ids, pm, gr, n, num_rows, dim, sc, bs, o, st)
                    : launch_all<float, 1>(g, table, a, b, ids, pm, gr, n, num_rows, dim, sc, bs, o, st);
  }
  return vec == 4 ? launch_all<__nv_bfloat16, 4>(g, table, a, b, ids, pm, gr, n, num_rows, dim, sc, bs, o, st)
                  : launch_all<__nv_bfloat16, 1>(g, table, a, b, ids, pm, gr, n, num_rows, dim, sc, bs, o, st);
}

extern "C" int persia_update_keys(const UpdateSlots* p, int nslots, void* out, void* stream) {
  if (p == nullptr || out == nullptr || nslots < 1 || nslots > kMaxUpdateSlots || p->start[0] != 0) {
    return cudaErrorInvalidValue;
  }
  for (int s = 0; s < nslots; ++s) {
    if (p->start[s + 1] < p->start[s] || p->vocab[s] < 1 || p->offset[s] < 0 ||
        static_cast<long long>(p->offset[s]) + p->vocab[s] > INT_MAX ||
        (p->ids[s] == nullptr && p->start[s + 1] > p->start[s])) {
      return cudaErrorInvalidValue;
    }
  }
  const int total = p->start[nslots];
  if (total == 0) return cudaSuccess;
  update_keys_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *p, nslots, static_cast<int32_t*>(out));
  return cudaGetLastError();
}
