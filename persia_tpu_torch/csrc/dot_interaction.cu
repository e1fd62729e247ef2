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
// Design (path, rows per block, threads, shared memory and feature stride
// from persia_tpu_torch/ops/plans.py::dot_plan, checked here). Both paths:
// - one block takes `rows` consecutive batch rows, one warp per row; their
//   inputs are one contiguous span, read with 16-byte loads;
// - the block's outputs are one contiguous span too: staged in shared
//   memory at the output's own alignment mod 16, then written with 16-byte
//   stores (a scalar head and tail around them); the (B, n, n) matrix is
//   never formed.
// The tensor-core path (bf16, d in {16, 32, 48, 64}, n <= 32; the serving
// shape): the warp's 32 x 32 (padded) Gram matrix on mma.sync m16n8k16,
// only the tiles that hold upper-triangle entries, operands by ldmatrix
// from bf16 rows at a stride of d + 8 elements (conflict-free). Being
// bytes-bound does not make the multiplies free: a scalar walk of 351 dots
// issues 26 x 16 FMAs per lane with 58 % of the lanes idle, and that issue
// time, not the bytes, bounded it.
// The FMA path (f32, and every other shape): features widened to f32 in
// shared memory, row stride d + 4 floats for the served widths (odd for
// the rest); lane i holds feature i in registers (d a template parameter
// for 8, 16, 32, 48, 64, fully unrolled; a generic instantiation for the
// rest) and the warp walks j = 1 .. n-1 in step, every lane reading
// feature j at one address (a broadcast, no conflicts). The output index of
// (i, j) is first(i) + j, first(i) computed once per owned i: no per-output
// division.
// Dots accumulate in f32 and round once to the output type; the FMA path
// sums in order over d, the tensor cores in their own order.
//
// Backward (dot_interaction_bwd): with g (B, n(n-1)/2) the gradient of the
// output and G the symmetric n x n matrix holding g(i, j) at (i, j) and
// (j, i) with a zero diagonal, dfeats[b, i] = sum_{j != i} G[b, i, j]
// feats[b, j], accumulated in f32 and rounded once to the input type. It
// replaces XLA's autodiff of the same einsum + triu gather (two batched
// products and their sum). Bytes bound too: at the bench shape it reads
// 3.5 MB of features and 2.9 MB of g and writes 3.5 MB, for 2 x 27 x 26 x
// 16 FLOP a row. Paths and geometry from plans.py::dot_bwd_plan:
// - tensor cores (bf16, d in {16, 32, 48, 64}, n <= 32): a warp per batch
//   row scatters g into a zero-padded symmetric 32 x 32 bf16 tile in shared
//   memory (the block's pair -> (i, j) table computed once), copies the row's
//   features into 32 zero-padded rows, and multiplies the two on mma.sync
//   m16n8k16: A = the tile by ldmatrix, B = the features by ldmatrix.trans
//   (they are k-major there). The result goes from the accumulators to
//   device memory as bf16 pairs;
// - FMA walk (f32, other shapes): a block widens rows_per_block rows of
//   features and g to f32 in shared memory; each thread owns (row, i, t)
//   and sums over j in order.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxRows = 8;

template <typename T>
__device__ __forceinline__ void to_f32x8(const uint4& raw, float (&x)[8]);
template <>
__device__ __forceinline__ void to_f32x8<__nv_bfloat16>(const uint4& raw, float (&x)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 -> f32 is a 16-bit shift
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

// The block's output span, staged in shared memory at `stage` (which has
// dst's alignment mod 16): a scalar head, 16-byte stores, a scalar tail.
template <typename T>
__device__ __forceinline__ void store_span(const T* stage, T* dst, int total, int shift) {
  constexpr int kVec = 16 / sizeof(T);
  const int head = min(((16 - shift) % 16) / static_cast<int>(sizeof(T)), total);
  const int vecs = (total - head) / kVec;
  const int tail = head + vecs * kVec;
  if (static_cast<int>(threadIdx.x) < head) dst[threadIdx.x] = stage[threadIdx.x];
  for (int c = threadIdx.x; c < vecs; c += blockDim.x) {
    reinterpret_cast<uint4*>(dst + head)[c] = reinterpret_cast<const uint4*>(stage + head)[c];
  }
  for (int e = tail + threadIdx.x; e < total; e += blockDim.x) dst[e] = stage[e];
}

// D > 0: the width, compiled in; D == 0: runtime d
template <typename T, int D>
__global__ void __launch_bounds__(32 * kMaxRows)
dot_interaction_kernel(const T* __restrict__ feats, T* __restrict__ out, int batch, int n,
                       int d_runtime, int rows_per_block, int feat_stride) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int d = D > 0 ? D : d_runtime;
  const int nd = n * d;
  const int pairs = n * (n - 1) / 2;
  const int b0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, batch - b0);
  float* f = reinterpret_cast<float*>(smem);  // rows * n feature rows, stride feat_stride

  // 1. the block's input span, widened to f32
  const T* src = feats + static_cast<size_t>(b0) * nd;
  const int count = rows * nd;
  constexpr int kVec = 16 / sizeof(T);
  auto widen_scalar = [&]() {
    for (int e = threadIdx.x; e < count; e += blockDim.x) {
      const int row = e / d;
      f[row * feat_stride + (e - row * d)] = persia::to_f32(src[e]);
    }
  };
  if constexpr (D > 0 && D % kVec == 0) {
    if (reinterpret_cast<uintptr_t>(src) % 16 == 0) {
      // a 16-byte chunk never crosses a feature row (kVec divides D)
      for (int c = threadIdx.x; c < count / kVec; c += blockDim.x) {
        const int e = c * kVec;
        const int row = e / D;  // D is a constant: no division instruction
        float* to = f + row * feat_stride + (e - row * D);
        const uint4 raw = reinterpret_cast<const uint4*>(src)[c];
        if constexpr (sizeof(T) == 4) {
          *reinterpret_cast<float4*>(to) = *reinterpret_cast<const float4*>(&raw);
        } else {
          float x[8];
          to_f32x8<T>(raw, x);
          *reinterpret_cast<float4*>(to) = make_float4(x[0], x[1], x[2], x[3]);
          *reinterpret_cast<float4*>(to + 4) = make_float4(x[4], x[5], x[6], x[7]);
        }
      }
    } else {
      widen_scalar();
    }
  } else {
    widen_scalar();
  }

  // the output staging area starts at the output span's alignment mod 16
  T* dst = out + static_cast<size_t>(b0) * pairs;
  const int shift = static_cast<int>(reinterpret_cast<uintptr_t>(dst) % 16);
  const int feat_bytes = (rows_per_block * n * feat_stride * 4 + 15) / 16 * 16;
  T* stage = reinterpret_cast<T*>(smem + feat_bytes + shift);
  __syncthreads();

  // 2. one warp per batch row; lane i owns feature i (and i + 32, ...)
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp < rows) {
    const float* fr = f + warp * n * feat_stride;
    T* st = stage + warp * pairs;
    for (int i0 = 0; i0 < n - 1; i0 += 32) {
      const int i = i0 + lane;
      const bool owns = i < n - 1;
      const int ii = owns ? i : 0;
      const int first = ii * (2 * n - ii - 1) / 2 - ii - 1;  // out index of (i, j): first + j
      if constexpr (D > 0) {
        float a[D];
#pragma unroll
        for (int t = 0; t < D; t += 4) {
          const float4 x = *reinterpret_cast<const float4*>(fr + ii * feat_stride + t);
          a[t] = x.x, a[t + 1] = x.y, a[t + 2] = x.z, a[t + 3] = x.w;
        }
        for (int j = i0 + 1; j < n; ++j) {
          if (owns && j > i) {
            const float* c = fr + j * feat_stride;  // one address for the warp
            float acc = 0.f;
#pragma unroll
            for (int t = 0; t < D; t += 4) {
              const float4 x = *reinterpret_cast<const float4*>(c + t);
              acc = fmaf(a[t], x.x, acc);
              acc = fmaf(a[t + 1], x.y, acc);
              acc = fmaf(a[t + 2], x.z, acc);
              acc = fmaf(a[t + 3], x.w, acc);
            }
            persia::store_f32(st + first + j, acc);
          }
        }
      } else {
        const float* a = fr + ii * feat_stride;  // odd stride: lanes on distinct banks
        for (int j = i0 + 1; j < n; ++j) {
          if (owns && j > i) {
            const float* c = fr + j * feat_stride;
            float acc = 0.f;
            for (int t = 0; t < d; ++t) acc = fmaf(a[t], c[t], acc);
            persia::store_f32(st + first + j, acc);
          }
        }
      }
    }
  }
  __syncthreads();

  store_span(stage, dst, rows * pairs, shift);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a b, m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16, D in {16, 32, 48, 64}, n <= 32: the warp of a batch row computes its
// n x n Gram matrix (padded to 32 x 32) on the tensor cores, only the tiles
// that hold upper-triangle entries: 6 m16n8k16 products per 16 of d at
// n = 27, where the FMA walk issues 26 x 16 FMAs per lane. Features stay
// bf16 in shared memory, row stride D + 8 elements, so each ldmatrix phase
// of 8 rows x 16 bytes hits 32 distinct banks.
template <int D>
__global__ void __launch_bounds__(32 * kMaxRows)
dot_interaction_mma_kernel(const __nv_bfloat16* __restrict__ feats,
                           __nv_bfloat16* __restrict__ out, int batch, int n,
                           int rows_per_block) {
  constexpr int kStride = D + 8;
  extern __shared__ __align__(16) uint8_t smem[];
  const int nd = n * D;
  const int pairs = n * (n - 1) / 2;
  const int b0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, batch - b0);
  __nv_bfloat16* f = reinterpret_cast<__nv_bfloat16*>(smem);

  // 1. the block's input span; rows past a batch row's n belong to the
  // next one (or are slack): they only reach Gram entries never written
  const __nv_bfloat16* src = feats + static_cast<size_t>(b0) * nd;
  const int count = rows * nd;
  if (reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    for (int c = threadIdx.x; c < count / 8; c += blockDim.x) {
      const int e = c * 8;
      const int row = e / D;
      *reinterpret_cast<uint4*>(f + row * kStride + (e - row * D)) =
          reinterpret_cast<const uint4*>(src)[c];
    }
  } else {
    for (int e = threadIdx.x; e < count; e += blockDim.x) {
      const int row = e / D;
      f[row * kStride + (e - row * D)] = src[e];
    }
  }
  __nv_bfloat16* dst = out + static_cast<size_t>(b0) * pairs;
  const int shift = static_cast<int>(reinterpret_cast<uintptr_t>(dst) % 16);
  const int feat_rows = rows_per_block * n + 32 - n;
  const int feat_bytes = (feat_rows * kStride * 2 + 15) / 16 * 16;
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(smem + feat_bytes + shift);
  __syncthreads();

  // 2. one warp per batch row
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp < rows) {
    const uint32_t fb = static_cast<uint32_t>(__cvta_generic_to_shared(f + warp * n * kStride));
    // tile (rb, cb): rows 16rb.., columns 8cb..; it holds an output if some
    // i < j < n lies in it
    bool live[2][4];
#pragma unroll
    for (int rb = 0; rb < 2; ++rb) {
#pragma unroll
      for (int cb = 0; cb < 4; ++cb) live[rb][cb] = 16 * rb < n - 1 && 8 * cb < n && 8 * cb + 7 > 16 * rb;
    }
    float c[2][4][4];
#pragma unroll
    for (int rb = 0; rb < 2; ++rb)
#pragma unroll
      for (int cb = 0; cb < 4; ++cb)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[rb][cb][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t a[2][4], b[2][4];
#pragma unroll
      for (int rb = 0; rb < 2; ++rb) {  // A: rows 16rb + 0..15, k 16ks + 0..15
        const int row = 16 * rb + (lane & 7) + 8 * ((lane >> 3) & 1);
        ldmatrix_x4(a[rb], fb + (row * kStride + 16 * ks + 8 * (lane >> 4)) * 2);
      }
#pragma unroll
      for (int cp = 0; cp < 2; ++cp) {  // B of column blocks 2cp and 2cp+1
        const int row = 16 * cp + 8 * (lane >> 4) + (lane & 7);
        ldmatrix_x4(b[cp], fb + (row * kStride + 16 * ks + 8 * ((lane >> 3) & 1)) * 2);
      }
#pragma unroll
      for (int rb = 0; rb < 2; ++rb)
#pragma unroll
        for (int cb = 0; cb < 4; ++cb)
          if (live[rb][cb]) mma_bf16(c[rb][cb], a[rb], b[cb / 2][2 * (cb % 2)], b[cb / 2][2 * (cb % 2) + 1]);
    }
    // accumulator entry e of tile (rb, cb): i = 16rb + lane/4 + 8(e/2),
    // j = 8cb + 2(lane%4) + e%2; output index first(i) + j
    __nv_bfloat16* st = stage + warp * pairs;
#pragma unroll
    for (int rb = 0; rb < 2; ++rb) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = 16 * rb + lane / 4 + 8 * half;
        const int first = (i * (2 * n - i - 1) >> 1) - i - 1;
#pragma unroll
        for (int cb = 0; cb < 4; ++cb) {
          if (!live[rb][cb]) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = 8 * cb + 2 * (lane % 4) + e;
            if (i < j && j < n) st[first + j] = __float2bfloat16(c[rb][cb][2 * half + e]);
          }
        }
      }
    }
  }
  __syncthreads();

  // 3. the block's output span
  store_span(stage, dst, rows * pairs, shift);
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// out index of pair (i, j), i < j: pair_first(i, n) + j
__device__ __forceinline__ int pair_first(int i, int n) { return (i * (2 * n - i - 1) >> 1) - i - 1; }

constexpr int kGsymStride = 40;  // bf16 elements: rows 80 bytes apart, ldmatrix conflict-free

// bf16, D in {16, 32, 48, 64}, n <= 32; one warp per batch row.
template <int D>
__global__ void __launch_bounds__(32 * kMaxRows)
dot_interaction_bwd_mma_kernel(const __nv_bfloat16* __restrict__ feats,
                               const __nv_bfloat16* __restrict__ grad,
                               __nv_bfloat16* __restrict__ out, int batch, int n,
                               int rows_per_block) {
  constexpr int kStride = D + 8;  // feature rows 16-byte aligned, ldmatrix.trans conflict-free
  extern __shared__ __align__(16) uint8_t smem[];
  const int pairs = n * (n - 1) / 2;
  const int b0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, batch - b0);
  uint16_t* table = reinterpret_cast<uint16_t*>(smem);  // pair p -> (i << 8) | j
  const int table_bytes = (pairs * 2 + 15) / 16 * 16;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  __nv_bfloat16* gsym = reinterpret_cast<__nv_bfloat16*>(smem + table_bytes) + warp * 32 * kGsymStride;
  __nv_bfloat16* f = reinterpret_cast<__nv_bfloat16*>(smem + table_bytes) +
                     rows_per_block * 32 * kGsymStride + warp * 32 * kStride;

  // 1. the pair table (once per block); each warp zeroes its tile and the
  // padding rows n..31 of its features
  if (threadIdx.x < n - 1) {
    const int i = threadIdx.x;
    const int first = pair_first(i, n);
    for (int j = i + 1; j < n; ++j) table[first + j] = static_cast<uint16_t>((i << 8) | j);
  }
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int c = lane; c < 32 * kGsymStride / 8; c += 32) reinterpret_cast<uint4*>(gsym)[c] = zero;
  for (int c = n * kStride / 8 + lane; c < 32 * kStride / 8; c += 32) reinterpret_cast<uint4*>(f)[c] = zero;
  __syncthreads();
  if (warp >= rows) return;

  // 2. g into the symmetric tile, the row's features into shared memory
  const int b = b0 + warp;
  const __nv_bfloat16* g = grad + static_cast<size_t>(b) * pairs;
  for (int p = lane; p < pairs; p += 32) {
    const int ij = table[p];
    const int i = ij >> 8, j = ij & 0xFF;
    gsym[i * kGsymStride + j] = g[p];
    gsym[j * kGsymStride + i] = g[p];
  }
  const uint32_t* src = reinterpret_cast<const uint32_t*>(feats + static_cast<size_t>(b) * n * D);
  for (int w = lane; w < n * D / 2; w += 32) {
    const int row = (2 * w) / D;
    *reinterpret_cast<uint32_t*>(f + row * kStride + (2 * w - row * D)) = src[w];
  }
  __syncwarp();

  // 3. dfeats (32 x D) = Gsym (32 x 32) . feats (32 x D), rows i < n kept
  const uint32_t gb = static_cast<uint32_t>(__cvta_generic_to_shared(gsym));
  const uint32_t fb = static_cast<uint32_t>(__cvta_generic_to_shared(f));
  float c[2][D / 8][4];
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[mb][nb][e] = 0.f;
  const bool live1 = n > 16;  // the second 16 rows hold outputs
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    uint32_t a[2][4];
#pragma unroll
    for (int mb = 0; mb < 2; ++mb) {  // A: rows 16mb + 0..15, k 16ks + 0..15
      const int row = 16 * mb + (lane & 7) + 8 * ((lane >> 3) & 1);
      ldmatrix_x4(a[mb], gb + (row * kGsymStride + 16 * ks + 8 * (lane >> 4)) * 2);
    }
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {  // B of column blocks 2np and 2np+1: k rows, t columns
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, fb + ((16 * ks + (lane & 15)) * kStride + 16 * np + 8 * (lane >> 4)) * 2);
      mma_bf16(c[0][2 * np], a[0], bf[0], bf[1]);
      mma_bf16(c[0][2 * np + 1], a[0], bf[2], bf[3]);
      if (live1) {
        mma_bf16(c[1][2 * np], a[1], bf[0], bf[1]);
        mma_bf16(c[1][2 * np + 1], a[1], bf[2], bf[3]);
      }
    }
  }
  // accumulator entries 2h, 2h+1 of block (mb, nb): i = 16mb + lane/4 + 8h,
  // t = 8nb + 2(lane%4) + {0, 1}
  __nv_bfloat16* o = out + static_cast<size_t>(b) * n * D;
#pragma unroll
  for (int mb = 0; mb < 2; ++mb) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 16 * mb + lane / 4 + 8 * h;
      if (i >= n) continue;
#pragma unroll
      for (int nb = 0; nb < D / 8; ++nb) {
        const int t = 8 * nb + 2 * (lane % 4);
        *reinterpret_cast<__nv_bfloat162*>(o + i * D + t) =
            __floats2bfloat162_rn(c[mb][nb][2 * h], c[mb][nb][2 * h + 1]);
      }
    }
  }
}

// every dtype and shape: rows_per_block rows widened to f32 in shared memory
template <typename T>
__global__ void dot_interaction_bwd_kernel(const T* __restrict__ feats, const T* __restrict__ grad,
                                           T* __restrict__ out, int batch, int n, int d,
                                           int rows_per_block) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int nd = n * d;
  const int pairs = n * (n - 1) / 2;
  const int b0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, batch - b0);
  float* f = reinterpret_cast<float*>(smem);  // rows x n x d
  float* g = f + rows_per_block * nd;  // rows x pairs
  for (int e = threadIdx.x; e < rows * nd; e += blockDim.x) {
    f[e] = persia::to_f32(feats[static_cast<size_t>(b0) * nd + e]);
  }
  for (int e = threadIdx.x; e < rows * pairs; e += blockDim.x) {
    g[e] = persia::to_f32(grad[static_cast<size_t>(b0) * pairs + e]);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < rows * nd; e += blockDim.x) {
    const int r = e / nd;
    const int rem = e - r * nd;
    const int i = rem / d;
    const int t = rem - i * d;
    const float* fr = f + r * nd + t;
    const float* gr = g + r * pairs;
    const int first_i = pair_first(i, n);
    float acc = 0.f;
    for (int j = 0; j < n; ++j) {
      if (j == i) continue;
      const int p = j < i ? pair_first(j, n) + i : first_i + j;
      acc = fmaf(gr[p], fr[j * d], acc);
    }
    persia::store_f32(out + static_cast<size_t>(b0) * nd + e, acc);
  }
}

template <typename T>
int launch(const void* feats, void* out, int batch, int n, int d, int rows, int stride,
           int smem, cudaStream_t s) {
  const dim3 grid((batch + rows - 1) / rows);
  const dim3 block(32 * rows);
  const T* x = static_cast<const T*>(feats);
  T* y = static_cast<T*>(out);
  switch (d) {
    case 8: dot_interaction_kernel<T, 8><<<grid, block, smem, s>>>(x, y, batch, n, d, rows, stride); break;
    case 16: dot_interaction_kernel<T, 16><<<grid, block, smem, s>>>(x, y, batch, n, d, rows, stride); break;
    case 32: dot_interaction_kernel<T, 32><<<grid, block, smem, s>>>(x, y, batch, n, d, rows, stride); break;
    case 48: dot_interaction_kernel<T, 48><<<grid, block, smem, s>>>(x, y, batch, n, d, rows, stride); break;
    case 64: dot_interaction_kernel<T, 64><<<grid, block, smem, s>>>(x, y, batch, n, d, rows, stride); break;
    default: dot_interaction_kernel<T, 0><<<grid, block, smem, s>>>(x, y, batch, n, d, rows, stride); break;
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_mma(const void* feats, void* out, int batch, int n, int d, int rows, int smem,
               cudaStream_t s) {
  const dim3 grid((batch + rows - 1) / rows);
  const dim3 block(32 * rows);
  const auto* x = static_cast<const __nv_bfloat16*>(feats);
  auto* y = static_cast<__nv_bfloat16*>(out);
  switch (d) {
    case 16: dot_interaction_mma_kernel<16><<<grid, block, smem, s>>>(x, y, batch, n, rows); break;
    case 32: dot_interaction_mma_kernel<32><<<grid, block, smem, s>>>(x, y, batch, n, rows); break;
    case 48: dot_interaction_mma_kernel<48><<<grid, block, smem, s>>>(x, y, batch, n, rows); break;
    case 64: dot_interaction_mma_kernel<64><<<grid, block, smem, s>>>(x, y, batch, n, rows); break;
    default: return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_bwd_mma(const void* feats, const void* grad, void* out, int batch, int n, int d,
                   int rows, int smem, cudaStream_t s) {
  const dim3 grid((batch + rows - 1) / rows);
  const dim3 block(32 * rows);
  const auto* x = static_cast<const __nv_bfloat16*>(feats);
  const auto* g = static_cast<const __nv_bfloat16*>(grad);
  auto* y = static_cast<__nv_bfloat16*>(out);
  switch (d) {
    case 16: dot_interaction_bwd_mma_kernel<16><<<grid, block, smem, s>>>(x, g, y, batch, n, rows); break;
    case 32: dot_interaction_bwd_mma_kernel<32><<<grid, block, smem, s>>>(x, g, y, batch, n, rows); break;
    case 48: dot_interaction_bwd_mma_kernel<48><<<grid, block, smem, s>>>(x, g, y, batch, n, rows); break;
    case 64: dot_interaction_bwd_mma_kernel<64><<<grid, block, smem, s>>>(x, g, y, batch, n, rows); break;
    default: return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Geometry and path from ops/plans.py::dot_bwd_plan; returns a CUDA error code.
extern "C" int persia_dot_interaction_bwd(const void* feats, const void* grad, void* out,
                                          int batch, int n, int d, int dtype, int use_mma,
                                          int rows_per_block, int threads, int smem_bytes,
                                          void* stream) {
  if (n < 2 || d < 1 || batch <= 0 || rows_per_block < 1 || rows_per_block > kMaxRows) {
    return cudaErrorInvalidValue;
  }
  if (dtype != persia::kFloat32 && dtype != persia::kBFloat16) return cudaErrorInvalidValue;
  const long long pairs = n * (n - 1) / 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_mma) {
    const bool fits = dtype == persia::kBFloat16 && d % 16 == 0 && d <= 64 && n <= 32;
    const long long need = rows_per_block * (32LL * kGsymStride * 2 + 32LL * (d + 8) * 2) +
                           (pairs * 2 + 15) / 16 * 16;
    if (!fits || threads != 32 * rows_per_block || smem_bytes != need || smem_bytes > 48 * 1024) {
      return cudaErrorInvalidValue;
    }
    return launch_bwd_mma(feats, grad, out, batch, n, d, rows_per_block, smem_bytes, s);
  }
  const long long need = 4LL * rows_per_block * (n * d + pairs);
  if (threads < 32 || threads > 1024 || threads % 32 != 0 || smem_bytes != need ||
      smem_bytes > 48 * 1024) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((batch + rows_per_block - 1) / rows_per_block);
  if (dtype == persia::kFloat32) {
    dot_interaction_bwd_kernel<float><<<grid, threads, smem_bytes, s>>>(
        static_cast<const float*>(feats), static_cast<const float*>(grad),
        static_cast<float*>(out), batch, n, d, rows_per_block);
  } else {
    dot_interaction_bwd_kernel<__nv_bfloat16><<<grid, threads, smem_bytes, s>>>(
        static_cast<const __nv_bfloat16*>(feats), static_cast<const __nv_bfloat16*>(grad),
        static_cast<__nv_bfloat16*>(out), batch, n, d, rows_per_block);
  }
  return static_cast<int>(cudaGetLastError());
}

// Geometry and path from ops/plans.py::dot_plan; returns a CUDA error code.
extern "C" int persia_dot_interaction(const void* feats, void* out, int batch, int n, int d,
                                      int dtype, int use_mma, int rows_per_block,
                                      int feat_stride, int smem_bytes, void* stream) {
  if (n < 2 || d < 1 || batch <= 0 || rows_per_block < 1 || rows_per_block > kMaxRows) {
    return cudaErrorInvalidValue;
  }
  if (dtype != persia::kFloat32 && dtype != persia::kBFloat16) return cudaErrorInvalidValue;
  const int elem = dtype == persia::kFloat32 ? 4 : 2;
  const long long staging = 1LL * rows_per_block * (n * (n - 1) / 2) * elem + 16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_mma) {
    const bool fits = dtype == persia::kBFloat16 && d % 16 == 0 && d <= 64 && n <= 32;
    const long long feat_bytes = (2LL * (rows_per_block * n + 32 - n) * feat_stride + 15) / 16 * 16;
    if (!fits || feat_stride != d + 8 || smem_bytes < feat_bytes + staging ||
        smem_bytes > 48 * 1024) {
      return cudaErrorInvalidValue;
    }
    return launch_mma(feats, out, batch, n, d, rows_per_block, smem_bytes, s);
  }
  const bool specialised = d == 8 || d == 16 || d == 32 || d == 48 || d == 64;
  if (feat_stride != (specialised ? d + 4 : d + 1 - d % 2)) return cudaErrorInvalidValue;
  const long long feat_bytes = (4LL * rows_per_block * n * feat_stride + 15) / 16 * 16;
  if (smem_bytes < feat_bytes + staging || smem_bytes > 48 * 1024) return cudaErrorInvalidValue;
  if (dtype == persia::kFloat32) {
    return launch<float>(feats, out, batch, n, d, rows_per_block, feat_stride, smem_bytes, s);
  }
  return launch<__nv_bfloat16>(feats, out, batch, n, d, rows_per_block, feat_stride, smem_bytes,
                               s);
}
