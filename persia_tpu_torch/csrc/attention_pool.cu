// DIN's masked attention pool (K8) and its backward (K9).
//
// Forward (attention_pool_fwd): for each sample b, over its L history
// positions, with x = logits where mask, -inf elsewhere, and 0 everywhere
// on a row with no valid position,
//   w[b, l] = softmax(x[b])[l] where mask[b, l], else 0     (f32, saved)
//   out[b, :] = sum_l round_T(w[b, l]) * hist[b, l, :]
// summed in f32 and rounded once to T (bf16 or f32, hist's dtype).
// Backward (attention_pool_bwd), from d_out (B, dim) in T:
//   d_hist[b, l, :] = round_T(round_T(w[b, l]) * d_out[b, :])
//   g[b, l] = round_T(sum_c d_out[b, c] * hist[b, l, c]) where mask, else 0
//   d_logits[b, l] = w[b, l] * (g[b, l] - sum_j w[b, j] g[b, j]) where mask,
//                    else 0
// so masked positions and all-masked rows get a zero gradient and no NaN,
// as jax.grad gives through the reference's two `where`s.
//
// Replaces: persia_tpu/models/din.py:67-72, the `where`s, softmax, cast and
// einsum that XLA fuses around DIN's attention logits, and their autodiff;
// there is no Pallas kernel for it.
//
// Bound on the H100: bytes. At DIN's Taobao shape (B=1024, L=50, dim 16,
// bf16) the forward reads the logits (0.2 MB), the mask (51 KB) and the
// history rows (1.6 MB) and writes the weights (0.2 MB) and 32 KB of
// interests; the backward reads as much and writes d_hist (1.6 MB) and
// d_logits. A few operations per byte.
//
// Design: one warp per sample row; a block holds a few. Both kernels issue
// every global load at their top, so a warp waits on two round trips: a
// lane's mask bytes and weights (the forward's logits; positions lane + 32
// i, kept in registers) and, in the backward, its d_out vector; then, as
// soon as a ballot has given every lane the row's mask, the 16-byte
// history rows of its lane group's positions (the first kAhead; DIN's 50
// positions are at most 4 a group), never a masked one. The forward's max
// and sum are shuffle trees, so two runs give the same bits. The rounded
// weights stay in registers and reach a position's lane group by shuffle.
// In the forward's pooling a lane group takes one position's row (8 bf16
// or 4 f32 columns a lane) and the groups' partial sums meet in a shuffle
// tree. In the backward a lane group stores its positions' d_hist as soon
// as the weights and d_out are there, takes each valid position's dot
// with d_out (its columns, then a shuffle over the group) and hands g by
// shuffle to the lane that holds the position's weight (past kMidPerLane
// positions a lane, through L floats of shared memory a warp), which sums
// s = sum w g in the plain order and writes d_logits. Geometry comes from
// ops/plans.py::attention_pool_plan and is checked here.

#include <cmath>
#include <cstdint>

#include "vec.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxPoolThreads = 256;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = __fadd_rn(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

// x rounded to T and widened back (round to nearest even)
__device__ __forceinline__ float round_as(float x, float*) { return x; }
__device__ __forceinline__ float round_as(float x, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// a[k] for a warp-uniform k (0 past the end), without indexing registers
template <typename V, int N>
__device__ __forceinline__ V pick(const V (&a)[N], int k) {
  V r = V(0);
#pragma unroll
  for (int i = 0; i < N; ++i) r = i == k ? a[i] : r;
  return r;
}

// PL: the positions a lane holds (weights, mask bits; the forward's
// logits), lane + 32 i for i < PL: L <= 32 * PL, PL one of 2 (DIN's 50),
// kMidPerLane and kMaxPerLane; kAhead: the history rows a lane has in flight
constexpr int kMaxPerLane = 48;  // 1536 positions: the longest row the plan takes (the registers)
constexpr int kMidPerLane = 8;   // above it the backward keeps g in shared memory
constexpr int kAhead = 8;

template <typename T, int VEC, int PL>
__global__ void __launch_bounds__(kMaxPoolThreads)
attention_pool_fwd_kernel(const float* __restrict__ logits, const uint8_t* __restrict__ mask,
                          const T* __restrict__ hist, T* __restrict__ out, float* __restrict__ weights,
                          int batch, int L, int dim, int lanes_log2) {
  using U = typename RowUnit<T, VEC>::type;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= batch) return;  // the whole warp
  const float* lg = logits + 1LL * b * L;
  const uint8_t* mk = mask + 1LL * b * L;
  float* w_out = weights + 1LL * b * L;

  // the lane's mask bytes and logits, loaded once; the row's mask in every
  // lane as a word per 32 positions
  float x[PL];
  unsigned bits[PL];
#pragma unroll
  for (int i = 0; i < PL; ++i) {
    const int l = lane + 32 * i;
    const bool on = l < L && __ldg(mk + l);
    x[i] = l < L ? __ldg(lg + l) : 0.f;
    bits[i] = __ballot_sync(kFull, on);
  }

  // pooling geometry: lane group g (2^lanes_log2 lanes, one position's
  // row) takes positions g + groups * q; those of one q lie in one mask
  // word, q >> lanes_log2. lanes_log2 makes the vectors' count a multiple
  // of the group's lanes, so every lane runs the same trips
  const int groups = 32 >> lanes_log2;
  const int g = lane >> lanes_log2;
  const int v0 = lane & ((1 << lanes_log2) - 1);
  const int vecs = dim / VEC;
  const int walk = (L + groups - 1) / groups;  // positions a group walks
  const T* h = hist + 1LL * b * L * dim;
  U rows[kAhead];
  auto request = [&](int q0, int v) {  // the valid rows of positions q0.., never a masked one
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const int l = g + groups * (q0 + i);
      if ((pick(bits, (q0 + i) >> lanes_log2) >> (l & 31)) & 1u) {
        rows[i] = __ldg(reinterpret_cast<const U*>(h + 1LL * l * dim) + v);
      }
    }
  };
  request(0, v0);  // in flight while the softmax runs

  float mx = -INFINITY;
  bool any = false;
#pragma unroll
  for (int i = 0; i < PL; ++i) {
    if ((bits[i] >> lane) & 1u) {
      any = true;
      mx = fmaxf(mx, x[i]);
    }
  }
  any = __any_sync(kFull, any);
  mx = warp_max(mx);
  if (!any) mx = 0.f;  // x is 0 everywhere
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < PL; ++i) {
    if (lane + 32 * i < L) {
      const float xi = any ? (((bits[i] >> lane) & 1u) ? x[i] : -INFINITY) : 0.f;
      sum = __fadd_rn(sum, expf(xi - mx));
    }
  }
  sum = warp_sum(sum);
  float w_round[PL];  // the lane's positions' weights, rounded to T
#pragma unroll
  for (int i = 0; i < PL; ++i) {
    const int l = lane + 32 * i;
    w_round[i] = 0.f;
    if (l < L) {
      const bool on = (bits[i] >> lane) & 1u;
      const float xi = any ? (on ? x[i] : -INFINITY) : 0.f;
      const float w = on ? __fdiv_rn(expf(xi - mx), sum) : 0.f;
      w_out[l] = w;
      w_round[i] = round_as(w, static_cast<T*>(nullptr));
    }
  }

  // pooling: each group's positions in order, their weights by shuffle
  for (int v = v0; v < vecs; v += 1 << lanes_log2) {
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
    for (int q0 = 0; q0 < walk; q0 += kAhead) {
      if (v != v0 || q0 > 0) request(q0, v);
#pragma unroll
      for (int i = 0; i < kAhead; ++i) {
        const int q = q0 + i;
        const int l = g + groups * q;
        const float w = __shfl_sync(kFull, pick(w_round, q >> lanes_log2), l & 31);
        if ((pick(bits, q >> lanes_log2) >> (l & 31)) & 1u) {
          float xv[VEC];
          widen(rows[i], xv);
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[j] = __fmaf_rn(w, xv[j], acc[j]);
        }
      }
    }
    for (int off = 1 << lanes_log2; off < 32; off <<= 1) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = __fadd_rn(acc[j], __shfl_xor_sync(kFull, acc[j], off));
    }
    if (g == 0) store_as(out + 1LL * b * dim + v * VEC, acc);
  }
}

// a[k] = x for a warp-uniform k, without indexing registers
template <typename V, int N>
__device__ __forceinline__ void put(V (&a)[N], int k, V x) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] = i == k ? x : a[i];
}

// one block an SM is enough (DIN's 256 blocks are ~2 an SM): without the
// hint ptxas keeps DIN's template at 128 registers and spills
template <typename T, int VEC, int PL>
__global__ void __launch_bounds__(kMaxPoolThreads, 1)
attention_pool_bwd_kernel(const T* __restrict__ d_out, const uint8_t* __restrict__ mask,
                          const T* __restrict__ hist, const float* __restrict__ weights,
                          T* __restrict__ d_hist, float* __restrict__ d_logits, int batch, int L, int dim,
                          int lanes_log2) {
  constexpr bool kGShared = PL > kMidPerLane;  // g in shared memory, not registers
  using U = typename RowUnit<T, VEC>::type;
  extern __shared__ float g_smem[];  // kGShared: L values of g a warp
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= batch) return;  // the whole warp
  const uint8_t* mk = mask + 1LL * b * L;
  const float* w_in = weights + 1LL * b * L;

  // the forward's lane groups: group g (2^lanes_log2 lanes) takes
  // positions g + groups * q, a lane the vectors v0, v0 + lanes, ...
  const int groups = 32 >> lanes_log2;
  const int g = lane >> lanes_log2;
  const int v0 = lane & ((1 << lanes_log2) - 1);
  const int vecs = dim / VEC;
  const int walk = (L + groups - 1) / groups;  // positions a group walks
  const T* h = hist + 1LL * b * L * dim;
  T* dh = d_hist + 1LL * b * L * dim;
  const U* di_row = reinterpret_cast<const U*>(d_out + 1LL * b * dim);

  // every load at the top: the lane's first d_out vector; its weights and
  // mask bytes (positions lane + 32 i), the row's mask in every lane by
  // ballot; then the valid history rows of its group's first positions
  const U d0 = __ldg(di_row + v0);
  float wv[PL];
  unsigned bits[PL];
#pragma unroll
  for (int i = 0; i < PL; ++i) {
    const int l = lane + 32 * i;
    const bool on = l < L && __ldg(mk + l);
    wv[i] = l < L ? __ldg(w_in + l) : 0.f;
    bits[i] = __ballot_sync(kFull, on);
  }
  U rows[kAhead];
  auto request = [&](int q0, int v) {  // the valid rows of positions q0.., never a masked one
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const int l = g + groups * (q0 + i);
      if ((pick(bits, (q0 + i) >> lanes_log2) >> (l & 31)) & 1u) {
        rows[i] = __ldg(reinterpret_cast<const U*>(h + 1LL * l * dim) + v);
      }
    }
  };
  request(0, v0);

  float g_own[kGShared ? 1 : PL];  // g at the lane's positions lane + 32 i
#pragma unroll
  for (int i = 0; i < (kGShared ? 1 : PL); ++i) g_own[i] = 0.f;
  float* g_sh = g_smem + warp * L;
  for (int q0 = 0; q0 < walk; q0 += kAhead) {
    // the group's positions' rounded weights, by shuffle from their lanes
    float wr[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const int q = q0 + i;
      wr[i] = q < walk ? __shfl_sync(kFull, round_as(pick(wv, q >> lanes_log2), static_cast<T*>(nullptr)),
                                     (g + groups * q) & 31)
                       : 0.f;
    }
    float dot[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) dot[i] = 0.f;
    for (int v = v0; v < vecs; v += 1 << lanes_log2) {
      if (v != v0 || q0 > 0) request(q0, v);
      float di[VEC];
      widen(v == v0 ? d0 : __ldg(di_row + v), di);
#pragma unroll
      for (int i = 0; i < kAhead; ++i) {  // d_hist, masked positions too: T(T(w) * d_out)
        const int l = g + groups * (q0 + i);
        if (l < L) {
          float prod[VEC];
#pragma unroll
          for (int j = 0; j < VEC; ++j) prod[j] = __fmul_rn(wr[i], di[j]);
          store_as(dh + 1LL * l * dim + v * VEC, prod);
        }
      }
#pragma unroll
      for (int i = 0; i < kAhead; ++i) {  // the valid positions' dot, v then j ascending
        const int q = q0 + i;
        const int l = g + groups * q;
        if ((pick(bits, q >> lanes_log2) >> (l & 31)) & 1u) {
          float x[VEC];
          widen(rows[i], x);
#pragma unroll
          for (int j = 0; j < VEC; ++j) dot[i] = __fmaf_rn(di[j], x[j], dot[i]);
        }
      }
    }
    // g: each position's dot summed over its group, rounded, 0 where
    // masked; to the lane that owns the position (l & 31)
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const int q = q0 + i;
      if (q >= walk) break;  // warp-uniform
      const int l = g + groups * q;
      for (int off = 1; off < 1 << lanes_log2; off <<= 1) {
        dot[i] = __fadd_rn(dot[i], __shfl_xor_sync(kFull, dot[i], off));
      }
      const bool valid = (pick(bits, q >> lanes_log2) >> (l & 31)) & 1u;
      const float gq = valid ? round_as(dot[i], static_cast<T*>(nullptr)) : 0.f;
      if constexpr (kGShared) {
        if (v0 == 0 && l < L) g_sh[l] = gq;
      } else {
        // lane o owns o + 32 i': group o % groups, q = o / groups + i' * 2^lanes_log2
        const float got = __shfl_sync(kFull, gq, (lane & (groups - 1)) << lanes_log2);
        if ((q & ((1 << lanes_log2) - 1)) == lane >> (5 - lanes_log2)) put(g_own, q >> lanes_log2, got);
      }
    }
  }
  if constexpr (kGShared) __syncwarp();

  // s = sum w g over the lane's positions in order, then the warp; d_logits
  auto g_at = [&](int i) -> float {
    if constexpr (kGShared) {
      return g_sh[lane + 32 * i];
    } else {
      return g_own[i];
    }
  };
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < PL; ++i) {
    if (lane + 32 * i < L) s = __fmaf_rn(wv[i], g_at(i), s);
  }
  s = warp_sum(s);
  float* dl = d_logits + 1LL * b * L;
#pragma unroll
  for (int i = 0; i < PL; ++i) {
    const int l = lane + 32 * i;
    if (l < L) dl[l] = (bits[i] >> lane) & 1u ? __fmul_rn(wv[i], __fsub_rn(g_at(i), s)) : 0.f;
  }
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

int log2_exact(int x) {
  if (x < 1 || (x & (x - 1)) != 0) return -1;
  int k = 0;
  while ((1 << k) < x) ++k;
  return k;
}

// the checks both entry points share: shapes (L <= 32 * kMaxPerLane), the
// vector width and its alignment, the lane groups and the launch's geometry
int check_launch(int dtype, int batch, int L, int dim, int vec, int lanes, int warps, int grid, int smem,
                 int smem_per_warp, const void* hist, const void* big) {
  if ((dtype != persia::kFloat32 && dtype != persia::kBFloat16) || batch < 1 || L < 1 || L > 32 * kMaxPerLane ||
      dim < 1 || 1LL * batch * L * dim >= INT32_MAX) {
    return cudaErrorInvalidValue;
  }
  const int wide = dtype == persia::kFloat32 ? 4 : 8;
  if ((vec != 1 && vec != wide) || dim % vec != 0) return cudaErrorInvalidValue;
  if (vec > 1 && (!aligned16(hist) || !aligned16(big))) return cudaErrorInvalidValue;
  const int lanes_log2 = log2_exact(lanes);
  if (lanes_log2 < 0 || lanes > 32 || (dim / vec) % lanes != 0) return cudaErrorInvalidValue;
  if (warps < 1 || warps * 32 > kMaxPoolThreads || 1LL * grid * warps < batch ||
      1LL * (grid - 1) * warps >= batch || smem != warps * smem_per_warp || smem > 48 * 1024) {
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

// the forward at the fewest softmax positions a lane that cover L
template <typename T, int VEC>
void launch_fwd(const float* lg, const uint8_t* mk, const T* h, T* o, float* w, int batch, int L, int dim,
                int lanes_log2, int grid, int threads, cudaStream_t st) {
  if (L <= 32 * 2) {
    attention_pool_fwd_kernel<T, VEC, 2><<<grid, threads, 0, st>>>(lg, mk, h, o, w, batch, L, dim, lanes_log2);
  } else if (L <= 32 * kMidPerLane) {
    attention_pool_fwd_kernel<T, VEC, kMidPerLane><<<grid, threads, 0, st>>>(lg, mk, h, o, w, batch, L, dim,
                                                                              lanes_log2);
  } else {
    attention_pool_fwd_kernel<T, VEC, kMaxPerLane><<<grid, threads, 0, st>>>(lg, mk, h, o, w, batch, L, dim,
                                                                              lanes_log2);
  }
}

// the backward likewise; shared memory (smem bytes) only above kMidPerLane
template <typename T, int VEC>
void launch_bwd(const T* di, const uint8_t* mk, const T* h, const float* w, T* dh, float* dl, int batch, int L,
                int dim, int lanes_log2, int grid, int threads, int smem, cudaStream_t st) {
  if (L <= 32 * 2) {
    attention_pool_bwd_kernel<T, VEC, 2><<<grid, threads, 0, st>>>(di, mk, h, w, dh, dl, batch, L, dim, lanes_log2);
  } else if (L <= 32 * kMidPerLane) {
    attention_pool_bwd_kernel<T, VEC, kMidPerLane><<<grid, threads, 0, st>>>(di, mk, h, w, dh, dl, batch, L, dim,
                                                                              lanes_log2);
  } else {
    attention_pool_bwd_kernel<T, VEC, kMaxPerLane><<<grid, threads, smem, st>>>(di, mk, h, w, dh, dl, batch, L,
                                                                                 dim, lanes_log2);
  }
}

}  // namespace

// Forward: logits (B, L) f32, mask (B, L) bytes 0/1, hist (B, L, dim) T,
// out (B, dim) T, weights (B, L) f32, L <= 32 * kMaxPerLane. vec = 8 (bf16)
// or 4 (f32) for 16-byte loads (dim a multiple of vec, hist and out 16-byte
// aligned), else 1; lanes (a power of 2 dividing dim / vec) a position's
// lane group. grid blocks of warps warps, no shared memory. Returns a CUDA
// error code.
extern "C" int persia_attention_pool_fwd(const void* logits, const void* mask, const void* hist, void* out,
                                         void* weights, int dtype, int batch, int L, int dim, int vec,
                                         int lanes, int warps, int grid, void* stream) {
  int rc = check_launch(dtype, batch, L, dim, vec, lanes, warps, grid, 0, 0, hist, out);
  if (rc != cudaSuccess) return rc;
  if (logits == nullptr || mask == nullptr || weights == nullptr) {
    return cudaErrorInvalidValue;
  }
  const int lanes_log2 = log2_exact(lanes);
  const float* lg = static_cast<const float*>(logits);
  const uint8_t* mk = static_cast<const uint8_t*>(mask);
  float* w = static_cast<float*>(weights);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = warps * 32;
  if (dtype == persia::kFloat32) {
    const float* h = static_cast<const float*>(hist);
    float* o = static_cast<float*>(out);
    if (vec == 4) {
      launch_fwd<float, 4>(lg, mk, h, o, w, batch, L, dim, lanes_log2, grid, threads, st);
    } else {
      launch_fwd<float, 1>(lg, mk, h, o, w, batch, L, dim, lanes_log2, grid, threads, st);
    }
  } else {
    const __nv_bfloat16* h = static_cast<const __nv_bfloat16*>(hist);
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
    if (vec == 8) {
      launch_fwd<__nv_bfloat16, 8>(lg, mk, h, o, w, batch, L, dim, lanes_log2, grid, threads, st);
    } else {
      launch_fwd<__nv_bfloat16, 1>(lg, mk, h, o, w, batch, L, dim, lanes_log2, grid, threads, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// Backward: d_out (B, dim) T, mask, hist and the forward's weights as
// above; d_hist (B, L, dim) T, d_logits (B, L) f32. The same geometry;
// smem = warps * L * 4 bytes where L > 32 * kMidPerLane, else 0. Returns a
// CUDA error code.
extern "C" int persia_attention_pool_bwd(const void* d_out, const void* mask, const void* hist,
                                         const void* weights, void* d_hist, void* d_logits, int dtype, int batch,
                                         int L, int dim, int vec, int lanes, int warps, int grid, int smem,
                                         void* stream) {
  const int smem_per_warp = L > 32 * kMidPerLane ? L * 4 : 0;
  int rc = check_launch(dtype, batch, L, dim, vec, lanes, warps, grid, smem, smem_per_warp, hist, d_hist);
  if (rc != cudaSuccess) return rc;
  if (d_out == nullptr || mask == nullptr || weights == nullptr || d_logits == nullptr ||
      (vec > 1 && !aligned16(d_out))) {
    return cudaErrorInvalidValue;
  }
  const int lanes_log2 = log2_exact(lanes);
  const uint8_t* mk = static_cast<const uint8_t*>(mask);
  const float* w = static_cast<const float*>(weights);
  float* dl = static_cast<float*>(d_logits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = warps * 32;
  if (dtype == persia::kFloat32) {
    const float* di = static_cast<const float*>(d_out);
    const float* h = static_cast<const float*>(hist);
    float* dh = static_cast<float*>(d_hist);
    if (vec == 4) {
      launch_bwd<float, 4>(di, mk, h, w, dh, dl, batch, L, dim, lanes_log2, grid, threads, smem, st);
    } else {
      launch_bwd<float, 1>(di, mk, h, w, dh, dl, batch, L, dim, lanes_log2, grid, threads, smem, st);
    }
  } else {
    const __nv_bfloat16* di = static_cast<const __nv_bfloat16*>(d_out);
    const __nv_bfloat16* h = static_cast<const __nv_bfloat16*>(hist);
    __nv_bfloat16* dh = static_cast<__nv_bfloat16*>(d_hist);
    if (vec == 8) {
      launch_bwd<__nv_bfloat16, 8>(di, mk, h, w, dh, dl, batch, L, dim, lanes_log2, grid, threads, smem, st);
    } else {
      launch_bwd<__nv_bfloat16, 1>(di, mk, h, w, dh, dl, batch, L, dim, lanes_log2, grid, threads, smem, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
