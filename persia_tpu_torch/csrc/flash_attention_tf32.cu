// Flash attention forward, f32, for Hopper: both products on the tensor
// cores in split TF32 (3xTF32), fed by TMA. q, k, v, out [B, L, H, D] f32,
// D in {16, 32, 64, 128}.
//
// Replaces: persia_tpu/ops/flash_attention.py:33-82 `_fa_kernel`, launched
// by `_fa_forward` (pallas_call at :107), for f32 inputs (bf16 inputs take
// flash_attention_hopper.cu). Same function: scores q.k*scale summed in
// f32, keys at or past L masked (and keys after the query under `causal`),
// online max / sum / accumulator in f32, masked probabilities zero, output
// acc / max(l, 1e-30) in f32.
//
// Numerics: why three TF32 passes and not one. A TF32 product reads 10 of
// an f32's 23 mantissa bits. Each operand is written x = hi + lo, hi =
// tf32(x), lo = tf32(x - hi), and a.b is taken as hi.hi + hi.lo + lo.hi in
// the tensor cores with f32 sums; the dropped lo.lo is ~2^-22 relative.
// Emulated in torch on a CPU at (B=2, L=1024, H=4, D=64), randn inputs,
// against an f64 reference: one pass has a max abs error of 3.0e-4, 2.4x
// the route's tolerance (atol 1e-4 + rtol 1e-4 |ref|) non-causal and 7.7x
// causal; three passes 3.0e-7, 0.002x and 0.003x. The softmax (f32,
// ex2.approx.ftz ~2^-22 relative) is as in the bf16 kernel.
//
// Bound on the H100: operations. At (4, 1024, 8, 64) the function does
// 4*B*H*L*L*D = 8.6 GFLOP over 33.6 MB; three TF32 passes are 25.8 GFLOP
// at 494.7 TFLOP/s: 0.052 ms (bytes: 0.010 ms; the same work on the f32
// FMA pipes at 67 TFLOP/s: 0.128 ms).
//
// Two kernels (geometry from persia_tpu_torch/ops/plans.py::tf32_plan,
// checked by the C entry points):
//
// 1. tf32_split_kernel, the pre-pass (memory bound): reads q, k, v once and
//    writes the planes the main kernel's TMA loads, rows padded to L_pad
//    (a multiple of 64) with zeros:
//    - qk [4, B*H, L_pad, D]: q_hi, q_lo, k_hi, k_lo, D contiguous: the
//      K-major operands of S = Q K^T;
//    - vt [2, B*H, D, L_pad]: v_hi, v_lo transposed, keys contiguous: TF32
//      wgmma takes K-major operands only (no transpose flag for 32-bit
//      types), so the B operand of O += P V must have keys innermost. Each
//      group of 8 keys is stored in the order 0,2,4,6,1,3,5,7: the S
//      accumulator gives a thread keys 2t and 2t+1 of a group (t = lane % 4)
//      and the TF32 A fragment wants columns t and t+4, so with this order
//      P goes from the accumulator into the A registers without a shuffle.
//      P.V sums over keys, so their order is free.
// 2. fa_fwd_tf32x3_kernel, the main kernel, shaped like the bf16 one:
//    - one block = one warpgroup (128 threads, 64 query rows of one
//      (b, h)); q tiles longest-first; thread 0 loads the Q planes and the
//      first `stages` key tiles, and refills a stage as soon as all four
//      warps have released it (full and empty mbarriers per stage);
//    - key tiles of 32: a stage (k_hi, k_lo, v_hi, v_lo) is 512*D bytes,
//      the Q planes 512*D, so two stages fit two blocks per SM up to D=64
//      (one at D=128), and a thread holds S (16 floats), P_hi and P_lo (32
//      registers) and O (D/2) in well under 128 registers;
//    - S = Q K^T: per k8 slice three wgmma m64n32k8 (q_lo.k_hi, q_hi.k_lo,
//      q_hi.k_hi) into one f32 accumulator, operands K-major in shared
//      memory, 128-byte swizzle (64-byte at D=16) as TMA wrote them;
//    - softmax in registers as in the bf16 kernel (row max of unscaled
//      scores: scale > 0, the wrapper makes it so);
//    - O += P V: P split in registers into P_hi and P_lo (the A operand),
//      per k8 slice three wgmma m64nDk8 (p_lo.v_hi, p_hi.v_lo, p_hi.v_hi)
//      with V^T from shared memory;
//    - S of tile i+1 is issued beside P V of tile i, the last tile peeled;
//    - output: normalised f32 written into the Q planes' shared memory in
//      the TMA swizzle and stored by TMA over [B, L, H, D], rows >= L
//      clipped.

#include <initializer_list>

#include "hopper.cuh"

namespace {

using namespace persia::sm90;

constexpr int kBlockQ = 64;
constexpr int kBlockK = 32;
constexpr int kThreads = 128;  // one warpgroup; its thread 0 also issues the copies
constexpr int kSplitThreads = 256;
constexpr int kSeqAlign = 64;  // planes hold whole q tiles
constexpr int kSmemAlign = 1024;
constexpr float kNegBig = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// position p of a V^T row holds key vt_key(p): 0,2,4,6,1,3,5,7 in each group of 8
__host__ __device__ constexpr int vt_key(int p) {
  return (p & ~7) | ((p & 3) << 1) | ((p >> 2) & 1);
}

template <int D>
__global__ void __launch_bounds__(kSplitThreads)
tf32_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ qk, float* __restrict__ vt,
                  int seq_len, int seq_pad, int heads) {
  constexpr int kVec = D / 4;  // float4s in a row
  __shared__ float vs[kBlockK][D + 1];  // odd stride: the transposed reads hit 32 banks
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int l0 = blockIdx.x * kBlockK;
  const size_t plane = static_cast<size_t>(gridDim.y) * seq_pad * D;
  auto split4 = [](float4 x, float4& hi, float4& lo) {
    uint32_t h4[4], l4[4];
    tf32_split(x.x, h4[0], l4[0]);
    tf32_split(x.y, h4[1], l4[1]);
    tf32_split(x.z, h4[2], l4[2]);
    tf32_split(x.w, h4[3], l4[3]);
    hi = make_float4(__uint_as_float(h4[0]), __uint_as_float(h4[1]), __uint_as_float(h4[2]),
                     __uint_as_float(h4[3]));
    lo = make_float4(__uint_as_float(l4[0]), __uint_as_float(l4[1]), __uint_as_float(l4[2]),
                     __uint_as_float(l4[3]));
  };
  for (int i = threadIdx.x; i < kBlockK * kVec; i += kSplitThreads) {
    const int r = i / kVec;
    const int c = (i % kVec) * 4;
    const int l = l0 + r;
    float4 xq = make_float4(0.f, 0.f, 0.f, 0.f), xk = xq, xv = xq;
    if (l < seq_len) {
      const size_t src = (static_cast<size_t>(b) * seq_len + l) * heads * D +
                         static_cast<size_t>(h) * D + c;
      xq = *reinterpret_cast<const float4*>(q + src);
      xk = *reinterpret_cast<const float4*>(k + src);
      xv = *reinterpret_cast<const float4*>(v + src);
    }
    const size_t dst = (static_cast<size_t>(bh) * seq_pad + l) * D + c;
    float4 hi, lo;
    split4(xq, hi, lo);
    *reinterpret_cast<float4*>(qk + dst) = hi;
    *reinterpret_cast<float4*>(qk + plane + dst) = lo;
    split4(xk, hi, lo);
    *reinterpret_cast<float4*>(qk + 2 * plane + dst) = hi;
    *reinterpret_cast<float4*>(qk + 3 * plane + dst) = lo;
    vs[r][c] = xv.x;
    vs[r][c + 1] = xv.y;
    vs[r][c + 2] = xv.z;
    vs[r][c + 3] = xv.w;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < D * kBlockK; i += kSplitThreads) {
    const int d = i / kBlockK;
    const int p = i % kBlockK;
    uint32_t hi, lo;
    tf32_split(vs[vt_key(p)][d], hi, lo);
    const size_t dst = (static_cast<size_t>(bh) * D + d) * seq_pad + l0 + p;
    vt[dst] = __uint_as_float(hi);
    vt[plane + dst] = __uint_as_float(lo);
  }
}

template <int D>
struct Geometry {
  static constexpr int kBoxCols = D < 32 ? D : 32;  // floats in one swizzle row
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kRowBytes = kBoxCols * 4;  // the swizzle width: 64 at D=16, else 128
  static constexpr uint32_t kSwizzleMask = kRowBytes / 16 - 1;
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;
  static constexpr int kQBox = kBlockQ * kRowBytes;
  static constexpr int kKBox = kBlockK * kRowBytes;
  static constexpr int kQTile = kBoxes * kQBox;  // one Q plane: 64 x D
  static constexpr int kKTile = kBoxes * kKBox;  // one K plane: 32 x D
  static constexpr int kVTile = D * kBlockK * 4;  // one V^T plane: D rows of 32 keys (128 B)
  static constexpr int kStage = 2 * kKTile + 2 * kVTile;
};

// K-major plane tile of kRows rows (Q: 64, K: 32), the k8 slice kk of its D
// columns: rows of kRowBytes, 8-row groups 8 * kRowBytes apart; a slice
// inside a swizzle row starts 32 bytes further
template <int D, int kRows>
__device__ __forceinline__ uint64_t plane_desc(uint32_t tile, int kk) {
  using G = Geometry<D>;
  const int col = kk * 8;
  const uint32_t addr =
      tile + (col / G::kBoxCols) * (kRows * G::kRowBytes) + (col % G::kBoxCols) * 4;
  return wgmma_desc(addr, 16, 8 * G::kRowBytes, G::kLayout);
}

// V^T tile (D rows of 32 keys, 128-byte swizzle), the k8 slice kk of its keys
__device__ __forceinline__ uint64_t vt_desc(uint32_t tile, int kk) {
  return wgmma_desc(tile + kk * 32, 16, 8 * 128, 1);
}

// blocks that share an SM: two up to D=64, one at D=128 (shared memory)
constexpr int min_blocks_for(int dim) { return dim == 128 ? 1 : 2; }
template <int D>
__global__ void __launch_bounds__(kThreads, min_blocks_for(D))
fa_fwd_tf32x3_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap vt_map,
                     const __grid_constant__ CUtensorMap o_map, int seq_len, int heads,
                     int bh_count, int q_tiles, int stages, float scale_log2, int causal) {
  using G = Geometry<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + kSmemAlign - 1) & ~uint32_t(kSmemAlign - 1);
  const uint32_t q_hi = base;  // later the output tile
  const uint32_t q_lo = q_hi + G::kQTile;
  const uint32_t ring = q_lo + G::kQTile;  // per stage: k_hi, k_lo, v_hi, v_lo
  const uint32_t bars = ring + stages * G::kStage;
  const uint32_t q_full = bars;
  auto stage_at = [&](int it) { return ring + (it % stages) * G::kStage; };
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + stages + s); };

  const int q_tile = q_tiles - 1 - static_cast<int>(blockIdx.x) / bh_count;
  const int bh = static_cast<int>(blockIdx.x) % bh_count;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = q_tile * kBlockQ;
  const int k_end = causal ? min(seq_len, q0 + kBlockQ) : seq_len;
  const int n_kt = (k_end + kBlockK - 1) / kBlockK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kThreads / 32);  // one arrival per warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  // plane coordinates: qk {col, row, bh, 0..3 = q_hi, q_lo, k_hi, k_lo},
  // vt {key, dim, bh, 0..1 = v_hi, v_lo}
  auto load_kv = [&](int it) {
    const int s = it % stages;
    const uint32_t st = stage_at(it);
    mbar_expect_tx(full(s), G::kStage);
    for (int plane = 0; plane < 2; ++plane) {
      for (int bi = 0; bi < G::kBoxes; ++bi) {
        tma_load_4d(st + plane * G::kKTile + bi * G::kKBox, &k_map, full(s), bi * G::kBoxCols,
                    it * kBlockK, bh, 2 + plane);
      }
      tma_load_4d(st + 2 * G::kKTile + plane * G::kVTile, &vt_map, full(s), it * kBlockK, 0, bh,
                  plane);
    }
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(q_full, 2 * G::kQTile);
    for (int plane = 0; plane < 2; ++plane) {
      for (int bi = 0; bi < G::kBoxes; ++bi) {
        tma_load_4d(q_hi + plane * G::kQTile + bi * G::kQBox, &q_map, q_full, bi * G::kBoxCols,
                    q0, bh, plane);
      }
    }
    for (int it = 0; it < min(stages, n_kt); ++it) load_kv(it);
  }

  // Accumulator fragment of m64nN: register 4j+e of thread (warp w, lane
  // l) is row 16w + l/4 + 8*(e/2), column 8j + 2*(l%4) + e%2.
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r_lo = warp * 16 + lane / 4;
  const int c_lane = 2 * (lane % 4);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_run[2] = {kNegBig, kNegBig};
  float l_run[2] = {0.f, 0.f};  // this thread's share of its rows' sums
  float sc[16];  // the first k slice of every S overwrites it (scale_d 0)
#pragma unroll
  for (int i = 0; i < 16; ++i) sc[i] = 0.f;

  auto issue_scores = [&](int it) {  // S_it = Q K_it^T into sc
    const uint32_t k_hi = stage_at(it);
    const uint32_t k_lo = k_hi + G::kKTile;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const uint64_t qh = plane_desc<D, kBlockQ>(q_hi, kk);
      const uint64_t kh = plane_desc<D, kBlockK>(k_hi, kk);
      wgmma_tf32_ss(sc, plane_desc<D, kBlockQ>(q_lo, kk), kh, kk > 0);
      wgmma_tf32_ss(sc, qh, plane_desc<D, kBlockK>(k_lo, kk), 1);
      wgmma_tf32_ss(sc, qh, kh, 1);
    }
    wgmma_commit();
  };
  float corr[2];
  auto softmax = [&](int it) {  // S_it in sc -> P_it (f32) in sc
    const int k0 = it * kBlockK;
    const bool edge = k0 + kBlockK > seq_len || (causal && k0 + kBlockK - 1 > q0);
    float mx[2] = {kNegBig, kNegBig};
#pragma unroll
    for (int i = 0; i < 16; ++i) {  // raw scores; masked ones -inf
      if (edge) {
        const int key = k0 + 8 * (i / 4) + c_lane + (i & 1);
        const int query = q0 + r_lo + 8 * ((i >> 1) & 1);
        if (key >= seq_len || (causal && key > query)) sc[i] = -INFINITY;
      }
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // scale > 0, so the max commutes with it
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r] * scale_log2);  // >= -1e30: never -inf
      corr[r] = exp2_ftz(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float p = exp2_ftz(fmaf(sc[i], scale_log2, -m_run[(i >> 1) & 1]));  // exp2(-inf) = 0
      sc[i] = p;
      l_run[(i >> 1) & 1] += p;
    }
  };
  // A fragment of the k8 slice j: (row, column t), (row + 8, t), (row, t + 4),
  // (row + 8, t + 4); with V^T's key order these are the accumulator's
  // keys 2t and 2t+1 of the slice: registers 4j, 4j+2, 4j+1, 4j+3
  uint32_t p_hi[4][4], p_lo[4][4];
  auto split_p = [&]() {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      tf32_split(sc[4 * j + 0], p_hi[j][0], p_lo[j][0]);
      tf32_split(sc[4 * j + 2], p_hi[j][1], p_lo[j][1]);
      tf32_split(sc[4 * j + 1], p_hi[j][2], p_lo[j][2]);
      tf32_split(sc[4 * j + 3], p_hi[j][3], p_lo[j][3]);
      fence_regs(p_hi[j]);
      fence_regs(p_lo[j]);
    }
  };
  auto issue_pv = [&](int it) {  // O += P_it V_it
    const uint32_t v_hi = stage_at(it) + 2 * G::kKTile;
    const uint32_t v_lo = v_hi + G::kVTile;
#pragma unroll
    for (int kk = 0; kk < kBlockK / 8; ++kk) {
      wgmma_tf32_rs(o, p_lo[kk], vt_desc(v_hi, kk), 1);
      wgmma_tf32_rs(o, p_hi[kk], vt_desc(v_lo, kk), 1);
      wgmma_tf32_rs(o, p_hi[kk], vt_desc(v_hi, kk), 1);
    }
    wgmma_commit();
  };
  // stage it % stages is read: every warp says so, then thread 0 refills it
  auto release = [&](int it) {
    const int s = it % stages;
    if (lane == 0) mbar_arrive(empty(s));
    if (threadIdx.x == 0 && it + stages < n_kt) {
      mbar_wait(empty(s), (it / stages) & 1);
      load_kv(it + stages);
    }
    __syncwarp();  // warp 0 whole again before the next .aligned instruction
  };

  mbar_wait(q_full, 0);
  mbar_wait(full(0), 0);
  fence_regs(sc);
  wgmma_fence();
  issue_scores(0);
  wgmma_wait<0>();
  fence_regs(sc);
  softmax(0);  // o is still 0: nothing to rescale
  for (int it = 0; it + 1 < n_kt; ++it) {
    split_p();
    fence_regs(sc);
    fence_regs(o);
    mbar_wait(full((it + 1) % stages), ((it + 1) / stages) & 1);
    wgmma_fence();
    issue_scores(it + 1);
    issue_pv(it);
    wgmma_wait<1>();  // S_it+1 is done; P_it V_it may still run
    fence_regs(sc);
    softmax(it + 1);
    wgmma_wait<0>();
    fence_regs(o);
    release(it);
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {  // a row max moved
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
    }
  }
  split_p();
  fence_regs(o);
  wgmma_fence();
  issue_pv(n_kt - 1);
  wgmma_wait<0>();
  fence_regs(o);

  float denom[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    denom[r] = fmaxf(l_run[r], 1e-30f);
  }
  __syncthreads();  // no wgmma reads the Q planes any more
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r_lo + 8 * half;
      const int col = 8 * j + c_lane;
      uint32_t off = row * G::kRowBytes + (col % G::kBoxCols) * 4;
      off ^= ((off >> 7) & G::kSwizzleMask) << 4;  // the TMA swizzle
      st_shared_f32x2(q_hi + (col / G::kBoxCols) * G::kQBox + off,
                      o[4 * j + 2 * half] / denom[half], o[4 * j + 2 * half + 1] / denom[half]);
    }
  }
  fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int bi = 0; bi < G::kBoxes; ++bi) {
      tma_store_4d(&o_map, q_hi + bi * G::kQBox, bi * G::kBoxCols, h, q0, b);
    }
    tma_store_commit_and_wait();
  }
}

template <int D>
int launch_split(const float* q, const float* k, const float* v, float* qk, float* vt,
                 int seq_len, int seq_pad, int heads, int bh_count, cudaStream_t stream) {
  const dim3 grid(seq_pad / kBlockK, bh_count);
  tf32_split_kernel<D><<<grid, kSplitThreads, 0, stream>>>(q, k, v, qk, vt, seq_len, seq_pad,
                                                           heads);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const CUtensorMap (&maps)[4], int grid, int smem_bytes, int seq_len, int heads,
           int bh_count, int q_tiles, int stages, float scale_log2, int causal,
           cudaStream_t stream) {
  static int smem_configured = 0;  // above 48 KB a kernel must opt in, once
  if (smem_bytes > smem_configured) {
    const cudaError_t rc = cudaFuncSetAttribute(
        fa_fwd_tf32x3_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    smem_configured = smem_bytes;
  }
  fa_fwd_tf32x3_kernel<D><<<grid, kThreads, smem_bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], seq_len, heads, bh_count, q_tiles, stages, scale_log2,
      causal);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  }
  return true;
}

}  // namespace

// The pre-pass: q, k, v [B, L, H, D] f32 -> the qk and vt planes (layouts
// above); seq_pad from ops/plans.py::tf32_plan. Returns a CUDA error code.
extern "C" int persia_tf32_split(const void* q, const void* k, const void* v, void* qk, void* vt,
                                 int batch, int seq_len, int heads, int dim, int seq_pad,
                                 void* stream) {
  const int bh = batch * heads;
  if (batch <= 0 || seq_len <= 0 || heads <= 0 || bh > 65535) return cudaErrorInvalidValue;
  if (seq_pad % kSeqAlign != 0 || seq_pad < seq_len || seq_pad - seq_len >= kSeqAlign) {
    return cudaErrorInvalidValue;
  }
  if (!aligned16({q, k, v, qk, vt})) return cudaErrorMisalignedAddress;
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* qkf = static_cast<float*>(qk);
  auto* vtf = static_cast<float*>(vt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dim) {
    case 16: return launch_split<16>(qf, kf, vf, qkf, vtf, seq_len, seq_pad, heads, bh, s);
    case 32: return launch_split<32>(qf, kf, vf, qkf, vtf, seq_len, seq_pad, heads, bh, s);
    case 64: return launch_split<64>(qf, kf, vf, qkf, vtf, seq_len, seq_pad, heads, bh, s);
    case 128: return launch_split<128>(qf, kf, vf, qkf, vtf, seq_len, seq_pad, heads, bh, s);
    default: return cudaErrorInvalidValue;
  }
}

// The main kernel over the planes of persia_tf32_split, out [B, L, H, D]
// f32. Geometry from ops/plans.py::tf32_plan; returns a CUDA error code.
extern "C" int persia_flash_attention_fwd_tf32x3(const void* qk, const void* vt, void* out,
                                                 int batch, int seq_len, int heads, int dim,
                                                 float scale, int causal, int grid, int q_tiles,
                                                 int block_q, int block_k, int stages,
                                                 int seq_pad, int box_cols, int swizzle_bytes,
                                                 int smem_bytes, void* stream) {
  if (batch <= 0 || seq_len <= 0 || heads <= 0 || !(scale > 0.f)) return cudaErrorInvalidValue;
  if (dim != 16 && dim != 32 && dim != 64 && dim != 128) return cudaErrorInvalidValue;
  if (block_q != kBlockQ || block_k != kBlockK || stages < 2) return cudaErrorInvalidValue;
  if (seq_pad % kSeqAlign != 0 || seq_pad < seq_len || seq_pad - seq_len >= kSeqAlign) {
    return cudaErrorInvalidValue;
  }
  if (box_cols != (dim < 32 ? dim : 32) || swizzle_bytes != 4 * box_cols) {
    return cudaErrorInvalidValue;
  }
  if (q_tiles != (seq_len + kBlockQ - 1) / kBlockQ ||
      static_cast<long long>(grid) != static_cast<long long>(q_tiles) * batch * heads) {
    return cudaErrorInvalidValue;
  }
  const long long q_planes = 2LL * kBlockQ * dim * 4;
  const long long stage = 4LL * kBlockK * dim * 4;
  if (smem_bytes < kSmemAlign + q_planes + stages * stage + 8 * (1 + 2 * stages)) {
    return cudaErrorInvalidValue;
  }
  if (!aligned16({qk, vt, out})) return cudaErrorMisalignedAddress;
  const int bh = batch * heads;
  const cuuint64_t d = dim, pad = seq_pad, row = 4 * d;
  CUtensorMap maps[4];
  const bool ok =
      encode_map_4d(&maps[0], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, qk, {d, pad, cuuint64_t(bh), 4},
                    {row, row * pad, row * pad * bh}, {cuuint32_t(box_cols), kBlockQ, 1, 1},
                    swizzle_bytes) &&
      encode_map_4d(&maps[1], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, qk, {d, pad, cuuint64_t(bh), 4},
                    {row, row * pad, row * pad * bh}, {cuuint32_t(box_cols), kBlockK, 1, 1},
                    swizzle_bytes) &&
      encode_map_4d(&maps[2], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, vt, {pad, d, cuuint64_t(bh), 2},
                    {4 * pad, 4 * pad * d, 4 * pad * d * bh}, {kBlockK, cuuint32_t(dim), 1, 1},
                    128) &&
      encode_map_4d(&maps[3], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, out,
                    {d, cuuint64_t(heads), cuuint64_t(seq_len), cuuint64_t(batch)},
                    {row, row * heads, row * heads * seq_len},
                    {cuuint32_t(box_cols), 1, kBlockQ, 1}, swizzle_bytes);
  if (!ok) return encode_tiled() == nullptr ? cudaErrorNotSupported : cudaErrorInvalidValue;
  const float scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dim) {
    case 16: return launch<16>(maps, grid, smem_bytes, seq_len, heads, bh, q_tiles, stages, scale_log2, causal, s);
    case 32: return launch<32>(maps, grid, smem_bytes, seq_len, heads, bh, q_tiles, stages, scale_log2, causal, s);
    case 64: return launch<64>(maps, grid, smem_bytes, seq_len, heads, bh, q_tiles, stages, scale_log2, causal, s);
    case 128: return launch<128>(maps, grid, smem_bytes, seq_len, heads, bh, q_tiles, stages, scale_log2, causal, s);
    default: return cudaErrorInvalidValue;
  }
}
