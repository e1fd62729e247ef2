// Flash attention forward, bf16, for Hopper: TMA-fed tiles and both
// products on the tensor cores (wgmma). q, k, v, out [B, L, H, D], D in
// {16, 32, 64, 128}.
//
// Replaces: persia_tpu/ops/flash_attention.py:33-82 `_fa_kernel`, launched
// by `_fa_forward` (pallas_call at :107), for bf16 inputs (f32 inputs take
// the split-TF32 kernel of flash_attention_tf32.cu). Same function: scores
// q.k*scale accumulated in f32, keys at or past L masked (and keys after
// the query under `causal`), online max / sum / accumulator in f32, masked
// probabilities zero, output acc / max(l, 1e-30) rounded once to bf16.
//
// Numerics, the one departure from the TPU kernel: P.V multiplies P rounded
// to bf16 (the wgmma A operand), where the TPU kernel keeps P in f32, as
// FlashAttention-2/3 do. Q.K^T is unchanged: a product of two bf16 values is
// exact in f32, only the order of summation differs. The row sum l adds the
// unrounded f32 probabilities.
//
// Bound on the H100: operations. At (B=4, L=1024, H=8, D=64) the function
// does 4*B*H*L*L*D = 8.6 GFLOP over 16.8 MB, ~510 FLOP/byte, above the
// ~295 FLOP/byte balance point, so only the tensor cores can approach it.
//
// Design (geometry from persia_tpu_torch/ops/plans.py, checked here):
// - one block = one warpgroup (128 threads, 64 query rows of one (b, h));
//   grid = q tiles * B * H, q tiles longest-first so the heavy causal tiles
//   do not form the tail;
// - TMA straight over the [B, L, H, D] tensors: 4-D tensor maps with dims
//   {D, H, L, B} and box {min(D, 64), 1, 64, 1}, passed by value as
//   __grid_constant__; rows past L arrive as zeros and are masked, so
//   nothing is padded or transposed. The box row is the swizzle width (128
//   bytes at D=64 and 128, 64 at D=32, 32 at D=16), so TMA writes exactly
//   the swizzled layout the wgmma descriptors name; D=128 is two boxes;
// - thread 0 loads Q and the first `stages` K/V tiles, then refills each
//   stage of the ring as soon as all four warps have released it: a full
//   (TMA bytes) and an empty (one arrival per warp) mbarrier per stage. A
//   separate producer warp would hold a fifth warp's registers on every
//   SM sub-partition; without it four blocks fit an SM at up to 128
//   registers a thread, which the pipeline below needs;
// - S = Q K^T: wgmma m64n64k16, both operands K-major in shared memory;
// - softmax in registers: each accumulator row lives in a quad of threads
//   (quad shuffles for the max; the sum is reduced once at the end),
//   the row max taken over raw scores (scale > 0: the wrapper makes it so),
//   exp2 (ex2.approx.ftz) of one FMA with scale*log2(e) folded in, the
//   accumulator rescaled only when a row max of the warp moved, the mask
//   only on the ragged last tile and the causal diagonal tile;
// - O += P V: wgmma m64nDk16 with P as bf16 registers (the accumulator's
//   fragment layout is the A operand's) and V from shared memory with the
//   transpose flag (V is keys x D, D contiguous);
// - the two products are pipelined in the warpgroup: S for tile i+1 is
//   issued with P V of tile i, and the softmax of tile i+1 runs while the
//   tensor cores finish P V (the accumulator is rescaled after it); the
//   last tile is peeled off, so no branch surrounds a wgmma;
// - output: normalised, rounded to bf16, written into the Q tile's shared
//   memory in the same swizzled layout and stored by TMA, which clips rows
//   >= L.

#include <initializer_list>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace persia::sm90;

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;  // one warpgroup; its thread 0 also issues the copies
constexpr int kSmemAlign = 1024;
constexpr float kNegBig = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Geometry {
  static constexpr int kBoxCols = D < 64 ? D : 64;
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kRowBytes = kBoxCols * 2;  // == the swizzle width
  static constexpr uint32_t kSwizzleMask = kRowBytes / 16 - 1;
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : (kRowBytes == 64 ? 2 : 3);
  static constexpr int kBoxBytes = 64 * kRowBytes;  // 64 rows of one box
  static constexpr int kTileBytes = kBoxes * kBoxBytes;  // a Q, K or V tile
};

// K-major operand (a Q or K tile), the k16 slice kk of its D columns: rows
// of kRowBytes, 8-row groups 8 * kRowBytes apart; a slice inside a swizzle
// row starts 32 bytes further
template <int D>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kk) {
  using G = Geometry<D>;
  const int col = kk * 16;
  const uint32_t addr = tile + (col / G::kBoxCols) * G::kBoxBytes + (col % G::kBoxCols) * 2;
  return wgmma_desc(addr, 16, 8 * G::kRowBytes, G::kLayout);
}

// MN-major operand (the V tile, keys x D), the k16 slice kk of its keys:
// D runs along a swizzle row, the next 64 columns one box further (LBO),
// 8-key groups 8 * kRowBytes apart (SBO)
template <int D>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int kk) {
  using G = Geometry<D>;
  return wgmma_desc(tile + kk * 16 * G::kRowBytes, G::kBoxBytes, 8 * G::kRowBytes, G::kLayout);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// blocks that share an SM: four up to D=64 (shared memory for two at D=128)
constexpr int min_blocks_for(int dim) { return dim == 128 ? 2 : 4; }
template <int D>
__global__ void __launch_bounds__(kThreads, min_blocks_for(D))
fa_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap o_map, int seq_len, int heads,
                    int bh_count, int q_tiles, int stages, float scale_log2, int causal) {
  using G = Geometry<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + kSmemAlign - 1) & ~uint32_t(kSmemAlign - 1);
  const uint32_t q_s = base;  // Q, later the output tile
  const uint32_t k_s = q_s + G::kTileBytes;
  const uint32_t v_s = k_s + stages * G::kTileBytes;
  const uint32_t bars = v_s + stages * G::kTileBytes;
  const uint32_t q_full = bars;
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

  // thread 0 issues Q and the first `stages` K/V tiles; later tiles go out
  // as their stage is released (below)
  auto load_kv = [&](int it) {
    const int s = it % stages;
    mbar_expect_tx(full(s), 2 * G::kTileBytes);
    for (int bi = 0; bi < G::kBoxes; ++bi) {
      const uint32_t off = s * G::kTileBytes + bi * G::kBoxBytes;
      tma_load_4d(k_s + off, &k_map, full(s), bi * G::kBoxCols, h, it * kBlockK, b);
      tma_load_4d(v_s + off, &v_map, full(s), bi * G::kBoxCols, h, it * kBlockK, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(q_full, G::kTileBytes);
    for (int bi = 0; bi < G::kBoxes; ++bi) {
      tma_load_4d(q_s + bi * G::kBoxBytes, &q_map, q_full, bi * G::kBoxCols, h, q0, b);
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
  float sc[32];  // the first k slice of every S overwrites it (scale_d 0)
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;

  auto issue_scores = [&](int it) {  // S_it = Q K_it^T into sc
    const uint32_t kt = k_s + (it % stages) * G::kTileBytes;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss_n64(sc, kmajor_desc<D>(q_s, kk), kmajor_desc<D>(kt, kk), kk > 0);
    }
    wgmma_commit();
  };
  float corr[2];
  auto softmax = [&](int it) {  // S_it in sc -> P_it (f32) in sc
    const int k0 = it * kBlockK;
    const bool edge = k0 + kBlockK > seq_len || (causal && k0 + kBlockK - 1 > q0);
    float mx[2] = {kNegBig, kNegBig};
#pragma unroll
    for (int i = 0; i < 32; ++i) {  // raw scores; masked ones -inf
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
    for (int i = 0; i < 32; ++i) {
      const float p = exp2_ftz(fmaf(sc[i], scale_log2, -m_run[(i >> 1) & 1]));  // exp2(-inf) = 0
      sc[i] = p;
      l_run[(i >> 1) & 1] += p;
    }
  };
  uint32_t pa[4][4];
  auto pack_p = [&]() {  // the S fragment of keys 16kk.. is the A fragment of slice kk
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      fence_regs(pa[kk]);
    }
  };
  auto issue_pv = [&](int it) {  // O += P_it V_it
    const uint32_t vt = v_s + (it % stages) * G::kTileBytes;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(o, pa[kk], mnmajor_desc<D>(vt, kk), 1);
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
    pack_p();
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
  pack_p();
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
  __syncthreads();  // no wgmma reads the Q tile any more
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r_lo + 8 * half;
      const int col = 8 * j + c_lane;
      const uint32_t v = pack_bf16(o[4 * j + 2 * half] / denom[half],
                                   o[4 * j + 2 * half + 1] / denom[half]);
      uint32_t off = row * G::kRowBytes + (col % G::kBoxCols) * 2;
      off ^= ((off >> 7) & G::kSwizzleMask) << 4;  // the TMA swizzle
      st_shared_u32(q_s + (col / G::kBoxCols) * G::kBoxBytes + off, v);
    }
  }
  fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int bi = 0; bi < G::kBoxes; ++bi) {
      tma_store_4d(&o_map, q_s + bi * G::kBoxBytes, bi * G::kBoxCols, h, q0, b);
    }
    tma_store_commit_and_wait();
  }
}

// a map over a contiguous bf16 [B, L, H, D] tensor, box {box_cols, 1, 64, 1}
bool encode_map(CUtensorMap* map, const void* ptr, int batch, int seq_len, int heads, int dim,
                int box_cols, int swizzle_bytes) {
  const cuuint64_t row = cuuint64_t(dim) * 2;
  return encode_map_4d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr,
                       {cuuint64_t(dim), cuuint64_t(heads), cuuint64_t(seq_len), cuuint64_t(batch)},
                       {row, row * heads, row * heads * seq_len},
                       {cuuint32_t(box_cols), 1, cuuint32_t(kBlockK), 1}, swizzle_bytes);
}

template <int D>
int launch(const CUtensorMap (&maps)[4], int grid, int smem_bytes, int seq_len, int heads,
           int bh_count, int q_tiles, int stages, float scale_log2, int causal,
           cudaStream_t stream) {
  static int smem_configured = 0;  // above 48 KB a kernel must opt in, once
  if (smem_bytes > smem_configured) {
    const cudaError_t rc = cudaFuncSetAttribute(
        fa_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    smem_configured = smem_bytes;
  }
  fa_fwd_wgmma_kernel<D><<<grid, kThreads, smem_bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], seq_len, heads, bh_count, q_tiles, stages, scale_log2,
      causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Geometry from ops/plans.py::flash_plan; returns a CUDA error code.
extern "C" int persia_flash_attention_fwd_wgmma(const void* q, const void* k, const void* v,
                                                void* out, int batch, int seq_len, int heads,
                                                int dim, float scale, int causal, int grid,
                                                int q_tiles, int block_q, int block_k, int stages,
                                                int box_cols, int swizzle_bytes, int smem_bytes,
                                                void* stream) {
  if (batch <= 0 || seq_len <= 0 || heads <= 0 || !(scale > 0.f)) return cudaErrorInvalidValue;
  if (block_q != kBlockQ || block_k != kBlockK || stages < 2) return cudaErrorInvalidValue;
  if (box_cols != (dim < 64 ? dim : 64) || swizzle_bytes != 2 * box_cols) {
    return cudaErrorInvalidValue;
  }
  if (q_tiles != (seq_len + kBlockQ - 1) / kBlockQ ||
      static_cast<long long>(grid) != static_cast<long long>(q_tiles) * batch * heads) {
    return cudaErrorInvalidValue;
  }
  const long long tile = static_cast<long long>(kBlockQ) * dim * 2;
  if (smem_bytes < kSmemAlign + tile * (1 + 2 * stages) + 8 * (1 + 2 * stages)) {
    return cudaErrorInvalidValue;
  }
  for (const void* p : {q, k, v, static_cast<const void*>(out)}) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return cudaErrorMisalignedAddress;
  }
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  CUtensorMap maps[4];
  const void* ptrs[4] = {q, k, v, out};
  for (int i = 0; i < 4; ++i) {
    if (!encode_map(&maps[i], ptrs[i], batch, seq_len, heads, dim, box_cols, swizzle_bytes)) {
      return cudaErrorInvalidValue;
    }
  }
  const float scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = batch * heads;
  switch (dim) {
    case 16: return launch<16>(maps, grid, smem_bytes, seq_len, heads, bh, q_tiles, stages, scale_log2, causal, s);
    case 32: return launch<32>(maps, grid, smem_bytes, seq_len, heads, bh, q_tiles, stages, scale_log2, causal, s);
    case 64: return launch<64>(maps, grid, smem_bytes, seq_len, heads, bh, q_tiles, stages, scale_log2, causal, s);
    case 128: return launch<128>(maps, grid, smem_bytes, seq_len, heads, bh, q_tiles, stages, scale_log2, causal, s);
    default: return cudaErrorInvalidValue;
  }
}
