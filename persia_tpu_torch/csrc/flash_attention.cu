// Flash attention forward, f32: q, k, v, out [B, L, H, D], tiled online
// softmax, the [L, L] score matrix never leaves the SM. bf16 inputs take
// the tensor-core kernel of flash_attention_hopper.cu; f32 stays here, on
// the FMA pipes, because TF32 tensor cores would not keep the TPU kernel's
// f32 numerics (this kernel matches them to 1e-4).
//
// Replaces: persia_tpu/ops/flash_attention.py:33-82 `_fa_kernel`, launched
// by `_fa_forward` (pallas_call at :107), for f32. Same arithmetic: scores q.k *
// scale in f32, keys at or past L masked (and keys after the query under
// `causal`), running max m / sum l / accumulator acc in f32, output
// acc / max(l, 1e-30) in the input type.
//
// Bound on the H100: operations. At (B=4, L=1024, H=8, D=64) the function
// does 4*B*H*L*L*D = 8.6 GFLOP over 33.6 MB of f32 in and out, on the f32
// FMA pipes (67 TFLOP/s): at least 0.128 ms.
//
// Design. The TPU kernel walks a grid (B*H, q blocks, k blocks) whose last
// axis runs in order and carries m/l/acc in VMEM scratch. On Hopper blocks
// run in no order, so one block owns one (b*h, q tile) and loops over the k
// tiles itself, m/l/acc living in registers:
// - each query row belongs to TPR = D/32 threads (1 for D <= 32), each
//   holding its slice of q and acc (DPT <= 32 floats); partial dots meet
//   through warp shuffles;
// - a k tile of BK = 32 keys and its v tile are staged in shared memory as
//   f32, read by strided [B, L, H, D] addressing (no transpose copy); a
//   thread's dims are interleaved float4 chunks, so the TPR threads of a row
//   hit distinct banks while rows of a warp broadcast;
// - 128 threads per block: 128 query rows for D <= 32, 64 for D = 64, 32 for
//   D = 128 (ops/plans.py::fma_rows); k/v tiles take at most 32 KB of static
//   shared memory;
// - causal: k tiles wholly above the block's last query are never visited
//   (the TPU kernel's `block_live` skip); ragged L: keys past L are masked
//   and loaded as zeros, so L is never padded.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBlockK = 32;
constexpr float kNegBig = -1e30f;

template <int D>
struct Tile {
  static constexpr int kDimsPerThread = D < 32 ? D : 32;
  static constexpr int kThreadsPerRow = D / kDimsPerThread;
  static constexpr int kRows = kThreads / kThreadsPerRow;
  static constexpr int kChunks = kDimsPerThread / 4;  // float4 chunks per thread
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out, int seq_len,
                           int heads, float scale, int causal) {
  using Cfg = Tile<D>;
  constexpr int TPR = Cfg::kThreadsPerRow;
  constexpr int DPT = Cfg::kDimsPerThread;
  constexpr int C4 = Cfg::kChunks;
  __shared__ __align__(16) float ks[kBlockK][D];
  __shared__ __align__(16) float vs[kBlockK][D];

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = blockIdx.x * Cfg::kRows;
  const int part = threadIdx.x % TPR;
  const int qi = q0 + threadIdx.x / TPR;
  const bool live = qi < seq_len;
  const size_t pos_stride = static_cast<size_t>(heads) * D;  // between sequence positions
  const size_t base = static_cast<size_t>(b) * seq_len * pos_stride + static_cast<size_t>(h) * D;

  // this thread's dims: chunks c = part + TPR * u, dims 4c .. 4c+3
  float qr[DPT];
  float acc[DPT];
#pragma unroll
  for (int u = 0; u < C4; ++u) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int dim = 4 * (part + TPR * u) + e;
      qr[4 * u + e] = live ? persia::to_f32(q[base + qi * pos_stride + dim]) : 0.f;
      acc[4 * u + e] = 0.f;
    }
  }
  float m = kNegBig;
  float l = 0.f;

  const int k_end = causal ? min(seq_len, q0 + Cfg::kRows) : seq_len;
  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed
    for (int e = threadIdx.x; e < kBlockK * D; e += kThreads) {
      const int r = e / D;
      const int c = e % D;
      const int kp = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (kp < seq_len) {
        const size_t off = base + kp * pos_stride + c;
        kv = persia::to_f32(k[off]);
        vv = persia::to_f32(v[off]);
      }
      ks[r][c] = kv;
      vs[r][c] = vv;
    }
    __syncthreads();

    float s[kBlockK];
    float tile_max = kNegBig;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int u = 0; u < C4; ++u) {
        const float4 kk = *reinterpret_cast<const float4*>(&ks[j][4 * (part + TPR * u)]);
        dot = fmaf(qr[4 * u + 0], kk.x, dot);
        dot = fmaf(qr[4 * u + 1], kk.y, dot);
        dot = fmaf(qr[4 * u + 2], kk.z, dot);
        dot = fmaf(qr[4 * u + 3], kk.w, dot);
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const int kp = k0 + j;
      const bool keep = kp < seq_len && (!causal || kp <= qi);
      s[j] = keep ? dot * scale : kNegBig;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    float tile_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const int kp = k0 + j;
      const bool keep = kp < seq_len && (!causal || kp <= qi);
      s[j] = keep ? expf(s[j] - m_new) : 0.f;
      tile_sum += s[j];
    }
    l = l * corr + tile_sum;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= corr;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float p = s[j];
#pragma unroll
      for (int u = 0; u < C4; ++u) {
        const float4 vv = *reinterpret_cast<const float4*>(&vs[j][4 * (part + TPR * u)]);
        acc[4 * u + 0] = fmaf(p, vv.x, acc[4 * u + 0]);
        acc[4 * u + 1] = fmaf(p, vv.y, acc[4 * u + 1]);
        acc[4 * u + 2] = fmaf(p, vv.z, acc[4 * u + 2]);
        acc[4 * u + 3] = fmaf(p, vv.w, acc[4 * u + 3]);
      }
    }
    m = m_new;
  }

  if (live) {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int u = 0; u < C4; ++u) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int dim = 4 * (part + TPR * u) + e;
        persia::store_f32(out + base + qi * pos_stride + dim, acc[4 * u + e] / denom);
      }
    }
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* out, int q_blocks, int batch,
           int seq_len, int heads, float scale, int causal, cudaStream_t stream) {
  if (q_blocks != (seq_len + Tile<D>::kRows - 1) / Tile<D>::kRows) return cudaErrorInvalidValue;
  const dim3 grid(q_blocks, batch * heads);
  flash_attention_fwd_kernel<float, D><<<grid, kThreads, 0, stream>>>(q, k, v, out, seq_len, heads,
                                                                      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f32 only; q_blocks from ops/plans.py::fma_rows. Returns a CUDA error code.
extern "C" int persia_flash_attention_fwd_fma(const void* q, const void* k, const void* v,
                                              void* out, int batch, int seq_len, int heads,
                                              int dim, float scale, int causal, int q_blocks,
                                              void* stream) {
  if (batch <= 0 || seq_len <= 0 || heads <= 0 || batch * heads > 65535) {
    return cudaErrorInvalidValue;
  }
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dim) {
    case 16: return launch<16>(qf, kf, vf, of, q_blocks, batch, seq_len, heads, scale, causal, s);
    case 32: return launch<32>(qf, kf, vf, of, q_blocks, batch, seq_len, heads, scale, causal, s);
    case 64: return launch<64>(qf, kf, vf, of, q_blocks, batch, seq_len, heads, scale, causal, s);
    case 128: return launch<128>(qf, kf, vf, of, q_blocks, batch, seq_len, heads, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}
