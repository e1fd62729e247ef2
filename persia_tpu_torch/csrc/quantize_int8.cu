// The cache tier's int8 parameter-server gradient wire (K15): absmax int8
// quantization with error feedback, one scale a segment (a PS slot's
// gradient).
//
// Input: the step's PS gradients g, flat (n,) f32 or bf16, the segments'
// offsets (S+1 ascending int32, off[0] = 0, off[S] = n; a segment may be
// empty) and the carried residual r (n,) f32. For each segment s:
//   v        = g + r                                (f32)
//   scale[s] = max(max |v|, 1e-30)                  (NaN if some v is NaN)
//   q        = clip(rint(v / scale * 127), -127, 127) as int8
//   r'       = v - q * (scale / 127)                (the new residual)
// Each division and product is rounded on its own (__fdiv_rn, __fmul_rn,
// __fsub_rn): nvcc's default -fmad=true would contract r' into an FMA and
// part from the plain version in the last bit. rintf rounds half to even,
// as torch.round and jnp.round do. r' may be written over r in place: each
// element is read and rewritten by one thread of its segment's block,
// after the block's reduction.
//
// Replaces: persia_tpu/parallel/grad_sync.py:244-260 (quantize_int8_ef) as
// persia_tpu/embedding/hbm_cache/step.py:361-400 calls it, a slot at a
// time: XLA ops, no Pallas kernel.
//
// Bound on the H100: bytes (g and r read once, q and r' written once; a few
// operations an element).
//
// Design: one block a segment, two sweeps of it: the absmax (a warp
// shuffle, then shared memory across the warps), then q and r'. The second
// sweep rereads g and r, mostly from L2. A simple first design: the
// segments of the main path (26 of 24,576 elements) give 26 blocks.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

}  // namespace

// The segments' offsets, passed by value (kernel parameters hold 4 KB).
constexpr int kMaxQuantSegments = 512;
struct QuantSegments {
  int off[kMaxQuantSegments + 1];
};

namespace {

__device__ __forceinline__ float abs_max(float m, float a) {
  return (a > m || a != a) ? a : m;  // NaN wins, as jnp.max and torch.amax
}

template <typename T>
__global__ void __launch_bounds__(kThreads) quantize_int8_ef_kernel(const T* __restrict__ g, const float* r,
                                                                     QuantSegments segs, int8_t* __restrict__ q,
                                                                     float* __restrict__ scales, float* r_out) {
  __shared__ float warp_max[kWarps];
  const int s = blockIdx.x;
  const int begin = segs.off[s], end = segs.off[s + 1];
  float m = 0.0f;
  for (int i = begin + threadIdx.x; i < end; i += kThreads) {
    m = abs_max(m, fabsf(__fadd_rn(persia::to_f32(g[i]), r[i])));
  }
  for (int d = 16; d > 0; d >>= 1) m = abs_max(m, __shfl_xor_sync(0xffffffffu, m, d));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  m = warp_max[0];
  for (int w = 1; w < kWarps; ++w) m = abs_max(m, warp_max[w]);
  const float scale = (m > 1e-30f || m != m) ? m : 1e-30f;
  if (threadIdx.x == 0) scales[s] = scale;
  const float step = __fdiv_rn(scale, 127.0f);
  for (int i = begin + threadIdx.x; i < end; i += kThreads) {
    const float v = __fadd_rn(persia::to_f32(g[i]), r[i]);
    const float t = fminf(fmaxf(rintf(__fmul_rn(__fdiv_rn(v, scale), 127.0f)), -127.0f), 127.0f);
    q[i] = static_cast<int8_t>(t);
    r_out[i] = __fsub_rn(v, __fmul_rn(t, step));
  }
}

}  // namespace

// g (n,) f32 or bf16 (dtype: persia::DType); offsets: host (segments + 1,)
// int32, ascending from 0 to n; r, r_out (n,) f32 (r_out may be r); q (n,)
// int8; scales (segments,) f32.
extern "C" int persia_quantize_int8_ef(const void* g, int dtype, const float* r, const int* offsets, int segments,
                                       int8_t* q, float* scales, float* r_out, void* stream) {
  if (segments < 0 || segments > kMaxQuantSegments || offsets == nullptr || offsets[0] != 0 ||
      (dtype != persia::kFloat32 && dtype != persia::kBFloat16)) {
    return cudaErrorInvalidValue;
  }
  QuantSegments segs;
  for (int s = 0; s <= segments; ++s) {
    if (s > 0 && offsets[s] < offsets[s - 1]) return cudaErrorInvalidValue;
    segs.off[s] = offsets[s];
  }
  if (segments == 0) return cudaSuccess;
  if (offsets[segments] > 0 && (g == nullptr || r == nullptr || q == nullptr || r_out == nullptr)) {
    return cudaErrorInvalidValue;
  }
  if (scales == nullptr) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == persia::kFloat32) {
    quantize_int8_ef_kernel<float><<<segments, kThreads, 0, st>>>(static_cast<const float*>(g), r, segs, q, scales,
                                                                  r_out);
  } else {
    quantize_int8_ef_kernel<__nv_bfloat16><<<segments, kThreads, 0, st>>>(static_cast<const __nv_bfloat16*>(g), r,
                                                                          segs, q, scales, r_out);
  }
  return cudaGetLastError();
}
