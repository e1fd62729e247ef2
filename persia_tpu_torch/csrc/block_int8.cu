// The dense ring's block-scaled int8 wire: quantize (K16) and dequantize
// (K17) of a flat f32 vector in blocks of `bs` elements, one f32 scale a
// block.
//
// K16, block_int8_quantize: for each block b of the (L,) input v (and, with
// the ring's error feedback, the carried residual ef):
//   x        = v + ef                               (f32; v without ef)
//   scale[b] = max(max |x|, 1e-30)                  (NaN if some x is NaN)
//   t        = clip(rint(x / scale * 127), -127, 127)
//   q        = t as int8 (a NaN codes 0, as PyTorch casts it)
//   err      = x - t * (scale / 127)                (what the wire lost)
// Each quotient, product and difference is rounded on its own (__fdiv_rn,
// __fmul_rn, __fsub_rn): nvcc's default contraction would fuse err into an
// FMA. rintf rounds half to even, as jnp.round and torch.round do. The
// maximum is exact in any order.
//
// K17, block_int8_dequantize: rows j < n of codes (chunk elements each)
// and their scales; element i of row j lands at out[((j + roll) % n) *
// chunk + i] as
//   out = [base (+ ef)] + q * (scale / 127)
// with base (the ring hop's accumulator chunk: out may be base) and ef
// optional, each sum rounded on its own in that order. A hop passes one
// row and roll 0; the all-gather passes the n gathered rows and roll 1,
// which puts row j (device j's owned chunk (j + 1) % n) in chunk order.
//
// Replaces: persia_tpu/parallel/grad_sync.py:312-324 (block_quantize_int8)
// with the error at :374-377 and :401 and the feedback add at :423, and
// :327-330 (block_dequantize_int8) with the hop's cur + deq (:381-385) and
// the all-gather's n rows rolled by one (:402-410): XLA ops, no Pallas
// kernel.
//
// Bound on the H100: bytes. K16 reads 4 (8 with ef) and writes 5 bytes an
// element; K17 reads 1 (+4 a base, +4 an ef) and writes 4.
//
// Design, K16: one thread block a quantization block; each thread holds up
// to kMaxPer of its block's elements in registers (element tid + k *
// threads), takes the block's maximum by warp shuffles and shared memory,
// and writes its codes and errors from the registers: v and ef are read
// once. K17: one thread an element, a grid-stride loop. Geometry comes
// from ops/plans.py::block_int8_plan and is checked here.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxBlockThreads = 256;  // plans.BLOCK_INT8_MAX_THREADS
constexpr int kMaxPer = 8;             // plans.BLOCK_INT8_MAX_PER: elements a thread holds

__device__ __forceinline__ float abs_max(float m, float a) {
  return (a > m || a != a) ? a : m;  // NaN wins, as jnp.max and torch.amax
}

__global__ void __launch_bounds__(kMaxBlockThreads)
    block_int8_quantize_kernel(const float* __restrict__ v, const float* __restrict__ ef, int bs,
                               int8_t* __restrict__ q, float* __restrict__ scales, float* __restrict__ err) {
  __shared__ float warp_max[kMaxBlockThreads / 32];
  const int b = blockIdx.x, tid = threadIdx.x, threads = blockDim.x;
  const int64_t base = static_cast<int64_t>(b) * bs;
  float x[kMaxPer];
  float m = 0.0f;
#pragma unroll
  for (int k = 0; k < kMaxPer; ++k) {
    const int i = tid + k * threads;
    x[k] = 0.0f;
    if (i < bs) {
      x[k] = ef != nullptr ? __fadd_rn(v[base + i], ef[base + i]) : v[base + i];
      m = abs_max(m, fabsf(x[k]));
    }
  }
  for (int d = 16; d > 0; d >>= 1) m = abs_max(m, __shfl_xor_sync(kFull, m, d));
  if ((tid & 31) == 0) warp_max[tid >> 5] = m;
  __syncthreads();
  m = warp_max[0];
  for (int w = 1; w < (threads >> 5); ++w) m = abs_max(m, warp_max[w]);
  const float scale = (m > 1e-30f || m != m) ? m : 1e-30f;
  const float step = __fdiv_rn(scale, 127.0f);
  if (tid == 0) scales[b] = scale;
#pragma unroll
  for (int k = 0; k < kMaxPer; ++k) {
    const int i = tid + k * threads;
    if (i < bs) {
      float t = rintf(__fmul_rn(__fdiv_rn(x[k], scale), 127.0f));
      const bool nan = t != t;
      if (!nan) t = fminf(fmaxf(t, -127.0f), 127.0f);
      q[base + i] = nan ? int8_t{0} : static_cast<int8_t>(t);
      if (err != nullptr) err[base + i] = __fsub_rn(x[k], __fmul_rn(t, step));
    }
  }
}

__global__ void block_int8_dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ scales,
                                             int n, int64_t chunk, int bs, int roll, const float* base,
                                             const float* __restrict__ ef, float* out) {
  const int64_t total = static_cast<int64_t>(n) * chunk;
  const int64_t blocks_per_row = chunk / bs;
  for (int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; e < total;
       e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t j = e / chunk, i = e - j * chunk;
    const float step = __fdiv_rn(__ldg(scales + j * blocks_per_row + i / bs), 127.0f);
    float y = __fmul_rn(static_cast<float>(q[e]), step);
    const int64_t o = ((j + roll) % n) * chunk + i;
    if (base != nullptr) {
      const float c = ef != nullptr ? __fadd_rn(base[o], __ldg(ef + o)) : base[o];
      y = __fadd_rn(c, y);
    }
    out[o] = y;
  }
}

}  // namespace

// K16. v (blocks * bs,) f32; ef: null or like v; q (blocks * bs,) int8;
// scales (blocks,) f32; err: null or like v (may not alias v or ef);
// threads: the plan's. Returns a CUDA error code.
extern "C" int persia_block_int8_quantize(const float* v, const float* ef, int blocks, int bs, int8_t* q,
                                          float* scales, float* err, int threads, void* stream) {
  if (blocks < 0 || bs < 1 || threads < 32 || threads > kMaxBlockThreads || threads % 32 != 0 ||
      bs > threads * kMaxPer) {
    return cudaErrorInvalidValue;
  }
  if (blocks == 0) return cudaSuccess;
  if (v == nullptr || q == nullptr || scales == nullptr) return cudaErrorInvalidValue;
  block_int8_quantize_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(v, ef, bs, q, scales, err);
  return static_cast<int>(cudaGetLastError());
}

// K17. q (n * chunk,) int8; scales (n * chunk / bs,) f32; chunk a
// multiple of bs; base, ef: null or (n * chunk,) f32 indexed as out; out
// (n * chunk,) f32 (may be base); roll in [0, n); grid and threads: the
// plan's. Returns a CUDA error code.
extern "C" int persia_block_int8_dequantize(const int8_t* q, const float* scales, int n, long long chunk, int bs,
                                            int roll, const float* base, const float* ef, float* out, int grid,
                                            int threads, void* stream) {
  if (n < 0 || chunk < 0 || bs < 1 || chunk % bs != 0 || roll < 0 || (n > 0 && roll >= n) || grid < 1 ||
      threads < 32 || threads > 1024 || (ef != nullptr && base == nullptr)) {
    return cudaErrorInvalidValue;
  }
  if (n == 0 || chunk == 0) return cudaSuccess;
  if (q == nullptr || scales == nullptr || out == nullptr) return cudaErrorInvalidValue;
  block_int8_dequantize_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      q, scales, n, static_cast<int64_t>(chunk), bs, roll, base, ef, out);
  return static_cast<int>(cudaGetLastError());
}
