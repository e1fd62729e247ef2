// The dense ring's block-scaled int8 wire: quantize (K16), dequantize
// (K17) and a ring hop's dequantize-accumulate folded into the next
// quantize, of a flat f32 vector in blocks of `bs` elements, one f32 scale
// a block.
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
// The fused hop, block_int8_requantize: one received row (codes q_in and
// scales sc_in) accumulated into the chunk base as K17 does it, x = (base
// + ef) + q_in * (sc_in / 127), then K16 of x without feedback (codes,
// scales, err); x is written back to base only where asked (acc_out). It
// is bit for bit K17 then K16: the ring's hop s accumulates the chunk that
// hop s + 1 sends, and nothing else reads it in between.
//
// Replaces: persia_tpu/parallel/grad_sync.py:312-324 (block_quantize_int8)
// with the error at :374-377 and :401 and the feedback add at :423, and
// :327-330 (block_dequantize_int8) with the hop's cur + deq (:381-385) and
// the all-gather's n rows rolled by one (:402-410): XLA ops, no Pallas
// kernel.
//
// Bound on the H100: bytes. K16 reads 4 (8 with ef) and writes 5 bytes an
// element; K17 reads 1 (+4 a base, +4 an ef) and writes 4; the fused hop
// reads 9 (+4 an ef) and writes 5 (+4 with acc_out).
//
// Design (ops/plans.py::block_int8_plan and block_dequant_plan choose by
// block size; the entry points check the geometry):
// - the warp plan (bs = 128 V, V = 1..4): a warp a quantization block,
//   lane l holding its 4 V contiguous elements l * 4V .. as V float4. Every
//   load is issued at the kernel's top (v, ef; the fused pass's codes as one
//   4V-byte load and the block's scale), the maximum takes 5 xor shuffles
//   (no shared memory, no barrier), the codes leave as one 4V-byte store a
//   lane, the errors as V float4, lane 0 stores the scale. The CTA holds
//   the fewest warps that keep the grid within one CTA an SM.
// - the block plan (any other bs up to 2048): a thread block a
//   quantization block, each thread up to kMaxPer of its elements in
//   registers (element tid + k * threads), the maximum by shuffles and
//   shared memory.
// - K17's vector plan (bs % 16 == 0): a thread a vector of 16 codes (one
//   16-byte load; base, ef and out as four float4), its row, block and
//   destination in 32-bit arithmetic and scale / 127 once; the grid one
//   CTA an SM. Other block sizes: a thread an element, grid-stride.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxBlockThreads = 256;  // plans.BLOCK_INT8_MAX_THREADS
constexpr int kMaxPer = 8;             // plans.BLOCK_INT8_MAX_PER: elements a thread holds
constexpr int kWarpMaxVec = 4;         // plans.BLOCK_INT8_WARP_MAX_VEC: float4s a lane
constexpr int kWarpMaxThreads = 512;   // plans.BLOCK_INT8_WARP_MAX_WARPS * 32
constexpr int kDequantVec = 16;        // plans.BLOCK_DEQUANT_VEC: codes a thread
constexpr int kDequantVecMaxThreads = 256;  // plans.BLOCK_DEQUANT_VEC_MAX_WARPS * 32
constexpr int kDequantMaxThreads = 1024;

__device__ __forceinline__ float abs_max(float m, float a) {
  return (a > m || a != a) ? a : m;  // NaN wins, as jnp.max and torch.amax
}

__device__ __forceinline__ float code_at(uint32_t word, int j) {
  return static_cast<float>(static_cast<int8_t>(static_cast<uint8_t>(word >> (8 * j))));
}

// K17's accumulate of d = q * step: (base + ef) + d, each sum rounded on
// its own
__device__ __forceinline__ float accumulate(float base, bool has_ef, float ef, float d) {
  return __fadd_rn(has_ef ? __fadd_rn(base, ef) : base, d);
}

__device__ __forceinline__ float block_scale(float m) { return (m > 1e-30f || m != m) ? m : 1e-30f; }

// K16's code of x at scale: the clipped rounding, a NaN coded 0; t keeps
// the NaN for the error, as the plain version does
__device__ __forceinline__ uint32_t quantize_one(float x, float scale, float step, float* err) {
  float t = rintf(__fmul_rn(__fdiv_rn(x, scale), 127.0f));
  const bool nan = t != t;
  if (!nan) t = fminf(fmaxf(t, -127.0f), 127.0f);
  *err = __fsub_rn(x, __fmul_rn(t, step));
  return nan ? 0u : static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(t)));
}

template <int V>
__device__ __forceinline__ void load_words(const int8_t* p, uint32_t (&w)[V]) {
  if constexpr (V == 4) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    w[0] = t.x, w[1] = t.y, w[2] = t.z, w[3] = t.w;
  } else if constexpr (V == 2) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    w[0] = t.x, w[1] = t.y;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) w[k] = reinterpret_cast<const uint32_t*>(p)[k];
  }
}

template <int V>
__device__ __forceinline__ void store_words(int8_t* p, const uint32_t (&w)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) reinterpret_cast<uint32_t*>(p)[k] = w[k];
  }
}

__device__ __forceinline__ float f4(const float4& a, int j) { return j == 0 ? a.x : j == 1 ? a.y : j == 2 ? a.z : a.w; }

// The warp plan: warp w of the grid owns block b = w; lane l its elements
// b * 128V + l * 4V + [0, 4V). kFused: v is the accumulator (base), and
// q_in / sc_in the received row.
template <int V, bool kFused>
__global__ void __launch_bounds__(kWarpMaxThreads)
    block_int8_quantize_warp_kernel(const float* v, const float* __restrict__ ef, const int8_t* __restrict__ q_in,
                                    const float* __restrict__ sc_in, int blocks, int8_t* __restrict__ q,
                                    float* __restrict__ scales, float* __restrict__ err, float* acc_out) {
  constexpr int kPer = 4 * V;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= blocks) return;
  const int64_t e0 = static_cast<int64_t>(b) * (32 * kPer) + lane * kPer;
  float4 xv[V], fv[V];
  uint32_t w[V];
  float s_in = 0.0f;
#pragma unroll
  for (int k = 0; k < V; ++k) xv[k] = *reinterpret_cast<const float4*>(v + e0 + 4 * k);
  if (ef != nullptr) {
#pragma unroll
    for (int k = 0; k < V; ++k) fv[k] = __ldg(reinterpret_cast<const float4*>(ef + e0 + 4 * k));
  }
  if constexpr (kFused) {
    load_words<V>(q_in + e0, w);
    s_in = __ldg(sc_in + b);
  }
  float x[kPer];
  float m = 0.0f;
  const float step_in = kFused ? __fdiv_rn(s_in, 127.0f) : 0.0f;
#pragma unroll
  for (int k = 0; k < V; ++k) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float a = f4(xv[k], j), f = ef != nullptr ? f4(fv[k], j) : 0.0f;
      float y;
      if constexpr (kFused) {
        y = accumulate(a, ef != nullptr, f, __fmul_rn(code_at(w[k], j), step_in));
      } else {
        y = ef != nullptr ? __fadd_rn(a, f) : a;
      }
      x[4 * k + j] = y;
      m = abs_max(m, fabsf(y));
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) m = abs_max(m, __shfl_xor_sync(kFull, m, d));
  const float scale = block_scale(m);
  const float step = __fdiv_rn(scale, 127.0f);
  uint32_t out_w[V];
  float e[kPer];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    out_w[k] = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) out_w[k] |= quantize_one(x[4 * k + j], scale, step, &e[4 * k + j]) << (8 * j);
  }
  store_words<V>(q + e0, out_w);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    *reinterpret_cast<float4*>(err + e0 + 4 * k) = make_float4(e[4 * k], e[4 * k + 1], e[4 * k + 2], e[4 * k + 3]);
  }
  if (lane == 0) scales[b] = scale;
  if (kFused && acc_out != nullptr) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      *reinterpret_cast<float4*>(acc_out + e0 + 4 * k) =
          make_float4(x[4 * k], x[4 * k + 1], x[4 * k + 2], x[4 * k + 3]);
    }
  }
}

// The block plan: thread block b owns block b, thread tid its elements
// tid + k * threads.
template <bool kFused>
__global__ void __launch_bounds__(kMaxBlockThreads)
    block_int8_quantize_kernel(const float* v, const float* __restrict__ ef, const int8_t* __restrict__ q_in,
                               const float* __restrict__ sc_in, int bs, int8_t* __restrict__ q,
                               float* __restrict__ scales, float* __restrict__ err, float* acc_out) {
  __shared__ float warp_max[kMaxBlockThreads / 32];
  const int b = blockIdx.x, tid = threadIdx.x, threads = blockDim.x;
  const int64_t base = static_cast<int64_t>(b) * bs;
  const float step_in = kFused ? __fdiv_rn(__ldg(sc_in + b), 127.0f) : 0.0f;
  float x[kMaxPer];
  float m = 0.0f;
#pragma unroll
  for (int k = 0; k < kMaxPer; ++k) {
    const int i = tid + k * threads;
    x[k] = 0.0f;
    if (i < bs) {
      if constexpr (kFused) {
        x[k] = accumulate(v[base + i], ef != nullptr, ef != nullptr ? ef[base + i] : 0.0f,
                          __fmul_rn(static_cast<float>(q_in[base + i]), step_in));
      } else {
        x[k] = ef != nullptr ? __fadd_rn(v[base + i], ef[base + i]) : v[base + i];
      }
      m = abs_max(m, fabsf(x[k]));
    }
  }
  for (int d = 16; d > 0; d >>= 1) m = abs_max(m, __shfl_xor_sync(kFull, m, d));
  if ((tid & 31) == 0) warp_max[tid >> 5] = m;
  __syncthreads();
  m = warp_max[0];
  for (int w = 1; w < (threads >> 5); ++w) m = abs_max(m, warp_max[w]);
  const float scale = block_scale(m);
  const float step = __fdiv_rn(scale, 127.0f);
  if (tid == 0) scales[b] = scale;
#pragma unroll
  for (int k = 0; k < kMaxPer; ++k) {
    const int i = tid + k * threads;
    if (i < bs) {
      float e;
      q[base + i] = static_cast<int8_t>(static_cast<uint8_t>(quantize_one(x[k], scale, step, &e)));
      err[base + i] = e;
      if (kFused && acc_out != nullptr) acc_out[base + i] = x[k];
    }
  }
}

// K17's vector plan: thread u takes elements 16u .. 16u + 15 of the n
// rows (one row, one quantization block: bs % 16 == 0).
__global__ void __launch_bounds__(kDequantVecMaxThreads)
    block_int8_dequantize_vec_kernel(const int8_t* __restrict__ q, const float* __restrict__ scales, int n,
                                     int chunk, int bs, int roll, const float* base, const float* __restrict__ ef,
                                     float* out) {
  const int units = n * (chunk / kDequantVec);
  for (int u = blockIdx.x * blockDim.x + threadIdx.x; u < units; u += gridDim.x * blockDim.x) {
    const int e = u * kDequantVec;
    const int j = e / chunk, i = e - j * chunk;
    const int row = j + roll < n ? j + roll : j + roll - n;
    const int o = row * chunk + i;
    const uint4 c = *reinterpret_cast<const uint4*>(q + e);
    const float s = __ldg(scales + e / bs);
    float4 bv[4], fv[4];
    if (base != nullptr) {
#pragma unroll
      for (int k = 0; k < 4; ++k) bv[k] = *reinterpret_cast<const float4*>(base + o + 4 * k);
    }
    if (ef != nullptr) {
#pragma unroll
      for (int k = 0; k < 4; ++k) fv[k] = __ldg(reinterpret_cast<const float4*>(ef + o + 4 * k));
    }
    const uint32_t w[4] = {c.x, c.y, c.z, c.w};
    const float step = __fdiv_rn(s, 127.0f);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float y[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float d = __fmul_rn(code_at(w[k], jj), step);
        y[jj] = base != nullptr ? accumulate(f4(bv[k], jj), ef != nullptr, ef != nullptr ? f4(fv[k], jj) : 0.0f, d)
                                : d;
      }
      *reinterpret_cast<float4*>(out + o + 4 * k) = make_float4(y[0], y[1], y[2], y[3]);
    }
  }
}

// K17's scalar plan: a thread an element, grid-stride.
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

bool aligned(const void* p, uintptr_t bytes) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0; }

// K16 or the fused hop on either plan. vec: V of the warp plan, 0 for the
// block plan; grid and threads the plan's.
template <bool kFused>
int launch_quantize(const float* v, const float* ef, const int8_t* q_in, const float* sc_in, int blocks, int bs,
                    int8_t* q, float* scales, float* err, float* acc_out, int vec, int grid, int threads,
                    void* stream) {
  if (blocks < 0 || bs < 1 || vec < 0 || vec > kWarpMaxVec || grid < 0) return cudaErrorInvalidValue;
  if (vec > 0) {
    if (bs != 128 * vec || threads < 32 || threads > kWarpMaxThreads || threads % 32 != 0 ||
        static_cast<int64_t>(grid) * (threads / 32) < blocks)
      return cudaErrorInvalidValue;
    const uintptr_t codes = (4 * vec) & -(4 * vec);  // a lane's codes: 4V bytes, as words of up to 16
    if (!aligned(v, 16) || !aligned(ef, 16) || !aligned(err, 16) || !aligned(acc_out, 16) || !aligned(q, codes) ||
        !aligned(q_in, codes))
      return cudaErrorMisalignedAddress;
  } else if (threads < 32 || threads > kMaxBlockThreads || threads % 32 != 0 || bs > threads * kMaxPer ||
             grid != blocks) {
    return cudaErrorInvalidValue;
  }
  if (blocks == 0) return cudaSuccess;
  if (v == nullptr || q == nullptr || scales == nullptr || err == nullptr ||
      (kFused && (q_in == nullptr || sc_in == nullptr)))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 0:
      block_int8_quantize_kernel<kFused><<<grid, threads, 0, s>>>(v, ef, q_in, sc_in, bs, q, scales, err, acc_out);
      break;
    case 1:
      block_int8_quantize_warp_kernel<1, kFused><<<grid, threads, 0, s>>>(v, ef, q_in, sc_in, blocks, q, scales, err,
                                                                          acc_out);
      break;
    case 2:
      block_int8_quantize_warp_kernel<2, kFused><<<grid, threads, 0, s>>>(v, ef, q_in, sc_in, blocks, q, scales, err,
                                                                          acc_out);
      break;
    case 3:
      block_int8_quantize_warp_kernel<3, kFused><<<grid, threads, 0, s>>>(v, ef, q_in, sc_in, blocks, q, scales, err,
                                                                          acc_out);
      break;
    default:
      block_int8_quantize_warp_kernel<4, kFused><<<grid, threads, 0, s>>>(v, ef, q_in, sc_in, blocks, q, scales, err,
                                                                          acc_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K16. v (blocks * bs,) f32; ef: null or like v; q (blocks * bs,) int8;
// scales (blocks,) f32; err like v (may not alias v or ef); vec, grid,
// threads: the plan's. Returns a CUDA error code.
extern "C" int persia_block_int8_quantize(const float* v, const float* ef, int blocks, int bs, int8_t* q,
                                          float* scales, float* err, int vec, int grid, int threads, void* stream) {
  return launch_quantize<false>(v, ef, nullptr, nullptr, blocks, bs, q, scales, err, nullptr, vec, grid, threads,
                                stream);
}

// The fused hop. q_in (blocks * bs,) int8 and sc_in (blocks,) f32: the
// received row; base (blocks * bs,) f32: the accumulator chunk; ef: null or
// like base; q, scales, err: as K16's (err may not alias base or ef);
// acc_out: null, or where x goes (may be base). Returns a CUDA error code.
extern "C" int persia_block_requantize_int8(const int8_t* q_in, const float* sc_in, const float* base,
                                            const float* ef, int blocks, int bs, int8_t* q, float* scales,
                                            float* err, float* acc_out, int vec, int grid, int threads,
                                            void* stream) {
  return launch_quantize<true>(base, ef, q_in, sc_in, blocks, bs, q, scales, err, acc_out, vec, grid, threads,
                               stream);
}

// K17. q (n * chunk,) int8; scales (n * chunk / bs,) f32; chunk a
// multiple of bs; base, ef: null or (n * chunk,) f32 indexed as out; out
// (n * chunk,) f32 (may be base); roll in [0, n); vec 1 for the vector
// plan (bs % 16 == 0, n * chunk < 2^31, 16-byte aligned), else 0; grid and
// threads: the plan's. Returns a CUDA error code.
extern "C" int persia_block_int8_dequantize(const int8_t* q, const float* scales, int n, long long chunk, int bs,
                                            int roll, const float* base, const float* ef, float* out, int vec,
                                            int grid, int threads, void* stream) {
  if (n < 0 || chunk < 0 || bs < 1 || chunk % bs != 0 || roll < 0 || (n > 0 && roll >= n) || grid < 1 ||
      threads < 32 || threads > kDequantMaxThreads || threads % 32 != 0 || (ef != nullptr && base == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const long long total = static_cast<long long>(n) * chunk;
  if (vec != 0 && (bs % kDequantVec != 0 || total >= (1LL << 31) || threads > kDequantVecMaxThreads))
    return cudaErrorInvalidValue;
  if (vec != 0 && (!aligned(q, 16) || !aligned(base, 16) || !aligned(ef, 16) || !aligned(out, 16)))
    return cudaErrorMisalignedAddress;
  if (total == 0) return cudaSuccess;
  if (q == nullptr || scales == nullptr || out == nullptr) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec != 0) {
    block_int8_dequantize_vec_kernel<<<grid, threads, 0, s>>>(q, scales, n, static_cast<int>(chunk), bs, roll, base,
                                                              ef, out);
  } else {
    block_int8_dequantize_kernel<<<grid, threads, 0, s>>>(q, scales, n, static_cast<int64_t>(chunk), bs, roll, base,
                                                          ef, out);
  }
  return static_cast<int>(cudaGetLastError());
}
