// The cache tier's int8 parameter-server gradient wire (K15): absmax int8
// quantization with error feedback, one scale a segment (a PS slot's
// gradient).
//
// Input: the step's PS gradients g, flat (n,) f32 or bf16, the segments'
// offsets (S+1 ascending int32, off[0] = 0, off[S] = n; a segment may be
// empty), the carried residual r (n,) f32 and, under the dynamic loss
// scale, two f32 scalars in device memory: inv (1 / the loss scale on a
// finite step, 0 on an overflow) and finite (1 or 0). For each segment s:
//   v        = g * inv + r                          (f32; inv = 1 without)
//   scale[s] = max(max |v|, 1e-30)                  (NaN if some v is NaN)
//   q        = clip(rint(v / scale * 127), -127, 127) as int8
//   r'       = v - q * (scale / 127)                (the new residual)
// Each product and difference is rounded on its own (__fmul_rn,
// __fsub_rn): nvcc's default -fmad=true would contract r' into an FMA and
// part from the plain version in the last bit. The quotient v / scale is
// the correctly rounded one wherever it decides the code (see divide()).
// g * inv is exact (inv is a power of two) and rounded on its own. rintf
// rounds half to even, as torch.round and jnp.round do. A NaN
// passes the clip, as torch.clamp lets it, and its code is 0, as
// PyTorch's cast makes it. A maximum is exact in any order, so the scale
// does not depend on how the segment is split. r' is written over r in
// place: each element is read and rewritten by one thread. With `finite`,
// scales[S] = finite (the tail the host reads); on an overflow step
// (finite 0) every code is 0, every scale 0 and the residual is left as it
// was (the host drops the step's gradients).
//
// At a shared scale (the dense bytegrad all-reduce): the same kernel in two
// more modes. With q null it writes the scales alone (the segments'
// max(max |v|, 1e-30), which the caller all-reduces with MAX); with
// scale_in (S f32 in device memory, one a segment) it takes scale =
// max(scale_in[s], 1e-30) instead of the segment's own maximum, skipping
// the maximum and the cluster's exchange, and writes codes, scales and
// residual as above (persia_tpu/parallel/grad_sync.py:279-297,
// quantize_int8_ef(g, r, scale=pmax(...)) a leaf at a time).
//
// Replaces: persia_tpu/parallel/grad_sync.py:244-260 (quantize_int8_ef) as
// persia_tpu/embedding/hbm_cache/step.py:361-415 calls it, a slot at a
// time, with the unscale f * inv and the finite gate (the codes and the
// residual selected, the finite flag appended to the scales): XLA ops, no
// Pallas kernel.
//
// Bound on the H100: bytes. g and r are read once and q and r' written
// once, 11 bytes an element at bf16; a few operations an element. At the
// ps-stream step (26 segments of 24,576 bf16) that is 7.0 MB, ~2.1 us.
//
// Design: one pass, a cluster of blocks a segment. The first design (one
// block of 512 threads a segment, two sweeps) put 26 blocks on 132 SMs,
// read g and r twice, loaded 2 or 4 bytes and stored 1 a thread at a time,
// and kept ~80 KB in flight where the card needs ~3 MB. Here a cluster of
// up to 8 blocks (a portable cluster) owns a segment, each block one span
// of its whole 8-element units; every thread issues all of its units'
// loads at the kernel's top into registers (a 16-byte load of g a unit at
// bf16, two at f32; two float4 of r), so that the whole input is in flight
// at once (3.8 MB at the ps-stream step, 208 blocks). It forms v once,
// takes the block's absmax by warp shuffles and shared memory, pushes it
// into a slot of every block of its cluster (distributed shared memory)
// and polls its own slots for the others', then writes the codes (one
// 8-byte store a unit) and the residual (two float4) from its registers:
// no element of the held units is read twice. The quotient takes
// Markstein's division (see divide()), with the branch between it and the
// IEEE one taken once a block. What still bounds it: no block can write
// before the slowest block of its cluster has read its span, so a
// segment's reads and writes do not overlap.
// csrc/probes/quantize_int8_variants.cu times the kernel beside cut-down
// variants (the same loads and stores with no maximum, with a block's or
// a cluster's barrier between them; a pull through distributed shared
// memory after the cluster barrier; the IEEE division; two segments a
// cluster), each of which measured slower or does not compute K15. A
// segment start off 8 elements takes a scalar head (and its end a scalar
// tail) in block 0; a span longer than the block's registers hold takes a
// bounded loop over the rest, read once for the maximum and once to write.
// With tensors off 16 bytes a unit is one element (scalar loads and
// stores). Geometry comes from ops/plans.py::quantize_int8_plan and is
// checked here.

#include <cooperative_groups.h>

#include <cstdint>

#include "cluster.cuh"
#include "vec.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxQuantThreads = 512;  // plans.QUANT_MAX_THREADS
constexpr int kMaxQuantWarps = kMaxQuantThreads / 32;
constexpr int kMaxQuantCluster = 8;  // plans.QUANT_MAX_CLUSTER: blocks a segment
constexpr int kEdgeThread = 8;  // the tail's first thread in block 0 (the head's is 0)

// units a thread holds in registers, 8-element units or single elements
// (plans.QUANT_MAX_UNITS)
constexpr int kMaxUnitsWide = 4;
constexpr int kMaxUnitsScalar = 8;

inline bool on_boundary(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

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

// One unit of VEC consecutive elements as loaded: g's 16-byte vectors (one
// at bf16, two at f32) and r's two float4, or one element of each.
template <typename T, int VEC>
struct Unit {
  static constexpr int kG = VEC * static_cast<int>(sizeof(T)) / 16;
  uint4 g[kG];
  float4 r[2];

  __device__ __forceinline__ void load(const T* gp, const float* rp) {
#pragma unroll
    for (int k = 0; k < kG; ++k) g[k] = __ldg(reinterpret_cast<const uint4*>(gp) + k);
    r[0] = reinterpret_cast<const float4*>(rp)[0];  // r is rewritten in place: no read-only path
    r[1] = reinterpret_cast<const float4*>(rp)[1];
  }
  __device__ __forceinline__ void sum(float (&v)[VEC], float iv) const {
    float gv[8], rv[8];
    if constexpr (kG == 1) {
      widen(g[0], gv);  // 8 bf16
    } else {
      const unsigned w[8] = {g[0].x, g[0].y, g[0].z, g[0].w, g[1].x, g[1].y, g[1].z, g[1].w};
#pragma unroll
      for (int k = 0; k < 8; ++k) gv[k] = __uint_as_float(w[k]);
    }
    float r0[4], r1[4];
    widen(r[0], r0);
    widen(r[1], r1);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      rv[k] = r0[k];
      rv[k + 4] = r1[k];
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = __fadd_rn(__fmul_rn(gv[k], iv), rv[k]);
  }
};

template <typename T>
struct Unit<T, 1> {
  T g;
  float r;

  __device__ __forceinline__ void load(const T* gp, const float* rp) {
    g = *gp;
    r = *rp;
  }
  __device__ __forceinline__ void sum(float (&v)[1], float iv) const {
    v[0] = __fadd_rn(__fmul_rn(persia::to_f32(g), iv), r);
  }
};

struct Scale {
  float scale, step, inv;
  bool fast;
};

__device__ __forceinline__ Scale make_scale(float m) {
  Scale sc;
  sc.scale = (m > 1e-30f || m != m) ? m : 1e-30f;
  sc.step = __fdiv_rn(sc.scale, 127.0f);
  sc.inv = __frcp_rn(sc.scale);
  sc.fast = sc.scale >= 0x1p-90f && sc.scale < 0x1p126f;  // false for NaN and inf
  return sc;
}

// v / scale, correctly rounded where it decides the code. FAST (2^-90 <=
// scale < 2^126): Markstein's division through the correctly rounded
// reciprocal inv, q0 = v * inv, e = v - q0 * scale (exact in an FMA: at
// these scales e is a multiple of 2^-146 wherever |q| >= 2^-10), q = q0 +
// e * inv, which is the correctly rounded v / scale there; below |q| =
// 2^-10 the code is a zero of v's sign either way; q0 where e is 0 (a
// zero keeps its sign). Else __fdiv_rn. The caller branches once a unit
// (or a block's held units), not once an element.
template <bool FAST>
__device__ __forceinline__ float divide(float v, const Scale& sc) {
  if constexpr (!FAST) {
    return __fdiv_rn(v, sc.scale);
  } else {
    const float q0 = __fmul_rn(v, sc.inv);
    const float e = __fmaf_rn(-q0, sc.scale, v);
    return e == 0.0f ? q0 : __fmaf_rn(e, sc.inv, q0);
  }
}

// one element's code and new residual; under FAST the scale and so every
// v of the segment are finite, so t is never NaN
template <bool FAST>
__device__ __forceinline__ float quantize(float v, const Scale& sc, int8_t& code) {
  float t = rintf(__fmul_rn(divide<FAST>(v, sc), 127.0f));
  if (FAST || t == t) t = fminf(fmaxf(t, -127.0f), 127.0f);
  code = FAST || t == t ? static_cast<int8_t>(t) : int8_t{0};
  return __fsub_rn(v, __fmul_rn(t, sc.step));
}

// a unit's codes and new residual: one 8-byte store and two float4, or one
// element of each
template <int VEC, bool FAST>
__device__ __forceinline__ void store_unit(const float (&v)[VEC], const Scale& sc, int8_t* qp, float* rp) {
  if constexpr (VEC == 8) {
    int8_t c[8];
    float out[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) out[k] = quantize<FAST>(v[k], sc, c[k]);
    uint2 packed;
    packed.x = (static_cast<uint8_t>(c[0])) | (static_cast<uint8_t>(c[1]) << 8) |
               (static_cast<uint8_t>(c[2]) << 16) | (static_cast<unsigned>(static_cast<uint8_t>(c[3])) << 24);
    packed.y = (static_cast<uint8_t>(c[4])) | (static_cast<uint8_t>(c[5]) << 8) |
               (static_cast<uint8_t>(c[6]) << 16) | (static_cast<unsigned>(static_cast<uint8_t>(c[7])) << 24);
    *reinterpret_cast<uint2*>(qp) = packed;
    store_as(rp, out);
  } else {
    int8_t c;
    *rp = quantize<FAST>(v[0], sc, c);
    *qp = c;
  }
}

// a unit's codes all 0 (an overflow step), the residual not written
template <int VEC>
__device__ __forceinline__ void zero_unit(int8_t* qp) {
  if constexpr (VEC == 8) {
    *reinterpret_cast<uint2*>(qp) = make_uint2(0u, 0u);
  } else {
    *qp = 0;
  }
}

// store_unit under the scale's own division
template <int VEC>
__device__ __forceinline__ void store_unit_any(const float (&v)[VEC], const Scale& sc, int8_t* qp, float* rp) {
  if (sc.fast) {
    store_unit<VEC, true>(v, sc, qp, rp);
  } else {
    store_unit<VEC, false>(v, sc, qp, rp);
  }
}

// the held units' codes and residual, from registers: unit tid + j * T of
// the span that starts at element `base`, for j < units while under held
template <int VEC, int UNITS, bool FAST>
__device__ __forceinline__ void store_held(const float (&v)[UNITS][VEC], const Scale& sc, int units, int held,
                                           int base, int8_t* q, float* r_out) {
#pragma unroll
  for (int j = 0; j < UNITS; ++j) {
    const int u = threadIdx.x + j * blockDim.x;
    if (j < units && u < held) store_unit<VEC, FAST>(v[j], sc, q + base + u * VEC, r_out + base + u * VEC);
  }
}

// Hopper's split cluster barrier: a block arrives once its slots are set
// and waits before it pushes into the other blocks' slots, so that every
// block of the cluster has started and set its slots by then
__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory"); }

constexpr unsigned kEmptySlot = 0xffffffffu;  // a NaN with its sign set: no |v| maximum is one

// the cluster's maximum from each block's m: block `rank` stores m into
// slots[rank] of every block of the cluster (distributed shared memory),
// then every warp polls its own block's slots until all are filled and
// takes their maximum (exact in any order); no block reads another's
// shared memory, so none waits for the others before it exits
__device__ __forceinline__ float cluster_abs_max(float m, unsigned* slots, int rank, int blocks) {
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31;
  cluster_wait();
  if (tid < blocks) {
    *reinterpret_cast<volatile unsigned*>(cluster.map_shared_rank(&slots[rank], tid)) = __float_as_uint(m);
  }
  unsigned c = 0;  // +0.0f
  if (lane < blocks) {
    const volatile unsigned* mine = slots;
    do {
      c = mine[lane];
    } while (c == kEmptySlot);
  }
  float f = __uint_as_float(c);
  for (int d = kMaxQuantCluster / 2; d > 0; d >>= 1) f = abs_max(f, __shfl_xor_sync(kFull, f, d));
  return __shfl_sync(kFull, f, 0);
}

// Block (s, rank) of the grid (segments x cluster): rank's span of segment
// s's whole units; each thread holds up to `units` of them (t, t + T, ...)
// in registers, the span's rest past them goes through the loop.
template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxQuantThreads)
    quantize_int8_ef_kernel(const T* __restrict__ g, const float* r, QuantSegments segs, int units,
                            const float* __restrict__ inv, const float* __restrict__ finite,
                            const float* __restrict__ scale_in, int8_t* __restrict__ q, float* __restrict__ scales,
                            float* r_out) {
  constexpr int kUnits = VEC == 8 ? kMaxUnitsWide : kMaxUnitsScalar;
  __shared__ float warp_max[kMaxQuantWarps];
  __shared__ unsigned slots[kMaxQuantCluster];
  const int s = blockIdx.x, rank = blockIdx.y, blocks = gridDim.y;
  const int tid = threadIdx.x, threads = blockDim.x;
  if (blocks > 1) {
    if (tid < kMaxQuantCluster) slots[tid] = kEmptySlot;
    cluster_arrive();
  }
  // the loss scale's unscale and gate (none: 1 and finite)
  const float iv = inv != nullptr ? __ldg(inv) : 1.0f;
  const bool ok = finite == nullptr || __ldg(finite) > 0.5f;
  const int begin = segs.off[s], end = segs.off[s + 1];
  const int head = min(end - begin, (VEC - begin % VEC) % VEC);  // scalar elements before the first unit
  const int body = begin + head;
  const int seg_units = (end - body) / VEC;
  const int body_end = body + seg_units * VEC;  // the scalar tail [body_end, end)
  const int span = (seg_units + blocks - 1) / blocks;
  const int u0 = min(seg_units, rank * span), u1 = min(seg_units, u0 + span);
  const int held = min(u1 - u0, threads * units);

  // every load of the held units (and of this thread's head or tail
  // element) first
  Unit<T, VEC> raw[kUnits];
#pragma unroll
  for (int j = 0; j < kUnits; ++j) {
    const int u = tid + j * threads;
    if (j < units && u < held) {
      const int i = body + (u0 + u) * VEC;
      raw[j].load(g + i, r + i);
    }
  }
  int edge = -1;
  if (rank == 0) {
    if (tid < head) {
      edge = begin + tid;
    } else if (tid >= kEdgeThread && tid - kEdgeThread < end - body_end) {
      edge = body_end + tid - kEdgeThread;
    }
  }
  T edge_g{};
  float edge_r = 0.f;
  if (edge >= 0) {
    edge_g = g[edge];
    edge_r = r[edge];
  }

  if (!ok) {  // an overflow step: zero codes, zero scales, the residual kept
    if (blocks > 1) cluster_wait();  // the arrive above is matched
#pragma unroll
    for (int j = 0; j < kUnits; ++j) {
      const int u = tid + j * threads;
      if (j < units && u < held) zero_unit<VEC>(q + body + (u0 + u) * VEC);
    }
    if (edge >= 0) q[edge] = 0;
    for (int u = held + tid; u < u1 - u0; u += threads) zero_unit<VEC>(q + body + (u0 + u) * VEC);
    if (rank == 0 && tid == 0) {
      scales[s] = 0.0f;
      if (s == 0) scales[gridDim.x] = 0.0f;
    }
    return;
  }

  // the maximum: the span's rest past the registers (read here once for
  // it), the held units, the edge element; none at a shared scale
  const bool shared = scale_in != nullptr;
  float m = 0.0f;
  for (int u = held + tid; !shared && u < u1 - u0; u += threads) {
    const int i = body + (u0 + u) * VEC;
    Unit<T, VEC> x;
    x.load(g + i, r + i);
    float v[VEC];
    x.sum(v, iv);
#pragma unroll
    for (int k = 0; k < VEC; ++k) m = abs_max(m, fabsf(v[k]));
  }
  float v[kUnits][VEC];
#pragma unroll
  for (int j = 0; j < kUnits; ++j) {
    if (j < units && tid + j * threads < held) {
      raw[j].sum(v[j], iv);
#pragma unroll
      for (int k = 0; k < VEC; ++k) m = abs_max(m, fabsf(v[j][k]));
    }
  }
  const float ev = __fadd_rn(__fmul_rn(persia::to_f32(edge_g), iv), edge_r);
  if (edge >= 0) m = abs_max(m, fabsf(ev));

  // the block's maximum (warp shuffles, then the warps in shared memory),
  // then the cluster's, pushed through distributed shared memory; or the
  // caller's scale
  if (shared) {
    if (blocks > 1) cluster_wait();  // the arrive above is matched
    m = __ldg(scale_in + s);
  } else {
    for (int d = 16; d > 0; d >>= 1) m = abs_max(m, __shfl_xor_sync(kFull, m, d));
    if ((tid & 31) == 0) warp_max[tid >> 5] = m;
    __syncthreads();
    m = warp_max[0];
    for (int w = 1; w < (threads >> 5); ++w) m = abs_max(m, warp_max[w]);
    if (blocks > 1) m = cluster_abs_max(m, slots, rank, blocks);
  }
  const Scale sc = make_scale(m);
  if (rank == 0 && tid == 0) {
    scales[s] = sc.scale;
    if (finite != nullptr && s == 0) scales[gridDim.x] = 1.0f;  // the finite tail
  }
  if (q == nullptr) return;  // the scales alone

  // the codes and the residual: the held units from registers, the edge
  // element, then the span's rest read a second time
  if (sc.fast) {
    store_held<VEC, kUnits, true>(v, sc, units, held, body + u0 * VEC, q, r_out);
  } else {
    store_held<VEC, kUnits, false>(v, sc, units, held, body + u0 * VEC, q, r_out);
  }
  if (edge >= 0) {
    float e[1] = {ev};
    store_unit_any<1>(e, sc, q + edge, r_out + edge);
  }
  for (int u = held + tid; u < u1 - u0; u += threads) {
    const int i = body + (u0 + u) * VEC;
    Unit<T, VEC> x;
    x.load(g + i, r + i);
    float w[VEC];
    x.sum(w, iv);
    store_unit_any<VEC>(w, sc, q + i, r_out + i);
  }
}

// the plan's numbers against what the kernel was compiled for: vec 8
// (g, r and r' on 16 bytes, q on 8) or 1; threads a multiple of 32 up to
// kMaxQuantThreads; units 1 to kMaxUnitsWide (kMaxUnitsScalar); cluster
// 1 to kMaxQuantCluster
int check_plan(int vec, int threads, int units, int cluster, const void* g, const float* r, const int8_t* q,
               const float* r_out) {
  if (vec != 1 && vec != 8) return cudaErrorInvalidValue;
  if (vec == 8 && !(on_boundary(g, 16) && on_boundary(r, 16) && on_boundary(r_out, 16) && on_boundary(q, 8))) {
    return cudaErrorInvalidValue;
  }
  if (threads < 32 || threads > kMaxQuantThreads || threads % 32 != 0) return cudaErrorInvalidValue;
  if (units < 1 || units > (vec == 8 ? kMaxUnitsWide : kMaxUnitsScalar)) return cudaErrorInvalidValue;
  if (cluster < 1 || cluster > kMaxQuantCluster) return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

// g (n,) f32 or bf16 (dtype: persia::DType); offsets: host (segments + 1,)
// int32, ascending from 0 to n; r, r_out (n,) f32 (r_out may be r); inv
// and finite: both null, or device f32 scalars (the loss scale's); q (n,)
// int8; scales (segments,) f32, (segments + 1,) with finite; vec,
// threads, units, cluster: the plan. Returns a CUDA error code.
static int launch_quantize(const void* g, int dtype, const float* r, const int* offsets, int segments,
                           const float* inv, const float* finite, const float* scale_in, int8_t* q, float* scales,
                           float* r_out, int vec, int threads, int units, int cluster, void* stream) {
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
  // q null (the scales alone) asks for no residual and no shared scale
  const bool scales_only = q == nullptr;
  if (offsets[segments] > 0 && (g == nullptr || r == nullptr || (!scales_only && r_out == nullptr))) {
    return cudaErrorInvalidValue;
  }
  if (scales == nullptr || (inv == nullptr) != (finite == nullptr)) return cudaErrorInvalidValue;
  if (scales_only && (scale_in != nullptr || r_out != nullptr)) return cudaErrorInvalidValue;
  int rc = check_plan(vec, threads, units, cluster, g, r, scales_only ? reinterpret_cast<const int8_t*>(r) : q,
                      scales_only ? r : r_out);
  if (rc != cudaSuccess) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PERSIA_QUANT(T, V)                                                                                    \
  rc = launch_clusters(quantize_int8_ef_kernel<T, V>, segments, cluster, threads, st, static_cast<const T*>(g), \
                       r, segs, units, inv, finite, scale_in, q, scales, r_out)
  if (dtype == persia::kFloat32) {
    if (vec == 8) PERSIA_QUANT(float, 8); else PERSIA_QUANT(float, 1);
  } else {
    if (vec == 8) PERSIA_QUANT(__nv_bfloat16, 8); else PERSIA_QUANT(__nv_bfloat16, 1);
  }
#undef PERSIA_QUANT
  return rc != cudaSuccess ? rc : static_cast<int>(cudaGetLastError());
}

extern "C" int persia_quantize_int8_ef(const void* g, int dtype, const float* r, const int* offsets, int segments,
                                       const float* inv, const float* finite, int8_t* q, float* scales,
                                       float* r_out, int vec, int threads, int units, int cluster, void* stream) {
  if (q == nullptr) return cudaErrorInvalidValue;
  return launch_quantize(g, dtype, r, offsets, segments, inv, finite, nullptr, q, scales, r_out, vec, threads, units,
                         cluster, stream);
}

// At a shared scale: q null writes the scales alone (scale_in and r_out
// null); else scale_in (segments,) f32 on the device gives each segment's
// scale. No loss-scale gate (inv and finite null).
extern "C" int persia_quantize_int8_ef_shared(const void* g, int dtype, const float* r, const int* offsets,
                                              int segments, const float* scale_in, int8_t* q, float* scales,
                                              float* r_out, int vec, int threads, int units, int cluster,
                                              void* stream) {
  if (q != nullptr && scale_in == nullptr) return cudaErrorInvalidValue;
  return launch_quantize(g, dtype, r, offsets, segments, nullptr, nullptr, scale_in, q, scales, r_out, vec, threads,
                         units, cluster, stream);
}
