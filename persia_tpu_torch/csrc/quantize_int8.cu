// The cache tier's int8 parameter-server gradient wire (K15): absmax int8
// quantization with error feedback, one scale a segment (a PS slot's
// gradient). Its two dense-sync modes (the segments' scales alone, and the
// codes at a shared scale) are flat passes of their own, further down.
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

#include <climits>
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

// max(m, 1e-30), NaN kept
__device__ __forceinline__ float scale_floor(float m) { return (m > 1e-30f || m != m) ? m : 1e-30f; }

__device__ __forceinline__ Scale make_scale(float m) {
  Scale sc;
  sc.scale = scale_floor(m);
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

// a unit's codes: one 8-byte store of 8 int8 (K15), two 16-byte stores of
// 8 int32 (the dense sync's, which its sum takes as they are), or one
// element
__device__ __forceinline__ void store_codes(int8_t* qp, const int8_t (&c)[8]) {
  uint2 packed;
  packed.x = (static_cast<uint8_t>(c[0])) | (static_cast<uint8_t>(c[1]) << 8) |
             (static_cast<uint8_t>(c[2]) << 16) | (static_cast<unsigned>(static_cast<uint8_t>(c[3])) << 24);
  packed.y = (static_cast<uint8_t>(c[4])) | (static_cast<uint8_t>(c[5]) << 8) |
             (static_cast<uint8_t>(c[6]) << 16) | (static_cast<unsigned>(static_cast<uint8_t>(c[7])) << 24);
  *reinterpret_cast<uint2*>(qp) = packed;
}
__device__ __forceinline__ void store_codes(int32_t* qp, const int8_t (&c)[8]) {
  reinterpret_cast<int4*>(qp)[0] = make_int4(c[0], c[1], c[2], c[3]);
  reinterpret_cast<int4*>(qp)[1] = make_int4(c[4], c[5], c[6], c[7]);
}
template <typename Q>
__device__ __forceinline__ void store_codes(Q* qp, const int8_t (&c)[1]) {
  *qp = c[0];
}

// a unit's codes and new residual (two float4, or one element)
template <int VEC, typename Q>
__device__ __forceinline__ void store_coded(const int8_t (&c)[VEC], const float (&out)[VEC], Q* qp, float* rp) {
  store_codes(qp, c);
  if constexpr (VEC == 8) {
    store_as(rp, out);
  } else {
    *rp = out[0];
  }
}

// a unit's codes and new residual at one scale
template <int VEC, bool FAST, typename Q>
__device__ __forceinline__ void store_unit(const float (&v)[VEC], const Scale& sc, Q* qp, float* rp) {
  int8_t c[VEC];
  float out[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) out[k] = quantize<FAST>(v[k], sc, c[k]);
  store_coded<VEC>(c, out, qp, rp);
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
template <int VEC, typename Q>
__device__ __forceinline__ void store_unit_any(const float (&v)[VEC], const Scale& sc, Q* qp, float* rp) {
  if (sc.fast) {
    store_unit<VEC, true>(v, sc, qp, rp);
  } else {
    store_unit<VEC, false>(v, sc, qp, rp);
  }
}

// the held units' codes and residual, from registers: unit tid + j * T of
// the span that starts at element `base`, for j < units while under held
template <int VEC, int UNITS, bool FAST, typename Q>
__device__ __forceinline__ void store_held(const float (&v)[UNITS][VEC], const Scale& sc, int units, int held,
                                           int base, Q* q, float* r_out) {
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
                            int8_t* __restrict__ q, float* __restrict__ scales, float* r_out) {
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
  // it), the held units, the edge element
  float m = 0.0f;
  for (int u = held + tid; u < u1 - u0; u += threads) {
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
  // then the cluster's, pushed through distributed shared memory
  for (int d = 16; d > 0; d >>= 1) m = abs_max(m, __shfl_xor_sync(kFull, m, d));
  if ((tid & 31) == 0) warp_max[tid >> 5] = m;
  __syncthreads();
  m = warp_max[0];
  for (int w = 1; w < (threads >> 5); ++w) m = abs_max(m, warp_max[w]);
  if (blocks > 1) m = cluster_abs_max(m, slots, rank, blocks);
  const Scale sc = make_scale(m);
  if (rank == 0 && tid == 0) {
    scales[s] = sc.scale;
    if (finite != nullptr && s == 0) scales[gridDim.x] = 1.0f;  // the finite tail
  }

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

// The offsets into the kernel's by-value parameter: (segments + 1,)
// ascending from 0, at most kMaxQuantSegments segments, gradients f32 or
// bf16.
int copy_segments(const int* offsets, int segments, int dtype, QuantSegments& segs) {
  if (segments < 0 || segments > kMaxQuantSegments || offsets == nullptr || offsets[0] != 0 ||
      (dtype != persia::kFloat32 && dtype != persia::kBFloat16)) {
    return cudaErrorInvalidValue;
  }
  for (int s = 0; s <= segments; ++s) {
    if (s > 0 && offsets[s] < offsets[s - 1]) return cudaErrorInvalidValue;
    segs.off[s] = offsets[s];
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// K15's two dense-sync modes (the bytegrad all-reduce), as flat passes over
// every SM.
//
// segment_absmax writes each segment's max(max |g + r|, 1e-30) (NaN if some
// v is NaN), which the caller all-reduces with MAX; quantize_int8_shared
// codes each segment at max(scale_in[s], 1e-30) instead of its own maximum
// and writes the codes (as int32, which the sum on the wire takes), the
// scales and the residual over r, each element as K15 codes it (the same
// make_scale, divide and quantize; persia_tpu/parallel/grad_sync.py:279-297,
// quantize_int8_ef(g, r, scale=pmax(...)) a leaf at a time). No loss-scale
// gate.
//
// Replaces: persia_tpu/parallel/grad_sync.py:290-291 (the leaf's absmax
// before its pmax) and :294-295 (quantize_int8_ef at the shared scale, and
// the cast of the codes to int32): XLA ops, no Pallas kernel.
//
// Bound on the H100: bytes. segment_absmax reads g and r once (8 bytes an
// element at f32); the quantize reads them and writes the codes and r' (13
// bytes an element with the int32 codes). At the bench DLRM
// tower's 341,073 f32 that is 2.7 MB (0.00081 ms) and 5.5 MB (0.00163 ms).
//
// Design. Both split the flat vector, not its segments, into equal spans
// of whole 8-element units that line up with the tensor's start (plans.
// flat_quant_plan): the tower's leaves run from 1 to 187,904 elements, and
// the cluster a segment K15 gives its own path put 93.5 % of the bytes on
// 16 of the 132 SMs. Here a CTA takes a span, the grid fills one wave of
// the SMs (132 CTAs at the tower), and each thread issues all of its loads
// at the top (units t, t + T, ... of the span; a 16-byte load of g a unit
// at bf16, two at f32; two float4 of r). The n % 8 elements past the last
// whole unit go to the last CTA's first threads, one each; a tensor off 16
// bytes takes units of one element. Segments are found by warp ballots
// over the offsets that the lanes load at the top (WarpSegments), with no
// chain of dependent loads: a CTA whose span lies in one segment (126 of
// the tower's 132) finds it once; a CTA across segments finds, for each
// warp's slot of 32 units, the segments of its first and last element,
// and only a slot across a boundary looks further, a lane its own unit;
// a unit across a boundary is spread over 8 lanes, an element each.
//
// segment_absmax combines the CTAs' maxima exactly in the same launch: the
// bits of a non-negative float order as an unsigned int does, and |NaN|
// sorts above +inf, so an atomicMax on the bits of |v| into a scratch word
// a segment is the exact maximum, with NaN winning as amax has it. A CTA in
// one segment reduces with __reduce_max_sync and one barrier and makes one
// atomic; a CTA across segments gathers its segments' maxima in shared
// memory first, one atomic a warp's slot. The last CTA to take a ticket
// (after __threadfence) applies the 1e-30 floor, writes the scales, and
// sets the scratch and the ticket back to zero for the next launch, so no
// memset runs before it. The wrapper keeps one scratch a (device, stream)
// and, in a CUDA graph, one a (device, stream, capture), zeroed by a fill
// node of that graph: no two launches that may overlap share one.
// The ticket's chain (the maximum's atomic, the fence, the ticket, the last
// CTA's reads) is most of what the kernel takes past a plain read of its
// inputs; a cooperative launch's grid barrier would take the same round
// trips and was not measured.
//
// The quantize is elementwise given scale_in: lane l loads scale_in[l] at
// the top, a CTA in one segment takes its scale by shuffle (no load waits
// on the lookup) and writes each element's code and residual from
// registers, with no maximum, no cluster and no barrier; a CTA across
// segments makes their scales once in shared memory behind one barrier.
constexpr int kFlatMaxThreads = 512;  // plans.FLAT_QUANT_MAX_THREADS
constexpr int kFlatMaxWarps = kFlatMaxThreads / 32;
constexpr int kTicket = kMaxQuantSegments;  // the scratch's last word

// the segment of element e in [lo, hi): the s with off[s] <= e < off[s + 1],
// given off[lo] <= e < off[hi] (empty segments are passed over); a lane's
// own search, for the few units at a boundary
__device__ __forceinline__ int find_segment(const int* off, int lo, int hi, int e) {
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (off[mid] <= e) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Segments found by a warp without dependent loads: lane l holds boundary
// off[l + 1] (past the first 32, a chunk of 32 is read at a time), and the
// segment of an element e that every lane asks about is the count of
// boundaries off[1..S] at or below it, one ballot a chunk. (Binary searches
// read the offsets in chains of dependent loads, which both kernels would
// wait on.)
struct WarpSegments {
  const int* off;
  int segments, mine;

  __device__ __forceinline__ WarpSegments(const int* off_, int segments_) : off(off_), segments(segments_) {
    const int lane = threadIdx.x & 31;
    mine = lane < segments ? off[lane + 1] : INT_MAX;
  }
  // the segment of element e < n, the same e in every lane of the warp
  __device__ __forceinline__ int of(int e) const {
    int s = __popc(__ballot_sync(kFull, mine <= e));
    for (int c = 33; c <= segments; c += 32) {
      const int k = c + static_cast<int>(threadIdx.x & 31);
      s += __popc(__ballot_sync(kFull, k <= segments && off[k] <= e));
    }
    return s;
  }
};

// scale_in[s] for a segment s that every lane of the warp asks about: lane
// l loaded scale_in[l] at the kernel's top (own), so the first 32 segments'
// scales come by shuffle, with no load after the lookup
__device__ __forceinline__ float warp_scale(int s, float own, const float* __restrict__ scale_in) {
  const float x = __shfl_sync(kFull, own, s & 31);
  return s < 32 ? x : __ldg(scale_in + s);
}

// The span of CTA b, before any load: whole units [u0, u0 + held) and, in
// the last CTA, the tail elements [whole * VEC, n) (thread t < tail takes
// one); its elements are [e0, e1).
template <int VEC>
struct FlatSpan {
  int u0, held, tail, e0, e1;

  __device__ __forceinline__ FlatSpan(int n, int span) {
    const int whole = n / VEC, b = blockIdx.x;
    u0 = b * span;
    held = max(0, min(whole, u0 + span) - u0);
    const bool last = b == static_cast<int>(gridDim.x) - 1;
    tail = last ? n - whole * VEC : 0;
    e0 = u0 * VEC;
    e1 = last ? n : (u0 + held) * VEC;
  }
  __device__ __forceinline__ int tail_element() const { return e1 - tail + static_cast<int>(threadIdx.x); }
};

// A warp's units of slot j of a span (units first + lane, lane < valid) and
// the segments of their first and last element; valid <= 0 (or j < 0): none
template <int VEC>
struct WarpSlot {
  int first, valid, s_lo, s_hi;

  __device__ __forceinline__ WarpSlot(const FlatSpan<VEC>& sp, const WarpSegments& ws, int j) {
    const int warp = threadIdx.x >> 5;
    first = warp * 32 + j * static_cast<int>(blockDim.x);
    valid = j < 0 ? 0 : min(32, sp.held - first);
    s_lo = s_hi = 0;
    if (valid > 0) {
      s_lo = ws.of((sp.u0 + first) * VEC);
      s_hi = ws.of((sp.u0 + first + valid) * VEC - 1);
    }
  }
};

// Element k of the unit that lane src holds (v), in lane k < VEC: a unit at
// a boundary is spread over the warp's first VEC lanes, which each take
// their element through the scalar path, in parallel (one lane walking all
// VEC elements would hold its CTA, as at the tower's 1-element leaf)
template <int VEC>
__device__ __forceinline__ float spread_element(const float (&v)[VEC], int src) {
  float x = 0.0f;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const float vk = __shfl_sync(kFull, v[k], src);
    if ((threadIdx.x & 31) == k) x = vk;
  }
  return x;
}

// the bits of |v| (non-negative: they order as the numbers do, NaN on top)
__device__ __forceinline__ unsigned abs_bits(float v) { return __float_as_uint(fabsf(v)); }

// Scratch: (kMaxQuantSegments + 1,) words, zero between launches: each
// segment's maximum |v| as bits, then the ticket. CTA b's maxima go into it
// by atomicMax; the last CTA writes the scales and zeroes it.
template <typename T, int VEC>
__global__ void __launch_bounds__(kFlatMaxThreads, 1)
    segment_absmax_kernel(const T* __restrict__ g, const float* __restrict__ r, const __grid_constant__ QuantSegments segs,
                          int segments, int n, int span, int units, unsigned* __restrict__ scratch,
                          float* __restrict__ scales) {
  constexpr int kUnits = VEC == 8 ? kMaxUnitsWide : kMaxUnitsScalar;
  __shared__ unsigned warp_max[kFlatMaxWarps];
  __shared__ unsigned seg_max[kMaxQuantSegments];  // a CTA across segments: |v| bits + 1, 0 untouched
  const int tid = threadIdx.x, threads = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int* off = segs.off;
  const FlatSpan<VEC> sp(n, span);

  // every load first: the lane's boundary, the held units, the tail element
  const WarpSegments ws(off, segments);
  Unit<T, VEC> raw[kUnits];
#pragma unroll
  for (int j = 0; j < kUnits; ++j) {
    const int u = tid + j * threads;
    if (j < units && u < sp.held) raw[j].load(g + (sp.u0 + u) * VEC, r + (sp.u0 + u) * VEC);
  }
  const bool has_tail = tid < sp.tail;
  float tv = 0.0f;
  if (has_tail) tv = __fadd_rn(persia::to_f32(g[sp.tail_element()]), r[sp.tail_element()]);

  const int s_first = sp.e1 > sp.e0 ? ws.of(sp.e0) : 0;
  const int s_last = sp.e1 > sp.e0 ? ws.of(sp.e1 - 1) : 0;
  if (s_first == s_last) {  // the span in one segment (or empty): one maximum
    unsigned m = has_tail ? abs_bits(tv) : 0u;
#pragma unroll
    for (int j = 0; j < kUnits; ++j) {
      if (j < units && tid + j * threads < sp.held) {
        float v[VEC];
        raw[j].sum(v, 1.0f);
#pragma unroll
        for (int k = 0; k < VEC; ++k) m = max(m, abs_bits(v[k]));
      }
    }
    m = __reduce_max_sync(kFull, m);
    if (lane == 0) warp_max[warp] = m;
    __syncthreads();
    if (warp != 0) return;
    m = lane < (threads >> 5) ? warp_max[lane] : 0u;
    m = __reduce_max_sync(kFull, m);
    if (lane == 0 && sp.e1 > sp.e0) atomicMax(scratch + s_first, m);
  } else {  // across segments: a warp's slot in one segment makes one shared atomic, a unit at a boundary its own
    const int count = s_last - s_first + 1;
    for (int i = tid; i < count; i += threads) seg_max[i] = 0u;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kUnits; ++j) {
      const WarpSlot<VEC> ww(sp, ws, j < units ? j : -1);
      const int e = (sp.u0 + ww.first + lane) * VEC;
      unsigned m = 0u;
      float v[VEC];
      if (lane < ww.valid) {
        raw[j].sum(v, 1.0f);
#pragma unroll
        for (int k = 0; k < VEC; ++k) m = max(m, abs_bits(v[k]));
      }
      if (ww.valid > 0 && ww.s_lo == ww.s_hi) {
        m = __reduce_max_sync(kFull, m);
        if (lane == 0) atomicMax(seg_max + (ww.s_lo - s_first), m + 1u);
      } else if (ww.valid > 0) {
        bool at_boundary = false;
        if (lane < ww.valid) {
          const int s = find_segment(off, ww.s_lo, ww.s_hi + 1, e);
          at_boundary = off[s + 1] < e + VEC;
          if (!at_boundary) atomicMax(seg_max + (s - s_first), m + 1u);
        }
        if constexpr (VEC > 1) {  // each unit at a boundary spread over lanes 0 to VEC - 1
          for (unsigned b = __ballot_sync(kFull, at_boundary); b != 0u; b &= b - 1u) {
            const int src = __ffs(b) - 1;
            const float x = spread_element<VEC>(v, src);
            const int ek = __shfl_sync(kFull, e, src) + lane;
            if (lane < VEC) atomicMax(seg_max + (find_segment(off, ww.s_lo, ww.s_hi + 1, ek) - s_first), abs_bits(x) + 1u);
          }
        }
      }
    }
    if (warp == 0 && sp.tail > 0) {  // the tail, in warp 0's first lanes
      const int s_lo = ws.of(sp.e1 - sp.tail), s_hi = ws.of(sp.e1 - 1);
      if (has_tail) {
        const int s = s_lo == s_hi ? s_lo : find_segment(off, s_lo, s_hi + 1, sp.tail_element());
        atomicMax(seg_max + (s - s_first), abs_bits(tv) + 1u);
      }
    }
    __syncthreads();
    if (warp != 0) return;
    for (int i = lane; i < count; i += 32) {
      const unsigned m = seg_max[i];
      if (m != 0u) atomicMax(scratch + s_first + i, m - 1u);
    }
  }

  // warp 0: the ticket; the last CTA's warp 0 writes the scales and zeroes
  // the scratch
  __threadfence();
  __syncwarp();
  unsigned ticket = 0u;
  if (lane == 0) ticket = atomicAdd(scratch + kTicket, 1u);
  ticket = __shfl_sync(kFull, ticket, 0);
  if (ticket != gridDim.x - 1) return;
  __threadfence();
  for (int s = lane; s < segments; s += 32) {
    scales[s] = scale_floor(__uint_as_float(atomicExch(scratch + s, 0u)));
  }
  if (lane == 0) atomicExch(scratch + kTicket, 0u);
}

// Codes (int32) and the residual at scale_in's scales; CTA 0 also writes
// the (S,) scales.
template <typename T, int VEC>
__global__ void __launch_bounds__(kFlatMaxThreads, 1)
    quantize_int8_shared_kernel(const T* __restrict__ g, const float* r, const __grid_constant__ QuantSegments segs,
                                int segments, int n, int span, int units, const float* __restrict__ scale_in,
                                int32_t* __restrict__ q, float* __restrict__ scales, float* r_out) {
  constexpr int kUnits = VEC == 8 ? kMaxUnitsWide : kMaxUnitsScalar;
  __shared__ Scale seg_scale[kMaxQuantSegments];  // a CTA across segments: its segments' scales
  const int tid = threadIdx.x, threads = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int* off = segs.off;
  const FlatSpan<VEC> sp(n, span);

  // every load first: the lane's boundary and scale, the held units, the
  // tail element
  const WarpSegments ws(off, segments);
  const float own = lane < segments ? __ldg(scale_in + lane) : 0.0f;
  Unit<T, VEC> raw[kUnits];
#pragma unroll
  for (int j = 0; j < kUnits; ++j) {
    const int u = tid + j * threads;
    if (j < units && u < sp.held) raw[j].load(g + (sp.u0 + u) * VEC, r + (sp.u0 + u) * VEC);
  }
  const bool has_tail = tid < sp.tail;
  float tv[1] = {0.0f};
  if (has_tail) tv[0] = __fadd_rn(persia::to_f32(g[sp.tail_element()]), r[sp.tail_element()]);

  if (blockIdx.x == 0) {  // s < 32 only in warp 0, lane s: its own
    for (int s = tid; s < segments; s += threads) scales[s] = scale_floor(s < 32 ? own : __ldg(scale_in + s));
  }
  if (sp.e1 <= sp.e0) return;
  const int s_first = ws.of(sp.e0), s_last = ws.of(sp.e1 - 1);
  const int base = sp.u0 * VEC;
  if (s_first == s_last) {  // the span in one segment: one scale
    const Scale sc = make_scale(warp_scale(s_first, own, scale_in));
    float v[kUnits][VEC];
#pragma unroll
    for (int j = 0; j < kUnits; ++j) {
      if (j < units && tid + j * threads < sp.held) raw[j].sum(v[j], 1.0f);
    }
    if (sc.fast) {
      store_held<VEC, kUnits, true>(v, sc, units, sp.held, base, q, r_out);
    } else {
      store_held<VEC, kUnits, false>(v, sc, units, sp.held, base, q, r_out);
    }
    if (has_tail) store_unit_any<1>(tv, sc, q + sp.tail_element(), r_out + sp.tail_element());
    return;
  }
  // across segments (a CTA-uniform branch): the scales of the CTA's
  // segments made once, in shared memory, so that no lane waits on a load
  // after its lookup; a warp's slot in one segment takes one, a unit at a
  // boundary each element's own
  const int count = s_last - s_first + 1;
  if (warp == 0) {
    for (int i = lane; i - lane < count; i += 32) {
      const float x = warp_scale(min(s_first + i, segments - 1), own, scale_in);
      if (i < count) seg_scale[i] = make_scale(x);
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kUnits; ++j) {
    const WarpSlot<VEC> ww(sp, ws, j < units ? j : -1);
    const int e = (sp.u0 + ww.first + lane) * VEC;
    float v[VEC];
    bool at_boundary = false;
    if (lane < ww.valid) {
      raw[j].sum(v, 1.0f);
      const int s = ww.s_lo == ww.s_hi ? ww.s_lo : find_segment(off, ww.s_lo, ww.s_hi + 1, e);
      at_boundary = off[s + 1] < e + VEC;
      if (!at_boundary) store_unit_any<VEC>(v, seg_scale[s - s_first], q + e, r_out + e);
    }
    if constexpr (VEC > 1) {  // each unit at a boundary spread over lanes 0 to VEC - 1
      for (unsigned b = __ballot_sync(kFull, at_boundary); b != 0u; b &= b - 1u) {
        const int src = __ffs(b) - 1;
        float x[1] = {spread_element<VEC>(v, src)};
        const int ek = __shfl_sync(kFull, e, src) + lane;
        if (lane < VEC) {
          store_unit_any<1>(x, seg_scale[find_segment(off, ww.s_lo, ww.s_hi + 1, ek) - s_first], q + ek, r_out + ek);
        }
      }
    }
  }
  if (warp == 0 && sp.tail > 0) {  // the tail, in warp 0's first lanes
    const int s_lo = ws.of(sp.e1 - sp.tail), s_hi = ws.of(sp.e1 - 1);
    if (has_tail) {
      const int e = sp.tail_element();
      const int s = s_lo == s_hi ? s_lo : find_segment(off, s_lo, s_hi + 1, e);
      store_unit_any<1>(tv, seg_scale[s - s_first], q + e, r_out + e);
    }
  }
}

// the flat plan's numbers against what the kernels were compiled for and
// the tensors: vec 8 (g, r, r' and the int32 codes on 16 bytes) or 1; threads a multiple of 32 up to kFlatMaxThreads; units
// 1 to kMaxUnitsWide (kMaxUnitsScalar); each CTA's span within its
// threads' units; grid the spans that cover the whole units (1 at least)
int check_flat_plan(int n, int vec, int threads, int units, int span, int grid, const void* g, const float* r,
                    const void* q, const float* r_out) {
  if (vec != 1 && vec != 8) return cudaErrorInvalidValue;
  if (vec == 8 && !(on_boundary(g, 16) && on_boundary(r, 16) && (r_out == nullptr || on_boundary(r_out, 16)) &&
                    (q == nullptr || on_boundary(q, 16)))) {
    return cudaErrorInvalidValue;
  }
  if (threads < 32 || threads > kFlatMaxThreads || threads % 32 != 0) return cudaErrorInvalidValue;
  if (units < 1 || units > (vec == 8 ? kMaxUnitsWide : kMaxUnitsScalar)) return cudaErrorInvalidValue;
  if (span < 1 || span > threads * units) return cudaErrorInvalidValue;
  const int whole = n / vec;
  if (grid != (whole > 0 ? (whole - 1) / span + 1 : 1)) return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

// g (n,) f32 or bf16 (dtype: persia::DType); offsets: host (segments + 1,)
// int32, ascending from 0 to n; r, r_out (n,) f32 (r_out may be r); inv
// and finite: both null, or device f32 scalars (the loss scale's); q (n,)
// int8; scales (segments,) f32, (segments + 1,) with finite; vec,
// threads, units, cluster: the plan. Returns a CUDA error code.
extern "C" int persia_quantize_int8_ef(const void* g, int dtype, const float* r, const int* offsets, int segments,
                                       const float* inv, const float* finite, int8_t* q, float* scales,
                                       float* r_out, int vec, int threads, int units, int cluster, void* stream) {
  QuantSegments segs;
  int rc = copy_segments(offsets, segments, dtype, segs);
  if (rc != cudaSuccess || segments == 0) return rc;
  if (offsets[segments] > 0 && (g == nullptr || r == nullptr || r_out == nullptr)) return cudaErrorInvalidValue;
  if (q == nullptr || scales == nullptr || (inv == nullptr) != (finite == nullptr)) return cudaErrorInvalidValue;
  rc = check_plan(vec, threads, units, cluster, g, r, q, r_out);
  if (rc != cudaSuccess) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PERSIA_QUANT(T, V)                                                                                    \
  rc = launch_clusters(quantize_int8_ef_kernel<T, V>, segments, cluster, threads, st, static_cast<const T*>(g), \
                       r, segs, units, inv, finite, q, scales, r_out)
  if (dtype == persia::kFloat32) {
    if (vec == 8) PERSIA_QUANT(float, 8); else PERSIA_QUANT(float, 1);
  } else {
    if (vec == 8) PERSIA_QUANT(__nv_bfloat16, 8); else PERSIA_QUANT(__nv_bfloat16, 1);
  }
#undef PERSIA_QUANT
  return rc != cudaSuccess ? rc : static_cast<int>(cudaGetLastError());
}

// K15's scales alone, flat: g (n,) f32 or bf16, r (n,) f32, offsets as
// above; scratch (kMaxQuantSegments + 1,) u32 on the device, all zero (it
// is left so), one a stream; scales (segments,) f32; vec, threads, units,
// span, grid: plans.flat_quant_plan.
extern "C" int persia_segment_absmax(const void* g, int dtype, const float* r, const int* offsets, int segments,
                                     unsigned* scratch, float* scales, int vec, int threads, int units, int span,
                                     int grid, void* stream) {
  QuantSegments segs;
  int rc = copy_segments(offsets, segments, dtype, segs);
  if (rc != cudaSuccess || segments == 0) return rc;
  const int n = offsets[segments];
  if ((n > 0 && (g == nullptr || r == nullptr)) || scratch == nullptr || scales == nullptr) {
    return cudaErrorInvalidValue;
  }
  rc = check_flat_plan(n, vec, threads, units, span, grid, g, r, nullptr, nullptr);
  if (rc != cudaSuccess) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PERSIA_ABSMAX(T, V) \
  segment_absmax_kernel<T, V><<<grid, threads, 0, st>>>(static_cast<const T*>(g), r, segs, segments, n, span, \
                                                         units, scratch, scales)
  if (dtype == persia::kFloat32) {
    if (vec == 8) PERSIA_ABSMAX(float, 8); else PERSIA_ABSMAX(float, 1);
  } else {
    if (vec == 8) PERSIA_ABSMAX(__nv_bfloat16, 8); else PERSIA_ABSMAX(__nv_bfloat16, 1);
  }
#undef PERSIA_ABSMAX
  return static_cast<int>(cudaGetLastError());
}

// Whether `stream` is capturing a CUDA graph (*capturing 1 or 0) and the
// capture's id (*id, 0 when it is not): segment_absmax's wrapper keys its
// scratch by them.
extern "C" int persia_stream_capture(void* stream, int* capturing, unsigned long long* id) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  unsigned long long cid = 0;
  const cudaError_t rc = cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &status, &cid);
  *capturing = rc == cudaSuccess && status == cudaStreamCaptureStatusActive;
  *id = *capturing ? cid : 0ull;
  return static_cast<int>(rc);
}

// K15 at a shared scale, flat: scale_in (segments,) f32 on the device; q
// (n,) int32; scales (segments,) f32; r_out may be r; the plan as above.
extern "C" int persia_quantize_int8_shared(const void* g, int dtype, const float* r, const int* offsets,
                                           int segments, const float* scale_in, int32_t* q, float* scales,
                                           float* r_out, int vec, int threads, int units, int span, int grid,
                                           void* stream) {
  QuantSegments segs;
  int rc = copy_segments(offsets, segments, dtype, segs);
  if (rc != cudaSuccess || segments == 0) return rc;
  const int n = offsets[segments];
  if ((n > 0 && (g == nullptr || r == nullptr || q == nullptr || r_out == nullptr)) || scale_in == nullptr ||
      scales == nullptr) {
    return cudaErrorInvalidValue;
  }
  rc = check_flat_plan(n, vec, threads, units, span, grid, g, r, q, r_out);
  if (rc != cudaSuccess) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PERSIA_SHARED(T, V)                                                                                   \
  quantize_int8_shared_kernel<T, V><<<grid, threads, 0, st>>>(static_cast<const T*>(g), r, segs, segments, n, \
                                                               span, units, scale_in, q, scales, r_out)
  if (dtype == persia::kFloat32) {
    if (vec == 8) PERSIA_SHARED(float, 8); else PERSIA_SHARED(float, 1);
  } else {
    if (vec == 8) PERSIA_SHARED(__nv_bfloat16, 8); else PERSIA_SHARED(__nv_bfloat16, 1);
  }
#undef PERSIA_SHARED
  return static_cast<int>(cudaGetLastError());
}
