// LowPrecisionDecentralized's sync mix (K18): the three reconstruction
// shadows advanced by the dequantized int8 deltas of this rank and of its
// two ring neighbours, and the parameters averaged with the neighbours'
// shadows, in place, in one pass.
//
// Input: the flat parameters x (n,) f32 and the shadows ss (this rank's),
// sl (the left neighbour's), sr (the right one's), (n,) f32 each; the int8
// codes q (this rank's, K15's), ql and qr (received from the left and the
// right), (n,) each; the segments' (leaves') offsets (S+1 ascending int32,
// off[0] = 0, off[S] = n; a segment may be empty) and each segment's
// scale s, s_l, s_r (S,) f32. For each element of segment k:
//   ss += q  * (s[k]   / 127)
//   sl += ql * (s_l[k] / 127)
//   sr += qr * (s_r[k] / 127)
//   x   = ((x + sl) + sr) / 3                      (the new sl and sr)
// Each quotient, product and sum is rounded on its own (__fdiv_rn,
// __fmul_rn, __fadd_rn): nvcc's default contraction would fuse a shadow's
// update into an FMA. So the kernel is bit for bit its plain version
// (ops/lp_ring.py::lp_ring_mix_reference), and rank i's sl bit for bit
// rank i - 1's ss (both add the same codes at the same scale to the same
// start). NaN and infinities pass through as IEEE arithmetic has them.
//
// Replaces: persia_tpu/parallel/grad_sync.py:445-453 (lp_ring_sync's
// ss + deq, sl + ql * (scl / 127), sr + qr * (scr / 127), (x + sl + sr) /
// 3, a leaf at a time): XLA ops, no Pallas kernel.
//
// Bound on the H100: bytes. x and the three shadows are read and written
// once (32 bytes an element) and the three codes read once (3): 35 bytes
// an element, ~12 operations. At the bench tower (341,073 elements) that is
// 11.9 MB, ~3.6 us at 3.35 TB/s.
//
// Design (ops/plans.py::lp_ring_mix_plan): a thread a unit of 4 elements
// where every f32 tensor starts on 16 bytes and every code tensor on 4
// (one float4 of each f32 tensor, one 4-byte word of each code tensor),
// else a thread an element; grid-stride over the units, the last n % 4
// elements to block 0's first threads. Each block copies the offsets (a
// by-value parameter) and the three scales / 127 into shared memory and
// finds a unit's segment by a binary search there; a unit that a segment
// boundary crosses takes its elements one at a time, each with its own
// segment.

#include <cstdint>

namespace {

constexpr int kMaxMixSegments = 512;  // plans.LP_MIX_MAX_SEGMENTS (K15's kMaxQuantSegments)
constexpr int kMixThreads = 256;      // plans.LP_MIX_THREADS

// The segments' offsets, passed by value (kernel parameters hold 4 KB).
struct MixSegments {
  int off[kMaxMixSegments + 1];
};

struct MixArgs {
  float* x;
  float* ss;
  float* sl;
  float* sr;
  const int8_t* q;
  const int8_t* ql;
  const int8_t* qr;
  const float* s;
  const float* s_l;
  const float* s_r;
  int segments;
  int n;
};

// The segment of element e: the last k with off[k] <= e (off[k + 1] > e
// then, so an empty segment is never chosen), by a search over the offsets
// in shared memory.
__device__ __forceinline__ int segment_of(const int* off, int segments, int e) {
  int lo = 0, hi = segments;  // off[lo] <= e < off[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (off[mid] <= e) lo = mid; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ float shadow(float base, int8_t code, float step) {
  return __fadd_rn(base, __fmul_rn(static_cast<float>(code), step));
}

__device__ __forceinline__ float mixed(float x, float l, float r) {
  return __fdiv_rn(__fadd_rn(__fadd_rn(x, l), r), 3.0f);
}

__device__ __forceinline__ void mix_one(const MixArgs& a, const float (*step)[kMaxMixSegments], int k, int e) {
  a.ss[e] = shadow(a.ss[e], a.q[e], step[0][k]);
  const float l = shadow(a.sl[e], a.ql[e], step[1][k]);
  const float r = shadow(a.sr[e], a.qr[e], step[2][k]);
  a.sl[e] = l;
  a.sr[e] = r;
  a.x[e] = mixed(a.x[e], l, r);
}

__device__ __forceinline__ void mix_unit(const MixArgs& a, const float (*step)[kMaxMixSegments], int k, int e) {
  float4* x4 = reinterpret_cast<float4*>(a.x + e);
  float4* ss4 = reinterpret_cast<float4*>(a.ss + e);
  float4* sl4 = reinterpret_cast<float4*>(a.sl + e);
  float4* sr4 = reinterpret_cast<float4*>(a.sr + e);
  const char4 q = *reinterpret_cast<const char4*>(a.q + e);
  const char4 ql = *reinterpret_cast<const char4*>(a.ql + e);
  const char4 qr = *reinterpret_cast<const char4*>(a.qr + e);
  const float4 x = *x4, ss = *ss4, sl = *sl4, sr = *sr4;
  const float st = step[0][k], stl = step[1][k], str = step[2][k];
  const float4 nss = make_float4(shadow(ss.x, q.x, st), shadow(ss.y, q.y, st), shadow(ss.z, q.z, st),
                                 shadow(ss.w, q.w, st));
  const float4 nsl = make_float4(shadow(sl.x, ql.x, stl), shadow(sl.y, ql.y, stl), shadow(sl.z, ql.z, stl),
                                 shadow(sl.w, ql.w, stl));
  const float4 nsr = make_float4(shadow(sr.x, qr.x, str), shadow(sr.y, qr.y, str), shadow(sr.z, qr.z, str),
                                 shadow(sr.w, qr.w, str));
  *ss4 = nss;
  *sl4 = nsl;
  *sr4 = nsr;
  *x4 = make_float4(mixed(x.x, nsl.x, nsr.x), mixed(x.y, nsl.y, nsr.y), mixed(x.z, nsl.z, nsr.z),
                    mixed(x.w, nsl.w, nsr.w));
}

template <int VEC>
__global__ void __launch_bounds__(kMixThreads) lp_ring_mix_kernel(const MixArgs a, const MixSegments segs) {
  __shared__ int off[kMaxMixSegments + 1];
  __shared__ float step[3][kMaxMixSegments];  // s / 127, s_l / 127, s_r / 127
  for (int k = threadIdx.x; k <= a.segments; k += blockDim.x) off[k] = segs.off[k];
  for (int k = threadIdx.x; k < a.segments; k += blockDim.x) {
    step[0][k] = __fdiv_rn(a.s[k], 127.0f);
    step[1][k] = __fdiv_rn(a.s_l[k], 127.0f);
    step[2][k] = __fdiv_rn(a.s_r[k], 127.0f);
  }
  __syncthreads();
  const int units = a.n / VEC;
  for (int u = blockIdx.x * blockDim.x + threadIdx.x; u < units; u += gridDim.x * blockDim.x) {
    const int e = u * VEC;
    const int k = segment_of(off, a.segments, e);
    if (VEC == 1) {
      mix_one(a, step, k, e);
    } else if (off[k + 1] >= e + VEC) {
      mix_unit(a, step, k, e);
    } else {  // a segment boundary inside the unit: each element its own segment
      for (int j = 0; j < VEC; ++j) mix_one(a, step, segment_of(off, a.segments, e + j), e + j);
    }
  }
  if (VEC > 1 && blockIdx.x == 0 && threadIdx.x < a.n - units * VEC) {
    const int e = units * VEC + threadIdx.x;
    mix_one(a, step, segment_of(off, a.segments, e), e);
  }
}

bool aligned(const void* p, uintptr_t bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

}  // namespace

// K18. x, ss, sl, sr (n,) f32, rewritten in place (none aliasing another);
// q, ql, qr (n,) int8; offsets: host (segments + 1,) int32, ascending from
// 0 to n, at most kMaxMixSegments segments; s, s_l, s_r (segments,) f32;
// vec 4 (every f32 tensor on 16 bytes, every code tensor on 4) or 1,
// grid: plans.lp_ring_mix_plan. Returns a CUDA error code.
extern "C" int persia_lp_ring_mix(float* x, float* ss, float* sl, float* sr, const int8_t* q, const int8_t* ql,
                                  const int8_t* qr, const float* s, const float* s_l, const float* s_r,
                                  const int* offsets, int segments, int vec, int grid, void* stream) {
  if (offsets == nullptr || segments < 0 || segments > kMaxMixSegments || offsets[0] != 0 || grid < 1 ||
      (vec != 1 && vec != 4))
    return cudaErrorInvalidValue;
  MixSegments segs;
  for (int k = 0; k <= segments; ++k) {
    if (k > 0 && offsets[k] < offsets[k - 1]) return cudaErrorInvalidValue;
    segs.off[k] = offsets[k];
  }
  const int n = offsets[segments];
  if (n == 0) return cudaSuccess;
  const void* f32s[] = {x, ss, sl, sr};
  const void* codes[] = {q, ql, qr};
  for (const void* p : f32s)
    if (p == nullptr) return cudaErrorInvalidValue;
  for (const void* p : codes)
    if (p == nullptr) return cudaErrorInvalidValue;
  if (s == nullptr || s_l == nullptr || s_r == nullptr) return cudaErrorInvalidValue;
  if (vec == 4) {
    for (const void* p : f32s)
      if (!aligned(p, 16)) return cudaErrorMisalignedAddress;
    for (const void* p : codes)
      if (!aligned(p, 4)) return cudaErrorMisalignedAddress;
  }
  const MixArgs a{x, ss, sl, sr, q, ql, qr, s, s_l, s_r, segments, n};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    lp_ring_mix_kernel<4><<<grid, kMixThreads, 0, st>>>(a, segs);
  } else {
    lp_ring_mix_kernel<1><<<grid, kMixThreads, 0, st>>>(a, segs);
  }
  return static_cast<int>(cudaGetLastError());
}
