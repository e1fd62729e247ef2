// Probe: what bounds K15 (csrc/quantize_int8.cu) at the ps-stream step's
// shape (26 segments of 24,576 bf16 gradients, f32 residual), by the
// kernel itself under other geometries and by cut-down variants of it,
// each timed by CUDA-graph replay (20 launches captured, 10 replays, the
// best of 3), warm (the same inputs each launch) and cold (24 copies of
// the inputs and codes, 106 MB, rotated). Not part of the kernel library
// (the build compiles csrc/*.cu only); build and run it on a card:
//
//   mkdir -p build/torch_kernels && nvcc -gencode arch=compute_90a,code=sm_90a \
//       -std=c++17 -O3 -o build/torch_kernels/quantize_int8_variants \
//       persia_tpu_torch/csrc/probes/quantize_int8_variants.cu
//   build/torch_kernels/quantize_int8_variants
//
// "kernel" is K15 as the library launches it (push, Markstein), under a
// few geometries. The variants run the plan's grid (26 x 8 blocks of 192
// threads, 16 elements a thread) as clusters of 8, or as plain blocks
// where a row's cluster is 0: "pull" takes the cluster barrier, then
// every rank's maximum read through distributed shared memory, "push"
// stores each block's maximum into a slot of every block of its cluster
// and polls its own slots (K15's exchange), "barrier_only" takes the
// barrier but keeps each block's own maximum, "own_max" skips the
// exchange; "_markstein" divides through the correctly rounded reciprocal
// and one correction (its bits checked against __fdiv_rn over 2^30 seeded
// (v, scale) pairs at the end), "_rcp_mul" multiplies by the reciprocal
// (not exact: a time only); "copy_*" store v and zero codes after the
// exchange (no quotient), "copy" after the block's maximum alone,
// "copy_free" with no maximum at all; "empty" returns at once; "pair_*"
// runs 13 clusters (of 8, or of 16 blocks, a non-portable size) of two
// segments each, every load of both at the top, the second's landing
// while the first is written.
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <random>
#include <vector>

#include "../quantize_int8.cu"

#define CK(x)                                                                          \
  do {                                                                                 \
    cudaError_t e = (x);                                                               \
    if (e != cudaSuccess) {                                                            \
      printf("%s:%d %s\n", __FILE__, __LINE__, cudaGetErrorString(e));                 \
      exit(1);                                                                         \
    }                                                                                  \
  } while (0)

namespace {

constexpr int kSegs = 26, kLen = 24576, kN = kSegs * kLen, kCopies = 24;

// how a block gets its segment's maximum: its own (none), K15's pull (the
// cluster barrier, then each rank's maximum read through distributed
// shared memory), the cluster barrier alone (its own maximum), or a push
// (each block stores its maximum into a slot of every block of the
// cluster and polls its own slots); kFree: not even the block's maximum
// (each thread stores as soon as its own loads land: copies only)
enum Exchange { kOwn = 0, kPull = 1, kBarrier = 2, kPush = 3, kFree = 4 };
// the quotient v / scale: __fdiv_rn, markstein_div, or v * (1 / scale)
enum Div { kFdiv = 0, kMarkstein = 1, kRcpMul = 2 };

// v / scale through the correctly rounded reciprocal and one correction
// (Markstein): q0 = v * inv, e = v - q0 * scale (exact in an FMA), q =
// q0 + e * inv; q0 where e is 0 (a zero keeps its sign)
__device__ __forceinline__ float markstein_div(float v, float scale, float inv) {
  const float q0 = __fmul_rn(v, inv);
  const float e = __fmaf_rn(-q0, scale, v);
  return e == 0.0f ? q0 : __fmaf_rn(e, inv, q0);
}

__device__ __forceinline__ unsigned long long mix(unsigned long long x) {  // splitmix64
  x += 0x9e3779b97f4a7c15ull;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
  return x ^ (x >> 31);
}

// counts of (v, scale) pairs, |v| <= scale, scale from 1e-30 up to 2^126,
// |v| down through the subnormals, where markstein_div's quotient, or the
// code and the residual made from it, differ from __fdiv_rn's
__global__ void check_markstein(unsigned long long pairs, unsigned long long* bad) {
  unsigned long long q_bad = 0, out_bad = 0;
  for (unsigned long long i = blockIdx.x * 256ull + threadIdx.x; i < pairs; i += 256ull * gridDim.x) {
    const unsigned long long h = mix(i), h2 = mix(i ^ 0x5bd1e995ull);
    const float scale = fmaxf(ldexpf(1.0f + (h & 0xffffff) * 0x1p-24f, static_cast<int>((h >> 24) % 226) - 100),
                              1e-30f);
    const float frac = (h2 & 0x7fffff) * 0x1p-23f;  // [0, 1)
    const int down = static_cast<int>((h2 >> 23) % 160);
    float v = fminf(ldexpf(frac, -down), 1.0f) * scale;
    if (h2 >> 63) v = -v;
    if ((h2 >> 40) % 97 == 0) v = (h2 >> 50) & 1 ? -0.0f : 0.0f;
    const float inv = __frcp_rn(scale), step = __fdiv_rn(scale, 127.0f);
    const float qa = __fdiv_rn(v, scale), qb = markstein_div(v, scale, inv);
    q_bad += __float_as_uint(qa) != __float_as_uint(qb);
    float ta = rintf(__fmul_rn(qa, 127.0f)), tb = rintf(__fmul_rn(qb, 127.0f));
    ta = fminf(fmaxf(ta, -127.0f), 127.0f);
    tb = fminf(fmaxf(tb, -127.0f), 127.0f);
    const float ra = __fsub_rn(v, __fmul_rn(ta, step)), rb = __fsub_rn(v, __fmul_rn(tb, step));
    out_bad += ta != tb || __float_as_uint(ra) != __float_as_uint(rb);
  }
  atomicAdd(&bad[0], q_bad);
  atomicAdd(&bad[1], out_bad);
}

// K15's body at bf16, 8-element units, in a variant: COPY stores v and
// zero codes straight after the exchange; EMPTY returns at once
template <int EXCH, int DIV, bool COPY, bool EMPTY>
__global__ void __launch_bounds__(kMaxQuantThreads)
    variant_kernel(const __nv_bfloat16* __restrict__ g, const float* r, QuantSegments segs, int units,
                   int8_t* __restrict__ q, float* __restrict__ scales, float* r_out) {
  using T = __nv_bfloat16;
  constexpr int VEC = 8, kUnits = kMaxUnitsWide;
  if constexpr (EMPTY) return;
  __shared__ float warp_max[kMaxQuantWarps];
  __shared__ float block_max;
  __shared__ unsigned slots[kMaxQuantCluster];
  const int s = blockIdx.x, rank = blockIdx.y, blocks = gridDim.y;
  const int tid = threadIdx.x, threads = blockDim.x, lane = tid & 31;
  if constexpr (EXCH == kPush) {
    if (tid < kMaxQuantCluster) slots[tid] = kEmptySlot;
    cluster_arrive();  // the slots are set before any block pushes into them
  }
  const int body = segs.off[s], seg_units = (segs.off[s + 1] - body) / VEC;
  const int span = (seg_units + blocks - 1) / blocks;
  const int u0 = min(seg_units, rank * span), u1 = min(seg_units, u0 + span);
  const int held = min(u1 - u0, threads * units);
  Unit<T, VEC> raw[kUnits];
#pragma unroll
  for (int j = 0; j < kUnits; ++j) {
    const int u = tid + j * threads;
    if (j < units && u < held) raw[j].load(g + body + (u0 + u) * VEC, r + body + (u0 + u) * VEC);
  }
  float m = 0.0f;
  float v[kUnits][VEC];
#pragma unroll
  for (int j = 0; j < kUnits; ++j) {
    if (j < units && tid + j * threads < held) {
      raw[j].sum(v[j], 1.0f);
#pragma unroll
      for (int k = 0; k < VEC; ++k) m = abs_max(m, fabsf(v[j][k]));
    }
  }
  if constexpr (EXCH != kFree) {
    for (int d = 16; d > 0; d >>= 1) m = abs_max(m, __shfl_xor_sync(kFull, m, d));
    if (lane == 0) warp_max[tid >> 5] = m;
    __syncthreads();
    m = warp_max[0];
    for (int w = 1; w < (threads >> 5); ++w) m = abs_max(m, warp_max[w]);
  }
  cg::cluster_group cluster = cg::this_cluster();
  if constexpr (EXCH == kPull) {
    if (tid == 0) block_max = m;
    cluster.sync();
    float c = lane < blocks ? *cluster.map_shared_rank(&block_max, lane) : 0.0f;
    for (int d = kMaxQuantCluster / 2; d > 0; d >>= 1) c = abs_max(c, __shfl_xor_sync(kFull, c, d));
    m = __shfl_sync(kFull, c, 0);
    cluster_arrive();
  } else if constexpr (EXCH == kBarrier) {
    cluster.sync();
  } else if constexpr (EXCH == kPush) {
    cluster_wait();  // every block of the cluster has set its slots
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
    m = __shfl_sync(kFull, f, 0);
  }
  const float scale = (m > 1e-30f || m != m) ? m : 1e-30f;
  if (rank == 0 && tid == 0) scales[s] = scale;
  const float step = __fdiv_rn(scale, 127.0f), inv = __frcp_rn(scale);
#pragma unroll
  for (int j = 0; j < kUnits; ++j) {
    const int u = tid + j * threads;
    if (j < units && u < held) {
      const int i = body + (u0 + u) * VEC;
      if constexpr (COPY) {
        *reinterpret_cast<uint2*>(q + i) = make_uint2(0, 0);
        store_as(r_out + i, v[j]);
      } else if constexpr (DIV == kFdiv) {
        store_unit<VEC, false>(v[j], Scale{scale, step, inv, false}, q + i, r_out + i);
      } else {
        int8_t c[8];
        float out[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float quot = DIV == kRcpMul ? __fmul_rn(v[j][k], inv) : markstein_div(v[j][k], scale, inv);
          float t = rintf(__fmul_rn(quot, 127.0f));
          t = fminf(fmaxf(t, -127.0f), 127.0f);
          c[k] = static_cast<int8_t>(t);
          out[k] = __fsub_rn(v[j][k], __fmul_rn(t, step));
        }
        uint2 packed;
        packed.x = (static_cast<uint8_t>(c[0])) | (static_cast<uint8_t>(c[1]) << 8) |
                   (static_cast<uint8_t>(c[2]) << 16) | (static_cast<unsigned>(static_cast<uint8_t>(c[3])) << 24);
        packed.y = (static_cast<uint8_t>(c[4])) | (static_cast<uint8_t>(c[5]) << 8) |
                   (static_cast<uint8_t>(c[6]) << 16) | (static_cast<unsigned>(static_cast<uint8_t>(c[7])) << 24);
        *reinterpret_cast<uint2*>(q + i) = packed;
        store_as(r_out + i, out);
      }
    }
  }
  if constexpr (EXCH == kPull) cluster_wait();
}

// a cluster's maximum by push: each block stores m into its slot of every
// block of the cluster, then polls its own slots (set to kEmptySlot before
// the cluster barrier that the caller has passed)
template <int C>
__device__ __forceinline__ float push_max(float m, unsigned* slots, int rank, int blocks) {
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid < blocks) {
    *reinterpret_cast<volatile unsigned*>(cluster.map_shared_rank(&slots[rank], tid)) = __float_as_uint(m);
  }
  unsigned c = 0;
  if (lane < blocks) {
    const volatile unsigned* mine = slots;
    do {
      c = mine[lane];
    } while (c == kEmptySlot);
  }
  float f = __uint_as_float(c);
  for (int d = C / 2; d > 0; d >>= 1) f = abs_max(f, __shfl_xor_sync(kFull, f, d));
  return __shfl_sync(kFull, f, 0);
}

// the block's maximum (warp shuffles, then the warps in shared memory)
__device__ __forceinline__ float block_abs_max(float m, float* warp_max) {
  for (int d = 16; d > 0; d >>= 1) m = abs_max(m, __shfl_xor_sync(kFull, m, d));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  m = warp_max[0];
  for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) m = abs_max(m, warp_max[w]);
  return m;
}

// two segments a cluster (grid.x = segments / 2; equal, aligned segments):
// every load of both at the top, the first segment's first, then the
// first's maximum, push, codes and residual while the second's loads land,
// then the second's; Markstein division
template <int U, int C>
__global__ void __launch_bounds__(kMaxQuantThreads)
    pair_kernel(const __nv_bfloat16* __restrict__ g, const float* r, QuantSegments segs, int,
                int8_t* __restrict__ q, float* __restrict__ scales, float* r_out) {
  using T = __nv_bfloat16;
  constexpr int VEC = 8;
  __shared__ float warp_max[2][kMaxQuantWarps];
  __shared__ unsigned slots[2][C];
  const int rank = blockIdx.y, blocks = gridDim.y, tid = threadIdx.x, threads = blockDim.x;
  if (tid < 2 * C) slots[tid / C][tid % C] = kEmptySlot;
  cluster_arrive();
  Unit<T, VEC> raw[2][U];
  int base[2], held[2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int s = 2 * blockIdx.x + p;
    const int body = segs.off[s], seg_units = (segs.off[s + 1] - body) / VEC;
    const int span = (seg_units + blocks - 1) / blocks;
    const int u0 = min(seg_units, rank * span), u1 = min(seg_units, u0 + span);
    base[p] = body + u0 * VEC;
    held[p] = min(u1 - u0, threads * U);
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int u = tid + j * threads;
      if (u < held[p]) raw[p][j].load(g + base[p] + u * VEC, r + base[p] + u * VEC);
    }
  }
  bool waited = false;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    float v[U][VEC];
    float m = 0.0f;
#pragma unroll
    for (int j = 0; j < U; ++j) {
      if (tid + j * threads < held[p]) {
        raw[p][j].sum(v[j], 1.0f);
#pragma unroll
        for (int k = 0; k < VEC; ++k) m = abs_max(m, fabsf(v[j][k]));
      }
    }
    m = block_abs_max(m, warp_max[p]);
    if (!waited) {
      cluster_wait();
      waited = true;
    }
    m = push_max<C>(m, slots[p], rank, blocks);
    const float scale = (m > 1e-30f || m != m) ? m : 1e-30f;
    if (rank == 0 && tid == 0) scales[2 * blockIdx.x + p] = scale;
    const float step = __fdiv_rn(scale, 127.0f), inv = __frcp_rn(scale);
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int u = tid + j * threads;
      if (u < held[p]) {
        int8_t c[8];
        float out[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          float t = rintf(__fmul_rn(markstein_div(v[j][k], scale, inv), 127.0f));
          t = fminf(fmaxf(t, -127.0f), 127.0f);
          c[k] = static_cast<int8_t>(t);
          out[k] = __fsub_rn(v[j][k], __fmul_rn(t, step));
        }
        uint2 packed;
        packed.x = (static_cast<uint8_t>(c[0])) | (static_cast<uint8_t>(c[1]) << 8) |
                   (static_cast<uint8_t>(c[2]) << 16) | (static_cast<unsigned>(static_cast<uint8_t>(c[3])) << 24);
        packed.y = (static_cast<uint8_t>(c[4])) | (static_cast<uint8_t>(c[5]) << 8) |
                   (static_cast<uint8_t>(c[6]) << 16) | (static_cast<unsigned>(static_cast<uint8_t>(c[7])) << 24);
        *reinterpret_cast<uint2*>(q + base[p] + u * VEC) = packed;
        store_as(r_out + base[p] + u * VEC, out);
      }
    }
  }
}

struct Buffers {
  __nv_bfloat16* g[kCopies];
  float* r[kCopies];
  int8_t* q[kCopies];
  float* scales;
};

// the mean ms a launch of `launch(copy)` over 20 launches captured in a
// graph and replayed 10 times, the best of 3; copy = 0 always (warm) or
// rotating through kCopies (cold)
template <typename F>
double graph_ms(F launch, bool cold, cudaStream_t st) {
  cudaGraph_t graph;
  cudaGraphExec_t exec;
  CK(cudaStreamBeginCapture(st, cudaStreamCaptureModeGlobal));
  for (int i = 0; i < 20; ++i) CK(static_cast<cudaError_t>(launch(cold ? i % kCopies : 0)));
  CK(cudaStreamEndCapture(st, &graph));
  CK(cudaGraphInstantiate(&exec, graph, 0));
  cudaEvent_t a, b;
  CK(cudaEventCreate(&a));
  CK(cudaEventCreate(&b));
  double best = 1e30;
  for (int rep = 0; rep < 4; ++rep) {
    CK(cudaEventRecord(a, st));
    for (int k = 0; k < 10; ++k) CK(cudaGraphLaunch(exec, st));
    CK(cudaEventRecord(b, st));
    CK(cudaEventSynchronize(b));
    float ms = 0.f;
    CK(cudaEventElapsedTime(&ms, a, b));
    if (rep > 0 && ms / 200.0 < best) best = ms / 200.0;  // the first replay warms up
  }
  CK(cudaGraphExecDestroy(exec));
  CK(cudaGraphDestroy(graph));
  return best;
}

}  // namespace

int main() {
  cudaDeviceProp prop;
  CK(cudaGetDeviceProperties(&prop, 0));
  printf("device %s, %d SMs\n", prop.name, prop.multiProcessorCount);
  std::mt19937 rng(7);
  std::normal_distribution<float> normal(0.f, 1.f);
  std::vector<__nv_bfloat16> hg(kN);
  std::vector<float> hr(kN);
  for (int s = 0; s < kSegs; ++s) {
    const float mag = std::pow(10.f, static_cast<float>(s % 5 - 4));
    for (int i = 0; i < kLen; ++i) {
      hg[s * kLen + i] = __float2bfloat16(normal(rng) * mag);
      hr[s * kLen + i] = normal(rng) * mag * 1e-2f;
    }
  }
  Buffers buf;
  for (int c = 0; c < kCopies; ++c) {
    CK(cudaMalloc(&buf.g[c], kN * sizeof(__nv_bfloat16)));
    CK(cudaMalloc(&buf.r[c], kN * sizeof(float)));
    CK(cudaMalloc(&buf.q[c], kN));
    CK(cudaMemcpy(buf.g[c], hg.data(), kN * sizeof(__nv_bfloat16), cudaMemcpyHostToDevice));
    CK(cudaMemcpy(buf.r[c], hr.data(), kN * sizeof(float), cudaMemcpyHostToDevice));
  }
  CK(cudaMalloc(&buf.scales, kSegs * sizeof(float)));
  int offsets[kSegs + 1];
  QuantSegments segs;
  for (int s = 0; s <= kSegs; ++s) segs.off[s] = offsets[s] = s * kLen;
  cudaStream_t st;
  CK(cudaStreamCreateWithFlags(&st, cudaStreamNonBlocking));

  struct Geometry {
    int cluster, threads, units;
  };
  const Geometry sweep[] = {{8, 192, 2}, {8, 128, 3}, {4, 384, 2}};
  printf("{\"probe\": \"quantize_int8_variants\", \"segments\": %d, \"length\": %d, \"rows\": [\n", kSegs, kLen);
  bool first = true;
  auto report = [&](const char* name, Geometry geo, double warm, double cold) {
    printf("%s  {\"variant\": \"%s\", \"cluster\": %d, \"threads\": %d, \"units\": %d, \"warm_ms\": %.6f, "
           "\"cold_ms\": %.6f}",
           first ? "" : ",\n", name, geo.cluster, geo.threads, geo.units, warm, cold);
    first = false;
  };
  for (const Geometry& geo : sweep) {
    auto launch = [&](int c) {
      return persia_quantize_int8_ef(buf.g[c], persia::kBFloat16, buf.r[c], offsets, kSegs, nullptr, nullptr,
                                     buf.q[c], buf.scales, buf.r[c], 8, geo.threads, geo.units, geo.cluster, st);
    };
    report("kernel", geo, graph_ms(launch, false, st), graph_ms(launch, true, st));
  }
  // the plan's grid (26 x 8 blocks), launched as clusters of 8 or as
  // plain blocks (cluster 0 in the report)
  auto variant = [&](const char* name, void (*kernel)(const __nv_bfloat16*, const float*, QuantSegments, int,
                                                      int8_t*, float*, float*),
                     bool clusters, Geometry geo = {8, 192, 2}) {
    auto launch = [&](int c) {
      if (clusters) {
        return launch_clusters(kernel, kSegs, geo.cluster, geo.threads, st, buf.g[c], buf.r[c], segs, geo.units,
                               buf.q[c], buf.scales, buf.r[c]);
      }
      kernel<<<dim3(kSegs, geo.cluster), geo.threads, 0, st>>>(buf.g[c], buf.r[c], segs, geo.units, buf.q[c],
                                                               buf.scales, buf.r[c]);
      return static_cast<int>(cudaGetLastError());
    };
    report(name, {clusters ? geo.cluster : 0, geo.threads, geo.units}, graph_ms(launch, false, st),
           graph_ms(launch, true, st));
  };
  variant("pull", variant_kernel<kPull, kFdiv, false, false>, true);
  variant("pull_markstein", variant_kernel<kPull, kMarkstein, false, false>, true);
  variant("pull_rcp_mul", variant_kernel<kPull, kRcpMul, false, false>, true);
  variant("push", variant_kernel<kPush, kFdiv, false, false>, true);
  variant("push_markstein", variant_kernel<kPush, kMarkstein, false, false>, true);
  variant("barrier_only", variant_kernel<kBarrier, kFdiv, false, false>, true);
  variant("own_max", variant_kernel<kOwn, kFdiv, false, false>, true);
  variant("own_max", variant_kernel<kOwn, kFdiv, false, false>, false);
  variant("copy_pull", variant_kernel<kPull, kFdiv, true, false>, true);
  variant("copy_barrier", variant_kernel<kBarrier, kFdiv, true, false>, true);
  variant("copy_push", variant_kernel<kPush, kFdiv, true, false>, true);
  variant("copy", variant_kernel<kOwn, kFdiv, true, false>, true);
  variant("copy", variant_kernel<kOwn, kFdiv, true, false>, false);
  variant("copy_free", variant_kernel<kFree, kFdiv, true, false>, false);
  variant("empty", variant_kernel<kOwn, kFdiv, false, true>, true);
  variant("empty", variant_kernel<kOwn, kFdiv, false, true>, false);
  for (const Geometry& geo : {Geometry{4, 384, 2}, Geometry{8, 128, 3}, Geometry{8, 384, 1}}) {
    variant("push_markstein", variant_kernel<kPush, kMarkstein, false, false>, true, geo);
  }
  // two segments a cluster: 13 clusters (the units a thread are a segment's)
  auto pair = [&](const char* name, void (*kernel)(const __nv_bfloat16*, const float*, QuantSegments, int, int8_t*,
                                                   float*, float*),
                  Geometry geo) {
    auto launch = [&](int c) {
      return launch_clusters(kernel, kSegs / 2, geo.cluster, geo.threads, st, buf.g[c], buf.r[c], segs, geo.units,
                             buf.q[c], buf.scales, buf.r[c]);
    };
    report(name, geo, graph_ms(launch, false, st), graph_ms(launch, true, st));
  };
  pair("pair_push_markstein", pair_kernel<2, 8>, {8, 192, 2});
  pair("pair_push_markstein", pair_kernel<1, 8>, {8, 384, 1});
  // clusters of 16 (non-portable): the single-segment grid's 208 blocks
  CK(cudaFuncSetAttribute(pair_kernel<1, 16>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
  CK(cudaFuncSetAttribute(pair_kernel<2, 16>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
  pair("pair_push_markstein", pair_kernel<1, 16>, {16, 192, 1});
  pair("pair_push_markstein", pair_kernel<2, 16>, {16, 96, 2});
  printf("\n]}\n");
  unsigned long long* bad;
  CK(cudaMalloc(&bad, 2 * sizeof(unsigned long long)));
  CK(cudaMemset(bad, 0, 2 * sizeof(unsigned long long)));
  const unsigned long long pairs = 1ull << 30;
  check_markstein<<<4 * prop.multiProcessorCount, 256, 0, st>>>(pairs, bad);
  unsigned long long hbad[2];
  CK(cudaMemcpy(hbad, bad, sizeof(hbad), cudaMemcpyDeviceToHost));
  printf("{\"markstein_check\": {\"pairs\": %llu, \"quotient_differs\": %llu, \"code_or_residual_differs\": %llu}}\n",
         pairs, hbad[0], hbad[1]);
  CK(cudaDeviceSynchronize());
  return 0;
}
