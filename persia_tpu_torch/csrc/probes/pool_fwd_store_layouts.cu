// Probe: what bounds the grouped gather-pool forward at the bench shape
// (B=4096, 26 slots, dim 16, bf16 rows, P=1537, zipf(1.2)-like ids), by
// cut-down variants of its thread layout, each timed by CUDA-graph replay
// (20 launches captured, 20 replays). Not part of the kernel library (the
// build compiles csrc/*.cu only); build and run it on a card:
//
//   mkdir -p build/torch_kernels && nvcc -gencode arch=compute_90a,code=sm_90a \
//       -std=c++17 -O3 -o build/torch_kernels/pool_fwd_store_layouts \
//       persia_tpu_torch/csrc/probes/pool_fwd_store_layouts.cu
//   build/torch_kernels/pool_fwd_store_layouts
//
// V0 is the layout with the slot on grid y and (column vector, sample)
// threads; V3 and V4 are its stores and its loads alone; V6 and V8 keep a
// sample's output row contiguous across a warp, V8 as csrc/embedding_pool.cu
// does it (one thread per (sample, slot, column vector)).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <random>
#include <vector>

constexpr int B = 4096, S = 26, D = 16, P = 1537;

#define CK(x) do { cudaError_t e = (x); if (e != cudaSuccess) { printf("%s:%d %s\n", __FILE__, __LINE__, cudaGetErrorString(e)); exit(1); } } while (0)

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) { v[2 * j] = __uint_as_float(w[j] << 16); v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u); }
}
__device__ __forceinline__ void store8(float* o, const float (&a)[8]) {
  reinterpret_cast<float4*>(o)[0] = make_float4(a[0], a[1], a[2], a[3]);
  reinterpret_cast<float4*>(o)[1] = make_float4(a[4], a[5], a[6], a[7]);
}

// V0: block (2, 128), grid (B/128, S); thread = (column vector, sample)
__global__ void v0(const __nv_bfloat16* rows, const int* idx, float* out) {
  const int s = blockIdx.y, b = blockIdx.x * blockDim.y + threadIdx.y, c = threadIdx.x * 8;
  float v[8];
  load8(rows + (s * P + __ldg(idx + s * B + b)) * D + c, v);
  store8(out + (b * S + s) * D + c, v);
}
// V1: sample fastest: block (128, 2): thread x = sample, y = cv
__global__ void v1(const __nv_bfloat16* rows, const int* idx, float* out) {
  const int s = blockIdx.y, b = blockIdx.x * blockDim.x + threadIdx.x, c = threadIdx.y * 8;
  float v[8];
  load8(rows + (s * P + __ldg(idx + s * B + b)) * D + c, v);
  store8(out + (b * S + s) * D + c, v);
}
// V2: 4 samples a thread (ILP), block (2, 128), grid (B/512, S)
__global__ void v2(const __nv_bfloat16* rows, const int* idx, float* out) {
  const int s = blockIdx.y, c = threadIdx.x * 8;
  int r[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) r[k] = __ldg(idx + s * B + blockIdx.x * 512 + k * 128 + threadIdx.y);
  float v[4][8];
#pragma unroll
  for (int k = 0; k < 4; ++k) load8(rows + (s * P + r[k]) * D + c, v[k]);
#pragma unroll
  for (int k = 0; k < 4; ++k) store8(out + ((blockIdx.x * 512 + k * 128 + threadIdx.y) * S + s) * D + c, v[k]);
}
// V3: stores only (V0 geometry)
__global__ void v3(const __nv_bfloat16*, const int*, float* out) {
  const int s = blockIdx.y, b = blockIdx.x * blockDim.y + threadIdx.y, c = threadIdx.x * 8;
  float v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  v[0] = b;
  store8(out + (b * S + s) * D + c, v);
}
// V4: loads only (V0 geometry), a store only if the sum is exactly -1
__global__ void v4(const __nv_bfloat16* rows, const int* idx, float* out) {
  const int s = blockIdx.y, b = blockIdx.x * blockDim.y + threadIdx.y, c = threadIdx.x * 8;
  float v[8];
  load8(rows + (s * P + __ldg(idx + s * B + b)) * D + c, v);
  if (v[0] + v[1] + v[2] + v[3] + v[4] + v[5] + v[6] + v[7] == -1.2345f) out[b] = v[0];
}
// V5: slots looped inside a block of (2, 128) threads, grid B/128: a
// block writes 128 samples' whole output rows (contiguous)
__global__ void v5(const __nv_bfloat16* rows, const int* idx, float* out) {
  const int b = blockIdx.x * blockDim.y + threadIdx.y, c = threadIdx.x * 8;
#pragma unroll 2
  for (int s = 0; s < S; ++s) {
    float v[8];
    load8(rows + (s * P + __ldg(idx + s * B + b)) * D + c, v);
    store8(out + (b * S + s) * D + c, v);
  }
}
// V6: one warp per sample over all slots: lane = (slot-half, cv): 26 slots x 2 cvs
// = 52 lanes -> 2 iterations; the output row of a sample (1664 B) contiguous
__global__ void v6(const __nv_bfloat16* rows, const int* idx, float* out) {
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  for (int t = lane; t < S * 2; t += 32) {
    const int s = t >> 1, c = (t & 1) * 8;
    float v[8];
    load8(rows + (s * P + __ldg(idx + s * B + b)) * D + c, v);
    store8(out + (b * S + s) * D + c, v);
  }
}
// V7: empty kernel, V0 grid
__global__ void v7(const __nv_bfloat16*, const int*, float*) {}
// V8: one thread per (sample, slot, column vector), blocks of 256
__global__ void v8(const __nv_bfloat16* rows, const int* idx, float* out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = t / (S * 2), item = t - b * (S * 2), s = item >> 1, c = (item & 1) * 8;
  float v[8];
  load8(rows + (s * P + __ldg(idx + s * B + b)) * D + c, v);
  store8(out + b * S * D + item * 8, v);
}

template <typename K>
float time_graph(K kernel, dim3 grid, dim3 block, const __nv_bfloat16* rows, const int* idx, float* out,
                 cudaStream_t st) {
  cudaGraph_t g;
  cudaGraphExec_t ge;
  for (int i = 0; i < 3; ++i) kernel<<<grid, block, 0, st>>>(rows, idx, out);
  CK(cudaStreamSynchronize(st));
  CK(cudaStreamBeginCapture(st, cudaStreamCaptureModeGlobal));
  for (int i = 0; i < 20; ++i) kernel<<<grid, block, 0, st>>>(rows, idx, out);
  CK(cudaStreamEndCapture(st, &g));
  CK(cudaGraphInstantiate(&ge, g, 0));
  CK(cudaGraphLaunch(ge, st));
  CK(cudaStreamSynchronize(st));
  cudaEvent_t a, z;
  cudaEventCreate(&a);
  cudaEventCreate(&z);
  cudaEventRecord(a, st);
  for (int i = 0; i < 20; ++i) CK(cudaGraphLaunch(ge, st));
  cudaEventRecord(z, st);
  CK(cudaEventSynchronize(z));
  float ms;
  cudaEventElapsedTime(&ms, a, z);
  cudaGraphExecDestroy(ge);
  cudaGraphDestroy(g);
  return ms / 400;
}

int main() {
  std::mt19937 rng(1);
  std::vector<int> idx(S * B);
  // zipf(1.2) ranks mod 1500 by inverse transform of a truncated power law
  std::uniform_real_distribution<double> u(0, 1);
  for (auto& x : idx) {
    double r = std::pow(1.0 - u(rng), -1.0 / 0.2);  // Pareto(0.2) ~ zipf(1.2) tail
    x = static_cast<int>(static_cast<long long>(r - 1) % 1500);
  }
  std::vector<__nv_bfloat16> rows(S * P * D);
  for (auto& x : rows) x = __float2bfloat16(static_cast<float>(u(rng)));
  __nv_bfloat16* d_rows;
  int* d_idx;
  float* d_out;
  CK(cudaMalloc(&d_rows, rows.size() * 2));
  CK(cudaMalloc(&d_idx, idx.size() * 4));
  CK(cudaMalloc(&d_out, B * S * D * 4));
  CK(cudaMemcpy(d_rows, rows.data(), rows.size() * 2, cudaMemcpyHostToDevice));
  CK(cudaMemcpy(d_idx, idx.data(), idx.size() * 4, cudaMemcpyHostToDevice));
  cudaStream_t st;
  CK(cudaStreamCreate(&st));
  for (int rep = 0; rep < 2; ++rep) {
    printf("V0 (cv, sample), slot = grid y   %.5f ms\n", time_graph(v0, dim3(B / 128, S), dim3(2, 128), d_rows, d_idx, d_out, st));
    printf("V1 sample fastest                %.5f ms\n", time_graph(v1, dim3(B / 128, S), dim3(128, 2), d_rows, d_idx, d_out, st));
    printf("V2 4 samples a thread            %.5f ms\n", time_graph(v2, dim3(B / 512, S), dim3(2, 128), d_rows, d_idx, d_out, st));
    printf("V3 stores only                   %.5f ms\n", time_graph(v3, dim3(B / 128, S), dim3(2, 128), d_rows, d_idx, d_out, st));
    printf("V4 loads only                    %.5f ms\n", time_graph(v4, dim3(B / 128, S), dim3(2, 128), d_rows, d_idx, d_out, st));
    printf("V5 slots looped in the block     %.5f ms\n", time_graph(v5, dim3(B / 128), dim3(2, 128), d_rows, d_idx, d_out, st));
    printf("V6 warp per sample               %.5f ms\n", time_graph(v6, dim3(B / 8), dim3(256), d_rows, d_idx, d_out, st));
    printf("V7 empty kernel                  %.5f ms\n", time_graph(v7, dim3(B / 128, S), dim3(2, 128), d_rows, d_idx, d_out, st));
    printf("V8 (sample, slot, cv) flat       %.5f ms\n", time_graph(v8, dim3(B * S * 2 / 256), dim3(256), d_rows, d_idx, d_out, st));
  }
  return 0;
}
