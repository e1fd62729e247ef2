// Shared helpers of the port's kernels: element loads/stores that widen to
// and narrow from f32, and the dtype codes the Python wrappers pass.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace persia {

enum DType { kFloat32 = 0, kBFloat16 = 1 };

static __device__ __forceinline__ float to_f32(float x) { return x; }
static __device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

static __device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
static __device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even
}

}  // namespace persia
