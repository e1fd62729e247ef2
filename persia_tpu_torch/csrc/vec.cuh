// Row access shared by the port's kernels: a few consecutive elements of a
// row widened to f32 in one load, and f32 values narrowed and stored in one
// store.
#pragma once

#include "common.cuh"

namespace {

// N consecutive elements of a row widened to f32: one 16-byte load for
// N = 4 (f32) or 8 (bf16), one 8-byte load for N = 4 (bf16), else one
// element
__device__ __forceinline__ void load_f32(const float* p, float (&v)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {  // bf16 -> f32 is exact: the bits move up
    v[2 * j] = __uint_as_float(w[j] << 16);
    v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = __uint_as_float(q.x << 16);
  v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16);
  v[3] = __uint_as_float(q.y & 0xffff0000u);
}
__device__ __forceinline__ void load_f32(const float* p, float (&v)[1]) { v[0] = __ldg(p); }
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p, float (&v)[1]) {
  v[0] = persia::to_f32(*p);
}

// A lane's share of a row as one load: 16 bytes (4 f32 or 8 bf16) or one
// element. widen() makes it VEC f32 where it is used, so a row in flight
// holds 4 registers (or 1), not VEC.
template <typename T, int VEC>
struct RowUnit {
  using type = T;
};
template <>
struct RowUnit<float, 4> {
  using type = float4;
};
template <>
struct RowUnit<__nv_bfloat16, 8> {
  using type = uint4;
};

__device__ __forceinline__ void widen(const float4& q, float (&v)[4]) {
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void widen(const uint4& q, float (&v)[8]) {
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {  // bf16 -> f32 is exact: the bits move up
    v[2 * j] = __uint_as_float(w[j] << 16);
    v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}
__device__ __forceinline__ void widen(float x, float (&v)[1]) { v[0] = x; }
__device__ __forceinline__ void widen(__nv_bfloat16 x, float (&v)[1]) { v[0] = persia::to_f32(x); }

// N f32 values stored as T: 16-byte f32 stores, 16-byte stores of 8 bf16
// and 8-byte stores of 4 (round to nearest even), or one element
__device__ __forceinline__ void store_as(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store_as(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_as(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 q;
  q.x = *reinterpret_cast<const unsigned*>(&lo);
  q.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = q;
}
__device__ __forceinline__ void store_as(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 q;
  unsigned* w = reinterpret_cast<unsigned*>(&q);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    w[j] = *reinterpret_cast<const unsigned*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = q;
}
template <typename T>
__device__ __forceinline__ void store_as(T* p, const float (&v)[1]) {
  persia::store_f32(p, v[0]);
}

}  // namespace
