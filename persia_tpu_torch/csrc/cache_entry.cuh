// The cache tier's entry helpers (K12, cache_aux.cu; K13, cached_gather.cu):
// a group's pool (its table, f32 or bf16, and at most two f32 optimizer
// state arrays, whose columns an entry [emb | s0 | s1] lays out in that
// order), vector loads and stores of f32 and of a bf16 wire or table, and
// the pool's checks.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace persia_cache {

struct Pool {
  void* table;  // f32, or bf16 (the kernels' TB template argument)
  float* s0;
  float* s1;
  long long rows;
  int dim, w0, w1;
};

// the first float of a state column `col` (>= dim) of row r (a vector never
// straddles two arrays: vec divides dim, w0 and w1)
__device__ __forceinline__ float* state_at(const Pool& p, long long r, int col) {
  col -= p.dim;
  if (col < p.w0) return p.s0 + r * p.w0 + col;
  return p.s1 + r * p.w1 + (col - p.w0);
}

// the first float of an entry's column `col` of row r in an f32 pool
__device__ __forceinline__ float* entry_at(const Pool& p, long long r, int col) {
  if (col < p.dim) return static_cast<float*>(p.table) + r * p.dim + col;
  return state_at(p, r, col);
}

template <int V>
__device__ __forceinline__ void load_f32(const float* p, float (&x)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      const float4 q = reinterpret_cast<const float4*>(p)[i];
      x[4 * i] = q.x;
      x[4 * i + 1] = q.y;
      x[4 * i + 2] = q.z;
      x[4 * i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) x[i] = p[i];
  }
}

template <int V>
__device__ __forceinline__ void store_f32(float* p, const float (&x)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      reinterpret_cast<float4*>(p)[i] = make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = x[i];
  }
}

// V floats from a wire at element `off`: f32, or bf16 widened (16 bytes at
// V = 8, 8 at V = 4)
template <int V>
__device__ __forceinline__ void load_wire(const void* base, bool bf16, long long off, float (&x)[V]) {
  if (!bf16) {
    load_f32<V>(static_cast<const float*>(base) + off, x);
    return;
  }
  const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(base) + off;
  if constexpr (V == 8) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  } else if constexpr (V == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const uint32_t w[2] = {q.x, q.y};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) x[i] = __bfloat162float(p[i]);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // each to nearest, ties to even
  return *reinterpret_cast<const uint32_t*>(&h);
}

// V floats to a wire at element `off`: f32, or rounded to bf16
template <int V>
__device__ __forceinline__ void store_wire(void* base, bool bf16, long long off, const float (&x)[V]) {
  if (!bf16) {
    store_f32<V>(static_cast<float*>(base) + off, x);
    return;
  }
  __nv_bfloat16* p = static_cast<__nv_bfloat16*>(base) + off;
  if constexpr (V == 8) {
    *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]),
                                              pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7]));
  } else if constexpr (V == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]));
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = __float2bfloat16_rn(x[i]);
  }
}

// V floats of an entry's columns [col, col + V) of row r, a bf16 table's
// (TB) widened
template <int V, bool TB>
__device__ __forceinline__ void load_entry(const Pool& p, long long r, int col, float (&x)[V]) {
  if constexpr (!TB) {
    load_f32<V>(entry_at(p, r, col), x);
  } else if (col < p.dim) {
    load_wire<V>(p.table, TB, r * p.dim + col, x);
  } else {
    load_f32<V>(state_at(p, r, col), x);
  }
}

// V floats to an entry's columns [col, col + V) of row r, rounded to a
// bf16 table's (TB) dtype (to nearest, ties to even)
template <int V, bool TB>
__device__ __forceinline__ void store_entry(const Pool& p, long long r, int col, const float (&x)[V]) {
  if constexpr (!TB) {
    store_f32<V>(entry_at(p, r, col), x);
  } else if (col < p.dim) {
    store_wire<V>(p.table, TB, r * p.dim + col, x);
  } else {
    store_f32<V>(state_at(p, r, col), x);
  }
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// the pool's shape and its vector width checked: vec in {1, 4, 8} divides
// every width, and at vec > 1 every array starts on 16 bytes
inline bool pool_ok(const Pool& p, int vec) {
  if (p.table == nullptr || p.rows < 1 || p.dim < 1 || p.w0 < 0 || p.w1 < 0 || (p.w0 > 0 && p.s0 == nullptr) ||
      (p.w1 > 0 && (p.s1 == nullptr || p.w0 == 0))) {
    return false;
  }
  if (vec != 1 && vec != 4 && vec != 8) return false;
  if (p.dim % vec || p.w0 % vec || p.w1 % vec) return false;
  return vec == 1 || (aligned16(p.table) && (p.w0 == 0 || aligned16(p.s0)) && (p.w1 == 0 || aligned16(p.s1)));
}

}  // namespace persia_cache
