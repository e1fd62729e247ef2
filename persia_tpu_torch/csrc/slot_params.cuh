// The parameter block of a group of slots, and the checks their C entry
// points share: the grouped gather-pool (K1/K2, csrc/embedding_pool.cu) and
// the raw-slot gather (K6, csrc/raw_gather.cu).
#pragma once

#include <climits>
#include <cstdint>

#include "vec.cuh"

// outside the anonymous namespace: the C entry points take it, and a
// parameter of an internal type would give them internal linkage too
constexpr int kMaxSlots = 64;

struct PoolSlotsParams {
  void* rows[kMaxSlots];  // (P, dim) T: the forward reads them, the backward writes its output here
  const int32_t* index[kMaxSlots];  // (B, L)
  const int32_t* counts[kMaxSlots];  // (B,) or null: no sqrt scaling
  const int32_t* order[kMaxSlots];  // backward: (B * L,) positions sorted by row
  const int32_t* offsets[kMaxSlots];  // backward: (P + 1,)
  int num_rows[kMaxSlots];  // P
  int ids_per_sample[kMaxSlots];  // L
};

namespace {

constexpr int kMaxThreads = 256;

inline bool fits_int(long long x) { return x >= 0 && x < INT_MAX; }

inline bool aligned(const void* ptr, int bytes) { return reinterpret_cast<uintptr_t>(ptr) % bytes == 0; }

inline int log2_exact(int x) {
  if (x < 1 || (x & (x - 1)) != 0) return -1;
  int k = 0;
  while ((1 << k) < x) ++k;
  return k;
}

// the group's pointers, the shapes and every product the kernels form in
// 32-bit index math
inline int check_group(const PoolSlotsParams* p, int nslots, int batch, int dim, int out_slots, int slot0,
                       bool backward) {
  if (p == nullptr || nslots < 1 || nslots > kMaxSlots || batch < 1 || dim < 1 || slot0 < 0 ||
      slot0 + nslots > out_slots || !fits_int(1LL * batch * out_slots * dim)) {
    return cudaErrorInvalidValue;
  }
  for (int s = 0; s < nslots; ++s) {
    if (p->rows[s] == nullptr || p->index[s] == nullptr || p->num_rows[s] < 1 ||
        p->ids_per_sample[s] < 1 || !fits_int(1LL * p->num_rows[s] * dim) ||
        !fits_int(1LL * batch * p->ids_per_sample[s])) {
      return cudaErrorInvalidValue;
    }
    if (backward && (p->order[s] == nullptr || p->offsets[s] == nullptr)) {
      return cudaErrorInvalidValue;
    }
  }
  return cudaSuccess;
}

}  // namespace
