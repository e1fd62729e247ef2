// Grouped row gather of the fused tier (K4): the rows of one table that the
// positions of a group of slots name, slot after slot.
//
// For slot s of the group (ids_s: B_s * L_s int32, flattened; out rows
// start[s] .. start[s + 1]) and each of its positions j:
//   stacked:   id < 0 -> row 0; id >= vocab_s -> row offset_s + vocab_s - 1;
//              else row offset_s + id
//   unstacked: id < 0 -> row 0; id >= vocab_s -> a row of NaN; else row id
//   out[start[s] + j, :] = table[row, :]      (the table's dtype)
// exactly what jnp.take computes in the reference: the stacked path clamps
// to the slot's own last row, the unstacked take's "fill" mode gives NaN.
//
// With a keys array it also writes each position's update key, the row
// its gradient updates, for the sparse update (K5) after the backward:
//   keys[start[s] + j] = 0 <= id < vocab_s ? offset_s + id : INT32_MAX
// (padding, and an id past the slot, go to the sentinel: a stacked id
// clamped to the slot's last row reads that row but updates none).
//
// Replaces: persia_tpu/parallel/fused_step.py:242-270 (_gather_all_stacked)
// and :145-152 (_gather_all), XLA gathers; with keys also the routing of
// the update ids, :389-399 with persia_tpu/ops/sparse_update.py:69-71 (XLA
// wheres; the mask to the sentinel); no Pallas kernel.
//
// Bound on the H100: bytes (the ids, each gathered row read and written
// once and, with keys, 4 bytes a position written; no arithmetic).
//
// Design: one thread per (position, vector), the vector the widest of 16,
// 8, 4 or 2 bytes that divides a row and the pointers' alignment; positions
// in order, so a warp's stores are one contiguous span. Each thread finds
// its slot by a binary search over the start offsets in the parameter
// struct (a warp mostly lies in one slot, so the reads are uniform). The
// key is an epilogue of the same search and id load: the position's first
// vector's thread stores it, before the unstacked path's early return.

#include <climits>
#include <cstdint>

#include "common.cuh"

// outside the anonymous namespace: the C entry point takes it
constexpr int kMaxGatherSlots = 128;

struct GatherSlots {
  const int32_t* ids[kMaxGatherSlots];
  int start[kMaxGatherSlots + 1];  // first output row of each slot; start[nslots] = total
  int offset[kMaxGatherSlots];     // the slot's first row in the table (stacked)
  int vocab[kMaxGatherSlots];      // the slot's rows
};

namespace {

constexpr int kThreads = 256;

template <typename V>
__device__ __forceinline__ V nan_vector(uint32_t word) {
  V v;
  uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(V) / 4); ++i) w[i] = word;
  return v;
}
template <>
__device__ __forceinline__ uint16_t nan_vector<uint16_t>(uint32_t word) {
  return static_cast<uint16_t>(word & 0xffffu);
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
    fused_gather_kernel(const V* __restrict__ table, V* __restrict__ out, int32_t* __restrict__ keys,
                        const __grid_constant__ GatherSlots p, int nslots, int vec_per_row, int stacked,
                        uint32_t nan_word) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long items = static_cast<long long>(p.start[nslots]) * vec_per_row;
  if (t >= items) return;
  const int pos = static_cast<int>(t / vec_per_row);
  const int v = static_cast<int>(t - static_cast<long long>(pos) * vec_per_row);
  int lo = 0, hi = nslots - 1;  // the last slot whose start <= pos
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (p.start[mid] <= pos) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const int s = lo;
  const int id = p.ids[s][pos - p.start[s]];
  if (keys != nullptr && v == 0) keys[pos] = id >= 0 && id < p.vocab[s] ? p.offset[s] + id : INT_MAX;
  long long row = 0;
  if (id >= 0) {
    if (id < p.vocab[s]) {
      row = static_cast<long long>(p.offset[s]) + id;
    } else if (stacked) {
      row = static_cast<long long>(p.offset[s]) + p.vocab[s] - 1;
    } else {
      out[t] = nan_vector<V>(nan_word);
      return;
    }
  }
  out[t] = table[row * vec_per_row + v];
}

}  // namespace

// keys: null, or int32 (start[nslots],) 4-byte aligned; every slot's
// offset + vocab must then fit int32
extern "C" int persia_fused_gather(const void* table, int dtype, long long num_rows, int dim, const GatherSlots* p,
                                   int nslots, int stacked, void* out, void* keys, void* stream) {
  if (table == nullptr || out == nullptr || p == nullptr || nslots < 1 || nslots > kMaxGatherSlots || dim < 1 ||
      num_rows < 1) {
    return cudaErrorInvalidValue;
  }
  if (dtype != persia::kFloat32 && dtype != persia::kBFloat16) return cudaErrorInvalidValue;
  if (p->start[0] != 0) return cudaErrorInvalidValue;
  for (int s = 0; s < nslots; ++s) {
    if (p->start[s + 1] < p->start[s] || p->vocab[s] < 1 || p->offset[s] < 0 ||
        static_cast<long long>(p->offset[s]) + p->vocab[s] > num_rows ||
        (p->ids[s] == nullptr && p->start[s + 1] > p->start[s]) ||
        (keys != nullptr && static_cast<long long>(p->offset[s]) + p->vocab[s] > INT_MAX)) {
      return cudaErrorInvalidValue;
    }
  }
  if (reinterpret_cast<uintptr_t>(keys) % alignof(int32_t) != 0) return cudaErrorInvalidValue;
  const long long total = p->start[nslots];
  if (total == 0) return cudaSuccess;
  const int elem = dtype == persia::kFloat32 ? 4 : 2;
  const long long row_bytes = static_cast<long long>(dim) * elem;
  const uintptr_t align = reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(out);
  int vec = 16;
  while (vec > elem && (row_bytes % vec != 0 || align % vec != 0)) vec >>= 1;
  if (row_bytes % vec != 0 || align % vec != 0) return cudaErrorInvalidValue;
  const int vpr = static_cast<int>(row_bytes / vec);
  const long long grid = (total * vpr + kThreads - 1) / kThreads;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  // NaN words: f32 0x7fc00000; bf16 0x7fc0 in each half
  const uint32_t nan_word = dtype == persia::kFloat32 ? 0x7fc00000u : 0x7fc07fc0u;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int32_t* k = static_cast<int32_t*>(keys);
  const unsigned g = static_cast<unsigned>(grid);
  switch (vec) {
    case 16:
      fused_gather_kernel<uint4><<<g, kThreads, 0, st>>>(static_cast<const uint4*>(table), static_cast<uint4*>(out), k,
                                                          *p, nslots, vpr, stacked, nan_word);
      break;
    case 8:
      fused_gather_kernel<uint2><<<g, kThreads, 0, st>>>(static_cast<const uint2*>(table), static_cast<uint2*>(out), k,
                                                          *p, nslots, vpr, stacked, nan_word);
      break;
    case 4:
      fused_gather_kernel<uint32_t><<<g, kThreads, 0, st>>>(static_cast<const uint32_t*>(table),
                                                             static_cast<uint32_t*>(out), k, *p, nslots, vpr, stacked,
                                                             nan_word);
      break;
    default:
      fused_gather_kernel<uint16_t><<<g, kThreads, 0, st>>>(static_cast<const uint16_t*>(table),
                                                             static_cast<uint16_t*>(out), k, *p, nslots, vpr, stacked,
                                                             nan_word);
      break;
  }
  return cudaGetLastError();
}
