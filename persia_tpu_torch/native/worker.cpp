// persia_tpu_torch's native embedding-worker hot loops: the port's own copy
// of the reference's core (native/worker.cpp), trimmed to what the port's
// worker calls. Built with g++ at first use by
// persia_tpu_torch/embedding/native_worker.py.
//
//   - per-slot id dedup feeding distinct-sign lookups;
//   - sum-pooling of host-pooled slots;
//   - per-sign gradient accumulation on the update path;
//   - the (B, L) index matrix of raw and device-pooled slots;
//   - splitmix64 shard routing across parameter-server replicas;
//   - the cache tier's prefixed (slot, sample) sign matrix of single-id
//     slots.
//
// Numeric contract with the numpy routines of
// persia_tpu_torch/embedding/worker.py: dedup returns distinct signs in
// first-seen order (np.unique returns them sorted; both pair with a
// consistent inverse array); pooling and accumulation add elements in input
// order, so float sums are bit-identical to np.add.at. The parity tests
// (tests/test_torch_native_worker.py) hold every entry point bit for bit to
// the reference's native core and to the numpy routines.
//
// C ABI only (ctypes-friendly); no Python headers needed.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

inline uint64_t next_pow2(uint64_t v) {
  uint64_t c = 16;
  while (c < v) c <<= 1;
  return c;
}

}  // namespace

extern "C" {

// Dedup a flat array of u64 signs. Writes the distinct signs in FIRST-SEEN
// (insertion) order to `distinct_out` (capacity >= n) and each element's
// position in that array to `inverse_out` (size n). Returns the distinct
// count. Insertion order (vs np.unique's sorted order) is deterministic for
// a given input and 6x faster; the orderings are interchangeable because
// every consumer pairs `distinct` with `inverse` (pooling sums and gather
// results are order-independent).
int64_t wk_dedup(const uint64_t* ids, int64_t n, uint64_t* distinct_out,
                 int64_t* inverse_out) {
  if (n <= 0) return 0;
  const uint64_t cap = next_pow2(static_cast<uint64_t>(n) * 2);
  const uint64_t mask = cap - 1;
  struct Slot {
    uint64_t key;
    int32_t val;
  };
  std::vector<Slot> tab(cap, Slot{0, -1});
  int64_t m = 0;
  for (int64_t i = 0; i < n; ++i) {
    const uint64_t s = ids[i];
    uint64_t h = splitmix64(s) & mask;
    for (;;) {
      if (tab[h].val < 0) {
        tab[h].key = s;
        tab[h].val = static_cast<int32_t>(m);
        distinct_out[m] = s;
        inverse_out[i] = m;
        ++m;
        break;
      }
      if (tab[h].key == s) {
        inverse_out[i] = tab[h].val;
        break;
      }
      h = (h + 1) & mask;
    }
  }
  return m;
}

// pooled[sample_of_id[i], :] += rows[inverse[i], :] for i in input order
// (bit-identical to np.add.at's sequential accumulation). `pooled` must be
// zero-initialized by the caller ((B, dim) f32).
void wk_sum_pool(const float* rows, const int64_t* inverse,
                 const int64_t* sample_of_id, int64_t n, int64_t dim,
                 float* pooled) {
  for (int64_t i = 0; i < n; ++i) {
    const float* src = rows + inverse[i] * dim;
    float* dst = pooled + sample_of_id[i] * dim;
    for (int64_t d = 0; d < dim; ++d) dst[d] += src[d];
  }
}

// per_distinct[inverse[i], :] += grad[sample_of_id[i], :] — the worker's
// per-sign gradient accumulation (mod.rs:703-872). `per_distinct` must be
// zero-initialized ((D, dim) f32).
void wk_grad_accum(const float* grad, const int64_t* inverse,
                   const int64_t* sample_of_id, int64_t n, int64_t dim,
                   float* per_distinct) {
  for (int64_t i = 0; i < n; ++i) {
    const float* src = grad + sample_of_id[i] * dim;
    float* dst = per_distinct + inverse[i] * dim;
    for (int64_t d = 0; d < dim; ++d) dst[d] += src[d];
  }
}

// Raw-slot index matrix: for each sample b, the first min(counts[b], L)
// positions hold that sample's entries of `inverse` (in order); the rest stay
// `pad`. `index_out` is (B, L) int32, NOT pre-filled by the caller.
void wk_raw_index(const int64_t* counts, const int64_t* inverse, int64_t B,
                  int64_t L, int32_t pad, int32_t* index_out) {
  int64_t pos = 0;
  for (int64_t b = 0; b < B; ++b) {
    int32_t* row = index_out + b * L;
    const int64_t take = counts[b] < L ? counts[b] : L;
    int64_t t = 0;
    for (; t < take; ++t) row[t] = static_cast<int32_t>(inverse[pos + t]);
    for (; t < L; ++t) row[t] = pad;
    pos += counts[b];
  }
}

// Fused shard partition: computes each sign's shard and writes, per shard,
// the member positions (into `pos_out`, grouped by shard with stable input
// order) and per-shard counts (`count_out`, size num_shards). Saves the
// num_shards boolean-mask passes the numpy router does.
// The cache tier's single-id (S, B) sign matrix: out[s*B + b] =
// (ids[s][b] & mask) | prefix[s], one call for all S slots (the per-slot
// numpy prefix-OR and copy). prefix_bit == 0 (or a zero prefix) copies.
void wk_build_sid_matrix(const uint64_t* const* ids, const uint64_t* prefixes,
                         int64_t S, int64_t B, int32_t prefix_bit,
                         uint64_t* out) {
  const uint64_t mask =
      prefix_bit > 0 ? ((~0ULL) >> prefix_bit) : ~0ULL;
  for (int64_t s = 0; s < S; ++s) {
    const uint64_t* src = ids[s];
    uint64_t* dst = out + s * B;
    const uint64_t p = prefixes[s];
    if (p == 0 || prefix_bit == 0) {
      std::memcpy(dst, src, sizeof(uint64_t) * B);
    } else {
      for (int64_t b = 0; b < B; ++b) dst[b] = (src[b] & mask) | p;
    }
  }
}

void wk_shard_partition(const uint64_t* signs, int64_t n, uint32_t num_shards,
                        int64_t* pos_out, int64_t* count_out) {
  std::vector<int64_t> shard(n);
  std::memset(count_out, 0, sizeof(int64_t) * num_shards);
  for (int64_t i = 0; i < n; ++i) {
    shard[i] = static_cast<int64_t>(splitmix64(signs[i]) % num_shards);
    ++count_out[shard[i]];
  }
  std::vector<int64_t> off(num_shards, 0);
  for (uint32_t s = 1; s < num_shards; ++s) off[s] = off[s - 1] + count_out[s - 1];
  for (int64_t i = 0; i < n; ++i) pos_out[off[shard[i]]++] = i;
}

}  // extern "C"
