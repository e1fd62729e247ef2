// persia_tpu_torch's native HBM-cache directory: the port's own copy of
// the reference's directory (native/cache.cpp), trimmed to what the cache
// tier's synchronous path calls. Built with g++ at first use by
// persia_tpu_torch/embedding/hbm_cache/directory.py.
//
// Host-side bookkeeping for the write-back cache of embedding rows on the
// card: a fixed-capacity LRU map from embedding sign -> cache row. The card
// holds the rows ([emb | optimizer state]); this directory decides, per
// batch, which signs hit, which miss (and which row each miss takes), and
// which resident signs are evicted to make room (their rows are read back
// from the card and written to the parameter server: the write-back).
//
//   - the Cache: row index == slab slot, an intrusive doubly-linked LRU, an
//     open-addressing hash with backward-shift deletion, a 1-byte tag per
//     slot for the 8-at-a-time probe (cache_set_probe_mode: 0 scalar, 1 the
//     tag walk; the same results either way), and touch-gated admission;
//   - cache_admit (deduplicated signs) and cache_admit_positions (a raw
//     position-level stream, deduplicated here), cache_probe (read-only),
//     cache_snapshot and cache_drain (LRU order, most recent first);
//   - the seeded cold-row init, bit for bit the parameter server's
//     (cache_uniform_init, cache_init_rows).
//
//   - the stream's pending-write-back map (pending_map_*: sign ->
//     (token, ring row) of every eviction whose write-back is in flight)
//     and the fused feeder call (cache_feed_batch: cache_admit_positions
//     and the map's probe of the misses in one call);
//   - the sharded directory (cache_create_sharded, cache_sharded_*,
//     cache_feed_batch_sharded): S shards, each its own mutex, LRU chain
//     and row range, walked by a pool of native threads.
//
// The reference's access sketch (and so the sketch observe it fuses into
// the sharded walk) is not part of this copy.
//
// C ABI only (ctypes-friendly); no Python headers needed.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <mutex>
#include <new>
#include <thread>
#include <vector>

#if defined(__linux__)
#include <pthread.h>
#include <sched.h>
#include <unistd.h>
#endif

namespace {

inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

// SWAR helpers for the 8-at-a-time tag probe: broadcast one byte across a
// u64 lane group, and mark (with 0x80 in that byte) every zero byte of v.
// The haszero trick only borrows INTO a byte when that byte is zero, so the
// markers are exact for our operands (tags are never 0x01..0x7F: a live tag
// always has its 0x80 occupancy bit set, an empty tag is 0x00).
inline uint64_t swar_bcast8(uint8_t b) {
  return (uint64_t)b * 0x0101010101010101ULL;
}
inline uint64_t swar_zero_bytes(uint64_t v) {
  return (v - 0x0101010101010101ULL) & ~v & 0x8080808080808080ULL;
}

// PERSIA_FEED_PROBE=scalar forces the legacy one-slot-at-a-time probe
// (golden reference); anything else (default) selects the SIMD tag-array
// walk. Read once per process — per-handle overrides ride the
// cache_set_probe_mode exports.
inline int default_probe_mode() {
  static const int mode = [] {
    const char* e = std::getenv("PERSIA_FEED_PROBE");
    return (e != nullptr && std::strcmp(e, "scalar") == 0) ? 0 : 1;
  }();
  return mode;
}

struct Cache {
  int64_t capacity = 0;
  int64_t count = 0;
  // per-row metadata (row index == slab slot); prev/next interleaved in one
  // 16-byte node so an LRU unlink touches one cache line, not two
  std::vector<uint64_t> row_sign;
  struct Link { int64_t prev, next; };
  std::vector<Link> lru;
  int64_t lru_head = -1, lru_tail = -1;
  std::vector<int64_t> free_rows;
  // open addressing sign -> row, sign and row interleaved in one 16-byte
  // bucket so a probe costs ONE cache-line fetch (this directory is
  // memory-latency-bound: the table spans tens of MB at production
  // capacities and every probe is a random access)
  struct Slot { uint64_t sign; int64_t row; };  // row -1 = empty
  std::vector<Slot> table;
  uint64_t mask = 0;
  // SIMD probe layout: a 1-byte tag per table slot, kept in a
  // separate dense array so one cache-line fetch covers 64 probe positions
  // instead of 4. tag = 0x80 | top-7-bits of splitmix64(sign) (the home
  // slot uses the LOW bits, so tag and placement are independent); 0x00 =
  // empty. The probe loads 8 tags as one u64 and resolves match/empty
  // lanes with SWAR compares; only tag-matching lanes touch the 16-byte
  // payload table. Tags are maintained on EVERY mutation regardless of
  // probe_mode, so the mode can flip at any time and both probes always
  // see a coherent layout. The 8 bytes past the end mirror tags[0..8) so
  // a group load starting near the top wraps without a branch.
  std::vector<uint8_t> tags;
  // 0 = scalar probe (golden reference), 1 = SIMD tag walk. Same results bit-for-bit by
  // construction: linear probing's result depends only on slot contents,
  // never on how many slots a step inspects at once.
  int probe_mode = default_probe_mode();
  // touch-gated admission (the reference's admit_probability analogue,
  // persia-embedding-config HyperParameters): a sign is only ADMITTED on
  // its admit_touches'th distinct-batch touch; earlier touches map to the
  // pad row (forward contributes zero, gradient dropped — exactly the
  // reference's non-admitted-sign semantics). Counters live in a compact
  // counting-Bloom byte table (hash-indexed, no sign storage): collisions
  // can only admit EARLY, never block admission. Slashes steady-state
  // eviction write-backs under zipf traffic (one-hit wonders never enter).
  int64_t admit_touches = 1;  // 1 = admit on first touch (exact parity)
  std::vector<uint8_t> touch_counts;
  uint64_t touch_mask = 0;

  explicit Cache(int64_t cap) : capacity(cap) {
    row_sign.assign(cap, 0);
    lru.assign(cap, Link{-1, -1});
    free_rows.reserve(cap);
    for (int64_t r = cap - 1; r >= 0; --r) free_rows.push_back(r);
    uint64_t tsize = 16;
    while (tsize < (uint64_t)cap * 2) tsize <<= 1;
    table.assign(tsize, Slot{0, -1});
    tags.assign(tsize + 8, 0);  // +8: wraparound mirror of tags[0..8)
    mask = tsize - 1;
  }

  void ensure_touch_table() {
    if (touch_counts.empty()) {
      uint64_t tsize = 16;
      while (tsize < (uint64_t)capacity * 4) tsize <<= 1;
      touch_counts.assign(tsize, 0);
      touch_mask = tsize - 1;
    }
  }

  inline uint64_t touch_idx(uint64_t sign) const {
    return splitmix64(sign ^ 0x5851F42D4C957F2DULL) & touch_mask;
  }

  // true -> admit now; false -> bypass this batch (counter bumped)
  inline bool touch_admits(uint64_t sign) {
    if (admit_touches <= 1) return true;
    uint8_t& c = touch_counts[touch_idx(sign)];
    if (c + 1 >= admit_touches) { c = 0; return true; }
    ++c;
    return false;
  }

  inline uint64_t home(uint64_t sign) const { return splitmix64(sign) & mask; }

  static inline uint8_t tag_of_hash(uint64_t h) {
    return (uint8_t)(0x80u | (uint32_t)(h >> 57));
  }

  // every tag write goes through here so the wrap mirror stays coherent
  inline void tag_set(uint64_t i, uint8_t v) {
    tags[i] = v;
    if (i < 8) tags[mask + 1 + i] = v;
  }

  int64_t find_pos_scalar(uint64_t sign) const {
    uint64_t i = home(sign);
    while (table[i].row >= 0) {
      if (table[i].sign == sign) return (int64_t)i;
      i = (i + 1) & mask;
    }
    return -1;
  }

  // SIMD tag walk with a precomputed sign hash: scan 8 tags per u64 load,
  // resolve candidate lanes in probe order, stop at the first empty lane.
  // Returns exactly what find_pos_scalar returns: linear probing's answer
  // ("the slot holding `sign` before the first empty slot from home") is a
  // property of the table contents alone, so inspecting 8 slots at a time
  // cannot change it — the lane mask discards candidates past the first
  // empty lane, and a tag hit (7-bit, ~1/128 false-positive rate) is
  // confirmed against the payload sign before it counts.
  int64_t find_pos_simd_h(uint64_t sign, uint64_t h) const {
    // home fast path: at the table's <=50% load factor most chains are one
    // slot long, and the home payload line is already prefetched by the
    // probe-wave stage — answer chain-length-1 probes with the SAME single
    // load the scalar walk pays, without touching the tag array's line
    const uint64_t home_p = h & mask;
    const Slot& s0 = table[home_p];
    if (s0.row < 0) return -1;
    if (s0.sign == sign) return (int64_t)home_p;
    const uint64_t target = swar_bcast8(tag_of_hash(h));
    uint64_t i = (home_p + 1) & mask;
    for (uint64_t probed = 0; probed <= mask; probed += 8) {
      uint64_t g;
      std::memcpy(&g, &tags[i], 8);  // mirror bytes make the top wrap safe
      uint64_t match = swar_zero_bytes(g ^ target);
      const uint64_t empty = swar_zero_bytes(g);
      if (empty) {
        // lanes at or past the first empty slot are beyond the probe
        // chain's end — a match there belongs to some other home's chain
        const int first_empty_lane = __builtin_ctzll(empty) >> 3;
        match &= ((uint64_t)1 << (8 * first_empty_lane)) - 1;
      }
      while (match) {
        const uint64_t p = (i + (uint64_t)(__builtin_ctzll(match) >> 3)) & mask;
        if (table[p].sign == sign) return (int64_t)p;
        match &= match - 1;  // clear this lane's 0x80 marker
      }
      if (empty) return -1;
      i = (i + 8) & mask;
    }
    return -1;
  }

  int64_t find_pos(uint64_t sign) const {
    return probe_mode ? find_pos_simd_h(sign, splitmix64(sign))
                      : find_pos_scalar(sign);
  }

  void lru_unlink(int64_t r) {
    const Link l = lru[r];
    if (l.prev >= 0) lru[l.prev].next = l.next; else lru_head = l.next;
    if (l.next >= 0) lru[l.next].prev = l.prev; else lru_tail = l.prev;
    lru[r] = Link{-1, -1};
  }

  void lru_push_front(int64_t r) {
    lru[r] = Link{-1, lru_head};
    if (lru_head >= 0) lru[lru_head].prev = r;
    lru_head = r;
    if (lru_tail < 0) lru_tail = r;
  }

  void touch(int64_t r) {
    if (lru_head == r) return;
    lru_unlink(r);
    lru_push_front(r);
  }

  void erase_table_pos(uint64_t i) {
    uint64_t j = i;
    for (;;) {
      table[i].row = -1;
      tag_set(i, 0);
      uint64_t k;
      for (;;) {
        j = (j + 1) & mask;
        if (table[j].row < 0) return;
        k = home(table[j].sign);
        bool home_in_range = (i <= j) ? (i < k && k <= j) : (i < k || k <= j);
        if (!home_in_range) break;
      }
      table[i] = table[j];
      tag_set(i, tags[j]);
      i = j;
    }
  }

  // evict the LRU row; returns (row) and writes its sign to *sign_out
  int64_t evict_lru(uint64_t* sign_out) {
    const int64_t r = lru_tail;
    *sign_out = row_sign[r];
    const int64_t pos = find_pos(row_sign[r]);
    if (pos >= 0) erase_table_pos((uint64_t)pos);
    lru_unlink(r);
    --count;
    return r;
  }

  int64_t insert(uint64_t sign) {  // caller guarantees a free row exists
    const int64_t r = free_rows.back();
    free_rows.pop_back();
    row_sign[r] = sign;
    const uint64_t h = splitmix64(sign);
    uint64_t i = h & mask;
    while (table[i].row >= 0) i = (i + 1) & mask;
    table[i] = Slot{sign, r};
    tag_set(i, tag_of_hash(h));
    lru_push_front(r);
    ++count;
    return r;
  }

  // full reset (the drain paths): empty table + tags + LRU + free list
  void reset_directory() {
    std::fill(table.begin(), table.end(), Slot{0, -1});
    std::fill(tags.begin(), tags.end(), 0);
    std::fill(lru.begin(), lru.end(), Link{-1, -1});
    lru_head = lru_tail = -1;
    count = 0;
    free_rows.clear();
    for (int64_t r = capacity - 1; r >= 0; --r) free_rows.push_back(r);
  }

  // batch-local scratch for cache_admit_positions (reused across calls):
  // 16-byte bucket = sign + (epoch<<32 | int32 val), so a probe costs one
  // cache-line fetch and there is NO per-call table clear (the clear cost
  // a multi-MB memset every batch) — a bucket is live only when its u32
  // epoch stamp matches the current call (wrap needs 2^32 calls)
  struct ScratchSlot { uint64_t sign; uint64_t packed; };
  std::vector<ScratchSlot> scratch;
  uint64_t scratch_mask = 0;
  uint64_t scratch_epoch = 0;

  void scratch_reserve(int64_t n) {
    uint64_t want = 16;
    while (want < (uint64_t)n * 2) want <<= 1;
    if (want > scratch.size()) {
      scratch.assign(want, ScratchSlot{0, 0});
      scratch_mask = want - 1;
      scratch_epoch = 0;
    }
    ++scratch_epoch;
  }
};

}  // namespace

extern "C" {

void* cache_create(int64_t capacity) { return new Cache(capacity); }

void cache_destroy(void* h) { delete static_cast<Cache*>(h); }

int64_t cache_len(void* h) { return static_cast<Cache*>(h)->count; }

int64_t cache_capacity(void* h) { return static_cast<Cache*>(h)->capacity; }

// Admit a batch of DEDUPLICATED signs. Two passes:
//   pass 1: every resident sign is LRU-touched (so no member of THIS batch
//           can be chosen as an eviction victim in pass 2 — a victim evicted
//           and re-missed in the same batch would check stale data out of
//           the PS while its fresh row is still riding the step's
//           write-back output);
//   pass 2: each miss evicts the LRU row if full, takes a row, and is
//           recorded in miss_idx_out; evictions are reported in
//           evict_*_out (evicted row == the reused row).
// All output arrays sized n by the caller. Returns n_miss (or -1 if
// n > capacity, which would force a batch member to evict another);
// *n_evict_out is the eviction count (n_evict <= n_miss). Signs must be
// distinct within one call (duplicates would double-admit).
int64_t cache_admit(void* h, const uint64_t* signs, int64_t n,
                    int64_t* rows_out, int64_t* miss_idx_out,
                    uint64_t* evict_signs_out, int64_t* evict_rows_out,
                    int64_t* n_evict_out) {
  Cache& c = *static_cast<Cache*>(h);
  *n_evict_out = 0;
  if (n > c.capacity) return -1;
  int64_t n_miss = 0, n_evict = 0;
  const int64_t PF = 16;  // software prefetch distance (latency-bound probes)
  for (int64_t i = 0; i < n; ++i) {
    if (i + PF < n) {
      const uint64_t hp = c.home(signs[i + PF]);
      __builtin_prefetch(&c.tags[hp]);
      __builtin_prefetch(&c.table[hp]);
    }
    const int64_t pos = c.find_pos(signs[i]);
    if (pos >= 0) {
      const int64_t r = c.table[pos].row;
      c.touch(r);
      rows_out[i] = r;
    } else if (!c.touch_admits(signs[i])) {
      rows_out[i] = c.capacity;  // bypass: pad row — zero fwd, grad dropped
    } else {
      rows_out[i] = -1;
      miss_idx_out[n_miss++] = i;
    }
  }
  for (int64_t m = 0; m < n_miss; ++m) {
    const int64_t i = miss_idx_out[m];
    if (c.count >= c.capacity) {
      uint64_t ev_sign;
      const int64_t ev_row = c.evict_lru(&ev_sign);
      evict_signs_out[n_evict] = ev_sign;
      evict_rows_out[n_evict] = ev_row;
      ++n_evict;
      c.free_rows.push_back(ev_row);
    }
    rows_out[i] = c.insert(signs[i]);
  }
  *n_evict_out = n_evict;
  return n_miss;
}

// Positions-level admit: like cache_admit but over a RAW (duplicated) sign
// stream — e.g. the concatenated (slot, batch) single-id matrix — with the
// dedup done here. One call replaces the per-slot dedup + cross-slot dedup +
// admit + per-position row LUT the Python tier used to run (the 1-core
// feeder's dominant prepare cost). Outputs:
//   rows_out[i]        (n,)  int32 cache row of position i
//   miss_signs_out     (<=n) first-seen-order distinct missing signs
//   miss_rows_out      (<=n) the row each miss was assigned
//   evict_*_out        (<=n) write-back victims
//   n_unique_out       distinct signs in the batch
//   n_evict_out        eviction count
// Returns n_miss, or -1 if the batch's distinct count exceeds capacity
// (outputs are then undefined; no rows were admitted or evicted, though
// resident signs seen before the overflow was detected keep their LRU
// touch — harmless, the caller raises).
int64_t cache_admit_positions(void* h, const uint64_t* signs, int64_t n,
                              int32_t* rows_out,
                              uint64_t* miss_signs_out, int64_t* miss_rows_out,
                              uint64_t* evict_signs_out, int64_t* evict_rows_out,
                              int64_t* n_unique_out, int64_t* n_evict_out) {
  Cache& c = *static_cast<Cache*>(h);
  *n_evict_out = 0;
  c.scratch_reserve(n);
  // pass 1: dedup + touch residents; misses get ordinal placeholders.
  // A scratch bucket's val holds: row (>=0, resident seen this batch — or
  // the pad row c.capacity for a touch-gated bypass) or -(miss_ordinal+2)
  // for a pending miss; a bucket is live only when its epoch stamp
  // matches this call.
  const uint64_t ep = c.scratch_epoch & 0xffffffffULL;
  int64_t n_unique = 0, n_miss = 0;
  const int64_t PF = 16;  // software prefetch distance: the scratch and
  // main tables span tens of MB, so every probe is a DRAM-latency random
  // access — prefetching the home buckets of signs[i+16] overlaps ~16
  // outstanding misses and is the main single-core speedup here
  for (int64_t i = 0; i < n; ++i) {
    if (i + PF < n) {
      const uint64_t hp = splitmix64(signs[i + PF]);
      __builtin_prefetch(&c.scratch[c.scratch_mask & hp]);
      __builtin_prefetch(&c.tags[hp & c.mask]);
      __builtin_prefetch(&c.table[hp & c.mask]);
    }
    const uint64_t s = signs[i];
    uint64_t j = c.scratch_mask & splitmix64(s);
    int64_t v;
    for (;;) {
      const Cache::ScratchSlot& sl = c.scratch[j];
      if ((sl.packed >> 32) != ep) { v = -1; break; }  // empty this batch
      if (sl.sign == s) { v = (int32_t)(uint32_t)sl.packed; break; }
      j = (j + 1) & c.scratch_mask;
    }
    if (v == -1) {  // first time this batch
      ++n_unique;
      const int64_t pos = c.find_pos(s);
      if (pos >= 0) {
        const int64_t r = c.table[pos].row;
        c.touch(r);
        v = r;
      } else if (!c.touch_admits(s)) {
        v = c.capacity;  // bypass: pad row — zero fwd, grad dropped
      } else {
        miss_signs_out[n_miss] = s;
        v = -(n_miss + 2);
        ++n_miss;
      }
      c.scratch[j] = Cache::ScratchSlot{s, (ep << 32) | (uint32_t)(int32_t)v};
    }
    rows_out[i] = (int32_t)v;  // miss placeholders fixed in pass 3
  }
  if (n_unique > c.capacity) {
    // nothing admitted yet (only LRU touches happened) — safe to bail
    return -1;
  }
  // pass 2: assign rows to misses (evicting LRU residents not in this batch)
  int64_t n_evict = 0;
  for (int64_t m = 0; m < n_miss; ++m) {
    if (c.count >= c.capacity) {
      uint64_t ev_sign;
      const int64_t ev_row = c.evict_lru(&ev_sign);
      evict_signs_out[n_evict] = ev_sign;
      evict_rows_out[n_evict] = ev_row;
      ++n_evict;
      c.free_rows.push_back(ev_row);
    }
    miss_rows_out[m] = c.insert(miss_signs_out[m]);
  }
  // pass 3: resolve miss placeholders to their assigned rows
  for (int64_t i = 0; i < n; ++i) {
    const int32_t v = rows_out[i];
    if (v < 0) rows_out[i] = (int32_t)miss_rows_out[-(int64_t)v - 2];
  }
  *n_unique_out = n_unique;
  *n_evict_out = n_evict;
  return n_miss;
}

// Read-only probe (no admit, no LRU touch): rows_out[i] = row or -1.
void cache_probe(void* h, const uint64_t* signs, int64_t n, int64_t* rows_out) {
  Cache& c = *static_cast<Cache*>(h);
  for (int64_t i = 0; i < n; ++i) {
    if (i + 16 < n) {
      const uint64_t hp = c.home(signs[i + 16]);
      __builtin_prefetch(&c.tags[hp]);
      __builtin_prefetch(&c.table[hp]);
    }
    const int64_t pos = c.find_pos(signs[i]);
    rows_out[i] = pos >= 0 ? c.table[pos].row : -1;
  }
}

// Touch-gated admission knob (the reference's admit_probability analogue):
// a non-resident sign is admitted only on its t'th distinct-batch touch;
// earlier touches map to the pad row (zero forward, dropped gradient —
// the reference's non-admitted-sign semantics). t=1 restores exact
// admit-on-first-touch behavior.
void cache_set_admit_touches(void* h, int64_t t) {
  Cache& c = *static_cast<Cache*>(h);
  // counters are uint8: clamp to 255 so a huge threshold degrades to
  // "admit on the 255th touch" instead of wrapping and never admitting
  c.admit_touches = t < 1 ? 1 : (t > 255 ? 255 : t);
  if (c.admit_touches > 1) c.ensure_touch_table();
}

// The touch gate's counters (empty with admit_touches 1): a snapshot fence
// saves them beside the flushed cache, so a resumed directory admits as the
// uninterrupted one would. cache_touch_counts copies them into out when
// n is their count and returns the count; cache_set_touch_counts loads n
// of them (n must be their count) and returns 0, or -1 on a wrong n.
int64_t cache_touch_counts(void* h, uint8_t* out, int64_t n) {
  Cache& c = *static_cast<Cache*>(h);
  const int64_t size = (int64_t)c.touch_counts.size();
  if (out != nullptr && n == size) std::copy(c.touch_counts.begin(), c.touch_counts.end(), out);
  return size;
}

int64_t cache_set_touch_counts(void* h, const uint8_t* in, int64_t n) {
  Cache& c = *static_cast<Cache*>(h);
  if (n != (int64_t)c.touch_counts.size()) return -1;
  std::copy(in, in + n, c.touch_counts.begin());
  return 0;
}

// Probe implementation switch: 0 = scalar (golden reference), nonzero =
// SIMD tag walk. Tags are maintained under both modes, so switching is
// always safe and results are bit-identical either way
// (tests/test_torch_hbm_cache.py runs both).
void cache_set_probe_mode(void* h, int64_t mode) {
  static_cast<Cache*>(h)->probe_mode = mode ? 1 : 0;
}

int64_t cache_probe_mode(void* h) {
  return static_cast<Cache*>(h)->probe_mode;
}

// Non-destructive listing of every resident (sign, row) pair in LRU order
// (MRU first): the serving-freshness publish path reads resident rows
// without disturbing the directory.
int64_t cache_snapshot(void* h, uint64_t* signs_out, int64_t* rows_out) {
  Cache& c = *static_cast<Cache*>(h);
  int64_t k = 0;
  for (int64_t r = c.lru_head; r >= 0; r = c.lru[r].next) {
    signs_out[k] = c.row_sign[r];
    rows_out[k] = r;
    ++k;
  }
  return k;
}

// Drain every resident entry (for flush-all at checkpoint/eval boundaries):
// writes all (sign, row) pairs in LRU order (MRU first) and empties the
// directory. Returns the number drained.
int64_t cache_drain(void* h, uint64_t* signs_out, int64_t* rows_out) {
  Cache& c = *static_cast<Cache*>(h);
  int64_t k = 0;
  for (int64_t r = c.lru_head; r >= 0; r = c.lru[r].next) {
    signs_out[k] = c.row_sign[r];
    rows_out[k] = r;
    ++k;
  }
  c.reset_directory();
  return k;
}

// Seeded per-sign uniform embedding init, bit-identical to the Python
// golden model (persia_tpu_torch/embedding/hashing.py uniform_init_for_signs:
// counter-mode splitmix64, top-53-bit mantissa, f64 affine then f32 cast).
// The cached tier inits every cold miss per step; doing it here keeps the
// single-core feeder off numpy's temporaries.
void cache_uniform_init(const uint64_t* signs, int64_t m, int64_t dim,
                        uint64_t seed, double lo, double hi, float* out) {
  const double kScale = 1.0 / 9007199254740992.0;  // 2^-53
  const double span = hi - lo;
  for (int64_t i = 0; i < m; ++i) {
    const uint64_t base = splitmix64(signs[i] ^ seed);
    float* row = out + i * dim;
    for (int64_t j = 0; j < dim; ++j) {
      const uint64_t s = splitmix64(base + (uint64_t)j);
      row[j] = (float)(lo + (double)(s >> 11) * kScale * span);
    }
  }
}

// Non-uniform seeded init for cached-tier cold misses. The algorithms are a
// verbatim mirror of persia_tpu_torch/native/ps.cpp Store::{normal,poisson,
// gamma}_from (each .cpp is a standalone translation unit, one source per
// .so, so the samplers are duplicated; tests/test_torch_hbm_cache.py holds
// these rows bit for bit to the reference's and to the port's numpy init).
namespace initk {

constexpr double kToUnit = 1.0 / 9007199254740992.0;  // 2^-53
constexpr double kTwoPi = 6.283185307179586;

struct SubStream {
  uint64_t b;
  uint64_t j = 0;
  SubStream(uint64_t base, uint64_t i) : b(splitmix64(base + i)) {}
  double next() { return (double)(splitmix64(b + 1 + j++) >> 11) * kToUnit; }
};

inline double normal_from(SubStream& st, double mean, double std_) {
  double u1 = st.next();
  if (u1 < kToUnit) u1 = kToUnit;
  double u2 = st.next();
  return mean + std_ * (std::sqrt(-2.0 * std::log(u1)) * std::cos(kTwoPi * u2));
}

inline double poisson_from(SubStream& st, double lam) {
  if (lam <= 0.0) return 0.0;
  double big_l = std::exp(-lam);
  int k = 0;
  double p = 1.0;
  while (k < 4096) {
    ++k;
    p *= st.next();
    if (!(p > big_l)) break;
  }
  return (double)(k - 1);
}

inline double gamma_from(SubStream& st, double shape, double scale) {
  if (shape <= 0.0) return 0.0;
  double boost = 1.0, k = shape;
  if (k < 1.0) {
    double u = st.next();
    if (u < kToUnit) u = kToUnit;
    boost = std::pow(u, 1.0 / k);
    k += 1.0;
  }
  double d = k - 1.0 / 3.0;
  double c = 1.0 / (3.0 * std::sqrt(d));
  for (int it = 0; it < 1024; ++it) {
    double x = normal_from(st, 0.0, 1.0);
    double v = 1.0 + c * x;
    if (v <= 0.0) continue;
    v = v * v * v;
    double u = st.next();
    if (u < 1.0 - 0.0331 * x * x * x * x) return boost * d * v * scale;
    double lu = std::log(u < kToUnit ? kToUnit : u);
    if (lu < 0.5 * x * x + d * (1.0 - v + std::log(v)))
      return boost * d * v * scale;
  }
  return boost * d * scale;
}

}  // namespace initk

// kind codes: 0=uniform 1=gamma 2=poisson 3=normal 4=inverse_sqrt
// (config.py INIT_KIND_CODES)
void cache_init_rows(const uint64_t* signs, int64_t m, int64_t dim,
                     uint64_t seed, int kind, double p0, double p1,
                     float* out) {
  if (kind == 0) return cache_uniform_init(signs, m, dim, seed, p0, p1, out);
  if (kind == 4) {
    double b = 1.0 / std::sqrt((double)dim);
    return cache_uniform_init(signs, m, dim, seed, -b, b, out);
  }
  for (int64_t i = 0; i < m; ++i) {
    const uint64_t base = splitmix64(signs[i] ^ seed);
    float* row = out + i * dim;
    for (int64_t j = 0; j < dim; ++j) {
      initk::SubStream st(base, (uint64_t)j);
      double v = 0.0;
      if (kind == 3) v = initk::normal_from(st, p0, p1);
      else if (kind == 2) v = initk::poisson_from(st, p0);
      else if (kind == 1) v = initk::gamma_from(st, p0, p1);
      row[j] = (float)v;
    }
  }
}

}  // extern "C"

// ------------------------------------------------------------ pending map
//
// sign -> (token, src) open-addressing map for the stream's write-back
// hazard gate: which in-flight eviction (token = the step's seq) holds a
// sign's freshest row, and at which row of the group's device ring (src).
// Insert overwrites (a later step wins); remove is token-conditional, so a
// landing write-back cannot delete a newer step's entry for the same sign.
// An internal mutex makes it thread-safe: the feeder probes it inside
// cache_feed_batch while the write-back thread removes landed entries. The
// map is one for all groups; callers namespace a group's keys by XOR-ing
// its salt into the signs (cache_feed_batch's `salt`).

namespace {

struct PendingMap {
  struct Slot {
    uint64_t sign;
    int64_t src;
    uint32_t token;
    uint8_t state;  // 0 empty, 1 used, 2 tombstone
  };
  std::mutex mu;
  std::vector<Slot> t;
  uint64_t mask = 0;
  int64_t count = 0;     // used slots
  int64_t occupied = 0;  // used + tombstones (the probe chains' load)

  void init(uint64_t cap) {
    uint64_t c = 64;
    while (c < cap) c <<= 1;
    t.assign(c, Slot{0, 0, 0, 0});
    mask = c - 1;
    count = occupied = 0;
  }

  void grow_if_needed(int64_t incoming) {
    if ((occupied + incoming) * 10 < (int64_t)t.size() * 7) return;
    std::vector<Slot> old;
    old.swap(t);
    uint64_t c = old.size();
    while ((count + incoming) * 10 >= (int64_t)c * 7) c <<= 1;
    t.assign(c, Slot{0, 0, 0, 0});
    mask = c - 1;
    count = occupied = 0;
    for (const Slot& s : old)
      if (s.state == 1) put(s.sign, s.src, s.token);
  }

  void put(uint64_t sign, int64_t src, uint32_t token) {
    uint64_t j = splitmix64(sign) & mask;
    int64_t first_tomb = -1;
    for (;;) {
      Slot& sl = t[j];
      if (sl.state == 0) {
        if (first_tomb >= 0) {
          t[first_tomb] = Slot{sign, src, token, 1};
        } else {
          sl = Slot{sign, src, token, 1};
          ++occupied;
        }
        ++count;
        return;
      }
      if (sl.state == 2) {
        if (first_tomb < 0) first_tomb = (int64_t)j;
      } else if (sl.sign == sign) {
        sl.src = src;
        sl.token = token;  // overwrite: a later step wins
        return;
      }
      j = (j + 1) & mask;
    }
  }

  // the caller holds mu; true on a live hit
  inline bool find(uint64_t s, int64_t* src, uint32_t* token) const {
    uint64_t j = splitmix64(s) & mask;
    for (;;) {
      const Slot& sl = t[j];
      if (sl.state == 0) return false;
      if (sl.state == 1 && sl.sign == s) {
        *src = sl.src;
        *token = sl.token;
        return true;
      }
      j = (j + 1) & mask;
    }
  }
};

}  // namespace

extern "C" {

void* pending_map_create() {
  auto* m = new (std::nothrow) PendingMap();
  if (m) m->init(1 << 12);
  return m;
}

void pending_map_destroy(void* h) { delete static_cast<PendingMap*>(h); }

int64_t pending_map_size(void* h) {
  PendingMap& m = *static_cast<PendingMap*>(h);
  std::lock_guard<std::mutex> lk(m.mu);
  return m.count;
}

void pending_map_insert(void* h, const uint64_t* signs, const int64_t* srcs, int64_t n, uint32_t token) {
  PendingMap& m = *static_cast<PendingMap*>(h);
  std::lock_guard<std::mutex> lk(m.mu);
  m.grow_if_needed(n);
  for (int64_t i = 0; i < n; ++i) m.put(signs[i], srcs[i], token);
}

// signs[i] -> (base_src + i, token): a step's evictions take one
// contiguous span of the ring
void pending_map_insert_range(void* h, const uint64_t* signs, int64_t n, int64_t base_src, uint32_t token) {
  PendingMap& m = *static_cast<PendingMap*>(h);
  std::lock_guard<std::mutex> lk(m.mu);
  m.grow_if_needed(n);
  for (int64_t i = 0; i < n; ++i) m.put(signs[i], base_src + i, token);
}

// tokens_out / srcs_out a sign (src -1: not pending); returns the hits
int64_t pending_map_query(void* h, const uint64_t* signs, int64_t n, uint32_t* tokens_out, int64_t* srcs_out) {
  PendingMap& m = *static_cast<PendingMap*>(h);
  std::lock_guard<std::mutex> lk(m.mu);
  int64_t hits = 0;
  const int64_t PF = 16;
  for (int64_t i = 0; i < n; ++i) {
    if (i + PF < n) __builtin_prefetch(&m.t[splitmix64(signs[i + PF]) & m.mask]);
    srcs_out[i] = -1;
    tokens_out[i] = 0;
    int64_t src;
    uint32_t token;
    if (m.find(signs[i], &src, &token)) {
      srcs_out[i] = src;
      tokens_out[i] = token;
      ++hits;
    }
  }
  return hits;
}

// remove the signs whose current entry carries `token` (a later re-evict
// of the same sign under a newer token survives its older landing)
void pending_map_remove(void* h, const uint64_t* signs, int64_t n, uint32_t token) {
  PendingMap& m = *static_cast<PendingMap*>(h);
  std::lock_guard<std::mutex> lk(m.mu);
  for (int64_t i = 0; i < n; ++i) {
    const uint64_t s = signs[i];
    uint64_t j = splitmix64(s) & m.mask;
    for (;;) {
      PendingMap::Slot& sl = m.t[j];
      if (sl.state == 0) break;
      if (sl.state == 1 && sl.sign == s) {
        if (sl.token == token) {
          sl.state = 2;  // a tombstone (occupied stays; growth compacts)
          --m.count;
        }
        break;
      }
      j = (j + 1) & m.mask;
    }
  }
}

// ------------------------------------------------------------ fused feeder
//
// The feeder's admit in one call: cache_admit_positions, then the pending
// map's probe of the misses (key = sign ^ salt), under the map's mutex.
// Extra outputs, sized by the caller as the misses are:
//   restore_src_out[j]  the ring row holding the j-th hit's freshest entry
//   restore_pos_out[j]  its ordinal among miss_signs_out / miss_rows_out
//   *n_restore_out      the hits
// Returns n_miss, or -1 on a capacity overflow (as cache_admit_positions;
// no probe then). The probe runs before the caller reserves this step's
// ring span, so the caller queries the hits again after reserving it: a
// write-back landing in between may have freed a span the hits point into.
int64_t cache_feed_batch(void* h, void* pending_h, const uint64_t* signs, int64_t n, int32_t* rows_out,
                         uint64_t* miss_signs_out, int64_t* miss_rows_out, uint64_t* evict_signs_out,
                         int64_t* evict_rows_out, int64_t* n_unique_out, int64_t* n_evict_out,
                         int64_t* restore_src_out, int64_t* restore_pos_out, int64_t* n_restore_out, uint64_t salt) {
  *n_restore_out = 0;
  const int64_t n_miss = cache_admit_positions(h, signs, n, rows_out, miss_signs_out, miss_rows_out, evict_signs_out,
                                               evict_rows_out, n_unique_out, n_evict_out);
  if (n_miss < 0 || pending_h == nullptr) return n_miss;
  PendingMap& m = *static_cast<PendingMap*>(pending_h);
  std::lock_guard<std::mutex> lk(m.mu);
  if (m.count == 0) return n_miss;
  int64_t n_restore = 0;
  const int64_t PF = 16;
  for (int64_t j = 0; j < n_miss; ++j) {
    if (j + PF < n_miss) __builtin_prefetch(&m.t[splitmix64(miss_signs_out[j + PF] ^ salt) & m.mask]);
    int64_t src;
    uint32_t token;
    if (m.find(miss_signs_out[j] ^ salt, &src, &token)) {
      restore_src_out[n_restore] = src;
      restore_pos_out[n_restore] = j;
      ++n_restore;
    }
  }
  *n_restore_out = n_restore;
  return n_miss;
}

}  // extern "C"

// ------------------------------------------------------------ sharded feeder
//
// The directory partitioned into S shards by the group's salted sign hash
// (shard_route of sign ^ part_salt: the pending map's salt doubles as the
// partition key), each with its own mutex, LRU chain and range of the
// card's rows. cache_feed_batch_sharded buckets the position stream by
// shard (a stable counting sort), walks each shard's positions on a pool
// of native threads (the calling thread walks too) and merges the outputs
// in ascending shard order on the calling thread.
//
// Determinism: a sign's shard is a function of (sign, part_salt, S) alone;
// each shard walks its positions in input order against its own state; the
// merge is in shard order. The row LUT, misses, evictions and restores are
// therefore the same bits at any thread count (threads change which OS
// thread walks a shard, never the walk), and at S == 1 they are
// cache_feed_batch's.
//
// Locking: a walker holds its own shard's mutex for the admit passes,
// releases it, then takes the pending map's for the miss probe; no thread
// holds two shard mutexes. Probes, lengths and snapshots may run beside a
// feed (they take one shard mutex at a time); feeds and drains on one
// handle are the caller's to serialise, as with the unsharded directory.

namespace {

constexpr int64_t SHARD_MAX = 64;

inline int64_t shard_route(uint64_t sign, uint64_t part_salt, int64_t n_shards) {
  // multiply-high range reduction of the salted hash: no modulo bias, and a
  // function of (sign, salt, S) only
  return (int64_t)((unsigned __int128)splitmix64(sign ^ part_salt) * (unsigned __int128)(uint64_t)n_shards >> 64);
}

struct FeedShard {
  Cache dir;      // the shard's directory; its rows are offset by row_base
  std::mutex mu;  // guards dir: a feed's walk against probe/drain/snapshot/len
  int64_t row_base = 0;
  // the last feed's outputs, merged by the caller in shard order
  std::vector<uint64_t> miss_signs;
  std::vector<int64_t> miss_rows;
  std::vector<uint64_t> ev_signs;
  std::vector<int64_t> ev_rows;
  std::vector<int64_t> rst_src;
  std::vector<int64_t> rst_pos;  // the shard's own miss ordinals
  int64_t n_unique = 0;
  bool overflow = false;
  // the last feed's walk time over both phases and its wait in the pool's
  // queue (dispatch to walk start, summed over both phases): busy says how
  // long the shard walked, stall how long it waited for a thread
  std::atomic<int64_t> busy_ns{0};
  std::atomic<int64_t> stall_ns{0};

  explicit FeedShard(int64_t cap) : dir(cap) {}
};

struct ShardedCache {
  int64_t total_capacity = 0;
  int64_t n_shards = 1;
  uint64_t part_salt = 0;
  std::vector<std::unique_ptr<FeedShard>> shards;

  // the calling thread's bucketing buffers (one feed at a time a handle)
  std::vector<uint8_t> sid;
  std::vector<int64_t> start;  // CSR offsets, n_shards + 1
  std::vector<int64_t> fill;
  std::vector<int64_t> pos;    // position indices grouped by shard

  // the pool: n_threads - 1 workers and the calling thread. Every dispatch
  // is exactly n_shards items, and the caller waits for all of them before
  // it replaces `job`, so a late worker's fetch_add past the end claims
  // nothing of a later dispatch.
  std::mutex pool_mu;
  std::condition_variable cv_work, cv_done;
  uint64_t gen = 0;
  std::function<void(int64_t)> job;
  std::atomic<int64_t> next_item{0};
  int64_t items_done = 0;
  bool stopping = false;
  int64_t n_threads = 1;
  // the workers' pinning (0 none, 1 compact: worker i on cpu i % ncpu,
  // 2 spread: workers striped across the cpus); guarded by pool_mu, a
  // change respawns the workers so that it applies from their start. The
  // calling thread is never pinned.
  int64_t affinity_mode = 0;
  std::vector<std::thread> workers;

  ShardedCache(int64_t cap, int64_t n, uint64_t salt, int64_t threads)
      : total_capacity(cap), n_shards(n), part_salt(salt) {
    const int64_t base = cap / n, rem = cap % n;
    int64_t row_base = 0;
    for (int64_t s = 0; s < n; ++s) {
      const int64_t c = base + (s < rem ? 1 : 0);
      shards.emplace_back(new FeedShard(c));
      shards.back()->row_base = row_base;
      row_base += c;
    }
    set_threads(threads);
  }

  ~ShardedCache() { set_threads(1); }

  void stop_workers() {
    {
      std::lock_guard<std::mutex> lk(pool_mu);
      stopping = true;
    }
    cv_work.notify_all();
    for (auto& w : workers) w.join();
    workers.clear();
    std::lock_guard<std::mutex> lk(pool_mu);
    stopping = false;
  }

  void start_workers(int64_t t) {
    for (int64_t i = 0; i < t - 1; ++i) workers.emplace_back([this, i] { worker_loop(i); });
  }

  void set_threads(int64_t t) {
    if (t < 1) t = 1;
    if (t > n_shards) t = n_shards;  // more threads than shards would idle
    {
      std::lock_guard<std::mutex> lk(pool_mu);
      if (t == n_threads && (t == 1 || !workers.empty())) return;
    }
    stop_workers();
    {
      std::lock_guard<std::mutex> lk(pool_mu);
      n_threads = t;
    }
    start_workers(t);
  }

  void set_affinity(int64_t mode) {
    if (mode < 0 || mode > 2) mode = 0;
    int64_t t;
    {
      std::lock_guard<std::mutex> lk(pool_mu);
      if (mode == affinity_mode) return;
      affinity_mode = mode;
      t = n_threads;
      if (workers.empty()) return;  // applies when workers next start
    }
    stop_workers();
    start_workers(t);
  }

  // pin pool worker widx at its start (best effort; Linux only)
  void apply_affinity(int64_t widx) {
#if defined(__linux__)
    int64_t mode, t;
    {
      std::lock_guard<std::mutex> lk(pool_mu);
      mode = affinity_mode;
      t = n_threads;
    }
    if (mode == 0) return;
    const long ncpu_l = sysconf(_SC_NPROCESSORS_ONLN);
    if (ncpu_l <= 0) return;
    const int64_t ncpu = (int64_t)ncpu_l;
    const int64_t n_workers = t > 1 ? t - 1 : 1;
    const int64_t cpu = mode == 1 ? widx % ncpu : (widx * ncpu / n_workers) % ncpu;
    cpu_set_t set;
    CPU_ZERO(&set);
    CPU_SET((int)cpu, &set);
    pthread_setaffinity_np(pthread_self(), sizeof(set), &set);
#else
    (void)widx;
#endif
  }

  void drain_items() {
    int64_t done = 0;
    for (;;) {
      const int64_t s = next_item.fetch_add(1);
      if (s >= n_shards) break;
      job(s);
      ++done;
    }
    if (done > 0) {
      std::lock_guard<std::mutex> lk(pool_mu);
      items_done += done;
      if (items_done >= n_shards) cv_done.notify_all();
    }
  }

  void worker_loop(int64_t widx) {
    apply_affinity(widx);
    uint64_t seen = 0;
    for (;;) {
      {
        std::unique_lock<std::mutex> lk(pool_mu);
        cv_work.wait(lk, [&] { return stopping || gen != seen; });
        if (stopping) return;
        seen = gen;
      }
      drain_items();
    }
  }

  // fn(s) for every shard, the caller taking part; returns once all are done
  void run_shards(const std::function<void(int64_t)>& fn) {
    if (n_threads <= 1) {
      for (int64_t s = 0; s < n_shards; ++s) fn(s);
      return;
    }
    {
      std::lock_guard<std::mutex> lk(pool_mu);
      job = fn;
      items_done = 0;
      next_item.store(0);
      ++gen;
    }
    cv_work.notify_all();
    drain_items();
    std::unique_lock<std::mutex> lk(pool_mu);
    cv_done.wait(lk, [&] { return items_done >= n_shards; });
  }
};

// phase A of one shard (the caller holds sh.mu): deduplicate and touch the
// residents over the shard's positions; misses get ordinal placeholders.
// LUT values are global: row_base + row, the global pad row
// (total_capacity) for a touch-gated bypass, or -(local miss ordinal + 2).
// Nothing is admitted yet, so an overflow of any shard can still bail
// with only LRU touches applied (cache_admit_positions' contract).
void shard_pass1(FeedShard& sh, const uint64_t* signs, int32_t* rows_out, const int64_t* pos, int64_t p0,
                 int64_t p1, int64_t total_capacity) {
  Cache& c = sh.dir;
  c.scratch_reserve(p1 - p0);
  sh.miss_signs.clear();
  sh.n_unique = 0;
  sh.overflow = false;
  const uint64_t ep = c.scratch_epoch & 0xffffffffULL;
  const int64_t PF = 16;  // the unsharded walk's prefetch distance
  for (int64_t t = p0; t < p1; ++t) {
    if (t + PF < p1) {
      const uint64_t hp = splitmix64(signs[pos[t + PF]]);
      __builtin_prefetch(&c.scratch[c.scratch_mask & hp]);
      __builtin_prefetch(&c.tags[hp & c.mask]);
      __builtin_prefetch(&c.table[hp & c.mask]);
    }
    const int64_t i = pos[t];
    const uint64_t s = signs[i];
    uint64_t j = c.scratch_mask & splitmix64(s);
    int64_t v;
    for (;;) {
      const Cache::ScratchSlot& sl = c.scratch[j];
      if ((sl.packed >> 32) != ep) { v = -1; break; }
      if (sl.sign == s) { v = (int32_t)(uint32_t)sl.packed; break; }
      j = (j + 1) & c.scratch_mask;
    }
    if (v == -1) {  // first time this batch
      ++sh.n_unique;
      const int64_t lpos = c.find_pos(s);
      if (lpos >= 0) {
        const int64_t r = c.table[lpos].row;
        c.touch(r);
        v = sh.row_base + r;
      } else if (!c.touch_admits(s)) {
        v = total_capacity;  // the global pad row: a zero forward, its gradient dropped
      } else {
        v = -((int64_t)sh.miss_signs.size() + 2);
        sh.miss_signs.push_back(s);
      }
      c.scratch[j] = Cache::ScratchSlot{s, (ep << 32) | (uint32_t)(int32_t)v};
    }
    rows_out[i] = (int32_t)v;
  }
  sh.overflow = sh.n_unique > c.capacity;
}

// phase B of one shard (the caller holds sh.mu): rows for the misses
// (evicting the shard's least recently used residents not in this batch),
// then the placeholders resolved. Rows are global.
void shard_pass2(FeedShard& sh, int32_t* rows_out, const int64_t* pos, int64_t p0, int64_t p1) {
  Cache& c = sh.dir;
  const int64_t n_miss = (int64_t)sh.miss_signs.size();
  sh.miss_rows.clear();
  sh.ev_signs.clear();
  sh.ev_rows.clear();
  for (int64_t m = 0; m < n_miss; ++m) {
    if (c.count >= c.capacity) {
      uint64_t ev_sign;
      const int64_t ev_row = c.evict_lru(&ev_sign);
      sh.ev_signs.push_back(ev_sign);
      sh.ev_rows.push_back(sh.row_base + ev_row);
      c.free_rows.push_back(ev_row);
    }
    sh.miss_rows.push_back(sh.row_base + c.insert(sh.miss_signs[m]));
  }
  for (int64_t t = p0; t < p1; ++t) {
    const int64_t i = pos[t];
    const int32_t v = rows_out[i];
    if (v < 0) rows_out[i] = (int32_t)sh.miss_rows[-(int64_t)v - 2];
  }
}

// the pending map's probe of one shard's misses (cache_feed_batch's
// contract: the caller queries the hits again after reserving its ring
// span). The caller must not hold sh.mu.
void shard_ledger_probe(FeedShard& sh, PendingMap* m, uint64_t salt) {
  sh.rst_src.clear();
  sh.rst_pos.clear();
  if (m == nullptr) return;
  std::lock_guard<std::mutex> lk(m->mu);
  if (m->count == 0) return;
  const int64_t n_miss = (int64_t)sh.miss_signs.size();
  const int64_t PF = 16;
  for (int64_t j = 0; j < n_miss; ++j) {
    if (j + PF < n_miss) __builtin_prefetch(&m->t[splitmix64(sh.miss_signs[j + PF] ^ salt) & m->mask]);
    int64_t src;
    uint32_t token;
    if (m->find(sh.miss_signs[j] ^ salt, &src, &token)) {
      sh.rst_src.push_back(src);
      sh.rst_pos.push_back(j);
    }
  }
}

inline int64_t ns_since(std::chrono::steady_clock::time_point t0) {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(std::chrono::steady_clock::now() - t0).count();
}

}  // namespace

extern "C" {

// the capacity split evenly across the shards (the first capacity % S get
// one row more); n_shards clamped to [1, min(64, capacity)], threads to
// [1, n_shards]
void* cache_create_sharded(int64_t capacity, int64_t n_shards, uint64_t part_salt, int64_t threads) {
  if (capacity < 1) return nullptr;
  if (n_shards < 1) n_shards = 1;
  if (n_shards > SHARD_MAX) n_shards = SHARD_MAX;
  if (n_shards > capacity) n_shards = capacity;
  return new (std::nothrow) ShardedCache(capacity, n_shards, part_salt, threads);
}

void cache_sharded_destroy(void* h) { delete static_cast<ShardedCache*>(h); }

int64_t cache_sharded_len(void* h) {
  ShardedCache& sc = *static_cast<ShardedCache*>(h);
  int64_t total = 0;
  for (auto& sh : sc.shards) {
    std::lock_guard<std::mutex> lk(sh->mu);
    total += sh->dir.count;
  }
  return total;
}

int64_t cache_sharded_capacity(void* h) { return static_cast<ShardedCache*>(h)->total_capacity; }

int64_t cache_sharded_n_shards(void* h) { return static_cast<ShardedCache*>(h)->n_shards; }

int64_t cache_sharded_threads(void* h) {
  ShardedCache& sc = *static_cast<ShardedCache*>(h);
  std::lock_guard<std::mutex> lk(sc.pool_mu);
  return sc.n_threads;
}

void cache_sharded_set_threads(void* h, int64_t t) { static_cast<ShardedCache*>(h)->set_threads(t); }

void cache_sharded_set_admit_touches(void* h, int64_t t) {
  ShardedCache& sc = *static_cast<ShardedCache*>(h);
  for (auto& sh : sc.shards) {
    std::lock_guard<std::mutex> lk(sh->mu);
    Cache& c = sh->dir;
    c.admit_touches = t < 1 ? 1 : (t > 255 ? 255 : t);
    if (c.admit_touches > 1) c.ensure_touch_table();
  }
}

// the touch gate's counters of every shard, concatenated in shard order
// (cache_touch_counts' contract over the concatenation)
int64_t cache_sharded_touch_counts(void* h, uint8_t* out, int64_t n) {
  ShardedCache& sc = *static_cast<ShardedCache*>(h);
  int64_t size = 0;
  for (auto& sh : sc.shards) size += (int64_t)sh->dir.touch_counts.size();
  if (out == nullptr || n != size) return size;
  int64_t k = 0;
  for (auto& sh : sc.shards) {
    std::lock_guard<std::mutex> lk(sh->mu);
    std::copy(sh->dir.touch_counts.begin(), sh->dir.touch_counts.end(), out + k);
    k += (int64_t)sh->dir.touch_counts.size();
  }
  return size;
}

int64_t cache_sharded_set_touch_counts(void* h, const uint8_t* in, int64_t n) {
  ShardedCache& sc = *static_cast<ShardedCache*>(h);
  int64_t size = 0;
  for (auto& sh : sc.shards) size += (int64_t)sh->dir.touch_counts.size();
  if (n != size) return -1;
  int64_t k = 0;
  for (auto& sh : sc.shards) {
    std::lock_guard<std::mutex> lk(sh->mu);
    const int64_t m = (int64_t)sh->dir.touch_counts.size();
    std::copy(in + k, in + k + m, sh->dir.touch_counts.begin());
    k += m;
  }
  return 0;
}

// each shard's resident count (out sized n_shards)
void cache_sharded_shard_sizes(void* h, int64_t* out) {
  ShardedCache& sc = *static_cast<ShardedCache*>(h);
  for (int64_t s = 0; s < sc.n_shards; ++s) {
    std::lock_guard<std::mutex> lk(sc.shards[s]->mu);
    out[s] = sc.shards[s]->dir.count;
  }
}

// each shard's walk ns of the last feed (out sized n_shards)
void cache_sharded_shard_busy_ns(void* h, int64_t* out) {
  ShardedCache& sc = *static_cast<ShardedCache*>(h);
  for (int64_t s = 0; s < sc.n_shards; ++s) out[s] = sc.shards[s]->busy_ns.load(std::memory_order_relaxed);
}

// each shard's pool-queue ns of the last feed (out sized n_shards)
void cache_sharded_shard_stall_ns(void* h, int64_t* out) {
  ShardedCache& sc = *static_cast<ShardedCache*>(h);
  for (int64_t s = 0; s < sc.n_shards; ++s) out[s] = sc.shards[s]->stall_ns.load(std::memory_order_relaxed);
}

// every shard's probe (1 the tag walk, 0 scalar; the same results), set
// under each shard's mutex
void cache_sharded_set_probe_mode(void* h, int64_t mode) {
  ShardedCache& sc = *static_cast<ShardedCache*>(h);
  for (auto& sh : sc.shards) {
    std::lock_guard<std::mutex> lk(sh->mu);
    sh->dir.probe_mode = mode ? 1 : 0;
  }
}

int64_t cache_sharded_probe_mode(void* h) {
  ShardedCache& sc = *static_cast<ShardedCache*>(h);
  std::lock_guard<std::mutex> lk(sc.shards[0]->mu);
  return sc.shards[0]->dir.probe_mode;
}

void cache_sharded_set_affinity(void* h, int64_t mode) { static_cast<ShardedCache*>(h)->set_affinity(mode); }

int64_t cache_sharded_affinity(void* h) {
  ShardedCache& sc = *static_cast<ShardedCache*>(h);
  std::lock_guard<std::mutex> lk(sc.pool_mu);
  return sc.affinity_mode;
}

// read-only probe (no admit, no LRU touch): rows_out[i] = global row or -1;
// one pass a shard, one mutex at a time
void cache_sharded_probe(void* h, const uint64_t* signs, int64_t n, int64_t* rows_out) {
  ShardedCache& sc = *static_cast<ShardedCache*>(h);
  const int64_t S = sc.n_shards;
  for (int64_t s = 0; s < S; ++s) {
    FeedShard& sh = *sc.shards[s];
    std::lock_guard<std::mutex> lk(sh.mu);
    for (int64_t i = 0; i < n; ++i) {
      if (S != 1 && shard_route(signs[i], sc.part_salt, S) != s) continue;
      const int64_t p = sh.dir.find_pos(signs[i]);
      rows_out[i] = p >= 0 ? sh.row_base + sh.dir.table[p].row : -1;
    }
  }
}

// cache_admit over distinct signs with global rows; miss_idx_out lists the
// missing inputs in shard order (input order within a shard). Returns -1,
// before changing anything, when a shard's routed count exceeds its
// capacity.
int64_t cache_sharded_admit(void* h, const uint64_t* signs, int64_t n, int64_t* rows_out, int64_t* miss_idx_out,
                            uint64_t* evict_signs_out, int64_t* evict_rows_out, int64_t* n_evict_out) {
  ShardedCache& sc = *static_cast<ShardedCache*>(h);
  *n_evict_out = 0;
  const int64_t S = sc.n_shards;
  std::vector<int64_t> routed(S, 0);
  std::vector<uint8_t> sid(n);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t s = S == 1 ? 0 : shard_route(signs[i], sc.part_salt, S);
    sid[i] = (uint8_t)s;
    ++routed[s];
  }
  for (int64_t s = 0; s < S; ++s)
    if (routed[s] > sc.shards[s]->dir.capacity) return -1;
  int64_t n_miss = 0, n_evict = 0;
  std::vector<int64_t> local_miss;
  for (int64_t s = 0; s < S; ++s) {
    FeedShard& sh = *sc.shards[s];
    std::lock_guard<std::mutex> lk(sh.mu);
    Cache& c = sh.dir;
    local_miss.clear();
    for (int64_t i = 0; i < n; ++i) {
      if (sid[i] != (uint8_t)s) continue;
      const int64_t p = c.find_pos(signs[i]);
      if (p >= 0) {
        const int64_t r = c.table[p].row;
        c.touch(r);
        rows_out[i] = sh.row_base + r;
      } else if (!c.touch_admits(signs[i])) {
        rows_out[i] = sc.total_capacity;
      } else {
        local_miss.push_back(i);
      }
    }
    for (const int64_t i : local_miss) {
      if (c.count >= c.capacity) {
        uint64_t ev_sign;
        const int64_t ev_row = c.evict_lru(&ev_sign);
        evict_signs_out[n_evict] = ev_sign;
        evict_rows_out[n_evict] = sh.row_base + ev_row;
        ++n_evict;
        c.free_rows.push_back(ev_row);
      }
      rows_out[i] = sh.row_base + c.insert(signs[i]);
      miss_idx_out[n_miss++] = i;
    }
  }
  *n_evict_out = n_evict;
  return n_miss;
}

// every resident (sign, global row), in shard order, most recent first
// within a shard; drain also empties every shard
static int64_t sharded_listing(void* h, uint64_t* signs_out, int64_t* rows_out, bool reset) {
  ShardedCache& sc = *static_cast<ShardedCache*>(h);
  int64_t k = 0;
  for (auto& shp : sc.shards) {
    FeedShard& sh = *shp;
    std::lock_guard<std::mutex> lk(sh.mu);
    Cache& c = sh.dir;
    for (int64_t r = c.lru_head; r >= 0; r = c.lru[r].next) {
      signs_out[k] = c.row_sign[r];
      rows_out[k] = sh.row_base + r;
      ++k;
    }
    if (reset) c.reset_directory();
  }
  return k;
}

int64_t cache_sharded_snapshot(void* h, uint64_t* signs_out, int64_t* rows_out) {
  return sharded_listing(h, signs_out, rows_out, false);
}

int64_t cache_sharded_drain(void* h, uint64_t* signs_out, int64_t* rows_out) {
  return sharded_listing(h, signs_out, rows_out, true);
}

// The sharded feeder call: cache_feed_batch's outputs and contract (global
// rows; -1 on any shard's overflow with nothing admitted). Phase A (the
// deduplicating walks) completes in every shard before phase B (the
// admits, then the pending map's probe) starts in any, so an overflow
// bails before a shard admits.
int64_t cache_feed_batch_sharded(void* h, void* pending_h, const uint64_t* signs, int64_t n, int32_t* rows_out,
                                 uint64_t* miss_signs_out, int64_t* miss_rows_out, uint64_t* evict_signs_out,
                                 int64_t* evict_rows_out, int64_t* n_unique_out, int64_t* n_evict_out,
                                 int64_t* restore_src_out, int64_t* restore_pos_out, int64_t* n_restore_out,
                                 uint64_t salt) {
  ShardedCache& sc = *static_cast<ShardedCache*>(h);
  *n_unique_out = *n_evict_out = *n_restore_out = 0;
  const int64_t S = sc.n_shards;
  // a stable counting sort: each shard's positions keep input order
  sc.sid.resize((size_t)n);
  sc.start.assign((size_t)S + 1, 0);
  sc.fill.assign((size_t)S, 0);
  sc.pos.resize((size_t)n);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t s = S == 1 ? 0 : shard_route(signs[i], sc.part_salt, S);
    sc.sid[i] = (uint8_t)s;
    ++sc.start[s + 1];
  }
  for (int64_t s = 0; s < S; ++s) sc.start[s + 1] += sc.start[s];
  for (int64_t i = 0; i < n; ++i) {
    const int64_t s = sc.sid[i];
    sc.pos[sc.start[s] + sc.fill[s]++] = i;
  }
  const auto t_dispatch_a = std::chrono::steady_clock::now();
  sc.run_shards([&](int64_t s) {
    FeedShard& sh = *sc.shards[s];
    const auto t0 = std::chrono::steady_clock::now();
    sh.stall_ns.store(std::chrono::duration_cast<std::chrono::nanoseconds>(t0 - t_dispatch_a).count(),
                      std::memory_order_relaxed);
    {
      std::lock_guard<std::mutex> lk(sh.mu);
      shard_pass1(sh, signs, rows_out, sc.pos.data(), sc.start[s], sc.start[s + 1], sc.total_capacity);
    }
    sh.busy_ns.store(ns_since(t0), std::memory_order_relaxed);
  });
  for (int64_t s = 0; s < S; ++s)
    if (sc.shards[s]->overflow) return -1;
  const auto t_dispatch_b = std::chrono::steady_clock::now();
  sc.run_shards([&](int64_t s) {
    FeedShard& sh = *sc.shards[s];
    const auto t0 = std::chrono::steady_clock::now();
    sh.stall_ns.fetch_add(std::chrono::duration_cast<std::chrono::nanoseconds>(t0 - t_dispatch_b).count(),
                          std::memory_order_relaxed);
    {
      std::lock_guard<std::mutex> lk(sh.mu);
      shard_pass2(sh, rows_out, sc.pos.data(), sc.start[s], sc.start[s + 1]);
    }
    shard_ledger_probe(sh, static_cast<PendingMap*>(pending_h), salt);
    sh.busy_ns.fetch_add(ns_since(t0), std::memory_order_relaxed);
  });
  // the merge, in shard order
  int64_t n_miss = 0, n_unique = 0, n_evict = 0, n_restore = 0;
  for (int64_t s = 0; s < S; ++s) {
    FeedShard& sh = *sc.shards[s];
    const int64_t miss_base = n_miss;
    std::copy(sh.miss_signs.begin(), sh.miss_signs.end(), miss_signs_out + n_miss);
    std::copy(sh.miss_rows.begin(), sh.miss_rows.end(), miss_rows_out + n_miss);
    n_miss += (int64_t)sh.miss_signs.size();
    std::copy(sh.ev_signs.begin(), sh.ev_signs.end(), evict_signs_out + n_evict);
    std::copy(sh.ev_rows.begin(), sh.ev_rows.end(), evict_rows_out + n_evict);
    n_evict += (int64_t)sh.ev_signs.size();
    for (size_t j = 0; j < sh.rst_pos.size(); ++j) {
      restore_src_out[n_restore] = sh.rst_src[j];
      restore_pos_out[n_restore] = miss_base + sh.rst_pos[j];
      ++n_restore;
    }
    n_unique += sh.n_unique;
  }
  *n_unique_out = n_unique;
  *n_evict_out = n_evict;
  *n_restore_out = n_restore;
  return n_miss;
}

}  // extern "C"
