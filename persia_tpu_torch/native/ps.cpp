// persia_tpu_torch's native parameter-server core: the port's own copy of
// the reference's core (native/ps.cpp), trimmed to the lookup and gradient
// paths. Built with g++ at first use by
// persia_tpu_torch/embedding/native_store.py.
//
//   - a sharded LRU embedding holder: an open-addressing hash table per
//     internal shard with backward-shift deletion and an intrusive
//     doubly-linked LRU over an entry slab;
//   - entries [emb | optimizer state] in one flat float vector, with the
//     seeded-by-sign init (uniform, gamma, poisson, normal, inverse_sqrt);
//   - train lookups LRU-touch hits, admit misses behind a probability gate
//     and re-init on a dim mismatch; infer lookups read zeros on a miss;
//   - gradient updates apply the registered sparse optimizer (SGD,
//     Adagrad +- vectorwise, Adam with per-group batch beta powers), clamp
//     to +-weight_bound, and count the rows whose sign is absent
//     (grad misses);
//   - the checkpoint unit: one internal shard dumped in the wire format
//     shared with the numpy store, from the least to the most recently
//     used entry, and loaded back routed by sign;
//   - the bounded apply-journal: ids of gradient batches already applied
//     since the last snapshot fence, each with its payload's crc32, so a
//     resumed trainer's replay applies each batch exactly once.
//
// Numeric contract: identical splitmix64 shard routing, admit gate, seeded
// init and per-element update formulas to the port's numpy store
// (persia_tpu_torch/embedding/store.py). Built with the reference's flags,
// this core computes the reference core's floats bit for bit; against the
// numpy store, the update's floats agree to rtol 2e-5 (-mfma contracts)
// and everything integer (entries present, eviction, misses) exactly.
// Parity: tests/test_torch_native_store.py.
//
//   - the cache tier's entry reads: a full-entry checkout (admitting
//     misses), a warm/cold probe (admitting nothing) and an entry's dim.
//
// Range export and delete and the non-finite scrub are not part of this
// copy.
//
// C ABI only (ctypes-friendly); no Python headers needed.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <map>
#include <mutex>
#include <new>
#include <unordered_map>
#include <vector>

namespace {

// ----------------------------------------------------------------- hashing

inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

// ---------------------------------------------------------------- optimizer

enum OptKind { OPT_NONE = -1, OPT_SGD = 0, OPT_ADAGRAD = 1, OPT_ADAM = 2 };

struct OptimizerConfig {
  int kind = OPT_NONE;
  float lr = 0.01f;
  float weight_decay = 0.f;
  float initialization = 0.01f;  // adagrad accumulator init
  float g_square_momentum = 1.f;
  float eps = 1e-10f;
  int vectorwise_shared = 0;
  float beta1 = 0.9f;
  float beta2 = 0.999f;

  uint32_t state_dim(uint32_t dim) const {
    switch (kind) {
      case OPT_SGD: return 0;
      case OPT_ADAGRAD: return vectorwise_shared ? 1 : dim;
      case OPT_ADAM: return 2 * dim;
      default: return 0;
    }
  }
};

// ------------------------------------------------------------------- shard

struct Entry {
  uint64_t sign;
  float* data;     // [emb | state], heap-owned
  uint32_t dim;    // embedding dim (first `dim` floats of data are the emb)
  uint32_t len;    // total floats = dim + optimizer state
  int32_t prev, next;  // LRU list links (entry slab indices)
};

struct Shard {
  // open-addressing table: table_sign/table_slot parallel arrays, pow2 size
  std::vector<uint64_t> table_sign;
  std::vector<int32_t> table_slot;  // -1 = empty, else index into entries
  std::vector<Entry> entries;
  std::vector<int32_t> free_list;
  int32_t lru_head = -1;  // most recently used
  int32_t lru_tail = -1;  // least recently used
  size_t count = 0;
  size_t max_entries = 0;
  size_t mask = 0;
  std::mutex mu;

  void init(size_t cap) {
    max_entries = cap ? cap : 1;
    size_t tsize = 4;
    while (tsize < max_entries * 2) tsize <<= 1;
    table_sign.assign(tsize, 0);
    table_slot.assign(tsize, -1);
    mask = tsize - 1;
    entries.reserve(max_entries);
  }

  inline size_t home(uint64_t sign) const { return splitmix64(sign) & mask; }

  // returns table position of sign or SIZE_MAX
  size_t find_pos(uint64_t sign) const {
    size_t i = home(sign);
    while (table_slot[i] >= 0) {
      if (table_sign[i] == sign) return i;
      i = (i + 1) & mask;
    }
    return SIZE_MAX;
  }

  void lru_unlink(int32_t e) {
    Entry& en = entries[e];
    if (en.prev >= 0) entries[en.prev].next = en.next; else lru_head = en.next;
    if (en.next >= 0) entries[en.next].prev = en.prev; else lru_tail = en.prev;
    en.prev = en.next = -1;
  }

  void lru_push_front(int32_t e) {
    Entry& en = entries[e];
    en.prev = -1;
    en.next = lru_head;
    if (lru_head >= 0) entries[lru_head].prev = e;
    lru_head = e;
    if (lru_tail < 0) lru_tail = e;
  }

  void touch(int32_t e) {
    if (lru_head == e) return;
    lru_unlink(e);
    lru_push_front(e);
  }

  // backward-shift deletion at table position pos (linear probing invariant kept)
  void erase_table_pos(size_t i) {
    size_t j = i;
    for (;;) {
      table_slot[i] = -1;
      size_t k;
      for (;;) {
        j = (j + 1) & mask;
        if (table_slot[j] < 0) return;
        k = home(table_sign[j]);
        // move j back to i unless j's home lies cyclically in (i, j]
        bool home_in_range = (i <= j) ? (i < k && k <= j) : (i < k || k <= j);
        if (!home_in_range) break;
      }
      table_sign[i] = table_sign[j];
      table_slot[i] = table_slot[j];
      i = j;
    }
  }

  void remove_entry(int32_t e) {
    size_t pos = find_pos(entries[e].sign);
    if (pos != SIZE_MAX) erase_table_pos(pos);
    lru_unlink(e);
    std::free(entries[e].data);
    entries[e].data = nullptr;
    free_list.push_back(e);
    --count;
  }

  void evict_lru() {
    if (lru_tail >= 0) remove_entry(lru_tail);
  }

  // insert new sign (must not exist); returns entry index with uninit data ptr
  int32_t insert(uint64_t sign, uint32_t dim, uint32_t len) {
    if (count >= max_entries) evict_lru();
    int32_t e;
    if (!free_list.empty()) {
      e = free_list.back();
      free_list.pop_back();
    } else {
      entries.push_back(Entry{});
      e = (int32_t)entries.size() - 1;
    }
    Entry& en = entries[e];
    en.sign = sign;
    en.dim = dim;
    en.len = len;
    en.data = (float*)std::malloc(sizeof(float) * len);
    en.prev = en.next = -1;
    size_t i = home(sign);
    while (table_slot[i] >= 0) i = (i + 1) & mask;
    table_sign[i] = sign;
    table_slot[i] = e;
    lru_push_front(e);
    ++count;
    return e;
  }

  ~Shard() {
    for (auto& en : entries)
      if (en.data) std::free(en.data);
  }
};

// ------------------------------------------------------------------- store

struct Store {
  std::vector<Shard> shards;
  uint32_t num_shards;
  uint64_t seed;
  // hyperparameters (configure())
  double init_lo = -0.01, init_hi = 0.01;
  // init distribution (ps_set_init_method): 0=uniform 1=gamma 2=poisson
  // 3=normal 4=inverse_sqrt; p0/p1 per-kind params (config.py INIT_KIND_CODES)
  int init_kind = 0;
  double init_p0 = -0.01, init_p1 = 0.01;
  double admit_prob = 1.0;
  float weight_bound = 10.f;
  OptimizerConfig opt;
  std::map<int, std::pair<double, double>> batch_state;  // group -> (b1^t, b2^t)
  std::mutex batch_mu;
  // gradient rows skipped because their sign was absent (evicted, never
  // admitted) or held an entry of another dim or width
  std::atomic<int64_t> grad_misses{0};

  // Bounded apply-journal: id -> payload crc32 of the gradient batches
  // applied since the last snapshot fence. FIFO-bounded (the ring evicts
  // the oldest id once journal_cap ids are held), which is safe because a
  // resume only replays ids newer than the last committed fence.
  std::unordered_map<uint64_t, uint32_t> journal_map;
  std::vector<uint64_t> journal_ring;  // insertion order
  size_t journal_cap = 1 << 16;
  size_t journal_head = 0;  // ring slot the next insert overwrites when full
  std::mutex journal_mu;

  void journal_record(uint64_t id, uint32_t crc) {
    std::lock_guard<std::mutex> g(journal_mu);
    auto it = journal_map.find(id);
    if (it != journal_map.end()) {
      it->second = crc;
      return;
    }
    if (journal_ring.size() < journal_cap) {
      journal_ring.push_back(id);
    } else {
      journal_map.erase(journal_ring[journal_head]);
      journal_ring[journal_head] = id;
      journal_head = (journal_head + 1) % journal_cap;
    }
    journal_map.emplace(id, crc);
  }

  // 1 = applied (crc matches), 0 = unknown, -1 = applied with another crc
  int journal_probe(uint64_t id, uint32_t crc) {
    std::lock_guard<std::mutex> g(journal_mu);
    auto it = journal_map.find(id);
    if (it == journal_map.end()) return 0;
    return it->second == crc ? 1 : -1;
  }

  void journal_clear() {
    std::lock_guard<std::mutex> g(journal_mu);
    journal_map.clear();
    journal_ring.clear();
    journal_head = 0;
  }

  Store(uint64_t capacity, uint32_t n_shards, uint64_t seed_) : shards(n_shards) {
    num_shards = n_shards;
    seed = seed_;
    size_t per = capacity / n_shards;
    if (per < 1) per = 1;
    for (auto& s : shards) s.init(per);
  }

  inline Shard& shard_of(uint64_t sign) {
    // identical to the Python golden model: splitmix64(sign ^ 0xA5A5A5A5) % n
    return shards[splitmix64(sign ^ 0xA5A5A5A5ULL) % num_shards];
  }

  inline bool admit(uint64_t sign) const {
    if (admit_prob >= 1.0) return true;
    if (admit_prob <= 0.0) return false;
    uint64_t h = splitmix64(sign ^ 0xC0FFEEULL);
    return (double)(h % (1ULL << 24)) / (double)(1ULL << 24) < admit_prob;
  }

  // counter-mode uniform init, bit-identical to the port's
  // embedding/hashing.py uniform_init_for_signs
  void uniform_row(uint64_t sign, uint32_t dim, double lo, double hi,
                   float* out) const {
    uint64_t base = splitmix64(sign ^ seed);
    double range = hi - lo;
    for (uint32_t i = 0; i < dim; ++i) {
      uint64_t s = splitmix64(base + i);
      double u = (double)(s >> 11) * kToUnit;
      out[i] = (float)(lo + u * range);
    }
  }

  // Seeded init distributions beyond uniform (ref: emb_entry.rs:28-60).
  // Per-element splitmix64 substreams + glibc libm transcendentals — the
  // EXACT algorithms of embedding/hashing.py _normal_from/_poisson_from/
  // _gamma_from (CPython math.* calls the same libm), so rows are
  // bit-identical to the numpy store's where libm is glibc's.
  static constexpr double kToUnit = 1.0 / 9007199254740992.0;  // 2^-53
  static constexpr double kTwoPi = 6.283185307179586;

  struct SubStream {
    uint64_t b;
    uint64_t j = 0;
    SubStream(uint64_t base, uint64_t i) : b(splitmix64(base + i)) {}
    double next() { return (double)(splitmix64(b + 1 + j++) >> 11) * kToUnit; }
  };

  static double normal_from(SubStream& st, double mean, double std_) {
    double u1 = st.next();
    if (u1 < kToUnit) u1 = kToUnit;
    double u2 = st.next();
    return mean + std_ * (std::sqrt(-2.0 * std::log(u1)) * std::cos(kTwoPi * u2));
  }

  static double poisson_from(SubStream& st, double lam) {
    if (lam <= 0.0) return 0.0;
    double big_l = std::exp(-lam);
    int k = 0;
    double p = 1.0;
    while (k < 4096) {  // hard cap mirrored in hashing.py
      ++k;
      p *= st.next();
      if (!(p > big_l)) break;
    }
    return (double)(k - 1);
  }

  static double gamma_from(SubStream& st, double shape, double scale) {
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
    for (int it = 0; it < 1024; ++it) {  // cap mirrored in hashing.py
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
    return boost * d * scale;  // pathological-params fallback (same in Python)
  }

  void init_embedding(uint64_t sign, uint32_t dim, float* out) const {
    switch (init_kind) {
      case 0:  // uniform
        return uniform_row(sign, dim, init_p0, init_p1, out);
      case 4: {  // inverse_sqrt: uniform in ±1/sqrt(dim)
        double b = 1.0 / std::sqrt((double)dim);
        return uniform_row(sign, dim, -b, b, out);
      }
    }
    uint64_t base = splitmix64(sign ^ seed);
    for (uint32_t i = 0; i < dim; ++i) {
      SubStream st(base, i);
      double v = 0.0;
      if (init_kind == 3) v = normal_from(st, init_p0, init_p1);
      else if (init_kind == 2) v = poisson_from(st, init_p0);
      else if (init_kind == 1) v = gamma_from(st, init_p0, init_p1);
      out[i] = (float)v;
    }
  }

  void init_state(uint32_t dim, float* state) const {
    uint32_t sd = opt.state_dim(dim);
    if (opt.kind == OPT_ADAGRAD) {
      for (uint32_t i = 0; i < sd; ++i) state[i] = opt.initialization;
    } else {
      std::memset(state, 0, sizeof(float) * sd);
    }
  }

  std::pair<double, double> get_batch_state(int group) {
    std::lock_guard<std::mutex> g(batch_mu);
    auto it = batch_state.find(group);
    if (it != batch_state.end()) return it->second;
    // default: one advance from (1,1) — matches the Python store
    return {(double)opt.beta1, (double)opt.beta2};
  }

  void advance_batch_state(int group) {
    if (opt.kind != OPT_ADAM) return;
    std::lock_guard<std::mutex> g(batch_mu);
    auto it = batch_state.find(group);
    if (it == batch_state.end()) {
      batch_state[group] = {(double)opt.beta1, (double)opt.beta2};
    } else {
      it->second.first *= opt.beta1;
      it->second.second *= opt.beta2;
    }
  }

  void update_entry(float* emb, float* state, const float* grad_in, uint32_t dim,
                    std::pair<double, double> bs) {
    switch (opt.kind) {
      case OPT_SGD: {
        const float lr = opt.lr, wd = opt.weight_decay;
        if (wd != 0.f) {
          for (uint32_t i = 0; i < dim; ++i) emb[i] -= lr * (grad_in[i] + wd * emb[i]);
        } else {
          for (uint32_t i = 0; i < dim; ++i) emb[i] -= lr * grad_in[i];
        }
        break;
      }
      case OPT_ADAGRAD: {
        const float lr = opt.lr, wd = opt.weight_decay, mom = opt.g_square_momentum,
                    eps = opt.eps;
        if (opt.vectorwise_shared) {
          // shared accumulator = mean(g^2); double accumulation like numpy
          double g2 = 0.0;
          for (uint32_t i = 0; i < dim; ++i) {
            float g = grad_in[i] + (wd != 0.f ? wd * emb[i] : 0.f);
            g2 += (double)g * (double)g;
          }
          g2 /= (double)dim;
          state[0] = state[0] * mom + (float)g2;
          float denom = std::sqrt(state[0] + eps);
          for (uint32_t i = 0; i < dim; ++i) {
            float g = grad_in[i] + (wd != 0.f ? wd * emb[i] : 0.f);
            emb[i] -= lr * g / denom;
          }
        } else {
          for (uint32_t i = 0; i < dim; ++i) {
            float g = grad_in[i] + (wd != 0.f ? wd * emb[i] : 0.f);
            state[i] = state[i] * mom + g * g;
            emb[i] -= lr * g / std::sqrt(state[i] + eps);
          }
        }
        break;
      }
      case OPT_ADAM: {
        const float lr = opt.lr, wd = opt.weight_decay, b1 = opt.beta1, b2 = opt.beta2,
                    eps = opt.eps;
        float* m = state;
        float* v = state + dim;
        const float bc1 = (float)(1.0 - bs.first);
        const float bc2 = (float)(1.0 - bs.second);
        for (uint32_t i = 0; i < dim; ++i) {
          float g = grad_in[i] + (wd != 0.f ? wd * emb[i] : 0.f);
          m[i] = b1 * m[i] + (1.f - b1) * g;
          v[i] = b2 * v[i] + (1.f - b2) * g * g;
          float m_hat = m[i] / bc1;
          float v_hat = v[i] / bc2;
          emb[i] -= lr * m_hat / (std::sqrt(v_hat) + eps);
        }
        break;
      }
      default:
        break;
    }
    if (weight_bound > 0.f) {
      const float b = weight_bound;
      for (uint32_t i = 0; i < dim; ++i) {
        if (emb[i] > b) emb[i] = b;
        else if (emb[i] < -b) emb[i] = -b;
      }
    }
  }
};

// What a row does once its entry (or miss) is resolved:
//   kDefer  — read/update the entry's data; the engine applies it in order
//             with the data lines prefetched (classify prefetches them)
//   kDone   — fully handled inside classify (zero-fill, warm=0, skip)
//   kMutate — needs structural mutation (insert/evict/re-init); the engine
//             drains earlier rows, runs `mutate` sequentially, then
//             re-resolves everything after it (an insert can change what a
//             later duplicate sign resolves to)
enum class RowAction : int8_t { kDefer = 0, kDone = 1, kMutate = 2 };

// Shard-grouped row walk shared by the batched lookup/update entry points:
// stable counting sort of row indices by owning shard, then one shard at a
// time — ONE lock per touched shard instead of per row. Within a shard,
// rows process in chunks through a 4-pass software pipeline:
//   1. prefetch the chunk's home buckets        (table spans 100s of MB)
//   2. probe (buckets hot) + prefetch Entry structs
//   3. classify (structs hot) + prefetch entry data rows
//   4. apply in original order (data hot)
// Each pass issues up to CHUNK independent DRAM loads concurrently instead
// of one dependent chain per row — the walk is memory-latency bound, and
// this is where the per-row cost goes from ~4 serialized misses to ~4
// misses amortized over the whole chunk. Passes 1-3 are read-only; applies
// and mutations run in the rows' ORIGINAL relative order, so the resulting
// table/LRU/optimizer state is IDENTICAL to the sequential per-row walk
// (shards are independent state; stability of the counting sort preserves
// within-shard order).
template <class Classify, class Apply, class Mutate>
inline void walk_rows_by_shard(Store* s, const uint64_t* signs, int64_t n,
                               Classify&& classify, Apply&& apply,
                               Mutate&& mutate) {
  const uint32_t ns = s->num_shards;
  thread_local std::vector<uint32_t> cnt;
  thread_local std::vector<uint32_t> shard_idx;
  thread_local std::vector<int64_t> order;
  cnt.assign(ns + 1, 0);
  if ((int64_t)shard_idx.size() < n) { shard_idx.resize(n); order.resize(n); }
  for (int64_t i = 0; i < n; ++i) {
    shard_idx[i] = (uint32_t)(splitmix64(signs[i] ^ 0xA5A5A5A5ULL) % ns);
    cnt[shard_idx[i] + 1]++;
  }
  for (uint32_t r = 0; r < ns; ++r) cnt[r + 1] += cnt[r];
  {
    thread_local std::vector<uint32_t> ofs;
    ofs.assign(cnt.begin(), cnt.end() - 1);
    for (int64_t i = 0; i < n; ++i) order[ofs[shard_idx[i]]++] = i;
  }
  constexpr int64_t CHUNK = 32;
  int32_t ent[CHUNK];
  RowAction act[CHUNK];
  for (uint32_t r = 0; r < ns; ++r) {
    int64_t k = cnt[r];
    const int64_t k_end = cnt[r + 1];
    if (k == k_end) continue;
    Shard& sh = s->shards[r];
    std::lock_guard<std::mutex> g(sh.mu);
    while (k < k_end) {
      const int64_t m = std::min(CHUNK, k_end - k);
      for (int64_t j = 0; j < m; ++j) {
        const size_t hp = sh.home(signs[order[k + j]]);
        __builtin_prefetch(&sh.table_sign[hp]);
        __builtin_prefetch(&sh.table_slot[hp]);
      }
      for (int64_t j = 0; j < m; ++j) {
        const size_t pos = sh.find_pos(signs[order[k + j]]);
        const int32_t e = (pos == SIZE_MAX) ? -1 : sh.table_slot[pos];
        ent[j] = e;
        if (e >= 0) __builtin_prefetch(&sh.entries[e]);
      }
      // classification stops at the first mutation: a structural change can
      // alter what every later row resolves to (duplicate-sign inserts)
      int64_t stop = m;
      for (int64_t j = 0; j < m; ++j) {
        act[j] = classify(sh, order[k + j], ent[j]);
        if (act[j] == RowAction::kMutate) { stop = j; break; }
      }
      for (int64_t j = 0; j < stop; ++j)
        if (act[j] == RowAction::kDefer) apply(sh, order[k + j], ent[j]);
      if (stop < m) {
        mutate(sh, order[k + stop]);
        k += stop + 1;
        // Drain a RUN of consecutive mutations sequentially (cold fill
        // classifies nearly every row kMutate; restarting the 32-row
        // pipeline to consume one row per pass would redo ~16x the probe
        // work). Back to chunked mode at the first non-mutating row.
        while (k < k_end) {
          const int64_t i = order[k];
          const size_t pos = sh.find_pos(signs[i]);
          const int32_t e = (pos == SIZE_MAX) ? -1 : sh.table_slot[pos];
          const RowAction a = classify(sh, i, e);
          if (a == RowAction::kMutate) {
            mutate(sh, i);
            ++k;
            continue;
          }
          if (a == RowAction::kDefer) apply(sh, i, e);
          ++k;
          break;
        }
      } else {
        k += m;
      }
    }
  }
}

// data-row prefetch helper for classify passes
inline void prefetch_row(const float* data, uint32_t n_floats) {
  for (uint32_t o = 0; o < n_floats; o += 16) __builtin_prefetch(data + o);
}

}  // namespace

// ------------------------------------------------------------------- C API

extern "C" {

void* ps_create(uint64_t capacity, uint32_t num_shards, uint64_t seed) {
  if (capacity == 0 || num_shards == 0) return nullptr;
  return new (std::nothrow) Store(capacity, num_shards, seed);
}

void ps_destroy(void* h) { delete (Store*)h; }

void ps_configure(void* h, double init_lo, double init_hi, double admit_prob,
                  float weight_bound) {
  Store* s = (Store*)h;
  s->init_lo = init_lo;
  s->init_hi = init_hi;
  // keep the uniform params in sync for callers that never push an explicit
  // init method (ps_set_init_method overrides these after)
  if (s->init_kind == 0) {
    s->init_p0 = init_lo;
    s->init_p1 = init_hi;
  }
  s->admit_prob = admit_prob;
  s->weight_bound = weight_bound;
}

void ps_set_init_method(void* h, int kind, double p0, double p1) {
  Store* s = (Store*)h;
  s->init_kind = kind;
  s->init_p0 = p0;
  s->init_p1 = p1;
}

void ps_register_optimizer(void* h, int kind, float lr, float weight_decay,
                           float initialization, float g_square_momentum, float eps,
                           int vectorwise_shared, float beta1, float beta2) {
  Store* s = (Store*)h;
  s->opt = OptimizerConfig{kind, lr, weight_decay, initialization, g_square_momentum,
                           eps, vectorwise_shared, beta1, beta2};
  std::lock_guard<std::mutex> g(s->batch_mu);
  s->batch_state.clear();
}

// Multi-slot batched lookup: ONE call per training batch instead of one per
// slot (the per-slot fan-out was measurable pure overhead on a 1-core host;
// reference batches the same way — lookup_batched_all_slots,
// embedding_worker_service/mod.rs:874-942). Group g covers rows
// [key_ofs[g], key_ofs[g+1]) of `signs` with embedding dim dims[g]; its rows
// are written at out + out_ofs[g] (float offset), row-major. State effects
// (LRU order, admits, evictions) are identical to per-slot sequential calls
// — see walk_rows_by_shard.
void ps_lookup_batched(void* h, const uint64_t* signs, const int64_t* key_ofs,
                       const uint32_t* dims, const int64_t* out_ofs,
                       int32_t n_groups, int train, float* out) {
  Store* s = (Store*)h;
  const int64_t n = n_groups > 0 ? key_ofs[n_groups] : 0;
  if (n == 0) return;
  // per-row group resolution (rows are contiguous per group)
  thread_local std::vector<int32_t> row_group;
  if ((int64_t)row_group.size() < n) row_group.resize(n);
  for (int32_t g = 0; g < n_groups; ++g)
    for (int64_t i = key_ofs[g]; i < key_ofs[g + 1]; ++i) row_group[i] = g;
  thread_local std::vector<uint32_t> entry_lens;
  entry_lens.resize(n_groups);
  for (int32_t g = 0; g < n_groups; ++g)
    entry_lens[g] = dims[g] + s->opt.state_dim(dims[g]);

  auto row_ptr = [&](int64_t i) {
    const int32_t g = row_group[i];
    return out + out_ofs[g] + (size_t)(i - key_ofs[g]) * dims[g];
  };
  walk_rows_by_shard(
      s, signs, n,
      [&](Shard& sh, int64_t i, int32_t e) {
        const int32_t g = row_group[i];
        const uint32_t dim = dims[g];
        if (e >= 0 && sh.entries[e].dim == dim &&
            (!train || sh.entries[e].len == entry_lens[g])) {
          prefetch_row(sh.entries[e].data, dim);
          return RowAction::kDefer;
        }
        if (!train) {  // infer: zeros on miss/mismatch — never read state
          std::memset(row_ptr(i), 0, sizeof(float) * dim);
          return RowAction::kDone;
        }
        if (e < 0 && !s->admit(signs[i])) {
          std::memset(row_ptr(i), 0, sizeof(float) * dim);
          return RowAction::kDone;
        }
        return RowAction::kMutate;  // admit-miss insert or dim-mismatch re-init
      },
      [&](Shard& sh, int64_t i, int32_t e) {
        if (train) sh.touch(e);
        std::memcpy(row_ptr(i), sh.entries[e].data,
                    sizeof(float) * dims[row_group[i]]);
      },
      [&](Shard& sh, int64_t i) {
        const int32_t g = row_group[i];
        const uint32_t dim = dims[g];
        const uint64_t sign = signs[i];
        size_t pos = sh.find_pos(sign);
        int32_t e = (pos == SIZE_MAX) ? -1 : sh.table_slot[pos];
        if (e >= 0) sh.remove_entry(e);  // dim mismatch → re-init
        int32_t ne = sh.insert(sign, dim, entry_lens[g]);
        float* data = sh.entries[ne].data;
        s->init_embedding(sign, dim, data);
        s->init_state(dim, data + dim);
        std::memcpy(row_ptr(i), data, sizeof(float) * dim);
      });
}

// out: (n, dim) row-major f32
void ps_lookup(void* h, const uint64_t* signs, int64_t n, uint32_t dim, int train,
               float* out) {
  const int64_t key_ofs[2] = {0, n};
  const int64_t out_ofs[1] = {0};
  ps_lookup_batched(h, signs, key_ofs, &dim, out_ofs, 1, train, out);
}

// Batched full-entry checkout for the HBM cache tier
// (persia_tpu_torch/embedding/hbm_cache): like a train lookup, but copies the
// whole [emb | optimizer state] row so the device-side sparse optimizer
// continues from the PS's accumulated state. Misses are admitted
// unconditionally (the cache tier owns admission; write-back re-inserts on
// eviction either way) with the same seeded init as ps_lookup. Entries with
// a mismatched dim are re-initialized, matching lookup. `out` is
// (n, dim + state_dim) row-major. Returns the entry length.
int64_t ps_checkout(void* h, const uint64_t* signs, int64_t n, uint32_t dim,
                    float* out) {
  Store* s = (Store*)h;
  const uint32_t entry_len = dim + s->opt.state_dim(dim);
  walk_rows_by_shard(
      s, signs, n,
      [&](Shard& sh, int64_t, int32_t e) {
        if (e >= 0 && sh.entries[e].dim == dim && sh.entries[e].len == entry_len) {
          prefetch_row(sh.entries[e].data, entry_len);
          return RowAction::kDefer;
        }
        return RowAction::kMutate;
      },
      [&](Shard& sh, int64_t i, int32_t e) {
        sh.touch(e);
        std::memcpy(out + (size_t)i * entry_len, sh.entries[e].data,
                    sizeof(float) * entry_len);
      },
      [&](Shard& sh, int64_t i) {
        const uint64_t sign = signs[i];
        size_t pos = sh.find_pos(sign);
        int32_t e = (pos == SIZE_MAX) ? -1 : sh.table_slot[pos];
        if (e >= 0) sh.remove_entry(e);  // dim mismatch → re-init
        int32_t ne = sh.insert(sign, dim, entry_len);
        float* data = sh.entries[ne].data;
        s->init_embedding(sign, dim, data);
        s->init_state(dim, data + dim);
        std::memcpy(out + (size_t)i * entry_len, data, sizeof(float) * entry_len);
      });
  return entry_len;
}

// Warm/cold split for the HBM cache tier: rows whose sign exists
// (dim-matched) copy their full [emb | state] entry into `out` with an LRU
// touch and set warm_out[i]=1; cold signs are NOT admitted (the cache owns
// them until its eviction write-back re-inserts) and leave out untouched.
// Returns the entry length.
int64_t ps_probe_entries(void* h, const uint64_t* signs, int64_t n, uint32_t dim,
                         float* out, uint8_t* warm_out) {
  Store* s = (Store*)h;
  const uint32_t entry_len = dim + s->opt.state_dim(dim);
  walk_rows_by_shard(
      s, signs, n,
      [&](Shard& sh, int64_t i, int32_t e) {
        if (e >= 0 && sh.entries[e].dim == dim && sh.entries[e].len == entry_len) {
          prefetch_row(sh.entries[e].data, entry_len);
          return RowAction::kDefer;
        }
        warm_out[i] = 0;
        return RowAction::kDone;
      },
      [&](Shard& sh, int64_t i, int32_t e) {
        sh.touch(e);
        std::memcpy(out + (size_t)i * entry_len, sh.entries[e].data,
                    sizeof(float) * entry_len);
        warm_out[i] = 1;
      },
      [](Shard&, int64_t) {});  // probe never mutates
  return entry_len;
}

void ps_advance_batch_state(void* h, int group) { ((Store*)h)->advance_batch_state(group); }

// Multi-slot batched gradient update: ONE call per gradient batch. Group g
// covers rows [key_ofs[g], key_ofs[g+1]) with dim dims[g], gradient rows at
// grads + grad_ofs[g], and optimizer group opt_groups[g] (Adam batch-level
// beta powers are fetched once per group — the caller advances them once per
// gradient batch, matching optim.rs:99-221). State-identical to per-slot
// sequential calls (walk_rows_by_shard preserves within-shard order).
int ps_update_batched(void* h, const uint64_t* signs, const int64_t* key_ofs,
                      const uint32_t* dims, const float* grads,
                      const int64_t* grad_ofs, const int32_t* opt_groups,
                      int32_t n_groups) {
  Store* s = (Store*)h;
  if (s->opt.kind == OPT_NONE) return -1;
  const int64_t n = n_groups > 0 ? key_ofs[n_groups] : 0;
  if (n == 0) return 0;
  thread_local std::vector<int32_t> row_group;
  if ((int64_t)row_group.size() < n) row_group.resize(n);
  for (int32_t g = 0; g < n_groups; ++g)
    for (int64_t i = key_ofs[g]; i < key_ofs[g + 1]; ++i) row_group[i] = g;
  thread_local std::vector<uint32_t> entry_lens;
  entry_lens.resize(n_groups);
  std::vector<std::pair<double, double>> bs(n_groups);
  for (int32_t g = 0; g < n_groups; ++g) {
    entry_lens[g] = dims[g] + s->opt.state_dim(dims[g]);
    bs[g] = s->get_batch_state(opt_groups[g]);
  }

  int64_t misses = 0;
  walk_rows_by_shard(
      s, signs, n,
      [&](Shard& sh, int64_t i, int32_t e) {
        const int32_t g = row_group[i];
        if (e < 0 || sh.entries[e].dim != dims[g] ||
            sh.entries[e].len != entry_lens[g]) {
          ++misses;
          return RowAction::kDone;  // evicted / never admitted → skip
        }
        prefetch_row(sh.entries[e].data, entry_lens[g]);
        return RowAction::kDefer;
      },
      [&](Shard& sh, int64_t i, int32_t e) {
        const int32_t g = row_group[i];
        const uint32_t dim = dims[g];
        sh.touch(e);
        float* data = sh.entries[e].data;
        s->update_entry(data, data + dim,
                        grads + grad_ofs[g] + (size_t)(i - key_ofs[g]) * dim,
                        dim, bs[g]);
      },
      [](Shard&, int64_t) {});  // update never mutates structure
  s->grad_misses += misses;
  return 0;
}

// grads: (n, dim) row-major
int ps_update_gradients(void* h, const uint64_t* signs, int64_t n, uint32_t dim,
                        const float* grads, int group) {
  const int64_t key_ofs[2] = {0, n};
  const int64_t grad_ofs[1] = {0};
  return ps_update_batched(h, signs, key_ofs, &dim, grads, grad_ofs, &group, 1);
}

// values: (n, entry_len) full entries [emb | state]; dim = embedding dim
void ps_set_embedding(void* h, const uint64_t* signs, int64_t n, uint32_t dim,
                      uint32_t entry_len, const float* values) {
  Store* s = (Store*)h;
  for (int64_t i = 0; i < n; ++i) {
    uint64_t sign = signs[i];
    Shard& sh = s->shard_of(sign);
    std::lock_guard<std::mutex> g(sh.mu);
    size_t pos = sh.find_pos(sign);
    if (pos != SIZE_MAX) sh.remove_entry(sh.table_slot[pos]);
    int32_t e = sh.insert(sign, dim, entry_len);
    std::memcpy(sh.entries[e].data, values + (size_t)i * entry_len,
                sizeof(float) * entry_len);
  }
}

// returns entry length, or -1 if absent; copies min(len, cap) floats into out
int32_t ps_get_entry(void* h, uint64_t sign, float* out, int32_t cap) {
  Store* s = (Store*)h;
  Shard& sh = s->shard_of(sign);
  std::lock_guard<std::mutex> g(sh.mu);
  size_t pos = sh.find_pos(sign);
  if (pos == SIZE_MAX) return -1;
  const Entry& en = sh.entries[sh.table_slot[pos]];
  int32_t ncopy = (int32_t)en.len < cap ? (int32_t)en.len : cap;
  if (out && ncopy > 0) std::memcpy(out, en.data, sizeof(float) * ncopy);
  return (int32_t)en.len;
}

// returns the entry's embedding dim, or -1 if absent
int32_t ps_get_entry_dim(void* h, uint64_t sign) {
  Store* s = (Store*)h;
  Shard& sh = s->shard_of(sign);
  std::lock_guard<std::mutex> g(sh.mu);
  size_t pos = sh.find_pos(sign);
  if (pos == SIZE_MAX) return -1;
  return (int32_t)sh.entries[sh.table_slot[pos]].dim;
}

int64_t ps_size(void* h) {
  Store* s = (Store*)h;
  int64_t total = 0;
  for (auto& sh : s->shards) {
    std::lock_guard<std::mutex> g(sh.mu);
    total += (int64_t)sh.count;
  }
  return total;
}

void ps_clear(void* h) {
  Store* s = (Store*)h;
  for (auto& sh : s->shards) {
    std::lock_guard<std::mutex> g(sh.mu);
    for (auto& en : sh.entries)
      if (en.data) {
        std::free(en.data);
        en.data = nullptr;
      }
    sh.entries.clear();
    sh.free_list.clear();
    std::fill(sh.table_slot.begin(), sh.table_slot.end(), -1);
    sh.lru_head = sh.lru_tail = -1;
    sh.count = 0;
  }
  std::lock_guard<std::mutex> g(s->batch_mu);
  s->batch_state.clear();
}

int64_t ps_grad_misses(void* h) { return ((Store*)h)->grad_misses.load(); }

// Checkpoint wire format, shared with the numpy store:
//   u32 entry_count, then per entry: u64 sign, u32 dim, u32 len, len * f32.
// Entries go out from the least to the most recently used, so a dump
// loaded back (each insert becoming the most recent) rebuilds the same LRU
// order, and later evictions match an uninterrupted run's.
int64_t ps_dump_shard_size(void* h, uint32_t shard) {
  Store* s = (Store*)h;
  if (shard >= s->num_shards) return -1;
  Shard& sh = s->shards[shard];
  std::lock_guard<std::mutex> g(sh.mu);
  int64_t bytes = 4;
  for (int32_t e = sh.lru_tail; e >= 0; e = sh.entries[e].prev)
    bytes += 16 + (int64_t)sh.entries[e].len * 4;
  return bytes;
}

// returns the bytes written, or -1 (no such shard, or cap too small)
int64_t ps_dump_shard(void* h, uint32_t shard, uint8_t* out, int64_t cap) {
  Store* s = (Store*)h;
  if (shard >= s->num_shards) return -1;
  Shard& sh = s->shards[shard];
  std::lock_guard<std::mutex> g(sh.mu);
  uint8_t* p = out;
  uint8_t* end = out + cap;
  if (p + 4 > end) return -1;
  uint32_t cnt = (uint32_t)sh.count;
  std::memcpy(p, &cnt, 4);
  p += 4;
  for (int32_t e = sh.lru_tail; e >= 0; e = sh.entries[e].prev) {
    const Entry& en = sh.entries[e];
    int64_t need = 16 + (int64_t)en.len * 4;
    if (p + need > end) return -1;
    std::memcpy(p, &en.sign, 8);
    std::memcpy(p + 8, &en.dim, 4);
    std::memcpy(p + 12, &en.len, 4);
    std::memcpy(p + 16, en.data, (size_t)en.len * 4);
    p += need;
  }
  return p - out;
}

// Loads a dump (of any shard layout: each entry routes by its sign),
// replacing entries of the same sign. Returns the entries loaded, or -1 on
// a payload shorter than its counts say (entries before the tear stay).
int64_t ps_load_shard(void* h, const uint8_t* data, int64_t len) {
  Store* s = (Store*)h;
  if (len < 4) return -1;
  uint32_t cnt;
  std::memcpy(&cnt, data, 4);
  const uint8_t* p = data + 4;
  const uint8_t* end = data + len;
  for (uint32_t i = 0; i < cnt; ++i) {
    if (end - p < 16) return -1;
    uint64_t sign;
    uint32_t edim, elen;
    std::memcpy(&sign, p, 8);
    std::memcpy(&edim, p + 8, 4);
    std::memcpy(&elen, p + 12, 4);
    p += 16;
    if (end - p < (int64_t)elen * 4) return -1;
    Shard& sh = s->shard_of(sign);
    {
      std::lock_guard<std::mutex> g(sh.mu);
      size_t pos = sh.find_pos(sign);
      if (pos != SIZE_MAX) sh.remove_entry(sh.table_slot[pos]);
      int32_t e = sh.insert(sign, edim, elen);
      std::memcpy(sh.entries[e].data, p, (size_t)elen * 4);
    }
    p += (int64_t)elen * 4;
  }
  return (int64_t)cnt;
}

// The apply-journal (see Store::journal_*). It is not part of the dump: a
// rewind to a fence (clear + shard load) also clears it, so the replayed
// post-fence batches apply again.
void ps_journal_record(void* h, uint64_t id, uint32_t crc) {
  ((Store*)h)->journal_record(id, crc);
}

// 1 = already applied (crc matches), 0 = unknown id, -1 = crc mismatch
int32_t ps_journal_probe(void* h, uint64_t id, uint32_t crc) {
  return ((Store*)h)->journal_probe(id, crc);
}

int64_t ps_journal_len(void* h) {
  Store* s = (Store*)h;
  std::lock_guard<std::mutex> g(s->journal_mu);
  return (int64_t)s->journal_map.size();
}

void ps_journal_clear(void* h) { ((Store*)h)->journal_clear(); }

}  // extern "C"
