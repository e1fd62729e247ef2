// The cache tier's aux program (K12): one cache group's eviction payload,
// warm entries, cold seeds and in-flight restores, a step; and its payload
// read alone, the flush's and publish's read (entry_rows_kernel).
//
// Input: the group's table T (R = C+1 rows, dim) f32 or bf16 (the pool's
// dtype) and its f32 optimizer state columns, at most two (s0: Adagrad
// acc (R, w0) or Adam m (R, dim); s1: Adam v (R, dim)), which an entry
// [emb | s0 | s1] (E = dim + w0 + w1 floats) lays out in that order. A
// bf16 table's row is widened to f32 where it is read and every value
// written to it rounded to bf16 (to nearest, ties to even), as the
// reference's .astype(table.dtype) rounds.
//  (a) payload[k, :] = entry of row clamp(ev_rows[k], 0, R - 1), f32 or
//      rounded to bf16 (to nearest, ties to even), read before any write
//      (a bf16 table's row widened and rounded back: its bits unchanged);
//      with ring_store, stored a second time at ring[start + k, :], start =
//      ring_pos (+ ring_rows where negative) clamped into
//      [0, ring_rows - n_ev], as lax.dynamic_update_slice places it;
//  (b) for each warm k with 0 <= m_rows[k] < R: the entry of m_rows[k] =
//      m_entries[k, :] (f32 or bf16, widened);
//  (c) for each cold k with 0 <= c_rows[k] < R: T[c_rows[k], :] =
//      c_emb[k, :] (f32 or bf16, widened), s0 and s1 of the row = c0, c1;
//  (d) for each restore k with 0 <= r_dst[k] < R: the entry of r_dst[k] =
//      ring[clamp(r_src[k], 0, ring_rows - 1), :] (the ring is in the
//      payload's dtype, the write-back wire's; widened).
// Rows outside [0, R) are dropped by (b)-(d): the host pads with R (and a
// restore's source with 0). The rows of (b)-(d) are distinct, so no float
// is written twice. Contract: no live restore reads a ring row of this
// call's own span [start, start + n_ev) (the stream reserves a step's
// span before its gate looks for restores, so its restores read earlier
// steps' spans); the plain version checks it on CPU tensors.
//
// Replaces: persia_tpu/embedding/hbm_cache/groups.py:260-293 (_apply_aux),
// with the table's dtype from :126-138 (init_cached_tables) and the casts of
// :225-236 (_scatter_entry_block) and :287 (the cold seeds),
// :296-314 (_apply_aux_ring: the ring), :250-256 (_restore_rows, through
// _scatter_entry_block :225-236: (d)) and :240-248 (_gather_entry_rows,
// (a) alone in f32), XLA gathers and scatters; no Pallas kernel.
//
// Bound on the H100: bytes (the row indices and the pairing; (a) reads
// n_ev entries and writes the payload (and the ring), (b) reads K_w entries
// and writes them, (c) reads K_c seeds and writes K_c entries, (d) reads
// K_r ring entries and writes them; no arithmetic). At a saturated step the
// bytes take ~0.9 us, under the one-launch floor (~1.1-1.4 us): the design
// spends one launch and nothing more.
//
// Design: one kernel, one launch a call. (a) must read an evicted row
// before (b), (c) or (d) rewrites it, and a miss usually takes the row an
// eviction frees. The host knows which: each of the k rows a call evicts
// is taken by one of its misses (the unsharded directory's last k, in
// order; a sharded one's last of each shard), so the tier pairs each write
// with the payload slot of the row it overwrites (m_slot, c_slot, r_slot;
// -1 for none) and lists the slots no write claims (ev_free, -1 pads). One
// item space: warm writes, then cold writes, then restores, then the
// unclaimed slots, each entry cut into vectors of `vec` columns (8 where a
// bf16 wire or payload is involved, 4 otherwise: 16-byte loads and stores
// of the f32 pool; 1 for widths that are no multiple of it, e.g. Adagrad's
// vector-wise acc). A thread owns one vector of one entry: a write with a
// slot loads the row's old vector, stores it to the payload (and the
// ring), then stores the new one; no other thread touches that row, so no
// barrier orders them. An unclaimed slot is only read; a write without a
// slot only writes. A restore's source is a ring row outside the call's
// span, which no thread of the call stores.
//
// entry_rows_kernel: the same row-major walk, a thread a float4 of one
// row's [table | state] (64-byte runs of each array at dim 16), the
// output written coalesced.

#include <cstdint>

#include "cache_entry.cuh"
#include "common.cuh"

using namespace persia_cache;

namespace {

constexpr int kThreads = 256;

// the arguments of one K12 call
struct CacheAuxArgs {
  Pool pool;
  int units;  // vectors an entry: E / vec
  const int32_t* ev_rows;
  int n_ev;
  void* payload;
  bool payload_bf16;
  void* ring;  // null: no ring
  long long ring_rows;
  bool ring_store;  // (a) also into the ring
  long long ring_start;
  const int32_t* m_rows;
  const int32_t* m_slot;
  int n_m;
  const void* m_entries;
  bool m_bf16;
  const int32_t* c_rows;
  const int32_t* c_slot;
  int n_c;
  const void* c_emb;
  bool c_bf16;
  float c0, c1;
  const int32_t* r_src;
  const int32_t* r_dst;
  const int32_t* r_slot;
  int n_r;
  const int32_t* ev_free;
  int n_free;
};

// TB: the table is bf16 (a template argument, so the f32 pool's code has
// no branch on it)
template <int V, bool TB>
__global__ void __launch_bounds__(kThreads) cache_aux_kernel(const CacheAuxArgs a) {
  const int t = blockIdx.x * kThreads + threadIdx.x;  // the entry point keeps items * units < 2^31
  const int item = t / a.units;
  const int n_writes = a.n_m + a.n_c + a.n_r;
  if (item >= n_writes + a.n_free) return;
  const int col = (t - item * a.units) * V;
  const int E = a.pool.dim + a.pool.w0 + a.pool.w1;
  float fresh[V];
  long long r;
  int slot;
  bool write = true;
  if (item < a.n_m) {  // (b): a warm entry
    const int k = item;
    r = a.m_rows[k];
    slot = a.m_slot[k];
    load_wire<V>(a.m_entries, a.m_bf16, static_cast<long long>(k) * E + col, fresh);
  } else if (item < a.n_m + a.n_c) {  // (c): a cold seed
    const int k = item - a.n_m;
    r = a.c_rows[k];
    slot = a.c_slot[k];
    if (col < a.pool.dim) {
      load_wire<V>(a.c_emb, a.c_bf16, static_cast<long long>(k) * a.pool.dim + col, fresh);
    } else {
      const float c = col < a.pool.dim + a.pool.w0 ? a.c0 : a.c1;
#pragma unroll
      for (int i = 0; i < V; ++i) fresh[i] = c;
    }
  } else if (item < n_writes) {  // (d): a restore from the ring
    const int k = item - a.n_m - a.n_c;
    r = a.r_dst[k];
    if (r < 0 || r >= a.pool.rows) return;  // a pad: its source is not read
    slot = a.r_slot[k];
    long long s = a.r_src[k];
    s = s < 0 ? 0 : (s >= a.ring_rows ? a.ring_rows - 1 : s);
    load_wire<V>(a.ring, a.payload_bf16, s * E + col, fresh);
  } else {  // (a) alone: an eviction slot no write claims
    slot = a.ev_free[item - n_writes];
    if (slot < 0) return;
    r = a.ev_rows[slot];
    r = r < 0 ? 0 : (r >= a.pool.rows ? a.pool.rows - 1 : r);
    write = false;
  }
  if (r < 0 || r >= a.pool.rows) return;  // a dropped write (a pad)
  // an f32 pool: one address for the read and the write, taken before
  // either
  float* const dst = TB ? nullptr : entry_at(a.pool, r, col);
  if (slot >= 0) {  // the row's old contents first, in this thread
    float old[V];
    if constexpr (TB) {
      load_entry<V, true>(a.pool, r, col, old);
    } else {
      load_f32<V>(dst, old);
    }
    const long long off = static_cast<long long>(slot) * E + col;
    store_wire<V>(a.payload, a.payload_bf16, off, old);
    if (a.ring_store) store_wire<V>(a.ring, a.payload_bf16, a.ring_start * E + off, old);
  }
  if (!write) return;
  if constexpr (TB) {
    store_entry<V, true>(a.pool, r, col, fresh);
  } else {
    store_f32<V>(dst, fresh);
  }
}

template <int V, bool TB>
__global__ void __launch_bounds__(kThreads)
    entry_rows_kernel(const Pool p, int units, const int32_t* __restrict__ rows, int n, float* __restrict__ out) {
  const int t = blockIdx.x * kThreads + threadIdx.x;  // the entry point keeps n * units < 2^31
  const int k = t / units;
  if (k >= n) return;
  const int col = (t - k * units) * V;
  long long r = rows[k];
  r = r < 0 ? 0 : (r >= p.rows ? p.rows - 1 : r);
  float x[V];
  load_entry<V, TB>(p, r, col, x);
  store_f32<V>(out + static_cast<long long>(k) * (p.dim + p.w0 + p.w1) + col, x);
}

unsigned grid_of(long long items) { return static_cast<unsigned>((items + kThreads - 1) / kThreads); }

template <bool TB>
void launch_aux(int vec, long long items, const CacheAuxArgs& a, cudaStream_t st) {
  if (vec == 8) {
    cache_aux_kernel<8, TB><<<grid_of(items), kThreads, 0, st>>>(a);
  } else if (vec == 4) {
    cache_aux_kernel<4, TB><<<grid_of(items), kThreads, 0, st>>>(a);
  } else {
    cache_aux_kernel<1, TB><<<grid_of(items), kThreads, 0, st>>>(a);
  }
}

template <bool TB>
void launch_entry_rows(int vec, long long items, const Pool& p, int units, const int32_t* rows, int n, float* out,
                       cudaStream_t st) {
  if (vec == 4) {
    entry_rows_kernel<4, TB><<<grid_of(items), kThreads, 0, st>>>(p, units, rows, n, out);
  } else {
    entry_rows_kernel<1, TB><<<grid_of(items), kThreads, 0, st>>>(p, units, rows, n, out);
  }
}

}  // namespace

// payload: (n_ev, E) f32 or bf16 (payload_dtype); m_entries (n_m, E) and
// c_emb (n_c, dim) f32 or bf16; m_slot (n_m,), c_slot (n_c,) and r_slot
// (n_r,) the payload slot each write reads first, or -1; r_src and r_dst
// (n_r,) the restores' ring rows and table rows; ev_free (n_free,) the
// slots no write claims, -1 pads; ring (ring_rows, E) in the payload's
// dtype, or null: read by the restores, and with ring_store written by
// (a). A piece with no rows may pass null. vec: columns a thread (1, 4 or
// 8). One launch, none when every piece is empty.
extern "C" int persia_cache_aux(void* table, int table_dtype, long long rows, int dim, float* s0, int w0, float* s1,
                                int w1, int vec,
                                const int32_t* ev_rows, int n_ev, void* payload, int payload_dtype,
                                const int32_t* m_rows, const int32_t* m_slot, int n_m, const void* m_entries,
                                int m_dtype, const int32_t* c_rows, const int32_t* c_slot, int n_c, const void* c_emb,
                                int c_dtype, float c0, float c1, const int32_t* r_src, const int32_t* r_dst,
                                const int32_t* r_slot, int n_r, const int32_t* ev_free, int n_free, void* ring,
                                long long ring_rows, int ring_store, long long ring_pos, void* stream) {
  const Pool pool{table, s0, s1, rows, dim, w0, w1};
  if ((table_dtype != persia::kFloat32 && table_dtype != persia::kBFloat16) || !pool_ok(pool, vec) || n_ev < 0 ||
      n_m < 0 || n_c < 0 || n_r < 0 || n_free < 0) {
    return cudaErrorInvalidValue;
  }
  const auto dtype_ok = [](int d) { return d == persia::kFloat32 || d == persia::kBFloat16; };
  const auto vec_ok = [vec](const void* p) { return vec == 1 || aligned16(p); };
  if ((n_ev > 0 && (ev_rows == nullptr || payload == nullptr || !dtype_ok(payload_dtype) || !vec_ok(payload))) ||
      (n_m > 0 && (m_rows == nullptr || m_slot == nullptr || m_entries == nullptr || !dtype_ok(m_dtype) ||
                   !vec_ok(m_entries))) ||
      (n_c > 0 && (c_rows == nullptr || c_slot == nullptr || c_emb == nullptr || !dtype_ok(c_dtype) ||
                   !vec_ok(c_emb))) ||
      (n_r > 0 && (r_src == nullptr || r_dst == nullptr || r_slot == nullptr || ring == nullptr || ring_rows < 1 ||
                   !dtype_ok(payload_dtype))) ||
      (n_free > 0 && (ev_free == nullptr || n_ev == 0)) ||
      (ring_store && (ring == nullptr || ring_rows < n_ev)) || (ring != nullptr && !vec_ok(ring))) {
    return cudaErrorInvalidValue;
  }
  const int units = (dim + w0 + w1) / vec;
  const long long items = (static_cast<long long>(n_m) + n_c + n_r + n_free) * units;
  if (items + kThreads > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (items == 0) return cudaSuccess;
  CacheAuxArgs a{};
  a.pool = pool;
  a.units = units;
  a.ev_rows = ev_rows;
  a.n_ev = n_ev;
  a.payload = payload;
  a.payload_bf16 = payload_dtype == persia::kBFloat16;
  a.ring = ring;
  a.ring_rows = ring_rows;
  a.ring_store = ring_store != 0;
  // as lax.dynamic_update_slice places it: a negative start counts from the
  // end, then the start is clamped so that the payload lands whole
  long long start = ring_pos < 0 ? ring_pos + ring_rows : ring_pos;
  start = start < 0 ? 0 : (start > ring_rows - n_ev ? ring_rows - n_ev : start);
  a.ring_start = start;
  a.m_rows = m_rows;
  a.m_slot = m_slot;
  a.n_m = n_m;
  a.m_entries = m_entries;
  a.m_bf16 = m_dtype == persia::kBFloat16;
  a.c_rows = c_rows;
  a.c_slot = c_slot;
  a.n_c = n_c;
  a.c_emb = c_emb;
  a.c_bf16 = c_dtype == persia::kBFloat16;
  a.c0 = c0;
  a.c1 = c1;
  a.r_src = r_src;
  a.r_dst = r_dst;
  a.r_slot = r_slot;
  a.n_r = n_r;
  a.ev_free = ev_free;
  a.n_free = n_free;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (table_dtype == persia::kBFloat16) {
    launch_aux<true>(vec, items, a, st);
  } else {
    launch_aux<false>(vec, items, a, st);
  }
  return cudaGetLastError();
}

// out: (n, E) f32, the entries of rows (each clamped into [0, rows)), a
// bf16 table's columns widened; vec 4 or 1. One launch, none for n = 0.
extern "C" int persia_entry_rows(const void* table, int table_dtype, long long rows, int dim, const float* s0, int w0,
                                 const float* s1, int w1, int vec, const int32_t* row_ids, int n, float* out,
                                 void* stream) {
  const Pool pool{const_cast<void*>(table), const_cast<float*>(s0), const_cast<float*>(s1), rows, dim, w0, w1};
  if ((table_dtype != persia::kFloat32 && table_dtype != persia::kBFloat16) || !pool_ok(pool, vec) || vec == 8 ||
      n < 0 || (n > 0 && (row_ids == nullptr || out == nullptr)) ||
      (vec > 1 && !aligned16(out))) {
    return cudaErrorInvalidValue;
  }
  const int units = (dim + w0 + w1) / vec;
  const long long items = static_cast<long long>(n) * units;
  if (items + kThreads > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (items == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (table_dtype == persia::kBFloat16) {
    launch_entry_rows<true>(vec, items, pool, units, row_ids, n, out, st);
  } else {
    launch_entry_rows<false>(vec, items, pool, units, row_ids, n, out, st);
  }
  return cudaGetLastError();
}
