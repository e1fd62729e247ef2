"""The cache directory and the host's staging buffers (counterpart of
``persia_tpu/embedding/hbm_cache/directory.py``).

``CacheDirectory`` binds the port's native directory
(``persia_tpu_torch/native/cache.cpp``, built with ``g++`` at first use into
``build/torch_native/``): an LRU map sign → cache row of a fixed capacity,
unsharded, or in ``shards`` partitions walked by a pool of
``feed_threads`` native threads (``shard_route`` is the partition).
``PendingSignMap`` binds the stream's map of in-flight
write-backs, which ``CacheDirectory.feed_batch`` probes inside the admit.
``native_init_rows`` births a cold row on the host bit for bit as the
parameter server would (the same seeded init), so a sign's first row does
not depend on which tier saw it first.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import threading
from typing import Optional, Tuple

import numpy as np

from persia_tpu_torch.embedding._native_build import NATIVE_SRC, build_so, cxx_flags
from persia_tpu_torch.embedding.hashing import splitmix64
from persia_tpu_torch.embedding.hbm_cache.common import _bucket
from persia_tpu_torch.embedding.native_store import INIT_KIND_CODES

_LIB: Optional[ctypes.CDLL] = None
_LOAD_LOCK = threading.Lock()

_i64p = ctypes.POINTER(ctypes.c_int64)
_u64p = ctypes.POINTER(ctypes.c_uint64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def build_native():
    """Compile the directory unless built (see ``_native_build.build_so``);
    ``-pthread``: the sharded feeder walks its shards on native threads."""
    return build_so([NATIVE_SRC / "cache.cpp"], "libpersia_torch_cache.so", cxx_flags() + ["-pthread"])


def _load_lib() -> ctypes.CDLL:
    global _LIB
    with _LOAD_LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(build_native()))
        i64, p = ctypes.c_int64, ctypes.c_void_p
        lib.cache_create.restype = p
        lib.cache_create.argtypes = [i64]
        lib.cache_destroy.restype = None
        lib.cache_destroy.argtypes = [p]
        lib.cache_len.restype = i64
        lib.cache_len.argtypes = [p]
        lib.cache_capacity.restype = i64
        lib.cache_capacity.argtypes = [p]
        lib.cache_admit.restype = i64
        lib.cache_admit.argtypes = [p, _u64p, i64, _i64p, _i64p, _u64p, _i64p, _i64p]
        lib.cache_admit_positions.restype = i64
        lib.cache_admit_positions.argtypes = [p, _u64p, i64, _i32p, _u64p, _i64p, _u64p, _i64p, _i64p, _i64p]
        lib.cache_probe.restype = None
        lib.cache_probe.argtypes = [p, _u64p, i64, _i64p]
        lib.cache_drain.restype = i64
        lib.cache_drain.argtypes = [p, _u64p, _i64p]
        lib.cache_snapshot.restype = i64
        lib.cache_snapshot.argtypes = [p, _u64p, _i64p]
        lib.cache_set_admit_touches.restype = None
        lib.cache_set_admit_touches.argtypes = [p, i64]
        lib.cache_touch_counts.restype = i64
        lib.cache_touch_counts.argtypes = [p, _u8p, i64]
        lib.cache_set_touch_counts.restype = i64
        lib.cache_set_touch_counts.argtypes = [p, _u8p, i64]
        lib.cache_set_probe_mode.restype = None
        lib.cache_set_probe_mode.argtypes = [p, i64]
        lib.cache_probe_mode.restype = i64
        lib.cache_probe_mode.argtypes = [p]
        lib.cache_uniform_init.restype = None
        lib.cache_uniform_init.argtypes = [_u64p, i64, i64, ctypes.c_uint64, ctypes.c_double, ctypes.c_double,
                                           _f32p]
        lib.cache_init_rows.restype = None
        lib.cache_init_rows.argtypes = [_u64p, i64, i64, ctypes.c_uint64, ctypes.c_int, ctypes.c_double,
                                        ctypes.c_double, _f32p]
        u32 = ctypes.c_uint32
        lib.pending_map_create.restype = p
        lib.pending_map_create.argtypes = []
        lib.pending_map_destroy.restype = None
        lib.pending_map_destroy.argtypes = [p]
        lib.pending_map_size.restype = i64
        lib.pending_map_size.argtypes = [p]
        lib.pending_map_insert.restype = None
        lib.pending_map_insert.argtypes = [p, _u64p, _i64p, i64, u32]
        lib.pending_map_insert_range.restype = None
        lib.pending_map_insert_range.argtypes = [p, _u64p, i64, i64, u32]
        lib.pending_map_query.restype = i64
        lib.pending_map_query.argtypes = [p, _u64p, i64, ctypes.POINTER(u32), _i64p]
        lib.pending_map_remove.restype = None
        lib.pending_map_remove.argtypes = [p, _u64p, i64, u32]
        lib.cache_feed_batch.restype = i64
        lib.cache_feed_batch.argtypes = [p, p, _u64p, i64, _i32p, _u64p, _i64p, _u64p, _i64p, _i64p, _i64p,
                                         _i64p, _i64p, _i64p, ctypes.c_uint64]
        # the sharded directory
        lib.cache_create_sharded.restype = p
        lib.cache_create_sharded.argtypes = [i64, i64, ctypes.c_uint64, i64]
        for name, res, args in (
            ("destroy", None, [p]), ("len", i64, [p]), ("capacity", i64, [p]), ("n_shards", i64, [p]),
            ("threads", i64, [p]), ("set_threads", None, [p, i64]), ("set_admit_touches", None, [p, i64]),
            ("touch_counts", i64, [p, _u8p, i64]), ("set_touch_counts", i64, [p, _u8p, i64]),
            ("shard_sizes", None, [p, _i64p]), ("shard_busy_ns", None, [p, _i64p]),
            ("shard_stall_ns", None, [p, _i64p]), ("set_probe_mode", None, [p, i64]),
            ("probe_mode", i64, [p]), ("set_affinity", None, [p, i64]), ("affinity", i64, [p]),
            ("probe", None, [p, _u64p, i64, _i64p]),
            ("admit", i64, [p, _u64p, i64, _i64p, _i64p, _u64p, _i64p, _i64p]),
            ("snapshot", i64, [p, _u64p, _i64p]), ("drain", i64, [p, _u64p, _i64p]),
        ):
            fn = getattr(lib, f"cache_sharded_{name}")
            fn.restype, fn.argtypes = res, args
        lib.cache_feed_batch_sharded.restype = i64
        lib.cache_feed_batch_sharded.argtypes = lib.cache_feed_batch.argtypes
        _LIB = lib
        return lib


def _out_rows(out: Optional[np.ndarray], m: int, dim: int) -> np.ndarray:
    if out is None:
        return np.empty((m, dim), dtype=np.float32)
    if out.dtype != np.float32 or not out.flags.c_contiguous or out.shape != (m, dim):
        raise ValueError(f"out must be a contiguous ({m}, {dim}) float32 array")
    return out


def native_uniform_init(signs: np.ndarray, seed: int, dim: int, lo: float, hi: float,
                        out: Optional[np.ndarray] = None) -> np.ndarray:
    """Seeded uniform rows (M, dim) f32, bit for bit
    ``hashing.uniform_init_for_signs``; ``out`` is filled in place when
    given."""
    lib = _load_lib()
    signs = np.ascontiguousarray(signs, dtype=np.uint64)
    out = _out_rows(out, len(signs), dim)
    lib.cache_uniform_init(signs.ctypes.data_as(_u64p), len(signs), dim, ctypes.c_uint64(seed), lo, hi,
                           out.ctypes.data_as(_f32p))
    return out


def native_init_rows(signs: np.ndarray, seed: int, dim: int, method,
                     out: Optional[np.ndarray] = None) -> np.ndarray:
    """Seeded rows (M, dim) f32 for any ``config.InitializationMethod``,
    bit for bit ``hashing.init_for_signs`` and the parameter server's
    cores: a row born in the cache is the row the server would birth."""
    lib = _load_lib()
    signs = np.ascontiguousarray(signs, dtype=np.uint64)
    out = _out_rows(out, len(signs), dim)
    lib.cache_init_rows(signs.ctypes.data_as(_u64p), len(signs), dim, ctypes.c_uint64(seed),
                        INIT_KIND_CODES[method.kind], method.p0, method.p1, out.ctypes.data_as(_f32p))
    return out


_MALLOPT_DONE = False


def _retain_allocator_pages() -> None:
    """Let glibc serve the MB-sized per-step staging buffers from retained
    heap pages instead of fresh mmaps (page faults and unmaps every step),
    so every step can own new buffers (``_BufRing``) at the cost of a
    free-list pop. Once a process, when the first tier is built; opt out
    with ``PERSIA_NO_MALLOPT=1``; a no-op where ``mallopt`` is missing."""
    global _MALLOPT_DONE
    if _MALLOPT_DONE or os.environ.get("PERSIA_NO_MALLOPT") == "1":
        return
    _MALLOPT_DONE = True
    try:
        libc = ctypes.CDLL(None)
        libc.mallopt.restype = ctypes.c_int
        libc.mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
        libc.mallopt(-3, 64 * 1024 * 1024)  # M_MMAP_THRESHOLD
    except (OSError, AttributeError):  # not glibc
        pass


class _BufRing:
    """Per-step host staging buffers. Every call returns a new array: the
    buffers escape into asynchronous copies to the card, and a reused one
    rewritten while a copy still reads it would corrupt training. The
    ``key`` argument names the buffer's use."""

    def get(self, key, shape, dtype) -> np.ndarray:
        return np.empty(shape, dtype)

    def full(self, key, shape, dtype, fill) -> np.ndarray:
        arr = np.empty(shape, dtype)
        arr.fill(fill)
        return arr


#: ``PERSIA_FEED_AFFINITY``'s names of the walker pool's pinning: ``none``
#: leaves the walkers unpinned, ``compact`` puts worker i on cpu ``i %
#: ncpu``, ``spread`` stripes the workers across the cpus.
AFFINITY_MODES = {"none": 0, "compact": 1, "spread": 2}


def feed_affinity_from_env() -> int:
    """``PERSIA_FEED_AFFINITY`` as a pinning mode (0, none, by default and
    for an unknown name: the placement is best effort)."""
    return AFFINITY_MODES.get(os.environ.get("PERSIA_FEED_AFFINITY", "none").strip().lower(), 0)


def shard_route(signs, part_salt: int, n_shards: int) -> np.ndarray:
    """Each sign's shard, bit for bit the native directory's partition: the
    high 64 bits of ``splitmix64(sign ^ part_salt) * n_shards`` (int64)."""
    h = splitmix64(np.asarray(signs, dtype=np.uint64) ^ np.uint64(int(part_salt) & (2 ** 64 - 1)))
    lo, hi = h & np.uint64(0xFFFFFFFF), h >> np.uint64(32)
    n = np.uint64(n_shards)
    # (hi * 2^32 + lo) * n >> 64, with n < 2^32: two 64-bit products
    return ((hi * n + ((lo * n) >> np.uint64(32))) >> np.uint64(32)).astype(np.int64)


class CacheDirectory:
    """LRU map sign → cache row (native, O(1) a sign).

    ``admit_touches``: a sign that is not resident is admitted only on its
    Nth batch that touches it; the earlier touches map to the pad row
    ``capacity`` (a zero forward, its gradient dropped: the reference's
    non-admitted sign). 1 admits on the first touch.

    ``shards``: when set, the directory is that many partitions (each its
    own mutex, LRU chain and range of rows; clamped to [1, min(64,
    capacity)]) keyed by ``shard_route(sign, part_salt)``; ``feed_batch``
    then walks them on a pool of ``feed_threads`` native threads and merges
    them in shard order, so its outputs are the same bits at any thread
    count. They differ from the unsharded directory's for ``shards > 1``
    (the LRU order is a shard's), so a job keeps its shard count;
    ``shards=1`` is the unsharded walk bit for bit. ``part_salt`` is the
    group's salt (``group_salt``). ``affinity`` pins the pool's threads
    (``AFFINITY_MODES``; ``PERSIA_FEED_AFFINITY`` by default). ``probe``:
    the probe (1 the tag walk, 0 scalar; the same results)."""

    def __init__(self, capacity: int, admit_touches: int = 1, probe: Optional[int] = None,
                 shards: Optional[int] = None, feed_threads: int = 1, part_salt: int = 0,
                 affinity: Optional[int] = None):
        if capacity < 1:
            raise ValueError("capacity must be positive")
        self._lib = _load_lib()
        self.part_salt = int(part_salt) & (2 ** 64 - 1)
        self._sharded = shards is not None
        if self._sharded:
            self._h = self._lib.cache_create_sharded(capacity, max(1, int(shards)), self.part_salt,
                                                     max(1, int(feed_threads)))
            self.shards: Optional[int] = int(self._lib.cache_sharded_n_shards(self._h))
        else:
            self._h = self._lib.cache_create(capacity)
            self.shards = None
        if not self._h:
            raise MemoryError("the native directory could not be made")
        self.capacity = capacity
        self.admit_touches = int(admit_touches)
        if self.admit_touches > 1:
            self._fn("set_admit_touches")(self._h, self.admit_touches)
        if probe is not None:
            self.set_probe_mode(probe)
        aff = feed_affinity_from_env() if affinity is None else int(affinity)
        if self._sharded and aff:
            self._lib.cache_sharded_set_affinity(self._h, aff)
        self._scratch_n = 0
        self._rows_ring = _BufRing()

    def _fn(self, name: str):
        """The native call ``name`` of this directory's kind."""
        return getattr(self._lib, f"cache_sharded_{name}" if self._sharded else f"cache_{name}")

    def __del__(self):
        if getattr(self, "_h", None):
            self._fn("destroy")(self._h)
            self._h = None

    def __len__(self) -> int:
        return int(self._fn("len")(self._h))

    @property
    def probe_mode(self) -> int:
        """1: the 8-at-a-time tag probe; 0: the scalar walk (same results)."""
        return int(self._fn("probe_mode")(self._h))

    def set_probe_mode(self, mode: int) -> None:
        self._fn("set_probe_mode")(self._h, 1 if int(mode) else 0)

    @property
    def feed_threads(self) -> int:
        """The walker pool's threads (the caller's included; 1 unsharded)."""
        return int(self._lib.cache_sharded_threads(self._h)) if self._sharded else 1

    def set_feed_threads(self, threads: int) -> None:
        """Resize the walker pool (sharded only; clamped to [1, shards]).
        No output depends on it: safe between feeds."""
        if self._sharded:
            self._lib.cache_sharded_set_threads(self._h, max(1, int(threads)))

    @property
    def feed_affinity(self) -> int:
        """The walker pool's pinning (``AFFINITY_MODES``; 0 unsharded)."""
        return int(self._lib.cache_sharded_affinity(self._h)) if self._sharded else 0

    def set_feed_affinity(self, mode: int) -> None:
        """Re-pin the walker pool (sharded only; best effort, Linux only)."""
        if self._sharded:
            self._lib.cache_sharded_set_affinity(self._h, int(mode))

    def _per_shard(self, name: str, unsharded) -> np.ndarray:
        if not self._sharded:
            return np.asarray(unsharded, dtype=np.int64)
        out = np.empty(self.shards, dtype=np.int64)
        getattr(self._lib, f"cache_sharded_{name}")(self._h, out.ctypes.data_as(_i64p))
        return out

    def shard_sizes(self) -> np.ndarray:
        """Residents a shard ((shards,) int64; one entry unsharded)."""
        return self._per_shard("shard_sizes", [len(self)])

    def shard_busy_ns(self) -> np.ndarray:
        """Each shard's walk ns of the last feed (zeros unsharded)."""
        return self._per_shard("shard_busy_ns", [0])

    def shard_stall_ns(self) -> np.ndarray:
        """Each shard's wait in the pool's queue in the last feed, ns,
        summed over its two walks: busy says how long a shard walked, stall
        how long it waited for a thread (zeros unsharded)."""
        return self._per_shard("shard_stall_ns", [0])

    def _ensure_scratch(self, n: int) -> None:
        if n <= self._scratch_n:
            return
        self._scratch_n = n
        self._s_miss_signs = np.empty(n, dtype=np.uint64)
        self._s_miss_rows = np.empty(n, dtype=np.int64)
        self._s_ev_signs = np.empty(n, dtype=np.uint64)
        self._s_ev_rows = np.empty(n, dtype=np.int64)
        self._s_miss_idx = np.empty(n, dtype=np.int64)
        self._s_rst_src = np.empty(n, dtype=np.int64)
        self._s_rst_pos = np.empty(n, dtype=np.int64)

    def _overflow(self):
        return RuntimeError(f"batch distinct-sign count exceeds cache capacity {self.capacity} — "
                            "raise cache rows or shrink the batch")

    def admit(self, signs: np.ndarray):
        """Admit distinct ``signs``: ``(rows (n,) int64, miss_idx (M,),
        evict_signs (K,), evict_rows (K,))``. Residents are touched first,
        so no sign of the batch is evicted for another. Raises when the
        batch holds more signs than the capacity."""
        signs = np.ascontiguousarray(signs, dtype=np.uint64)
        n = len(signs)
        self._ensure_scratch(n)
        rows = self._rows_ring.get("rows64", (_bucket(max(n, 1)),), np.int64)[:n]
        n_evict = ctypes.c_int64(0)
        n_miss = self._fn("admit")(
            self._h, signs.ctypes.data_as(_u64p), n, rows.ctypes.data_as(_i64p),
            self._s_miss_idx.ctypes.data_as(_i64p), self._s_ev_signs.ctypes.data_as(_u64p),
            self._s_ev_rows.ctypes.data_as(_i64p), ctypes.byref(n_evict),
        )
        if n_miss < 0:
            raise self._overflow()
        k = n_evict.value
        return rows, self._s_miss_idx[:n_miss].copy(), self._s_ev_signs[:k].copy(), self._s_ev_rows[:k].copy()

    def admit_positions(self, signs: np.ndarray):
        """Admit a position-level stream (duplicates allowed; deduplicated
        natively): ``(rows (n,) int32 a position, miss_signs (M,) in
        first-seen order, miss_rows (M,), evict_signs (K,), evict_rows (K,),
        n_unique)``."""
        if self._sharded:
            return self.feed_batch(signs, None)[:6]
        signs = np.ascontiguousarray(signs, dtype=np.uint64)
        n = signs.size
        self._ensure_scratch(n)
        rows = self._rows_ring.get("rows", (_bucket(max(n, 1)),), np.int32)[:n]
        n_unique, n_evict = ctypes.c_int64(0), ctypes.c_int64(0)
        n_miss = self._lib.cache_admit_positions(
            self._h, signs.ctypes.data_as(_u64p), n, rows.ctypes.data_as(_i32p),
            self._s_miss_signs.ctypes.data_as(_u64p), self._s_miss_rows.ctypes.data_as(_i64p),
            self._s_ev_signs.ctypes.data_as(_u64p), self._s_ev_rows.ctypes.data_as(_i64p),
            ctypes.byref(n_unique), ctypes.byref(n_evict),
        )
        if n_miss < 0:
            raise self._overflow()
        k = n_evict.value
        return (rows, self._s_miss_signs[:n_miss].copy(), self._s_miss_rows[:n_miss].copy(),
                self._s_ev_signs[:k].copy(), self._s_ev_rows[:k].copy(), n_unique.value)

    def feed_batch(self, signs: np.ndarray, pending_map: Optional["PendingSignMap"], salt: int = 0):
        """``admit_positions`` and, in the same native call, the pending
        map's probe of the misses (``cache_feed_batch``, or
        ``cache_feed_batch_sharded`` walking the shards on the pool; key =
        sign ^ ``salt``): its 6-tuple, then ``(restore_src (R,), restore_pos
        (R,))``, the ring row and miss ordinal of every miss whose freshest
        entry is still in flight. The probe runs before the caller
        reserves its ring span, so the caller queries these hits again
        after reserving it."""
        signs = np.ascontiguousarray(signs, dtype=np.uint64)
        n = signs.size
        self._ensure_scratch(n)
        rows = self._rows_ring.get("rows", (_bucket(max(n, 1)),), np.int32)[:n]
        n_unique, n_evict, n_restore = ctypes.c_int64(0), ctypes.c_int64(0), ctypes.c_int64(0)
        feed = self._lib.cache_feed_batch_sharded if self._sharded else self._lib.cache_feed_batch
        n_miss = feed(
            self._h, pending_map._h if pending_map is not None else None, signs.ctypes.data_as(_u64p), n,
            rows.ctypes.data_as(_i32p), self._s_miss_signs.ctypes.data_as(_u64p),
            self._s_miss_rows.ctypes.data_as(_i64p), self._s_ev_signs.ctypes.data_as(_u64p),
            self._s_ev_rows.ctypes.data_as(_i64p), ctypes.byref(n_unique), ctypes.byref(n_evict),
            self._s_rst_src.ctypes.data_as(_i64p), self._s_rst_pos.ctypes.data_as(_i64p), ctypes.byref(n_restore),
            ctypes.c_uint64(salt & (2 ** 64 - 1)),
        )
        if n_miss < 0:
            raise self._overflow()
        k, r = n_evict.value, n_restore.value
        return (rows, self._s_miss_signs[:n_miss].copy(), self._s_miss_rows[:n_miss].copy(),
                self._s_ev_signs[:k].copy(), self._s_ev_rows[:k].copy(), n_unique.value,
                self._s_rst_src[:r].copy(), self._s_rst_pos[:r].copy())

    def probe(self, signs: np.ndarray) -> np.ndarray:
        """Each sign's row, -1 where it is not resident; no admission and no
        LRU touch (eval's lookup)."""
        signs = np.ascontiguousarray(signs, dtype=np.uint64)
        rows = np.empty(len(signs), dtype=np.int64)
        self._fn("probe")(self._h, signs.ctypes.data_as(_u64p), len(signs), rows.ctypes.data_as(_i64p))
        return rows

    def _listing(self, fn) -> Tuple[np.ndarray, np.ndarray]:
        signs = np.empty(self.capacity, dtype=np.uint64)
        rows = np.empty(self.capacity, dtype=np.int64)
        k = fn(self._h, signs.ctypes.data_as(_u64p), rows.ctypes.data_as(_i64p))
        return signs[:k].copy(), rows[:k].copy()

    def drain(self) -> Tuple[np.ndarray, np.ndarray]:
        """Empty the directory: ``(signs, rows)`` of every resident, most
        recently used first."""
        return self._listing(self._fn("drain"))

    def snapshot(self) -> Tuple[np.ndarray, np.ndarray]:
        """``drain``'s listing without emptying or touching anything."""
        return self._listing(self._fn("snapshot"))

    def touch_counts(self) -> np.ndarray:
        """The touch gate's counters (uint8; empty with ``admit_touches``
        1), which ``drain`` keeps: a snapshot saves them with the flushed
        cache."""
        n = int(self._fn("touch_counts")(self._h, None, 0))
        out = np.empty(n, dtype=np.uint8)
        self._fn("touch_counts")(self._h, out.ctypes.data_as(_u8p), n)
        return out

    def set_touch_counts(self, counts: np.ndarray) -> None:
        """Load counters ``touch_counts`` returned (of a directory of the
        same capacity and ``admit_touches``)."""
        counts = np.ascontiguousarray(counts, dtype=np.uint8)
        if self._fn("set_touch_counts")(self._h, counts.ctypes.data_as(_u8p), len(counts)) != 0:
            raise ValueError(f"{len(counts)} touch counters for a directory that keeps "
                             f"{int(self._fn('touch_counts')(self._h, None, 0))}")


def group_salt(name: str) -> int:
    """A cache group's 64-bit namespace salt (nonzero; by name): the
    reference keys its pending write-backs by ``sign ^ salt`` so that two
    groups' equal raw signs cannot meet."""
    h = hashlib.blake2b(name.encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") or 1


class PendingSignMap:
    """The stream's map sign → (token, ring row) of every eviction whose
    write-back is in flight (``pending_map_*`` of the native directory):
    the feeder's hazard gate queries it, the write-back thread removes a
    step's entries once they land. One map serves every group: each
    method XORs the group's ``salt`` (``group_salt``) into the signs, as
    ``CacheDirectory.feed_batch``'s native probe does. Thread-safe (a
    native mutex)."""

    def __init__(self):
        self._lib = _load_lib()
        self._h = self._lib.pending_map_create()
        if not self._h:
            raise MemoryError("pending_map_create failed")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.pending_map_destroy(self._h)
            self._h = None

    def __len__(self) -> int:
        return int(self._lib.pending_map_size(self._h))

    @staticmethod
    def _salted(signs: np.ndarray, salt: int) -> np.ndarray:
        signs = np.ascontiguousarray(signs, dtype=np.uint64)
        return signs ^ np.uint64(salt) if salt else signs

    def insert(self, signs: np.ndarray, srcs: np.ndarray, token: int, salt: int = 0) -> None:
        signs = self._salted(signs, salt)
        srcs = np.ascontiguousarray(srcs, dtype=np.int64)
        if len(signs) != len(srcs):
            raise ValueError(f"{len(signs)} signs but {len(srcs)} sources")
        self._lib.pending_map_insert(self._h, signs.ctypes.data_as(_u64p), srcs.ctypes.data_as(_i64p), len(signs),
                                     token & 0xFFFFFFFF)

    def insert_range(self, signs: np.ndarray, base_src: int, token: int, salt: int = 0) -> None:
        """``signs[i] -> (base_src + i, token)``: a step's ring span."""
        signs = self._salted(signs, salt)
        self._lib.pending_map_insert_range(self._h, signs.ctypes.data_as(_u64p), len(signs), int(base_src),
                                           token & 0xFFFFFFFF)

    def query(self, signs: np.ndarray, salt: int = 0):
        """``(hits, tokens (n,) uint32, srcs (n,) int64)``, src -1 where a
        sign is not pending."""
        signs = self._salted(signs, salt)
        n = len(signs)
        tokens = np.empty(n, dtype=np.uint32)
        srcs = np.empty(n, dtype=np.int64)
        hits = self._lib.pending_map_query(self._h, signs.ctypes.data_as(_u64p), n,
                                           tokens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                                           srcs.ctypes.data_as(_i64p))
        return int(hits), tokens, srcs

    def remove(self, signs: np.ndarray, token: int, salt: int = 0) -> None:
        """Remove the signs whose current entry carries ``token``."""
        signs = self._salted(signs, salt)
        self._lib.pending_map_remove(self._h, signs.ctypes.data_as(_u64p), len(signs), token & 0xFFFFFFFF)
