"""CachedEmbeddingTier: the cache tier's host side (counterpart of
``persia_tpu/embedding/hbm_cache/tier.py``): the directories, the
parameter-server traffic (probe, checkout, write-back) and each batch's
staging arrays.

Per batch and group: the group's distinct signs are admitted (hits keep
their row; a miss takes a free row or evicts the least recently used
sign), the misses split into warm (the server holds the sign: its whole
entry ships, ``miss_aux``) and cold (a new sign: its row is born on the
host with the server's seeded init, ``cold_aux``, and reaches the server
only at its eviction), and the evicted rows are listed for the write-back
(``evict_aux`` / ``evict_meta``). Every staging array's length is
``_bucket``-padded: row pads are C+1 (dropped by the device's writes) or C
(the zero row) for the payload's read.

Slots the cache does not hold (``ps_slots``: the hash-stacked ones and
those excluded) ride the parameter-server tier through the worker
(``CachedTrainCtx._ps_forward``); the tier leaves them out of its batches.
A feature group may not span both tiers, and with cache groups beside
them the sign prefix bit must be on, so the two tiers never write one
server entry. The sharded feeder (``feed_threads``, ``feed_shards``)
partitions each group's directory (``CacheDirectory(shards=)``) by the
group's salt. The reference's access sketch and its degraded-lookup
lineage are not part of the port.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from persia_tpu_torch.config import EmbeddingConfig
from persia_tpu_torch.data import PersiaBatch
from persia_tpu_torch.embedding import native_worker
from persia_tpu_torch.embedding.hashing import add_index_prefix
from persia_tpu_torch.embedding.hbm_cache.common import _bucket
from persia_tpu_torch.embedding.hbm_cache.directory import (
    CacheDirectory,
    _BufRing,
    _retain_allocator_pages,
    group_salt,
    native_init_rows,
)
from persia_tpu_torch.embedding.hbm_cache.groups import (
    CacheGroup,
    CacheLayout,
    _gather_entry_rows,
    make_cache_groups,
)
from persia_tpu_torch.embedding.optim import OptimizerConfig
from persia_tpu_torch.embedding.worker import ProcessedSlot, ShardedLookup, preprocess_batch
from persia_tpu_torch.utils import round_up_pow2
from persia_tpu_torch.wire import BF16Host, tensor_to_host_f32

AUX_WIRE_DTYPES = ("float32", "bfloat16")


def _eviction_slots(gname: str, rows_miss: np.ndarray, ev_rows: np.ndarray) -> np.ndarray:
    """(m,) int32: the payload slot j of the miss whose row is ``ev_rows[j]``
    (a miss takes the row it evicted), -1 for the misses that took a free
    row. Raises when an evicted row is no miss's."""
    k, m = len(ev_rows), len(rows_miss)
    slot = np.full(m, -1, dtype=np.int32)
    if not k:
        return slot
    if k <= m and np.array_equal(rows_miss[m - k:], ev_rows):  # the unsharded directory's order
        slot[m - k:] = np.arange(k, dtype=np.int32)
        return slot
    order = np.argsort(rows_miss, kind="stable")
    pos = np.minimum(np.searchsorted(rows_miss[order], ev_rows), max(m - 1, 0))
    if k > m or not np.array_equal(rows_miss[order][pos], ev_rows):
        raise RuntimeError(f"group {gname}: an evicted row is not the row of one of the call's misses")
    slot[order[pos]] = np.arange(k, dtype=np.int32)
    return slot


class CachedEmbeddingTier:
    """The directories, parameter-server traffic and staging of the cache
    tier over ``worker`` (an ``EmbeddingWorker``: its router reaches the
    replicas by sign).

    ``rows``: the cache capacity C of every group, or {dim: C}.
    ``init_seed``: the replicas' seed (by default replica 0's ``.seed``),
    which cold rows born here must share. ``aux_wire_dtype``: the dtype the
    warm entries and cold rows cross to the card in (bf16 rounds to
    nearest even, as ``ml_dtypes`` does). ``ps_slots``: the slots left to
    the parameter-server tier besides the hash-stacked ones (none of them
    in a cache group; ``self.ps_slots`` holds both, sorted)."""

    _PAR_CHUNK = 8192  # signs a store call takes before the call is split across threads

    def __init__(self, worker, sparse_cfg: OptimizerConfig, rows, embedding_config: Optional[EmbeddingConfig] = None,
                 init_seed: Optional[int] = None, admit_touches: int = 1, aux_wire_dtype: str = "float32",
                 ps_slots: Sequence[str] = (), feed_threads: Optional[int] = None,
                 feed_shards: Optional[int] = None):
        if aux_wire_dtype not in AUX_WIRE_DTYPES:
            raise ValueError(f"aux_wire_dtype must be one of {AUX_WIRE_DTYPES}, got {aux_wire_dtype!r}")
        self.worker = worker
        self.cfg = embedding_config or worker.embedding_config
        self.sparse_cfg = sparse_cfg
        self.aux_bf16 = aux_wire_dtype == "bfloat16"
        if init_seed is None:
            init_seed = getattr(self.router.replicas[0], "seed", None)
            if init_seed is None:
                raise ValueError("init_seed not given and the replicas expose no .seed")
        self.init_seed = int(init_seed)
        dims = {slot.dim for name, slot in self.cfg.slots_config.items()
                if not slot.hash_stack_config.enabled and name not in ps_slots}
        rows_per_group = rows if isinstance(rows, dict) else {d: rows for d in dims}
        self.groups, self.ps_slots = make_cache_groups(self.cfg, rows_per_group, sparse_cfg, exclude=ps_slots)
        self._check_tiers()
        # each group's namespace in the stream's one pending map (sign ^
        # salt), which is also its directory's partition key
        self.group_salt = {g.name: group_salt(g.name) for g in self.groups}
        if feed_threads is None:
            feed_threads = int(os.environ.get("PERSIA_FEED_THREADS", "1") or 1)
        self.feed_threads = max(1, int(feed_threads))
        if feed_shards is None:
            env = os.environ.get("PERSIA_FEED_SHARDS", "")
            if env:
                feed_shards = int(env)
            elif self.feed_threads > 1:
                feed_shards = 8
        if feed_shards is not None and int(feed_shards) < 1:
            feed_shards = None  # 0 forces the unsharded walk
        self.feed_shards = None if feed_shards is None else int(feed_shards)
        self.dirs = {g.name: CacheDirectory(g.rows, admit_touches=admit_touches, shards=self.feed_shards,
                                            feed_threads=self.feed_threads, part_salt=self.group_salt[g.name])
                     for g in self.groups}
        if self.feed_shards is not None and self.dirs:
            self.feed_shards = next(iter(self.dirs.values())).shards  # as the native side clamped it
        _retain_allocator_pages()
        self._ring = _BufRing()
        self._slot_group = {s: g for g in self.groups for s in g.slots}
        self._fast_eligible = {name: slot.embedding_summation and not slot.sqrt_scaling
                               for name, slot in self.cfg.slots_config.items()}
        self._fast_prefix = {name: slot.index_prefix for name, slot in self.cfg.slots_config.items()}
        self._pool: Optional[ThreadPoolExecutor] = None
        # the batch's distinct signs resident, checked out of the server, and
        # written back on eviction (the reference's metrics counters)
        self.hits = self.misses = self.evictions = 0

    def set_feed_threads(self, threads: int) -> None:
        """Resize every directory's walker pool; no output depends on it."""
        self.feed_threads = max(1, int(threads))
        for d in self.dirs.values():
            d.set_feed_threads(self.feed_threads)

    def feeder_shard_stats(self) -> Dict[str, Dict[str, List[int]]]:
        """Each group's residents a shard and each shard's walk and queue
        ns of the last feed (``sizes``, ``busy_ns``, ``stall_ns``); empty
        unsharded."""
        if self.feed_shards is None:
            return {}
        return {name: {"sizes": d.shard_sizes().tolist(), "busy_ns": d.shard_busy_ns().tolist(),
                       "stall_ns": d.shard_stall_ns().tolist()} for name, d in self.dirs.items()}

    def _check_tiers(self) -> None:
        """A feature group is one key space: a cached and a PS-tier slot in
        one would be two writers of the same server entries. With
        ``feature_index_prefix_bit == 0`` every slot hashes into one raw
        space, so a PS-tier sign could equal a cached sign of another group:
        cache groups beside PS-tier slots need the prefix bit."""
        cached = {s for g in self.groups for s in g.slots}
        ps = set(self.ps_slots)
        for fg_name, members in self.cfg.feature_groups.items():
            ms = set(members)
            if ms & cached and ms & ps:
                raise ValueError(f"feature group {fg_name!r} mixes cached slots {sorted(ms & cached)} with PS-tier "
                                 f"slots {sorted(ms & ps)}: one key space cannot span both tiers")
        if self.groups and self.ps_slots and self.cfg.feature_index_prefix_bit == 0:
            raise ValueError(
                f"mixed-tier config (cached groups + PS-tier slots {sorted(self.ps_slots)}) requires "
                "feature_index_prefix_bit > 0 so per-group sign prefixes partition the PS key space; with prefix "
                "bit 0 a cached-tier sign can collide with a PS-tier sign and the two tiers would race on one PS "
                "entry")

    def _cached_features(self, batch: PersiaBatch) -> List:
        return [f for f in batch.id_type_features if f.name not in self.ps_slots]

    def counts(self) -> Dict[str, int]:
        """Hits, misses and evictions since the tier was built."""
        return {"hits": self.hits, "misses": self.misses, "evictions": self.evictions}

    @property
    def router(self) -> ShardedLookup:
        return self.worker.lookup_router

    @property
    def init_method(self):
        """Read live from replica 0: cold rows born here stay the rows the
        replicas would birth."""
        return self.router.replicas[0].hyperparams.resolved_init_method()

    # ---------------------------------------------------- server traffic

    def _chunked(self, n: int, fn: Callable[[int, int], None]) -> None:
        """``fn(start, end)`` over chunks of ``_PAR_CHUNK``, on a thread pool
        past one chunk (a native store's calls release the GIL)."""
        if n <= self._PAR_CHUNK:
            fn(0, n)
            return
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=8, thread_name_prefix="cache-chunk")
        bounds = list(range(0, n, self._PAR_CHUNK)) + [n]
        list(self._pool.map(lambda se: fn(*se), zip(bounds[:-1], bounds[1:])))

    def _probe(self, signs: np.ndarray, dim: int) -> Tuple[np.ndarray, np.ndarray]:
        """(warm (n,) bool, entries (n, dim + state_dim)) without admitting
        anything; the chunks fill disjoint slices of one buffer."""
        n = len(signs)
        entry_len = dim + self.sparse_cfg.state_dim(dim)
        nb = _bucket(max(n, 1))
        vals = self._ring.get("probe_vals", (nb, entry_len), np.float32)[:n]
        warm8 = self._ring.get("probe_warm", (nb,), np.uint8)[:n]
        self._chunked(n, lambda s, e: self.router.probe_entries(signs[s:e], dim, vals_out=vals[s:e],
                                                                 warm_out=warm8[s:e]))
        return warm8.view(np.bool_), vals

    def _set_embedding(self, signs: np.ndarray, values: np.ndarray, dim: int) -> None:
        self._chunked(len(signs), lambda s, e: self.router.set_embedding(signs[s:e], values[s:e], dim=dim,
                                                                          commit_incremental=True))

    # ----------------------------------------------------------- helpers

    def _group_slots(self, pb: List[ProcessedSlot]) -> Dict[str, List[ProcessedSlot]]:
        out: Dict[str, List[ProcessedSlot]] = {}
        for slot in pb:
            out.setdefault(self._slot_group[slot.name].name, []).append(slot)
        for slots in out.values():
            slots.sort(key=lambda s: s.name)
        return out

    @staticmethod
    def _dedup_group_signs(slots: List[ProcessedSlot]):
        """The group's slots' distinct signs concatenated and deduplicated
        across slots (the directory takes distinct signs; with prefix bit 0
        two slots can share one): (distinct, inverse)."""
        all_signs = np.concatenate([s.distinct for s in slots]) if slots else np.empty(0, np.uint64)
        native = native_worker.dedup(all_signs)
        uniq, inv = native if native is not None else np.unique(all_signs, return_inverse=True)
        return uniq, inv.astype(np.int64).reshape(-1)

    @staticmethod
    def _stack_layout(slots: List[ProcessedSlot]) -> int:
        """The common L of the group's pooled slots: the most ids a sample
        of any of them holds, a power of two (0 without pooled slots)."""
        pooled = [s for s in slots if s.config.embedding_summation]
        if not pooled:
            return 0
        max_c = max((int(s.counts.max()) if len(s.counts) else 1) for s in pooled)
        return round_up_pow2(max(max_c, 1), floor=1)

    @staticmethod
    def _slot_rows(slot: ProcessedSlot, slot_rows: np.ndarray, L: int, pad_row: int) -> np.ndarray:
        idx = _position_index(slot, L)
        lut = np.append(slot_rows, np.int64(pad_row))
        return lut[idx].astype(np.int32)

    # -------------------------------------------------------- train path

    def _admit_aux(self, g: CacheGroup, miss_signs, rows_miss, ev_signs, ev_rows, n_unique, hazard_gate,
                   miss_aux, cold_aux, restore_aux, evict_aux, evict_meta, ring_alloc=None) -> None:
        """After the admit, for both paths: the counters, the eviction
        rows and their ring span, the hazard gate, the warm/cold split of
        the misses, and the pairing K12 reads each evicted row by: each of
        the k rows a call evicts is taken by one of its misses (the
        unsharded directory hands them to its last k misses, in order; a
        sharded one to each shard's last misses), so the miss whose row is
        ``ev_rows[j]`` takes payload slot j (``_eviction_slots``). Each
        warm, cold and restore write carries its miss's slot (-1: none, and
        for pads); each payload slot is claimed exactly once, by one of
        those writes, or is a pad, which ``e_free`` lists.

        ``ring_alloc(group, padded k)`` (the stream's) reserves the step's
        span of the group's eviction ring before the gate runs, so no row
        the gate hands back lies in this step's span (K12's contract: its
        restores never read the span it stores). ``hazard_gate(group,
        miss_signs)`` runs before the server probe; it returns None or
        ``[(None, src_idx, positions), ...]``: the misses at ``positions``
        are restored from rows ``src_idx`` of the group's ring by K12, their
        restores concatenated into ``restore_aux``."""
        C = g.rows
        self.hits += n_unique - len(miss_signs)
        self.misses += len(miss_signs)
        self.evictions += len(ev_signs)
        k, m = len(ev_rows), len(miss_signs)
        kp = _bucket(k) if k else 0
        slot_of = _eviction_slots(g.name, rows_miss, ev_rows)
        if k:
            ring_pos = ring_alloc(g.name, kp) if ring_alloc is not None else -1
            evict_meta[g.name] = (ev_signs, k, ring_pos)
        resolved = hazard_gate(g.name, miss_signs) if hazard_gate is not None and m else None
        handled = np.zeros(m, dtype=bool)
        if resolved:
            src = np.concatenate([np.asarray(s, dtype=np.int64) for _p, s, _pos in resolved])
            restored = np.concatenate([np.asarray(pos, dtype=np.int64) for _p, _s, pos in resolved])
            handled[restored] = True
            n, n_pad = len(restored), round_up_pow2(len(restored))
            r_src = self._ring.full(("r_src", g.name), (n_pad,), np.int32, 0)  # a pad reads ring row 0
            r_dst = self._ring.full(("r_dst", g.name), (n_pad,), np.int32, C + 1)  # and is dropped
            r_src[:n] = src
            r_dst[:n] = rows_miss[restored]
            restore_aux[g.name] = (r_src, r_dst, self._slots(("r_slot", g.name), n_pad, restored, slot_of))
        if k:
            e_rows = self._ring.full(("e_rows", g.name), (kp,), np.int32, C)
            e_rows[:k] = ev_rows
            # every live slot is claimed by its miss's write: the pads alone are unclaimed
            e_free = self._ring.full(("e_free", g.name), (_bucket(kp - k) if kp > k else 0,), np.int32, -1)
            e_free[:kp - k] = np.arange(k, kp)
            evict_aux[g.name] = (e_rows, e_free)
        if not m:
            return
        warm, vals = self._probe(miss_signs, g.dim)
        widx = np.nonzero(warm[:m] & ~handled)[0]
        cidx = np.nonzero(~warm[:m] & ~handled)[0]
        # pad rows are C+1, which the device's writes drop; the pad
        # entries' values are left as they are on purpose
        if len(widx):
            wp = _bucket(len(widx))
            w_rows = self._ring.full(("w_rows", g.name), (wp,), np.int32, C + 1)
            w_rows[:len(widx)] = rows_miss[widx]
            w_f32 = self._ring.get(("w_entries", g.name), (wp, g.dim + g.state_dim), np.float32)
            w_f32[:len(widx)] = vals[widx]
            miss_aux[g.name] = (w_rows, BF16Host.from_f32(w_f32) if self.aux_bf16 else w_f32,
                                self._slots(("w_slot", g.name), wp, widx, slot_of))
        if len(cidx):
            cp = _bucket(len(cidx))
            c_rows = self._ring.full(("c_rows", g.name), (cp,), np.int32, C + 1)
            c_rows[:len(cidx)] = rows_miss[cidx]
            c_f32 = self._ring.get(("c_emb", g.name), (cp, g.dim), np.float32)
            native_init_rows(miss_signs[cidx], self.init_seed, g.dim, self.init_method, out=c_f32[:len(cidx)])
            cold_aux[g.name] = (c_rows, BF16Host.from_f32(c_f32) if self.aux_bf16 else c_f32,
                                self._slots(("c_slot", g.name), cp, cidx, slot_of))

    def _slots(self, key, padded: int, idx: np.ndarray, slot_of: np.ndarray) -> np.ndarray:
        """The payload slot each of the misses ``idx`` overwrites
        (``slot_of``), -1 for the pads."""
        out = self._ring.full(key, (padded,), np.int32, -1)
        out[:len(idx)] = slot_of[idx]
        return out

    def _single_id_groups(self, batch: PersiaBatch):
        """[(group, slot names, (S, B) prefixed signs), ...] when every slot
        is pooled, unscaled, and every feature holds exactly one id a
        sample; else None (the general path). PS-tier slots are left out."""
        feats = {f.name: f for f in self._cached_features(batch)}
        for name in feats:
            if name not in self._slot_group:
                raise KeyError(f"unknown slot {name!r} (not in embedding config)")
            if not self._fast_eligible[name]:
                return None
        out = []
        prefix_bit = self.cfg.feature_index_prefix_bit
        for g in self.groups:
            names = [n for n in g.pooled_slots if n in feats]
            if not names:
                continue
            flats = []
            for name in names:
                flat, counts = feats[name].flat_counts()
                if len(flat) != len(counts) or not (counts == 1).all():
                    return None
                flats.append(np.ascontiguousarray(flat, dtype=np.uint64))
            mat = self._ring.get(("sid_mat", g.name), (len(names), len(flats[0])), np.uint64)
            prefixes = np.array([self._fast_prefix[n] for n in names], dtype=np.uint64)
            if not native_worker.build_sid_matrix(flats, prefixes, prefix_bit, mat):
                for i, (name, flat) in enumerate(zip(names, flats)):
                    mat[i] = add_index_prefix(flat, self._fast_prefix[name], prefix_bit)
            out.append((g, tuple(names), mat))
        return out

    @staticmethod
    def _host_inputs(batch: PersiaBatch, stacked_rows, raw_rows, stacked_scale=None) -> Dict:
        inputs = {
            "dense": [np.asarray(f.data, dtype=np.float32) for f in batch.non_id_type_features],
            "labels": [np.asarray(l.data, dtype=np.float32) for l in batch.labels],
            "stacked_rows": stacked_rows,
            "raw_rows": raw_rows,
        }
        if stacked_scale is not None:
            inputs["stacked_scale"] = stacked_scale
        return inputs

    def _slot_matrices(self, g: CacheGroup, slots, rows, stacked_rows, stacked_scale, raw_rows, layout_stacked):
        """Per-slot row matrices from the group's rows (slot-concatenated
        distinct order): pooled slots stacked into (S, B, L); returns
        whether any slot scales."""
        C = g.rows
        L = self._stack_layout(slots)
        off = 0
        mats, scales, names = [], [], []
        any_scale = False
        for slot in slots:
            d = slot.num_distinct
            srows = rows[off:off + d]
            off += d
            if slot.config.embedding_summation:
                names.append(slot.name)
                mats.append(self._slot_rows(slot, srows, L, C))
                if slot.config.sqrt_scaling:
                    any_scale = True
                    scales.append((1.0 / np.sqrt(np.maximum(slot.counts, 1))).astype(np.float32))
                else:
                    scales.append(np.ones(slot.batch_size, dtype=np.float32))
            else:
                raw_rows[slot.name] = self._slot_rows(slot, srows, slot.config.sample_fixed_size, C)
        if mats:
            stacked_rows[g.name] = np.stack(mats)
            stacked_scale[g.name] = np.stack(scales)
            layout_stacked.append((g.name, tuple(names)))
        return any_scale

    def prepare_batch(self, batch: PersiaBatch, hazard_gate: Optional[Callable] = None,
                      ring_alloc: Optional[Callable[[str, int], int]] = None, pending_map=None):
        """Admit the batch's signs, check the warm misses out of the server
        and build the step's host arrays: ``(inputs, layout, miss_aux,
        cold_aux, restore_aux, evict_aux, evict_meta)``. ``miss_aux``
        {group: (rows, entries, slots)}, ``cold_aux`` {group: (rows, seeds,
        slots)}, ``restore_aux`` {group: (ring rows, table rows, slots)},
        ``evict_aux`` {group: (rows, unclaimed slots)} (the pairing:
        ``_admit_aux``), ``evict_meta`` {group: (evicted signs, count, ring
        position or -1)}. PS-tier slots are left out (the ctx forwards
        them through the worker).

        ``hazard_gate(group, miss_signs)`` runs before a group's server
        probe: the synchronous ctx lands its deferred write-back there when
        one of these misses is a sign that write-back carries; the stream's
        returns restores from the eviction ring. ``ring_alloc`` is the
        stream's (``_admit_aux``). ``pending_map`` (the stream's
        ``PendingSignMap``): the single-id path probes it inside the admit
        (``CacheDirectory.feed_batch``) and queries its hits again after
        the ring span is reserved, in place of ``hazard_gate``."""
        fast = self._single_id_groups(batch)
        if fast is not None:
            return self._prepare_batch_single_id(batch, fast, hazard_gate, ring_alloc, pending_map)
        slots_by_group = self._group_slots(preprocess_batch(self._cached_features(batch), self.cfg))
        stacked_rows, stacked_scale, raw_rows = {}, {}, {}
        layout_stacked: List = []
        miss_aux, cold_aux, restore_aux, evict_aux, evict_meta = {}, {}, {}, {}, {}
        any_scale = False
        for g in self.groups:
            slots = slots_by_group.get(g.name, [])
            if not slots:
                continue
            uniq, inv = self._dedup_group_signs(slots)
            rows_u, miss_idx, ev_signs, ev_rows = self.dirs[g.name].admit(uniq)
            self._admit_aux(g, uniq[miss_idx], rows_u[miss_idx], ev_signs, ev_rows, len(uniq), hazard_gate,
                            miss_aux, cold_aux, restore_aux, evict_aux, evict_meta, ring_alloc)
            any_scale |= self._slot_matrices(g, slots, rows_u[inv], stacked_rows, stacked_scale, raw_rows,
                                             layout_stacked)
        inputs = self._host_inputs(batch, stacked_rows, raw_rows, stacked_scale if any_scale else None)
        return (inputs, CacheLayout(stacked=tuple(layout_stacked)), miss_aux, cold_aux, restore_aux, evict_aux,
                evict_meta)

    def _prepare_batch_single_id(self, batch: PersiaBatch, fast, hazard_gate, ring_alloc, pending_map):
        """One native admit a group over its (S, B) sign matrix
        (``admit_positions``, or with a ``pending_map`` ``feed_batch``:
        dedup, admit, each position's row and the pending map's probe);
        the row matrix is its output reshaped."""
        stacked_rows: Dict[str, np.ndarray] = {}
        layout_stacked: List = []
        miss_aux, cold_aux, restore_aux, evict_aux, evict_meta = {}, {}, {}, {}, {}
        for g, names, mat in fast:
            S, B = mat.shape
            d = self.dirs[g.name]
            gate = hazard_gate
            if pending_map is not None:
                salt = self.group_salt[g.name]
                rows, miss_signs, miss_rows, ev_signs, ev_rows, n_unique, _rst_src, rst_pos = d.feed_batch(
                    mat.reshape(-1), pending_map, salt=salt)
                gate = _make_reval_gate(pending_map, rst_pos, salt)
            else:
                rows, miss_signs, miss_rows, ev_signs, ev_rows, n_unique = d.admit_positions(mat.reshape(-1))
            self._admit_aux(g, miss_signs, miss_rows, ev_signs, ev_rows, n_unique, gate,
                            miss_aux, cold_aux, restore_aux, evict_aux, evict_meta, ring_alloc)
            stacked_rows[g.name] = rows.reshape(S, B, 1)
            layout_stacked.append((g.name, names))
        inputs = self._host_inputs(batch, stacked_rows, {})
        return (inputs, CacheLayout(stacked=tuple(layout_stacked)), miss_aux, cold_aux, restore_aux, evict_aux,
                evict_meta)

    # --------------------------------------------------------- eval path

    def prepare_eval_batch(self, batch: PersiaBatch):
        """Eval's host arrays, changing nothing of the cache: a resident
        sign reads its row (a read-only probe); a miss reads the server's
        infer lookup (zeros for a sign it lacks, nothing admitted) from the
        group's ``miss_tables`` at row C+1+j. ``(inputs, layout)``, PS-tier
        slots left out."""
        slots_by_group = self._group_slots(preprocess_batch(self._cached_features(batch), self.cfg))
        stacked_rows, stacked_scale, raw_rows, miss_tables = {}, {}, {}, {}
        layout_stacked: List = []
        any_scale = False
        for g in self.groups:
            slots = slots_by_group.get(g.name, [])
            if not slots:
                continue
            C = g.rows
            uniq, inv = self._dedup_group_signs(slots)
            rows_u = self.dirs[g.name].probe(uniq)
            miss_mask = rows_u < 0
            miss_signs = uniq[miss_mask]
            m = len(miss_signs)
            mt = np.zeros((round_up_pow2(max(m, 1)), g.dim), dtype=np.float32)
            if m:
                mt[:m] = self.router.lookup(miss_signs, g.dim, train=False)
                rows_u = rows_u.copy()
                rows_u[miss_mask] = C + 1 + np.arange(m)
            miss_tables[g.name] = mt
            any_scale |= self._slot_matrices(g, slots, rows_u[inv], stacked_rows, stacked_scale, raw_rows,
                                             layout_stacked)
        inputs = self._host_inputs(batch, stacked_rows, raw_rows, stacked_scale if any_scale else None)
        inputs["miss_tables"] = miss_tables
        return inputs, CacheLayout(stacked=tuple(layout_stacked))

    # -------------------------------------------------------- write-back

    def write_back(self, evict_meta, evict_payload) -> None:
        """Write the evicted rows' whole entries ``[emb | state]`` to the
        server: ``evict_payload`` {group: host tensor (f32 or bf16)}."""
        for gname, (ev_signs, k, _ring_pos) in evict_meta.items():
            if not k:
                continue
            g = next(gr for gr in self.groups if gr.name == gname)
            self._set_embedding(ev_signs[:k], tensor_to_host_f32(evict_payload[gname][:k]), g.dim)

    def _write_rows(self, g: CacheGroup, signs, rows, tables, emb_state) -> None:
        """Flush and publish: the rows' entries read on the device (K12's
        payload read, f32), one copy to the host, written to the server."""
        table = tables[g.name]
        rpad = np.zeros(round_up_pow2(len(rows)), dtype=np.int32)  # pads re-read row 0, sliced off
        rpad[:len(rows)] = rows
        payload = _gather_entry_rows(table, emb_state[g.name], torch.from_numpy(rpad).to(table.device))
        self._set_embedding(signs, tensor_to_host_f32(payload[:len(rows)]), g.dim)

    def flush(self, tables, emb_state) -> None:
        """Drain every group's directory and write its rows to the server."""
        for g in self.groups:
            signs, rows = self.dirs[g.name].drain()
            if len(signs):
                self._write_rows(g, signs, rows, tables, emb_state)

    def publish(self, tables, emb_state) -> int:
        """Write every resident row to the server, evicting nothing;
        returns the rows written."""
        total = 0
        for g in self.groups:
            signs, rows = self.dirs[g.name].snapshot()
            if len(signs):
                self._write_rows(g, signs, rows, tables, emb_state)
                total += len(signs)
        return total


def _make_reval_gate(pending_map, rst_pos: np.ndarray, salt: int):
    """The hazard gate of the single-id path under a pending map:
    ``feed_batch`` found the candidates before this step's ring span was
    reserved, and a write-back that landed in between may have freed a
    span they point into. ``_admit_aux`` calls the gate after the
    reservation, so querying the candidates again here closes that window:
    entries still live point into spans the allocator cannot have handed
    out; a dead entry's write-back has landed, and its miss reads the
    server like any other."""
    if not len(rst_pos):
        return None

    def gate(gname: str, miss_signs: np.ndarray):
        _hits, _tokens, srcs = pending_map.query(miss_signs[rst_pos], salt=salt)
        live = srcs >= 0
        if not live.any():
            return None
        return [(None, srcs[live], rst_pos[live])]

    return gate


def _position_index(slot: ProcessedSlot, L: int) -> np.ndarray:
    """(B, L) positions into the slot's distinct signs, padded with D."""
    idx = native_worker.raw_index(slot.counts, slot.inverse, L, slot.num_distinct)
    if idx is None:
        idx = np.full((slot.batch_size, L), slot.num_distinct, dtype=np.int32)
        pos = 0
        for b, c in enumerate(slot.counts.tolist()):
            take = min(c, L)
            idx[b, :take] = slot.inverse[pos:pos + take]
            pos += c
    return idx
