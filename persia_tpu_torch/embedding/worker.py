"""Embedding-worker tier (counterpart of ``persia_tpu/embedding/worker.py``):
id preprocessing (prefix, dedup, hash-stack), sharded lookup over
parameter-server replicas, the pooling/layout postprocess that hands each
slot to the device, and the synchronous gradient return: the post-forward
buffer and its staleness count, per-slot device gradients turned into
per-key gradients, and one batched update per replica, optionally through
the replicas' apply-journal (exactly once across a trainer's crash and
resume). ``EmbeddingWorker.dump`` and ``load`` fan a checkpoint out to the
replicas (``persia_tpu_torch.checkpoint``).

The hot loops (dedup, sum pooling, gradient accumulation, index matrices,
shard partitioning) run in the native worker core
(``embedding/native_worker.py``) where it builds, and in numpy otherwise,
at the reference's call sites. Both give the same arrays bit for bit,
except that native dedup lists the distinct ids in first-seen order where
``np.unique`` sorts them; every consumer pairs them with their inverse.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import wait
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from persia_tpu_torch.config import EmbeddingConfig, SlotConfig
from persia_tpu_torch.data import IDTypeFeature, PersiaBatch
from persia_tpu_torch.embedding import native_worker
from persia_tpu_torch.embedding.hashing import add_index_prefix, hash_stack, sign_to_shard
from persia_tpu_torch.jobstate import journal_shard_id, payload_crc
from persia_tpu_torch.utils import round_up_pow2


class ForwardIdNotFound(RuntimeError):
    """A forward or gradient call named a batch ref the worker does not
    hold (already consumed, aborted, or never buffered)."""


@dataclass
class ProcessedSlot:
    """One slot after preprocessing: table keys + dedup layout."""

    config: SlotConfig
    batch_size: int
    counts: np.ndarray  # (B,) ids per sample
    distinct: np.ndarray  # (D,) distinct original signs (prefix applied, pre-hashstack)
    inverse: np.ndarray  # (n_ids,) position of each id in ``distinct``
    keys: np.ndarray  # (D * rounds,) table keys (post-hashstack), row-major per distinct id
    rounds: int  # hash-stack rounds (1 = disabled)

    @property
    def name(self) -> str:
        return self.config.name

    @property
    def num_distinct(self) -> int:
        return len(self.distinct)

    @property
    def sample_of_id(self) -> np.ndarray:
        """(n_ids,) sample index of each id."""
        return np.repeat(np.arange(len(self.counts), dtype=np.int64), self.counts)


@dataclass
class SumEmbeddingBatch:
    """Pooled slot output: one (B, dim) array."""

    name: str
    pooled: np.ndarray  # (B, dim) f32


@dataclass
class RawEmbeddingBatch:
    """Sequence slot output. ``index`` holds positions into ``distinct``
    padded with ``len(distinct)``; the device side appends a zero row so
    padded gathers read zeros."""

    name: str
    distinct: np.ndarray  # (D, dim) f32
    index: np.ndarray  # (B, sample_fixed_size) int32, pad value == D
    sample_id_num: np.ndarray  # (B,) int32


@dataclass
class DevicePooledBatch:
    """Sum slot shipped UNPOOLED: distinct rows + gather layout; the sum
    pool (and sqrt scaling, from ``counts``) runs on the device."""

    name: str
    distinct: np.ndarray  # (D, dim) f32 — hash-stack rounds summed, UNSCALED
    index: np.ndarray  # (B, L) int32, L = padded max ids/sample, pad == D
    counts: np.ndarray  # (B,) int32 true ids per sample
    sqrt_scaling: bool = False


FeatureEmbeddingBatch = Union[SumEmbeddingBatch, RawEmbeddingBatch, DevicePooledBatch]


def preprocess_slot(feature: IDTypeFeature, config: SlotConfig, prefix_bit: int) -> ProcessedSlot:
    """Dedup + prefix + hashstack for one slot. Dedup runs on the prefixed
    signs (first-seen order natively, sorted in numpy); hashstack expands
    each distinct sign into ``rounds`` table keys whose rows are summed."""
    flat, counts = feature.flat_counts()
    flat = add_index_prefix(flat.astype(np.uint64, copy=False), config.index_prefix, prefix_bit)
    native = native_worker.dedup(flat)
    if native is not None:
        distinct, inverse = native
    else:
        distinct, inverse = np.unique(flat, return_inverse=True)
    hs = config.hash_stack_config
    if hs.enabled:
        rounds = hs.hash_stack_rounds
        keys = hash_stack(distinct, rounds, hs.embedding_size).reshape(-1)
        keys = add_index_prefix(keys, config.index_prefix, prefix_bit)
    else:
        rounds = 1
        keys = distinct
    return ProcessedSlot(
        config=config,
        batch_size=len(counts),
        counts=counts,
        distinct=distinct,
        inverse=inverse.astype(np.int64).reshape(-1),
        keys=keys,
        rounds=rounds,
    )


def preprocess_batch(
    id_type_features: Sequence[IDTypeFeature], embedding_config: EmbeddingConfig
) -> List[ProcessedSlot]:
    prefix_bit = embedding_config.feature_index_prefix_bit
    return [
        preprocess_slot(f, embedding_config.slot(f.name), prefix_bit) for f in id_type_features
    ]


def _split_flat_rows(flat: np.ndarray, key_ofs: np.ndarray, dims: np.ndarray) -> List[np.ndarray]:
    """Slice a batched-lookup reply (flat f32, groups back to back) into
    per-group (count, dim) views."""
    out = []
    off = 0
    for g in range(len(dims)):
        c = int(key_ofs[g + 1] - key_ofs[g])
        d = int(dims[g])
        out.append(flat[off:off + c * d].reshape(c, d))
        off += c * d
    return out


def _partition_positions(signs: np.ndarray, n: int) -> List[Tuple[int, np.ndarray]]:
    """[(replica, ascending positions of its keys)] for the replicas that
    own any of ``signs`` under ``sign_to_shard`` routing."""
    part = native_worker.shard_partition(signs, n)
    if part is None:
        shard = sign_to_shard(signs, n)
        return [(r, pos) for r in range(n) if len(pos := np.flatnonzero(shard == r))]
    pos, counts = part
    ends = np.cumsum(counts)
    return [(r, pos[ends[r] - counts[r]:ends[r]]) for r in range(n) if counts[r]]


FANOUT_WAIT_S = 300.0  # the longest a router call waits on its replicas' tasks
FANOUT_SOLE_CALLS = 8  # a call fans out when its thread made the router's last this many calls


class ShardedLookup:
    """Routes table keys across parameter-server replicas by
    ``sign_to_shard`` and reassembles the replies. ``replicas`` are
    store-like objects exposing ``lookup_batched``.

    With more than one replica a call fans its per-replica parts out
    through a thread pool created here, sized ``min(32, 8 * replicas)``
    (the reference router's ``_concurrent``). The calling thread runs the
    first part itself, then, in order, every other part that no pool
    thread has started by the time it gets there, so a call never waits
    on a hand-off: a small call (``advance_batch_state``) or a busy host
    costs a submit and a cancel, not a thread's wake-up. Only a call from
    the thread that made each of the router's last ``FANOUT_SOLE_CALLS``
    calls fans out: a router whose calls come from several threads (a
    loader's lookup and gradient lanes, the cache stream's) already has
    its callers running at once, and a part handed to the pool there
    takes a core from them, so such a call runs inline, as does a call
    with one part. Each replica owns disjoint keys, so the
    results are bit for bit the serial loop's; they are assembled, and the
    journal and batch-state counts taken, on the calling thread. No call
    waits on a part that has not started, so a pool task that called the
    router could not deadlock it; a started part is waited for at most
    ``FANOUT_WAIT_S``. ``close`` shuts the pool down for good: later calls
    run their parts inline."""

    def __init__(self, replicas: Sequence):
        if not replicas:
            raise ValueError("need at least one PS replica")
        self.replicas = list(replicas)
        self.batch_advances: Dict[int, int] = {}
        self.journal_skips = 0  # journaled replica applies skipped as already applied
        self._count_lock = threading.Lock()
        # the threads of the router's last calls, under _count_lock
        self._callers = deque(maxlen=FANOUT_SOLE_CALLS)
        self._fan_pool = None
        if len(self.replicas) > 1:
            # eager: the router's callers run concurrently, a lazy start would race
            from concurrent.futures import ThreadPoolExecutor

            self._fan_pool = ThreadPoolExecutor(max_workers=min(32, 8 * len(self.replicas)),
                                                thread_name_prefix="ps-fanout")

    def close(self) -> None:
        """Shut the fan-out pool down, waiting for its running tasks."""
        pool, self._fan_pool = self._fan_pool, None
        if pool is not None:
            pool.shutdown(wait=True)

    def _concurrent(self, thunks: Sequence) -> List:
        """Run the per-replica ``thunks``, the first on this thread and the
        others on the pool unless this thread, going through them in
        order, gets to one first; their results in order. Inline when
        another thread made one of the router's last calls."""
        pool = self._fan_pool
        if len(thunks) <= 1 or pool is None:
            return [t() for t in thunks]
        me = threading.get_ident()
        with self._count_lock:
            sole = len(self._callers) == FANOUT_SOLE_CALLS and self._callers.count(me) == FANOUT_SOLE_CALLS
            self._callers.append(me)
        if not sole:
            return [t() for t in thunks]
        futures = [pool.submit(t) for t in thunks[1:]]
        out, started = [None] * len(thunks), []
        try:
            out[0] = thunks[0]()
            for i, f in enumerate(futures, 1):
                if f.cancel():  # no pool thread has it: run it here
                    out[i] = thunks[i]()
                else:
                    started.append((i, f))
        except BaseException:
            for f in futures:
                f.cancel()
            raise
        deadline = time.monotonic() + FANOUT_WAIT_S
        for i, f in started:
            done, _ = wait([f], timeout=max(0.0, deadline - time.monotonic()))
            if not done:
                raise TimeoutError(f"a PS replica call still running after {FANOUT_WAIT_S:.0f} s")
            out[i] = f.result()
        return out

    def lookup_groups(self, groups: Sequence, train: bool) -> List[np.ndarray]:
        """Multi-slot lookup, one call per replica: ``groups`` is ``[(keys,
        dim), ...]``; returns per-group ``(len(keys), dim)`` arrays."""
        if not groups:
            return []
        dims = np.fromiter((d for _, d in groups), dtype=np.uint32, count=len(groups))
        key_ofs = np.zeros(len(groups) + 1, dtype=np.int64)
        np.cumsum([len(k) for k, _ in groups], out=key_ofs[1:])
        all_keys = np.concatenate([np.asarray(k, dtype=np.uint64) for k, _ in groups])
        n = len(self.replicas)
        if n == 1:
            flat = self.replicas[0].lookup_batched(all_keys, key_ofs, dims, train)
            return _split_flat_rows(flat, key_ofs, dims)
        outs = [np.zeros((len(k), int(d)), dtype=np.float32) for k, d in groups]
        parts = [(r, pos, np.searchsorted(pos, key_ofs).astype(np.int64))
                 for r, pos in _partition_positions(all_keys, n)]
        flats = self._concurrent([
            (lambda r=r, pos=pos, sub_ofs=sub_ofs: self.replicas[r].lookup_batched(all_keys[pos], sub_ofs, dims,
                                                                                      train))
            for r, pos, sub_ofs in parts
        ])
        for (_, pos, sub_ofs), flat in zip(parts, flats):
            for g, rows in enumerate(_split_flat_rows(flat, sub_ofs, dims)):
                b, e = sub_ofs[g], sub_ofs[g + 1]
                if b < e:
                    outs[g][pos[b:e] - key_ofs[g]] = rows
        return outs

    def _update_replica(self, r: int, keys, key_ofs, dims, flat, opt_groups, journal_id) -> bool:
        """One replica's share of a gradient batch; with ``journal_id`` (a
        ``jobstate.make_journal_id`` base) through its apply-journal, under
        the id ``journal_shard_id(journal_id, r)`` and the crc of (keys,
        gradients). False when the journal skipped it as already applied."""
        rep = self.replicas[r]
        if journal_id is None:
            rep.update_batched(keys, key_ofs, dims, flat, opt_groups)
            return True
        return bool(rep.update_batched_journaled(journal_shard_id(journal_id, r), payload_crc(keys, flat),
                                                 keys, key_ofs, dims, flat, opt_groups))

    def _count_skips(self, applied: Sequence[bool]) -> None:
        skips = sum(1 for a in applied if not a)
        if skips:
            with self._count_lock:
                self.journal_skips += skips

    def update_groups(self, groups: Sequence, journal_id: Optional[int] = None) -> None:
        """Multi-slot gradient fan-out, one call per replica:
        ``groups`` is ``[(keys, grads (n, dim) f32, opt_group), ...]``. The
        caller advances Adam's batch state once per batch per group first.
        ``journal_id`` routes each replica's apply through its journal,
        counting a skipped duplicate in ``journal_skips``."""
        if not groups:
            return
        dims = np.fromiter((g.shape[1] for _, g, _ in groups), dtype=np.uint32, count=len(groups))
        opt_groups = np.fromiter((og for _, _, og in groups), dtype=np.int32, count=len(groups))
        key_ofs = np.zeros(len(groups) + 1, dtype=np.int64)
        np.cumsum([len(k) for k, _, _ in groups], out=key_ofs[1:])
        all_keys = np.concatenate([np.asarray(k, dtype=np.uint64) for k, _, _ in groups])
        n = len(self.replicas)
        if n == 1:
            flat = np.concatenate([np.asarray(g, dtype=np.float32).reshape(-1) for _, g, _ in groups])
            self._count_skips([self._update_replica(0, all_keys, key_ofs, dims, flat, opt_groups, journal_id)])
            return

        def one(r, pos):
            sub_ofs = np.searchsorted(pos, key_ofs).astype(np.int64)
            flat = np.concatenate([
                np.asarray(groups[g][1], dtype=np.float32)[pos[sub_ofs[g]:sub_ofs[g + 1]] - key_ofs[g]].reshape(-1)
                for g in range(len(groups))
            ])
            return self._update_replica(r, all_keys[pos], sub_ofs, dims, flat, opt_groups, journal_id)

        self._count_skips(self._concurrent([(lambda r=r, pos=pos: one(r, pos))
                                            for r, pos in _partition_positions(all_keys, n)]))

    # the cache tier's calls: one dim, each sign to its replica as in
    # lookup_groups

    def lookup(self, keys: np.ndarray, dim: int, train: bool) -> np.ndarray:
        """``(len(keys), dim)`` rows, each key from its replica."""
        keys = np.asarray(keys, dtype=np.uint64)
        n = len(self.replicas)
        if n == 1:
            return self.replicas[0].lookup(keys, dim, train)
        out = np.zeros((len(keys), dim), dtype=np.float32)
        parts = _partition_positions(keys, n)
        vals = self._concurrent([(lambda r=r, pos=pos: self.replicas[r].lookup(keys[pos], dim, train))
                                 for r, pos in parts])
        for (_, pos), v in zip(parts, vals):
            out[pos] = v
        return out

    def checkout_entries(self, signs: np.ndarray, dim: int) -> np.ndarray:
        """Whole entries ``[emb | optimizer state]`` (n, dim + state_dim),
        misses admitted (the replicas' ``checkout_entries``)."""
        signs = np.asarray(signs, dtype=np.uint64)
        n = len(self.replicas)
        if n == 1:
            return self.replicas[0].checkout_entries(signs, dim)
        parts = _partition_positions(signs, n)
        vals = self._concurrent([(lambda r=r, pos=pos: self.replicas[r].checkout_entries(signs[pos], dim))
                                 for r, pos in parts])
        if not parts:
            return np.empty((0, dim), np.float32)
        out = np.empty((len(signs), vals[0].shape[1]), np.float32)
        for (_, pos), v in zip(parts, vals):
            out[pos] = v
        return out

    def probe_entries(self, signs: np.ndarray, dim: int, vals_out: Optional[np.ndarray] = None,
                      warm_out: Optional[np.ndarray] = None):
        """The warm/cold split, admitting nothing: ``(warm (n,) bool, vals
        (n, dim + state_dim))``, the cold rows' values unspecified.
        ``vals_out`` / ``warm_out`` (a 1-byte dtype), when given, are
        filled in place (at least n rows) and returned."""
        signs = np.asarray(signs, dtype=np.uint64)
        n_signs = len(signs)
        n = len(self.replicas)
        if n == 1 and getattr(self.replicas[0], "supports_probe_out", False):
            return self.replicas[0].probe_entries(signs, dim, vals_out=vals_out, warm_out=warm_out)
        parts = ([(0, np.arange(n_signs))] if n == 1 else _partition_positions(signs, n))
        got = self._concurrent([(lambda r=r, pos=pos: self.replicas[r].probe_entries(signs[pos], dim))
                                for r, pos in parts])
        warm = np.zeros(n_signs, dtype=bool)
        vals = vals_out
        for (_, pos), (w, v) in zip(parts, got):
            if vals is None:
                vals = np.zeros((n_signs, v.shape[1]), np.float32)
            warm[pos] = w
            vals[pos] = v
        if vals is None:
            vals = np.zeros((0, dim), np.float32)
        if warm_out is not None:
            warm_out[:n_signs] = warm
            return warm_out[:n_signs].view(np.bool_), vals
        return warm, vals

    def set_embedding(self, signs: np.ndarray, values: np.ndarray, dim: Optional[int] = None,
                      commit_incremental: bool = False) -> None:
        """Insert or overwrite whole entries ``[emb | state]``, each on its
        replica. ``commit_incremental`` marks them as training updates for
        an incremental-update manager, as the reference's does (the cache
        tier's write-backs pass True); the port has no such manager yet,
        so the flag reaches nothing, as in a reference store with none
        attached."""
        del commit_incremental
        signs = np.asarray(signs, dtype=np.uint64)
        values = np.asarray(values, dtype=np.float32)
        n = len(self.replicas)
        if n == 1:
            self.replicas[0].set_embedding(signs, values, dim)
            return
        self._concurrent([(lambda r=r, pos=pos: self.replicas[r].set_embedding(signs[pos], values[pos], dim))
                          for r, pos in _partition_positions(signs, n)])

    def advance_batch_state(self, group: int) -> None:
        """Advance ``group``'s Adam beta powers on every replica, counted in
        ``batch_advances``."""
        with self._count_lock:
            self.batch_advances[group] = self.batch_advances.get(group, 0) + 1
        self._concurrent([(lambda rep=rep: rep.advance_batch_state(group)) for rep in self.replicas])


def _sum_hashstack_rounds(slot: ProcessedSlot, rows: np.ndarray) -> np.ndarray:
    if slot.rounds > 1:
        rows = rows.reshape(slot.num_distinct, slot.rounds, slot.config.dim).sum(axis=1)
    return rows


def _index_matrix(slot: ProcessedSlot, width: int) -> np.ndarray:
    """(B, width) int32: each sample's first ``width`` distinct positions,
    padded with D."""
    native = native_worker.raw_index(slot.counts, slot.inverse, width, slot.num_distinct)
    if native is not None:
        return native
    index = np.full((slot.batch_size, width), slot.num_distinct, dtype=np.int32)
    starts = np.zeros(slot.batch_size, dtype=np.int64)
    np.cumsum(slot.counts[:-1], out=starts[1:])
    sample = slot.sample_of_id
    rank = np.arange(len(sample), dtype=np.int64) - starts[sample]
    keep = rank < width
    index[sample[keep], rank[keep]] = slot.inverse[keep]
    return index


def postprocess_slot(
    slot: ProcessedSlot, rows: np.ndarray, device_pooling: bool = False
) -> FeatureEmbeddingBatch:
    """Pooling/layout postprocess of one slot's looked-up key rows. ``rows``
    is (len(keys), dim); hash-stack rounds are summed here.
    ``device_pooling`` ships sum slots unpooled (``DevicePooledBatch``)."""
    dim = slot.config.dim
    rows = _sum_hashstack_rounds(slot, rows)
    if slot.config.embedding_summation and device_pooling:
        counts = slot.counts.astype(np.int32, copy=False)
        # L is a shape: bucket to pow2 (single-id streams pin it at 1)
        L = round_up_pow2(int(counts.max()) if len(counts) else 1, floor=1)
        return DevicePooledBatch(
            slot.name, rows, _index_matrix(slot, L), counts, slot.config.sqrt_scaling
        )
    if slot.config.embedding_summation:
        pooled = None
        if len(slot.inverse):
            pooled = native_worker.sum_pool(rows, slot.inverse, slot.sample_of_id, slot.batch_size)
        if pooled is None:
            pooled = np.zeros((slot.batch_size, dim), dtype=np.float32)
            np.add.at(pooled, slot.sample_of_id, rows[slot.inverse])
        if slot.config.sqrt_scaling:
            scale = 1.0 / np.sqrt(np.maximum(slot.counts, 1)).astype(np.float32)
            pooled *= scale[:, None]
        return SumEmbeddingBatch(slot.name, pooled)

    L = slot.config.sample_fixed_size
    D = slot.num_distinct
    sample_id_num = np.minimum(slot.counts, L).astype(np.int32)
    index = _index_matrix(slot, L)
    if slot.config.sqrt_scaling:
        rows = rows / np.sqrt(np.maximum(D, 1)).astype(np.float32)
    return RawEmbeddingBatch(slot.name, rows, index, sample_id_num)


def slot_gradient_to_keys(
    slot: ProcessedSlot, grad: np.ndarray, scale_factor: float = 1.0,
    device_pooled: bool = False,
) -> Optional[np.ndarray]:
    """A slot's device gradient as per-table-key gradients, (len(keys), dim)
    f32, or None when the slot is skipped for a non-finite value.

    - host-pooled sum slot: ``grad`` is (B, dim); every id of sample b gets
      ``grad[b]`` (times 1/sqrt(n_ids) with sqrt scaling), summed per
      distinct sign;
    - device-pooled sum slot: ``grad`` is (D, dim), already per distinct
      sign with the sqrt scaling applied by the device;
    - raw slot: ``grad`` is (D, dim) per distinct row (divided by sqrt(D)
      with sqrt scaling, as the forward scaled the rows);
    - hash-stack keys each receive their distinct id's gradient.

    ``grad`` is divided by ``scale_factor`` first (a loss scale)."""
    if not np.isfinite(grad).all():
        return None
    grad = grad.astype(np.float32)
    if scale_factor != 1.0:
        grad = grad / np.float32(scale_factor)
    dim = slot.config.dim
    if slot.config.embedding_summation and device_pooled:
        if grad.shape[0] != slot.num_distinct:
            raise ValueError(
                f"device-pooled slot {slot.name!r}: grad rows {grad.shape[0]} "
                f"!= distinct {slot.num_distinct}"
            )
        per_distinct = grad
    elif slot.config.embedding_summation:
        if slot.config.sqrt_scaling:
            scale = 1.0 / np.sqrt(np.maximum(slot.counts, 1)).astype(np.float32)
            grad = grad * scale[:, None]
        per_distinct = None
        if len(slot.inverse):
            per_distinct = native_worker.grad_accum(grad, slot.inverse, slot.sample_of_id, slot.num_distinct)
        if per_distinct is None:
            per_distinct = np.zeros((slot.num_distinct, dim), dtype=np.float32)
            np.add.at(per_distinct, slot.inverse, grad[slot.sample_of_id])
    else:
        if grad.shape[0] != slot.num_distinct:
            raise ValueError(
                f"raw slot {slot.name!r}: grad rows {grad.shape[0]} != distinct {slot.num_distinct}"
            )
        per_distinct = grad
        if slot.config.sqrt_scaling:
            per_distinct = per_distinct / np.sqrt(np.maximum(slot.num_distinct, 1)).astype(np.float32)
    if slot.rounds > 1:
        return np.repeat(per_distinct, slot.rounds, axis=0)
    return per_distinct


class EmbeddingWorker:
    """The worker tier over in-process replicas.

    Serving calls ``forward_directly``. Training buffers a batch's ids
    (``put_forward_ids`` → a ref), looks them up (``forward_batch_id``,
    which keeps the batch's layout in the post-forward buffer and counts it
    in ``staleness``), and returns its gradients
    (``update_gradient_batched``) or drops them (``abort_gradient``).

    ``device_pooling``: sum slots ship unpooled (``DevicePooledBatch``), are
    pooled on the device, and their gradients come back per distinct sign.
    """

    def __init__(
        self,
        embedding_config: EmbeddingConfig,
        replicas: Sequence,
        device_pooling: bool = False,
    ):
        self.embedding_config = embedding_config
        self.lookup_router = ShardedLookup(replicas)
        self.device_pooling = device_pooling
        self.forward_id_buffer: Dict[int, List[ProcessedSlot]] = {}
        self.post_forward_buffer: Dict[int, List[ProcessedSlot]] = {}
        self.staleness = 0  # batches looked up whose gradients are not back
        self._ref_id = 0
        self._buf_lock = threading.Lock()
        # one gradient batch at a time: Adam's batch-state advance is atomic
        # with its batch's updates
        self._grad_lock = threading.Lock()

    def close(self) -> None:
        """Shut the router's fan-out pool down for good (the ctx's
        ``__exit__`` calls this; later calls run inline)."""
        self.lookup_router.close()

    def register_optimizer(self, optimizer) -> None:
        """Register the sparse optimizer on every replica."""
        for r in self.lookup_router.replicas:
            r.register_optimizer(optimizer)

    def dump(self, path: str) -> None:
        """Checkpoint every replica into ``path``, under one session id so
        that markers of an earlier dump there cannot complete this one."""
        from persia_tpu_torch.checkpoint import dump_store  # checkpoint → hashing → this package

        session = f"s{time.time_ns()}"
        replicas = self.lookup_router.replicas
        for i, r in enumerate(replicas):
            dump_store(r, path, replica_index=i, replica_size=len(replicas), session=session)

    def load(self, path: str) -> int:
        """Load a checkpoint into every replica, re-sharding by sign when
        the replica count changed; returns the entries loaded."""
        from persia_tpu_torch.checkpoint import load_store

        replicas = self.lookup_router.replicas
        return sum(load_store(r, path, replica_index=i, replica_size=len(replicas))
                   for i, r in enumerate(replicas))

    def put_forward_ids(self, batch: PersiaBatch) -> int:
        """Preprocess and buffer a batch's ids; returns its ref."""
        slots = preprocess_batch(batch.id_type_features, self.embedding_config)
        with self._buf_lock:
            self._ref_id += 1
            self.forward_id_buffer[self._ref_id] = slots
            return self._ref_id

    def forward_batch_id(self, ref: int, train: bool = True) -> List[FeatureEmbeddingBatch]:
        """Look up a buffered batch; with ``train`` its layout waits in the
        post-forward buffer for the gradients."""
        with self._buf_lock:
            slots = self.forward_id_buffer.pop(ref, None)
        if slots is None:
            raise ForwardIdNotFound(f"forward id {ref} not found (expired or already consumed)")
        out = self._lookup_slots(slots, train)
        if train:
            with self._buf_lock:
                self.post_forward_buffer[ref] = slots
                self.staleness += 1
        return out

    def abort_gradient(self, ref: int) -> None:
        """Drop a looked-up batch without applying gradients (its step
        failed), releasing its staleness slot."""
        with self._buf_lock:
            if self.post_forward_buffer.pop(ref, None) is not None:
                self.staleness = max(0, self.staleness - 1)

    def update_gradient_batched(
        self, ref: int, slot_grads: Dict[str, np.ndarray], scale_factor: float = 1.0,
        journal_id: Optional[int] = None,
    ) -> Dict[str, int]:
        """Gradient return of a looked-up batch: per-slot device gradients
        (keyed by slot name) → per-key gradients → one update per replica
        (through the replicas' apply-journal with ``journal_id``, a
        ``jobstate.make_journal_id`` base). Returns the slots skipped for a
        non-finite gradient."""
        with self._buf_lock:
            slots = self.post_forward_buffer.pop(ref, None)
            if slots is not None:
                self.staleness = max(0, self.staleness - 1)
        if slots is None:
            raise ForwardIdNotFound(
                f"forward id {ref} not found in post-forward buffer "
                "(already updated, aborted, or never forwarded)"
            )
        cfg = self.embedding_config
        skipped: Dict[str, int] = {}
        trip = []
        for slot in slots:
            grad = slot_grads.get(slot.name)
            if grad is None:
                continue
            per_key = slot_gradient_to_keys(slot, grad, scale_factor, device_pooled=self.device_pooling)
            if per_key is None:
                skipped[slot.name] = 1
                continue
            trip.append((slot.keys, per_key, cfg.group_of(slot.name)))
        with self._grad_lock:
            groups = {cfg.group_of(s.name) for s in slots if s.name in slot_grads}
            for g in sorted(groups):
                self.lookup_router.advance_batch_state(g)
            self.lookup_router.update_groups(trip, journal_id=journal_id)
        return skipped

    def _lookup_slots(self, slots: Sequence[ProcessedSlot], train: bool) -> List[FeatureEmbeddingBatch]:
        rows_list = self.lookup_router.lookup_groups([(s.keys, s.config.dim) for s in slots], train)
        return [
            postprocess_slot(s, rows, device_pooling=self.device_pooling)
            for s, rows in zip(slots, rows_list)
        ]

    def forward_directly(self, batch: PersiaBatch, train: bool = False) -> List[FeatureEmbeddingBatch]:
        """Lookup-direct path for eval/infer; ``train=True`` admits missing
        signs into the store."""
        slots = preprocess_batch(batch.id_type_features, self.embedding_config)
        return self._lookup_slots(slots, train)
