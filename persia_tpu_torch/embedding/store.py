"""Embedding parameter store (counterpart of
``persia_tpu/embedding/store.py``).

One parameter-server replica held in process: internal shards, each an
insertion-ordered dict used as an O(1) LRU, with entries ``(dim, [emb |
optimizer state])``. Lookup semantics are the reference's:

- train: LRU-touch hits; a miss passes the admit gate, then gets the seeded
  by-sign init (or reads zeros if it is not admitted); an entry whose width
  is not ``dim`` + the registered optimizer's state re-inits;
- infer: zeros on miss, no touch, no admission.

The gradient path applies the registered sparse optimizer entry by entry,
then clamps to ±``weight_bound``; a sign that is not present is counted in
``grad_misses`` and skipped. Adam's beta powers are kept per feature group
and advanced once per gradient batch.

The per-sign hashes and the init rows are computed vectorized for the whole
call; the entries and their order are the same as the reference's
sign-by-sign loop.

Durable state: ``dump_shard`` writes one internal shard in the checkpoint
wire format (u32 count, then per entry u64 sign, u32 dim, u32 len and len
f32), from the least to the most recently used entry, the bytes the native
core writes; ``load_shard_bytes`` routes each entry by its sign. The
apply-journal (``journal_*``, ``update_batched_journaled``) remembers the
gradient batches applied since the last snapshot fence, so a resumed
trainer's replay applies each exactly once.
"""

from __future__ import annotations

import logging
import struct
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from persia_tpu_torch.config import HyperParameters
from persia_tpu_torch.embedding.hashing import init_for_signs, splitmix64
from persia_tpu_torch.embedding.optim import OptimizerConfig

logger = logging.getLogger("persia_tpu_torch.store")

_ENTRY_HEAD = struct.Struct("<QII")  # sign, dim, len
_COUNT = struct.Struct("<I")


class _Shard:
    """One internal shard: insertion-ordered dict as an LRU."""

    __slots__ = ("entries", "capacity")

    def __init__(self, capacity: int):
        self.entries: Dict[int, Tuple[int, np.ndarray]] = {}
        self.capacity = capacity

    def get_refresh(self, sign: int) -> Optional[Tuple[int, np.ndarray]]:
        e = self.entries.pop(sign, None)
        if e is not None:
            self.entries[sign] = e  # reinsert → most-recently-used
        return e

    def insert(self, sign: int, dim: int, vec: np.ndarray) -> None:
        if sign in self.entries:
            self.entries.pop(sign)
        elif len(self.entries) >= self.capacity:
            self.entries.pop(next(iter(self.entries)))  # evict LRU
        self.entries[sign] = (dim, vec)

    def __len__(self) -> int:
        return len(self.entries)


class EmbeddingStore:
    """One parameter-server replica's store (numpy)."""

    def __init__(
        self,
        capacity: int = 1 << 20,
        num_internal_shards: int = 8,
        hyperparams: HyperParameters = HyperParameters(),
        optimizer: Optional[OptimizerConfig] = None,
        seed: int = 0,
    ):
        if num_internal_shards <= 0 or capacity <= 0:
            raise ValueError("capacity and num_internal_shards must be positive")
        per_shard = max(1, capacity // num_internal_shards)
        self._shards = [_Shard(per_shard) for _ in range(num_internal_shards)]
        self._num_shards = num_internal_shards
        # one coarse lock: lookups may come from several serving threads
        self._lock = threading.RLock()
        self.hyperparams = hyperparams
        self.optimizer = optimizer
        self.seed = seed
        # Adam's accumulated (beta1^t, beta2^t) per feature group
        self._batch_state: Dict[int, Tuple[float, float]] = {}
        self.grad_misses = 0  # gradient rows whose sign was absent
        # the apply-journal: id -> payload crc32, in insertion order, the
        # oldest dropped past _journal_cap (the native core's ring)
        self._journal: Dict[int, int] = {}
        self._journal_cap = 1 << 16

    def register_optimizer(self, optimizer: OptimizerConfig) -> None:
        with self._lock:
            self.optimizer = optimizer
            self._batch_state.clear()

    def _state_dim(self, dim: int) -> int:
        return self.optimizer.state_dim(dim) if self.optimizer is not None else 0

    def _shard_indices(self, signs: np.ndarray) -> List[int]:
        h = splitmix64(signs ^ np.uint64(0xA5A5A5A5))
        return (h % np.uint64(self._num_shards)).astype(np.int64).tolist()

    def _admitted(self, signs: np.ndarray) -> np.ndarray:
        p = self.hyperparams.admit_probability
        if p >= 1.0:
            return np.ones(len(signs), dtype=bool)
        if p <= 0.0:
            return np.zeros(len(signs), dtype=bool)
        h = splitmix64(signs ^ np.uint64(0xC0FFEE))
        return (h % np.uint64(1 << 24)).astype(np.float64) / float(1 << 24) < p

    def lookup(self, signs: np.ndarray, dim: int, train: bool) -> np.ndarray:
        """Fetch ``(len(signs), dim)`` embedding rows."""
        signs = np.asarray(signs, dtype=np.uint64)
        with self._lock:
            return self._lookup_locked(signs, dim, train)

    def _lookup_locked(self, signs: np.ndarray, dim: int, train: bool) -> np.ndarray:
        out = np.zeros((len(signs), dim), dtype=np.float32)
        if not len(signs):
            return out
        shard_idx = self._shard_indices(signs)
        sign_list = signs.tolist()
        if not train:
            for i, (s, k) in enumerate(zip(sign_list, shard_idx)):
                entry = self._shards[k].entries.get(s)
                if entry is not None and entry[0] == dim:
                    out[i] = entry[1][:dim]
            return out

        entry_len = dim + self._state_dim(dim)
        admitted = self._admitted(signs)
        fresh: Dict[int, np.ndarray] = {}  # sign -> entry created by this call
        fresh_rows: List[Tuple[int, int]] = []  # (out row, sign) read from a fresh entry
        no_optimizer = self.optimizer is None
        for i, (s, k) in enumerate(zip(sign_list, shard_idx)):
            shard = self._shards[k]
            entry = shard.get_refresh(s)
            # a hit; another dim or entry width re-inits (with no optimizer
            # registered, a wider entry, one restored with its state, is kept)
            if entry is not None and entry[0] == dim and (
                len(entry[1]) == entry_len or (no_optimizer and len(entry[1]) >= dim)
            ):
                if s in fresh:
                    fresh_rows.append((i, s))
                else:
                    out[i] = entry[1][:dim]
                continue
            if entry is None and not admitted[i]:
                continue
            vec = np.empty(entry_len, dtype=np.float32)
            shard.insert(s, dim, vec)
            fresh[s] = vec
            fresh_rows.append((i, s))
        if fresh:
            new_signs = np.fromiter(fresh.keys(), dtype=np.uint64, count=len(fresh))
            rows = init_for_signs(
                new_signs, self.seed, dim, self.hyperparams.resolved_init_method()
            )
            state = self.optimizer.init_state(dim) if self.optimizer is not None else None
            for vec, row in zip(fresh.values(), rows):
                vec[:dim] = row
                if state is not None:
                    vec[dim:] = state
            for i, s in fresh_rows:
                out[i] = fresh[s][:dim]
        return out

    def lookup_batched(
        self, signs: np.ndarray, key_ofs: np.ndarray, dims: np.ndarray, train: bool
    ) -> np.ndarray:
        """Multi-slot lookup in one call: group g covers
        ``signs[key_ofs[g]:key_ofs[g+1]]`` with dim ``dims[g]``. Returns one
        flat f32 buffer, the groups' ``(count_g, dims[g])`` rows back to
        back. State effects are exactly sequential per-group ``lookup``
        calls."""
        key_ofs = np.asarray(key_ofs, dtype=np.int64)
        parts = [
            self.lookup(signs[key_ofs[g]:key_ofs[g + 1]], int(dims[g]), train).reshape(-1)
            for g in range(len(dims))
        ]
        return np.concatenate(parts) if parts else np.empty(0, np.float32)

    def advance_batch_state(self, group: int) -> None:
        """Advance Adam's beta powers of ``group`` once per gradient batch."""
        if self.optimizer is None:
            return
        with self._lock:
            prev = self._batch_state.get(group, self.optimizer.initial_batch_state())
            self._batch_state[group] = self.optimizer.advance_batch_state(prev)

    def update_gradients(self, signs: np.ndarray, grads: np.ndarray, group: int = 0) -> None:
        """Apply the registered optimizer to each sign's entry in turn, then
        clamp the embedding to ±weight_bound. Absent signs (evicted, never
        admitted, or of another width) are skipped and counted."""
        if self.optimizer is None:
            raise RuntimeError("no optimizer registered")
        if grads.shape[0] != len(signs):
            raise ValueError("signs/grads length mismatch")
        signs = np.asarray(signs, dtype=np.uint64)
        with self._lock:
            self._update_locked(signs, grads, group)

    def _update_locked(self, signs: np.ndarray, grads: np.ndarray, group: int) -> None:
        if not len(signs):
            return
        opt = self.optimizer
        dim = grads.shape[1]
        entry_len = dim + self._state_dim(dim)
        # a group never advanced takes the first batch's powers
        batch_state = self._batch_state.get(
            group, opt.advance_batch_state(opt.initial_batch_state())
        )
        bound = self.hyperparams.weight_bound
        misses = 0
        for i, (s, k) in enumerate(zip(signs.tolist(), self._shard_indices(signs))):
            entry = self._shards[k].get_refresh(s)
            if entry is None or entry[0] != dim or len(entry[1]) != entry_len:
                misses += 1
                continue
            vec = entry[1]
            opt.update_dense(vec[:dim], vec[dim:], grads[i], batch_state)
            if bound > 0:
                np.clip(vec[:dim], -bound, bound, out=vec[:dim])
        self.grad_misses += misses

    def update_batched(
        self, signs: np.ndarray, key_ofs: np.ndarray, dims: np.ndarray,
        grads: np.ndarray, opt_groups: np.ndarray,
    ) -> None:
        """Multi-slot gradient update in one call; ``grads`` is flat in
        ``lookup_batched``'s layout. Exactly sequential per-group
        ``update_gradients`` calls."""
        key_ofs = np.asarray(key_ofs, dtype=np.int64)
        grads = np.asarray(grads, dtype=np.float32).reshape(-1)
        off = 0
        for g in range(len(dims)):
            d = int(dims[g])
            ks = signs[key_ofs[g]:key_ofs[g + 1]]
            size = len(ks) * d
            self.update_gradients(ks, grads[off:off + size].reshape(len(ks), d), int(opt_groups[g]))
            off += size

    # ---------------------------------------------- the cache tier's entries

    def _check_optimizer(self) -> None:
        # a store that lost its optimizer must not hand the cache tier
        # entries without their state (the width would be wrong)
        if self.optimizer is None:
            raise RuntimeError("no optimizer registered")

    def checkout_entries(self, signs: np.ndarray, dim: int) -> np.ndarray:
        """``(n, dim + state_dim)`` whole entries ``[emb | optimizer
        state]``, LRU-touched. A miss is admitted whatever the admit gate
        (the cache tier owns admission) with ``lookup``'s seeded init; an
        entry of another width re-inits."""
        self._check_optimizer()
        signs = np.asarray(signs, dtype=np.uint64)
        entry_len = dim + self._state_dim(dim)
        out = np.empty((len(signs), entry_len), dtype=np.float32)
        with self._lock:
            for i, (s, k) in enumerate(zip(signs.tolist(), self._shard_indices(signs))):
                shard = self._shards[k]
                entry = shard.get_refresh(s)
                if entry is not None and entry[0] == dim and len(entry[1]) == entry_len:
                    out[i] = entry[1]
                    continue
                vec = np.empty(entry_len, dtype=np.float32)
                vec[:dim] = init_for_signs(np.array([s], dtype=np.uint64), self.seed, dim,
                                           self.hyperparams.resolved_init_method())[0]
                vec[dim:] = self.optimizer.init_state(dim)
                shard.insert(s, dim, vec)
                out[i] = vec
        return out

    def probe_entries(self, signs: np.ndarray, dim: int) -> Tuple[np.ndarray, np.ndarray]:
        """The cache tier's warm/cold split: ``(warm (n,) bool, vals (n, dim
        + state_dim))``. A sign present at this width is warm: its whole
        entry, LRU-touched; any other is cold (zeros) and is not admitted,
        the cache owning it until its write-back."""
        self._check_optimizer()
        signs = np.asarray(signs, dtype=np.uint64)
        entry_len = dim + self._state_dim(dim)
        warm = np.zeros(len(signs), dtype=bool)
        vals = np.zeros((len(signs), entry_len), dtype=np.float32)
        with self._lock:
            for i, (s, k) in enumerate(zip(signs.tolist(), self._shard_indices(signs))):
                entry = self._shards[k].get_refresh(s)
                if entry is not None and entry[0] == dim and len(entry[1]) == entry_len:
                    warm[i] = True
                    vals[i] = entry[1]
        return warm, vals

    def set_embedding(self, signs: np.ndarray, values: np.ndarray, dim: Optional[int] = None) -> None:
        """Insert or overwrite whole entries ``[emb | state]`` (``values`` is
        (n, entry width)), each the most recently used; ``dim`` is the
        embedding width (default: all)."""
        signs = np.asarray(signs, dtype=np.uint64)
        values = np.asarray(values, dtype=np.float32)
        dim = values.shape[1] if dim is None else dim
        with self._lock:
            for i, (s, k) in enumerate(zip(signs.tolist(), self._shard_indices(signs))):
                self._shards[k].insert(s, dim, values[i].copy())

    def get_entry_dim(self, sign: int) -> Optional[int]:
        """The embedding width of the sign's entry (no LRU touch), or None."""
        sign = int(sign)
        with self._lock:
            k = self._shard_indices(np.array([sign], dtype=np.uint64))[0]
            e = self._shards[k].entries.get(sign)
            return None if e is None else e[0]

    def get_embedding_entry(self, sign: int) -> Optional[np.ndarray]:
        """The sign's whole entry ``[emb | optimizer state]`` (no LRU touch),
        or None."""
        sign = int(sign)
        with self._lock:
            k = self._shard_indices(np.array([sign], dtype=np.uint64))[0]
            e = self._shards[k].entries.get(sign)
            return None if e is None else e[1]

    def size(self) -> int:
        with self._lock:
            return sum(len(s) for s in self._shards)

    def clear(self) -> None:
        """Drop every entry and Adam's batch powers (not the journal)."""
        with self._lock:
            for shard in self._shards:
                shard.entries.clear()
            self._batch_state.clear()

    @property
    def num_internal_shards(self) -> int:
        return self._num_shards

    # ------------------------------------------------------------ checkpoint

    def dump_shard(self, shard_idx: int) -> bytes:
        """One internal shard in the checkpoint wire format, from the least
        to the most recently used entry."""
        if not 0 <= shard_idx < self._num_shards:
            raise IndexError(f"shard {shard_idx} out of range")
        with self._lock:  # a snapshot; serialised outside the lock
            items = list(self._shards[shard_idx].entries.items())
        parts = [_COUNT.pack(len(items))]
        for sign, (dim, vec) in items:
            parts.append(_ENTRY_HEAD.pack(sign, dim, len(vec)))
            parts.append(vec.tobytes())
        return b"".join(parts)

    def load_shard_bytes(self, raw: bytes) -> int:
        """Load a dump's entries, each routed by its sign and inserted as
        the most recently used (a dump of any shard layout loads); returns
        the entries loaded. Raises ``ValueError`` on a payload shorter than
        its counts say."""
        raw = memoryview(raw)
        if len(raw) < 4:
            raise ValueError("corrupt shard payload")
        (n,) = _COUNT.unpack_from(raw, 0)
        off = 4
        with self._lock:
            for _ in range(n):
                if len(raw) - off < 16:
                    raise ValueError("corrupt shard payload")
                sign, dim, ln = _ENTRY_HEAD.unpack_from(raw, off)
                off += 16
                if len(raw) - off < 4 * ln:
                    raise ValueError("corrupt shard payload")
                vec = np.frombuffer(raw, dtype=np.float32, count=ln, offset=off).copy()
                off += 4 * ln
                k = self._shard_indices(np.array([sign], dtype=np.uint64))[0]
                self._shards[k].insert(sign, dim, vec)
        return n

    # --------------------------------------------------------- apply-journal

    def journal_record(self, journal_id: int, crc: int) -> None:
        with self._lock:
            if journal_id not in self._journal and len(self._journal) >= self._journal_cap:
                del self._journal[next(iter(self._journal))]
            self._journal[journal_id] = crc & 0xFFFFFFFF

    def journal_probe(self, journal_id: int, crc: int) -> int:
        """1: already applied (the crc matches); 0: unknown; -1: the id
        was recorded with another payload crc."""
        with self._lock:
            rec = self._journal.get(journal_id)
        if rec is None:
            return 0
        return 1 if rec == (crc & 0xFFFFFFFF) else -1

    def journal_len(self) -> int:
        with self._lock:
            return len(self._journal)

    def journal_clear(self) -> None:
        """Forget every id: a rewind to a fence (clear + shard load) must,
        so the batches past the fence apply again."""
        with self._lock:
            self._journal.clear()

    def update_batched_journaled(
        self, journal_id: int, crc: int, signs, key_ofs, dims, grads, opt_groups,
    ) -> bool:
        """``update_batched`` once per journal id: a batch whose id is
        recorded (the crashed run applied it past the last fence) is
        skipped and False returned; otherwise it is applied, its id
        recorded and True returned. An id recorded with another payload
        crc (a journal-only resume recomputed the window against entries
        already past the fence) is skipped too, and logged: the first
        application stands. Probe, apply and record are not one atomic
        step against a PS crash, but a PS crash loses the store and
        recovers by a rewind, which clears the journal with the data."""
        st = self.journal_probe(journal_id, crc)
        if st == -1:
            logger.warning("apply-journal id %#x replayed with another payload crc; "
                           "the first application stands", journal_id)
        if st != 0:
            return False
        self.update_batched(signs, key_ofs, dims, grads, opt_groups)
        self.journal_record(journal_id, crc)
        return True
