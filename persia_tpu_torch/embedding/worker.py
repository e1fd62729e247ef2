"""Embedding-worker tier, lookup-direct subset (counterpart of
``persia_tpu/embedding/worker.py``): id preprocessing (prefix, dedup,
hash-stack), sharded lookup over parameter-server replicas, and the
pooling/layout postprocess that hands each slot to the device.

The numpy routines here are the ones the reference falls back to when its
native worker core is missing; they produce the same arrays bit for bit.
The gradient path comes with the training slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

import numpy as np

from persia_tpu_torch.config import EmbeddingConfig, SlotConfig
from persia_tpu_torch.data import IDTypeFeature, PersiaBatch
from persia_tpu_torch.embedding.hashing import add_index_prefix, hash_stack, sign_to_shard
from persia_tpu_torch.utils import round_up_pow2


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
    signs; hashstack expands each distinct sign into ``rounds`` table keys
    whose rows are summed."""
    flat, counts = feature.flat_counts()
    flat = add_index_prefix(flat.astype(np.uint64, copy=False), config.index_prefix, prefix_bit)
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


class ShardedLookup:
    """Routes table keys across parameter-server replicas by
    ``sign_to_shard`` and reassembles the replies. ``replicas`` are
    store-like objects exposing ``lookup_batched``."""

    def __init__(self, replicas: Sequence):
        if not replicas:
            raise ValueError("need at least one PS replica")
        self.replicas = list(replicas)

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
        shard = sign_to_shard(all_keys, n)
        for r in range(n):
            pos = np.flatnonzero(shard == r)
            if not len(pos):
                continue
            sub_ofs = np.searchsorted(pos, key_ofs).astype(np.int64)
            flat = self.replicas[r].lookup_batched(all_keys[pos], sub_ofs, dims, train)
            for g, rows in enumerate(_split_flat_rows(flat, sub_ofs, dims)):
                b, e = sub_ofs[g], sub_ofs[g + 1]
                if b < e:
                    outs[g][pos[b:e] - key_ofs[g]] = rows
        return outs


def _sum_hashstack_rounds(slot: ProcessedSlot, rows: np.ndarray) -> np.ndarray:
    if slot.rounds > 1:
        rows = rows.reshape(slot.num_distinct, slot.rounds, slot.config.dim).sum(axis=1)
    return rows


def _index_matrix(slot: ProcessedSlot, width: int) -> np.ndarray:
    """(B, width) int32: each sample's first ``width`` distinct positions,
    padded with D."""
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
        pooled = np.zeros((slot.batch_size, dim), dtype=np.float32)
        if len(slot.inverse):
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


class EmbeddingWorker:
    """The worker tier over in-process replicas: lookup-direct forward.

    ``device_pooling``: sum slots ship unpooled (``DevicePooledBatch``) and
    are pooled on the device.
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
