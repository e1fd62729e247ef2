"""User-facing contexts (counterpart of ``persia_tpu/ctx.py``), serving
subset: ``stage_embeddings`` and ``EmbeddingCtx.prepare_features`` turn the
worker's numpy outputs into tensors on the ctx's device, and ``InferCtx``
runs the lookup-direct forward."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from persia_tpu_torch.config import EmbeddingConfig
from persia_tpu_torch.data import PersiaBatch
from persia_tpu_torch.device import resolve_device
from persia_tpu_torch.embedding.worker import (
    DevicePooledBatch,
    EmbeddingWorker,
    FeatureEmbeddingBatch,
    SumEmbeddingBatch,
)
from persia_tpu_torch.parallel.train_step import build_eval_step
from persia_tpu_torch.utils import round_up_pow2


def _pad_bucket(n: int) -> int:
    """Padded-distinct bucket: pow2 below 512, then 512-quantum (the
    reference's bucketing, kept so both packages stage the same shapes)."""
    if n <= 512:
        return round_up_pow2(n)
    return -(-n // 512) * 512


def stage_embeddings(
    emb_batches: Sequence[FeatureEmbeddingBatch],
) -> Tuple[List[Dict], List[Optional[int]]]:
    """Convert worker outputs into the device batch's ``emb`` entries
    (numpy). Raw and device-pooled slots pad their distinct rows to a
    bucketed size, zero rows absorbing padded index entries; device-pooled
    slots share one bucket. Returns (entries, true distinct counts) — None
    for host-pooled slots."""
    entries: List[Dict] = []
    counts: List[Optional[int]] = []
    shared_p = 0
    for eb in emb_batches:
        if isinstance(eb, DevicePooledBatch):
            shared_p = max(shared_p, eb.distinct.shape[0] + 1)
    if shared_p:
        shared_p = _pad_bucket(shared_p)
    for eb in emb_batches:
        if isinstance(eb, SumEmbeddingBatch):
            entries.append({"pooled": eb.pooled})
            counts.append(None)
        elif isinstance(eb, DevicePooledBatch):
            d, dim = eb.distinct.shape
            padded = np.zeros((shared_p, dim), dtype=eb.distinct.dtype)
            padded[:d] = eb.distinct
            # uint16 indexes when the padded table allows: fewer bytes to the
            # device, widened there
            idx_dtype = np.uint16 if shared_p <= 0xFFFF else np.int32
            entry = {
                "distinct": padded,
                "pool_index": np.ascontiguousarray(eb.index, dtype=idx_dtype),
            }
            if eb.sqrt_scaling:
                entry["pool_counts"] = eb.counts.reshape(-1, 1).astype(np.int32)
            entries.append(entry)
            counts.append(d)
        else:
            d, dim = eb.distinct.shape
            p = round_up_pow2(d + 1)
            padded = np.zeros((p, dim), dtype=eb.distinct.dtype)
            padded[:d] = eb.distinct
            index = np.where(eb.index == d, p - 1, eb.index).astype(np.int32)
            mask = eb.index != d
            entries.append({"distinct": padded, "index": index, "mask": mask})
            counts.append(d)
    return entries, counts


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    if arr.dtype == np.uint16:
        # torch's uint16 has few kernels: ship the bits as int16, widen on
        # the device
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).to(device)
        return t.to(torch.int32) & 0xFFFF
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


class EmbeddingCtx:
    """Feature preparation: worker outputs → the device batch."""

    def __init__(self, worker: EmbeddingWorker, embedding_config: EmbeddingConfig, device=None):
        self.worker = worker
        self.embedding_config = embedding_config
        self.device = resolve_device(device)

    def prepare_features(
        self, batch: PersiaBatch, emb_batches: Sequence[FeatureEmbeddingBatch]
    ) -> Tuple[Dict, List[Optional[int]]]:
        """The device batch (tensors on ``self.device``) + true distinct
        counts per slot."""
        entries, counts = stage_embeddings(emb_batches)
        dev = self.device
        device_batch = {
            "dense": [_to_device(f.data.astype(np.float32), dev) for f in batch.non_id_type_features],
            "labels": [_to_device(l.data.astype(np.float32), dev) for l in batch.labels],
            "emb": [{k: _to_device(a, dev) for k, a in e.items()} for e in entries],
        }
        return device_batch, counts


class InferCtx(EmbeddingCtx):
    """Inference: lookup-direct, zeros-on-miss. The model carries its own
    parameters; it is moved to the ctx's device and put in eval mode."""

    def __init__(self, model: torch.nn.Module, worker, embedding_config, device=None):
        super().__init__(worker, embedding_config, device=device)
        self.model = model.to(self.device).eval()
        self._eval_step = build_eval_step(self.model)

    def predict(self, batch: PersiaBatch) -> np.ndarray:
        emb_batches = self.worker.forward_directly(batch, train=False)
        device_batch, _ = self.prepare_features(batch, emb_batches)
        return self._eval_step(device_batch).cpu().numpy()

    def predict_from_bytes(self, raw: bytes) -> np.ndarray:
        return self.predict(PersiaBatch.from_bytes(raw))
