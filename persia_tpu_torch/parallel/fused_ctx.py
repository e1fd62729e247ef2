"""A ``TrainCtx``-shaped context over the fused all-on-card tier
(counterpart of ``persia_tpu/parallel/fused_ctx.py``): ``train_step``,
``train_pipelined``, ``eval_batch`` and a whole-state checkpoint, over
``parallel/fused_step.py``.

The checkpoint is the reference's two files, ``fused_state.npz`` (every
leaf, ``a0 … an``) and ``fused_state.json`` (their
``jax.tree_util.keystr`` paths, in the reference's order), so each package
reads the other's: ``persia_tpu_torch.weights`` carries the layout.
"""

from __future__ import annotations

import io
import json
import logging
import os
from typing import Dict, Optional

import numpy as np
import torch

from persia_tpu_torch.data import PersiaBatch
from persia_tpu_torch.device import resolve_device
from persia_tpu_torch.jobstate import fsync_write_bytes
from persia_tpu_torch.parallel.fused_step import (
    FusedSlotSpec,
    FusedTrainState,
    build_fused_eval_step,
    build_fused_pipeline,
    build_fused_train_step,
    fused_batch_to_device,
    init_fused_state,
)
from persia_tpu_torch.parallel.train_step import _note_nonfinite_loss
from persia_tpu_torch.weights import fused_state_from_flax, fused_state_manifest, fused_state_to_flax

logger = logging.getLogger("persia_tpu_torch.fused_ctx")


def batch_to_fused(batch: PersiaBatch, specs: Optional[Dict[str, FusedSlotSpec]] = None,
                   fold_ids: bool = False) -> Dict:
    """``PersiaBatch`` → the fused step's batch of host arrays.

    A slot whose every sample carries exactly one id becomes (B,) int32;
    any other becomes (B, Lmax) int32 padded with -1, Lmax the batch's own
    longest list. With ``specs``, every id is range-checked against its
    slot's vocab before the int32 cast (an id >= 2^31 would wrap negative
    into the pad sentinel, one in [vocab, 2^31) would read the clamped last
    row): out-of-range ids raise, or with ``fold_ids`` fold by modulo."""
    def _ranged(name: str, flat: np.ndarray) -> np.ndarray:
        if specs is None or not len(flat):
            return flat
        vocab = np.uint64(specs[name].vocab)
        if fold_ids:
            return flat % vocab
        bad = flat >= vocab
        if bad.any():
            raise ValueError(
                f"slot {name!r}: {int(bad.sum())} id(s) outside [0, {int(vocab)}) (max {int(flat.max())}); "
                f"hash-sign ids must be folded first — pass fold_ids=True or fold upstream"
            )
        return flat

    ids = {}
    for f in batch.id_type_features:
        flat, counts = f.flat_counts()
        flat = _ranged(f.name, np.asarray(flat, dtype=np.uint64))
        if len(counts) and (counts == 1).all():  # one id per sample
            ids[f.name] = flat.astype(np.int32)
        else:
            b = len(counts)
            lmax = max(int(counts.max()), 1) if b else 1
            padded = np.full((b, lmax), -1, dtype=np.int32)
            off = 0
            for i, c in enumerate(counts):
                padded[i, :c] = flat[off:off + c]
                off += c
            ids[f.name] = padded
    out = {"dense": [np.asarray(d.data, np.float32) for d in batch.non_id_type_features], "ids": ids}
    if batch.labels:
        out["labels"] = [np.asarray(lb.data, np.float32) for lb in batch.labels]
    return out


class FusedTrainCtx:
    """All-on-card training context: the bench's fused tier as an API.

    The tables are made at the first batch, seeded from ``seed``.
    ``train_step`` reads the loss back (one device→host copy a step);
    throughput loops use ``fetch_metrics=False`` or the raw
    ``build_fused_train_step``. ``dense_optimizer`` is a
    ``torch.optim.Adam`` over ``model``'s parameters (made ``capturable``
    on a card); ``device`` is ``cuda`` unless given."""

    def __init__(
        self,
        model: torch.nn.Module,
        dense_optimizer: torch.optim.Optimizer,
        embedding_optimizer,
        specs: Dict[str, FusedSlotSpec],
        loss_fn=None,
        stack: bool = True,
        table_dtype=torch.float32,
        seed: int = 0,
        fold_ids: bool = False,
        device=None,
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.dense_optimizer = dense_optimizer
        self.sparse_cfg = embedding_optimizer.config
        self.specs = dict(specs)
        self.slot_order = sorted(self.specs)
        self.stack = stack
        self.table_dtype = table_dtype
        self.seed = seed
        self.fold_ids = fold_ids
        self._loss_kw = {} if loss_fn is None else {"loss_fn": loss_fn}
        self._pipelines: Dict = {}
        self._pipe_stats: Optional[Dict] = None
        self._last = None
        self._step = build_fused_train_step(self.sparse_cfg, self.specs, self.slot_order, stack=stack,
                                            **self._loss_kw)
        self._eval = build_fused_eval_step(self.specs, self.slot_order, stack=stack)
        self.state: Optional[FusedTrainState] = None

    def __enter__(self) -> "FusedTrainCtx":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def _ensure_state(self) -> None:
        if self.state is None:
            self.state = init_fused_state(
                self.model, self.dense_optimizer, torch.Generator().manual_seed(self.seed), self.specs,
                self.sparse_cfg, slot_order=self.slot_order, stack=self.stack,
                table_dtype=self.table_dtype, device=self.device,
            )

    def _to_device(self, batch: PersiaBatch) -> Dict:
        return fused_batch_to_device(batch_to_fused(batch, self.specs, self.fold_ids), self.device)

    def train_step(self, batch: PersiaBatch, fetch_metrics: bool = True) -> Dict:
        fb = self._to_device(batch)
        self._ensure_state()
        self.state, (loss, preds) = self._step(self.state, fb)
        self._last = (loss, preds)
        if not fetch_metrics:
            return {}
        return {"loss": _note_nonfinite_loss(float(loss)), "preds": preds.cpu().numpy()}

    def train_pipelined(self, batches, pipeline_depth: int = 2, dispatch_k: int = 1,
                        fetch_metrics: bool = True) -> Dict:
        """Train on a ``PersiaBatch`` iterable through a ``FusedPipeline``:
        conversion and host→device staging (FEED, on the feed thread and
        its stream) overlap the step (DENSE), ``pipeline_depth`` batches in
        flight at most, ``dispatch_k`` steps a dense stage. With
        ``dispatch_k=1`` the result is the ``train_step`` loop's bit for
        bit. The pipeline drains before this returns, so a checkpoint right
        after is a fence; its stats are in ``pipeline_stats``. Pipelines
        are kept per ``(pipeline_depth, dispatch_k)``."""
        it = iter(batches)
        try:
            first = next(it)
        except StopIteration:
            return {}
        fb0 = batch_to_fused(first, self.specs, self.fold_ids)
        self._ensure_state()
        key = (int(pipeline_depth), int(dispatch_k))
        pipe = self._pipelines.get(key)
        if pipe is None:
            pipe = build_fused_pipeline(self.sparse_cfg, self.specs, self.slot_order, stack=self.stack,
                                        depth=pipeline_depth, k=dispatch_k, device=self.device,
                                        **self._loss_kw)
            self._pipelines[key] = pipe

        def fused_stream():  # consumed by the feed thread: conversion rides the feed lane
            yield fb0
            for b in it:
                yield batch_to_fused(b, self.specs, self.fold_ids)

        self.state, losses = pipe.run(self.state, fused_stream())
        self._pipe_stats = pipe.stats()
        self._last = None
        if not fetch_metrics or not losses:
            return {}
        host = torch.stack(losses).cpu().numpy()
        return {"loss": _note_nonfinite_loss(float(host[-1])), "losses": host}

    def pipeline_stats(self) -> Optional[Dict]:
        """Stage and overlap stats of the last ``train_pipelined`` run."""
        return self._pipe_stats

    @property
    def sync_mode(self) -> str:
        """Dense-plane sync label: one device, one step, no collective."""
        return "local"

    def dense_wire_bytes_per_step(self) -> int:
        """Dense collective bytes a step: none, the step is on one device."""
        return 0

    def last_metrics(self) -> Optional[Dict]:
        if self._last is None:
            return None
        loss, preds = self._last
        return {"loss": _note_nonfinite_loss(float(loss)), "preds": preds.cpu().numpy()}

    def eval_batch(self, batch: PersiaBatch) -> np.ndarray:
        fb = self._to_device(batch)
        self._ensure_state()
        return self._eval(self.state, fb).cpu().numpy()

    # checkpoint: one .npz of every state leaf by its reference path + the
    # JSON list of the paths

    def dump_checkpoint(self, path: str) -> None:
        assert self.state is not None, "no state to dump (train first)"
        manifest, arrays = fused_state_to_flax(self.state)
        os.makedirs(path, exist_ok=True)
        buf = io.BytesIO()
        np.savez(buf, **{f"a{i}": a for i, a in enumerate(arrays)})
        # atomic and fsync'd: a crash mid-dump never leaves a torn archive
        fsync_write_bytes(os.path.join(path, "fused_state.npz"), buf.getvalue())
        fsync_write_bytes(os.path.join(path, "fused_state.json"), json.dumps(manifest).encode())
        logger.info("fused checkpoint written to %s (%d leaves)", path, len(manifest))

    def load_checkpoint(self, path: str) -> None:
        """Load a checkpoint of either package into the state, in place
        (a captured step graph stays valid)."""
        assert self.state is not None, (
            "load_checkpoint needs an initialized state — run one train_step/eval_batch first"
        )
        with open(os.path.join(path, "fused_state.json")) as f:
            manifest = json.load(f)
        if fused_state_manifest(self.state) != manifest:
            raise ValueError("checkpoint layout mismatch: model/spec/optimizer changed since the dump")
        data = np.load(os.path.join(path, "fused_state.npz"))
        fused_state_from_flax(manifest, [data[f"a{i}"] for i in range(len(manifest))],
                              self.model, self.dense_optimizer, self.device, into=self.state)
