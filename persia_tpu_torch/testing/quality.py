"""The quality gate through the port (counterpart of ``bench.py``'s
``bench_quality``): three tiers train on the identical learnable epoch and
are scored by held-out AUC; the gate fails when their AUCs spread by 0.02
or more, so a throughput gain that costs accuracy (admission gating, wire
quantization, bounded staleness) shows.

The stream: ``CriteoSynthetic(num_samples=(steps + 4) * 4096, vocab [1M]
x 26, seed=5, task_seed=7)``, the last 4 batches held out. The tiers, at
``bench.py``'s configuration (one builder, ``tier_ctx``, which the chip
check shares):

- ``cached``: DLRM bottom (256, 64, 16), top (512, 256), Adam(1e-3),
  Adagrad(0.05), one store of 2^25 rows and 64 shards (seed 1) behind a
  device-pooling worker, 2^21 cache rows, bf16 write-back and aux wires,
  ``admit_touches=2``; ``train_stream(fetch_final=False)``, the first 2
  batches untimed;
- ``ps-stream``: every slot on the PS tier with the int8 gradient wire
  (K15), ``train_stream(prefetch=4, psgrad_batch=16, fetch_final=False)``,
  the first 2 batches untimed;
- ``fused``: 26 stacked 1M x 16 tables on the card, the CUDA-graph step;
  the first batch trains untimed (the graph's capture; the bench re-inits
  after a compile step instead).

Each tier reports samples/s and AUC. The dense weights (and the fused
tables) are drawn by torch from seed 0, the same for every tier. The reference's pinned AUCs were
taken on another platform and are not used here.
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from persia_tpu_torch.testing.datasets import CRITEO_NUM_DENSE, CriteoSynthetic
from persia_tpu_torch.testing.synthetic import roc_auc

BATCH, N_SLOTS, EMB_DIM, VOCAB = 4096, 26, 16, 1_000_000
BOTTOM, TOP = (256, 64, EMB_DIM), (512, 256)
STORE_ROWS, STORE_SHARDS, CACHE_ROWS = 1 << 25, 64, 1 << 21
STEPS, EVAL_BATCHES, UNTIMED = 200, 4, 2
SPREAD_LIMIT = 0.02
SLOTS = tuple(f"cat_{i}" for i in range(N_SLOTS))
STREAM_KNOBS = dict(fetch_final=False)
PS_STREAM_KNOBS = dict(prefetch=4, psgrad_batch=16, fetch_final=False)
TIERS = ("cached", "ps-stream", "fused")


def bench_cfg():
    """26 single-id slots ``cat_i`` of dim 16, prefix bit 8."""
    from persia_tpu_torch.config import EmbeddingConfig, SlotConfig

    return EmbeddingConfig(slots_config={n: SlotConfig(dim=EMB_DIM) for n in SLOTS}, feature_index_prefix_bit=8)


def bench_model(state_dict=None):
    """DLRM at bench width on the CPU, from seed 0 or ``state_dict``."""
    from persia_tpu_torch.models import DLRM

    model = DLRM(CRITEO_NUM_DENSE, N_SLOTS, EMB_DIM, BOTTOM, TOP, device="cpu",
                 generator=torch.Generator().manual_seed(0))
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return model


def bench_store(backend: str = "auto", sparse: str = "adagrad", capacity: int = STORE_ROWS):
    """The bench's store: ``capacity`` rows, 64 shards, seed 1, Adagrad(0.05)
    (or SGD(0.05))."""
    from persia_tpu_torch.embedding.native_store import create_store

    return create_store(backend, capacity=capacity, num_internal_shards=STORE_SHARDS,
                        optimizer=_sparse_opt(sparse).config, seed=1)


def _sparse_opt(sparse: str):
    from persia_tpu_torch.embedding.optim import SGD, Adagrad

    return Adagrad(lr=0.05) if sparse == "adagrad" else SGD(lr=0.05)


def tier_ctx(device=None, store=None, ps_slots: Sequence[str] = (), ps_wire: str = "int8",
             cache_rows: int = CACHE_ROWS, wires: str = "bfloat16", admit_touches: int = 2,
             sparse: str = "adagrad", model=None, **options):
    """``bench.py``'s cached/ps-tier ctx (``_cached_tier_ctx``), entered and
    its state initialised: ``model`` (``bench_model()`` unless given),
    Adam(1e-3), Adagrad(0.05) (or SGD), a device-pooling worker over
    ``store`` (``bench_store()`` unless given), ``ps_slots`` on the PS tier
    with the ``ps_wire`` gradient wire; while any slot is cached, the
    ``wires`` write-back and aux wires and the touch gate. All slots on the
    PS leave ``cache_rows`` unused (the bench passes 8). ``options`` go to
    ``CachedTrainCtx`` as they are (``table_dtype``, the loss scale's)."""
    from persia_tpu_torch.embedding.hbm_cache import CachedTrainCtx
    from persia_tpu_torch.embedding.worker import EmbeddingWorker

    cfg = bench_cfg()
    model = model if model is not None else bench_model()
    store = store if store is not None else bench_store(sparse=sparse)
    cached = dict(wb_wire_dtype=wires, aux_wire_dtype=wires, admit_touches=admit_touches) \
        if len(set(ps_slots)) < N_SLOTS else {}
    ctx = CachedTrainCtx(model, torch.optim.Adam(model.parameters(), lr=1e-3), _sparse_opt(sparse),
                         EmbeddingWorker(cfg, [store], device_pooling=True), cfg, cache_rows=cache_rows,
                         device=device, ps_slots=tuple(ps_slots), ps_wire_dtype=ps_wire, **cached,
                         **options).__enter__()
    ctx.init_state()
    return ctx


def quality_data(steps: int = STEPS, batch_size: int = BATCH, vocab: int = VOCAB,
                 eval_batches: int = EVAL_BATCHES) -> Tuple[List, List]:
    """(train, held-out) batches of the shared learnable stream."""
    ds = CriteoSynthetic(num_samples=(steps + eval_batches) * batch_size, vocab_sizes=[vocab] * N_SLOTS,
                         seed=5, task_seed=7)
    batches = list(ds.batches(batch_size))
    return batches[:steps], batches[steps:]


def _auc(preds: Sequence[np.ndarray], eval_b) -> float:
    labels = [np.asarray(b.labels[0].data).reshape(-1) for b in eval_b]
    return float(roc_auc(np.concatenate(labels), np.concatenate([np.asarray(p).reshape(-1) for p in preds])))


def run_stream_tier(ctx, train_b, eval_b, ps_all: bool = False) -> Dict:
    """The cached or ps-stream tier on ``ctx``: the first ``UNTIMED`` batches
    streamed untimed, the rest timed, then the held-out AUC."""
    knobs = PS_STREAM_KNOBS if ps_all else STREAM_KNOBS
    ctx.train_stream(train_b[:UNTIMED], **knobs)
    t0 = time.perf_counter()
    ctx.train_stream(train_b[UNTIMED:], **knobs)
    if ctx.device.type == "cuda":
        ctx.last_metrics()  # the last step's header: the stream's work is done
    elapsed = time.perf_counter() - t0
    preds = [ctx.eval_batch(b) for b in eval_b]
    return {"samples_per_sec": (len(train_b) - UNTIMED) * len(train_b[0].labels[0].data) / elapsed,
            "auc": _auc(preds, eval_b), "timed_steps": len(train_b) - UNTIMED}


def fused_batch(batch) -> Dict:
    """A single-id ``PersiaBatch`` as the fused step's host batch."""
    ids = {}
    for f in batch.id_type_features:
        flat, counts = f.flat_counts()
        if len(flat) != len(counts):
            raise ValueError("the quality stream is single-id")
        ids[f.name] = flat.astype(np.int32)
    out = {"dense": [np.asarray(batch.non_id_type_features[0].data, np.float32)], "ids": ids}
    if batch.labels:
        out["labels"] = [np.asarray(batch.labels[0].data, np.float32)]
    return out


def fused_specs(vocab: int = VOCAB):
    from persia_tpu_torch.parallel.fused_step import FusedSlotSpec

    return {n: FusedSlotSpec(vocab=vocab, dim=EMB_DIM) for n in SLOTS}


def fused_state(device=None, vocab: int = VOCAB):
    """The fused tier's state: ``N_SLOTS`` stacked tables of ``vocab`` x 16
    on ``device`` drawn from seed 0, their Adagrad(0.05) state, Adam(1e-3)
    over ``bench_model()``."""
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.parallel.fused_step import init_fused_state

    model = bench_model()
    return init_fused_state(model, torch.optim.Adam(model.parameters(), lr=1e-3), torch.Generator().manual_seed(0),
                            fused_specs(vocab), Adagrad(lr=0.05).config, stack=True, device=device)


def run_fused_tier(train_b, eval_b, state, vocab: int = VOCAB) -> Dict:
    """The fused tier from ``state`` (``fused_state(vocab=vocab)``) over the
    stream with the graph step: the first batch untimed (the graph's
    capture), the rest timed, then the held-out AUC."""
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.parallel.fused_step import (
        build_fused_eval_step, build_fused_train_step, fused_batch_to_device,
    )

    specs = fused_specs(vocab)
    step = build_fused_train_step(Adagrad(lr=0.05).config, specs, stack=True, jit=True)
    eval_step = build_fused_eval_step(specs, stack=True)
    dev = state.step.device
    fb = [fused_batch(b) for b in train_b]
    state, (loss, _) = step(state, fused_batch_to_device(fb[0], dev))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for h in fb[1:]:
        state, (loss, _) = step(state, fused_batch_to_device(h, dev))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t0
    preds = [eval_step(state, fused_batch_to_device(fused_batch(b), dev)).cpu().numpy() for b in eval_b]
    return {"samples_per_sec": (len(fb) - 1) * len(fb[0]["dense"][0]) / elapsed, "auc": _auc(preds, eval_b),
            "timed_steps": len(fb) - 1, "loss_last": float(loss)}


def spread(results: Dict[str, Dict]) -> float:
    aucs = [results[t]["auc"] for t in TIERS if t in results]
    return max(aucs) - min(aucs)


def run_tier(tier: str, train_b, eval_b, device=None, store=None) -> Dict:
    """One tier of the gate from a fresh state: the stream tiers over
    ``store`` (``bench_store()`` unless given)."""
    if tier == "fused":
        return run_fused_tier(train_b, eval_b, fused_state(device))
    if tier not in TIERS:
        raise ValueError(f"tier must be one of {TIERS}, got {tier!r}")
    ps_all = tier == "ps-stream"
    ctx = tier_ctx(device, store, ps_slots=SLOTS if ps_all else (), cache_rows=8 if ps_all else CACHE_ROWS,
                   model=bench_model())
    try:
        return run_stream_tier(ctx, train_b, eval_b, ps_all=ps_all)
    finally:
        ctx.__exit__(None, None, None)


def bench_quality(steps: int = STEPS, device=None) -> Dict:
    """The gate: every tier over ``quality_data(steps)``, a fresh store
    each; returns each tier's samples/s and AUC, ``auc_spread`` and
    ``steps``. Raises ``AssertionError`` when the spread is
    ``SPREAD_LIMIT`` or more."""
    if steps <= UNTIMED:
        raise ValueError(f"steps must be > {UNTIMED} (the first batches train untimed)")
    train_b, eval_b = quality_data(steps)
    out: Dict = {t: run_tier(t, train_b, eval_b, device) for t in TIERS}
    out["auc_spread"] = spread(out)
    out["steps"] = steps
    if not out["auc_spread"] < SPREAD_LIMIT:
        raise AssertionError(f"tier AUC spread {out['auc_spread']} is not under {SPREAD_LIMIT}: {out}")
    return out
