"""The Criteo DLRM example through the port (counterpart of
``examples/criteo_dlrm/train.py``): DLRM on the Criteo-shaped synthetic
stream at Kaggle or 1TB cardinalities, on one of three tiers, with the
example's configuration.

- ``hybrid``: two numpy ``EmbeddingStore`` replicas of 2^20 rows and 16
  shards (Adagrad(0.05), seeds 3 and 4) behind an ``EmbeddingWorker``,
  ``TrainCtx`` through the ``DataLoader`` (4 lookup threads, staleness 4;
  ``--deterministic``: 1 thread, staleness 1, in order);
- ``cached``: the same stores behind ``CachedTrainCtx`` with 2^18 cache
  rows, ``train_stream``, then ``publish()`` before eval;
- ``fused``: ``FusedTrainCtx(fold_ids=True)``, every slot's table on the
  card, each capped at ``--fused-vocab-cap`` rows (ids fold by modulo).

Every tier: DLRM bottom (64, 32, 16), top (256, 128), dim 16, Adam(1e-3)
on the dense half, Adagrad(0.05) on the embeddings. ``--scale 1tb``
hash-stacks every slot of more than 1M ids (2 rounds into a table a tenth
of its size); on the cached tier those slots ride the PS tier.

The dense weights and the fused tables are drawn by torch from seed 0
(the reference's come from ``jax.random.PRNGKey(0)``, which no torch
generator reproduces), so the tests give both packages the same weights.
One departure: the ``DataLoader``'s gradients are flushed before eval (the
reference evaluates while the last ones may still be in flight).

Run:  python -m persia_tpu_torch.testing.criteo_dlrm [--scale kaggle|1tb]
      [--tier hybrid|cached|fused] [--steps N] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from persia_tpu_torch.testing.datasets import CRITEO_1TB_VOCABS, CRITEO_KAGGLE_VOCABS, CRITEO_NUM_DENSE, CriteoSynthetic
from persia_tpu_torch.testing.synthetic import roc_auc

EMB_DIM = 16
BOTTOM, TOP = (64, 32, EMB_DIM), (256, 128)
HASHSTACK_ABOVE_1TB = 1_000_000
TIERS = ("hybrid", "cached", "fused")
SEED = 0  # the dense weights' and the fused tables' seed


def vocabs_of(scale: str) -> Sequence[int]:
    return CRITEO_KAGGLE_VOCABS if scale == "kaggle" else CRITEO_1TB_VOCABS


def embedding_config(vocabs: Sequence[int], hashstack_above: Optional[int] = None):
    """``cat_i`` of dim 16 each; a slot of more than ``hashstack_above`` ids
    hash-stacks: 2 rounds into ``max(v // 10, 1)`` rows."""
    from persia_tpu_torch.config import EmbeddingConfig, HashStackConfig, SlotConfig

    slots = {}
    for i, v in enumerate(vocabs):
        hs = HashStackConfig()
        if hashstack_above is not None and v > hashstack_above:
            hs = HashStackConfig(hash_stack_rounds=2, embedding_size=max(v // 10, 1))
        slots[f"cat_{i}"] = SlotConfig(dim=EMB_DIM, hash_stack_config=hs)
    return EmbeddingConfig(slots_config=slots, feature_index_prefix_bit=8)


def build_model(num_slots: int):
    """The example's DLRM on the CPU, its weights drawn from ``SEED``."""
    from persia_tpu_torch.models import DLRM

    return DLRM(CRITEO_NUM_DENSE, num_slots, EMB_DIM, BOTTOM, TOP, device="cpu",
                generator=torch.Generator().manual_seed(SEED))


def build_ctx(vocabs: Sequence[int], ps_replicas: int = 2, capacity: int = 1 << 20,
              hashstack_above: Optional[int] = None, tier: str = "hybrid", admit_touches: int = 1,
              wire: str = "float32", dynamic_loss_scale: bool = False, fused_vocab_cap: Optional[int] = None,
              device=None):
    """The example's ``build_ctx`` through the port, on ``device`` (``cuda``
    unless given): for the hybrid and cached tiers ``ps_replicas`` numpy
    stores of ``capacity`` rows, 16 shards, Adagrad(0.05), seeds 3, 4, ...
    Returns the ctx, not entered."""
    from persia_tpu_torch.embedding.optim import Adagrad

    if tier not in TIERS:
        raise ValueError(f"tier must be one of {TIERS}, got {tier!r}")
    model = build_model(len(vocabs))
    adam = torch.optim.Adam(model.parameters(), lr=1e-3)
    if tier == "fused":
        from persia_tpu_torch.parallel.fused_ctx import FusedTrainCtx
        from persia_tpu_torch.parallel.fused_step import FusedSlotSpec

        cap = fused_vocab_cap or max(vocabs)
        specs = {f"cat_{i}": FusedSlotSpec(vocab=int(min(v, cap)), dim=EMB_DIM) for i, v in enumerate(vocabs)}
        return FusedTrainCtx(model, adam, Adagrad(lr=0.05), specs, fold_ids=True, seed=SEED, device=device)
    from persia_tpu_torch.embedding.store import EmbeddingStore
    from persia_tpu_torch.embedding.worker import EmbeddingWorker

    cfg = embedding_config(vocabs, hashstack_above)
    stores = [EmbeddingStore(capacity=capacity, num_internal_shards=16, optimizer=Adagrad(lr=0.05).config, seed=3 + r)
              for r in range(ps_replicas)]
    worker = EmbeddingWorker(cfg, stores)
    if tier == "cached":
        from persia_tpu_torch.embedding.hbm_cache import CachedTrainCtx

        return CachedTrainCtx(model, adam, Adagrad(lr=0.05), worker, cfg, cache_rows=1 << 18,
                              admit_touches=admit_touches, aux_wire_dtype=wire, wb_wire_dtype=wire,
                              dynamic_loss_scale=dynamic_loss_scale, device=device)
    from persia_tpu_torch.ctx import TrainCtx

    return TrainCtx(model, adam, Adagrad(lr=0.05), worker, cfg, dynamic_loss_scale=dynamic_loss_scale,
                    device=device)


def datasets(scale: str, steps: int, eval_steps: int, batch_size: int) -> Tuple[CriteoSynthetic, CriteoSynthetic]:
    """(train, test) as the example makes them: seeds 42 and 4242."""
    vocabs = vocabs_of(scale)
    return (CriteoSynthetic(num_samples=steps * batch_size, vocab_sizes=vocabs, seed=42),
            CriteoSynthetic(num_samples=eval_steps * batch_size, vocab_sizes=vocabs, seed=4242))


def train(ctx, tier: str, batches, deterministic: bool = False) -> Tuple[List[float], float]:
    """The example's training loop on ``ctx`` (entered) over ``batches``
    (an iterable of ``PersiaBatch``): (losses, seconds)."""
    losses: List[float] = []

    def record(loss):
        losses.append(float(loss))

    if tier == "fused":
        batches = list(batches)
        t0 = time.perf_counter()
        for b in batches:
            record(ctx.train_step(b)["loss"])
        return losses, time.perf_counter() - t0
    if tier == "cached":
        batches = list(batches)
        t0 = time.perf_counter()
        ctx.train_stream(batches, on_metrics=lambda m: record(m["loss"]))
        return losses, time.perf_counter() - t0
    from persia_tpu_torch.data_loader import DataLoader

    loader = DataLoader(batches, ctx, num_workers=1 if deterministic else 4, staleness=1 if deterministic else 4,
                        reproducible=deterministic)
    try:
        t0 = time.perf_counter()
        for tb in loader:
            record(ctx.train_step_prepared(tb, loader)["loss"])
        loader.flush()
        return losses, time.perf_counter() - t0
    finally:
        loader.shutdown()


def predict(ctx, batches) -> Tuple[np.ndarray, np.ndarray]:
    """(predictions, labels), each (N, 1), over held-out ``batches``."""
    preds, labels = [], []
    for b in batches:
        preds.append(np.asarray(ctx.eval_batch(b)).reshape(-1, 1))
        labels.append(np.asarray(b.labels[0].data).reshape(-1, 1))
    return np.concatenate(preds), np.concatenate(labels)


class _FileStream:
    def __init__(self, batches, requires_grad):
        self._batches = batches
        self._rg = requires_grad

    def batches(self, batch_size, requires_grad=True):
        for b in self._batches:
            b.requires_grad = self._rg and requires_grad
            yield b


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="DLRM on Criteo-shaped data through the PyTorch port")
    ap.add_argument("--scale", choices=("kaggle", "1tb"), default="kaggle")
    ap.add_argument("--batch-size", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=64, help="train batches")
    ap.add_argument("--eval-steps", type=int, default=8)
    ap.add_argument("--ps-replicas", type=int, default=2)
    ap.add_argument(
        "--tier", choices=TIERS, default="hybrid",
        help="hybrid = host-PS lookups per step; cached = the card's write-back cache with on-card sparse "
        "updates (capacity tier); fused = all tables on the card, one step program (in-memory ceiling)",
    )
    ap.add_argument("--admit-touches", type=int, default=1,
                    help="cached tier: admit a sign on its Nth distinct-batch touch (1 = always)")
    ap.add_argument("--wire", choices=("float32", "bfloat16"), default="float32",
                    help="cached tier: checkout/eviction wire dtype")
    ap.add_argument("--dynamic-loss-scale", action="store_true",
                    help="overflow skip + scale backoff/growth (hybrid and cached tiers)")
    ap.add_argument("--fused-vocab-cap", type=int, default=None,
                    help="fused tier: cap each table at N rows (ids fold by modulo)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--deterministic", action="store_true",
                    help="reproducible mode: ordered batches, staleness=1")
    ap.add_argument("--data-path", default=None,
                    help="train on a Criteo TSV (.tsv/.tsv.gz/.parquet; persia_tpu_torch.datasets.CriteoTSV) "
                    "instead of the synthetic stream; the last --eval-steps batches are held out")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    vocabs = vocabs_of(args.scale)
    hashstack_above = None if args.scale == "kaggle" else HASHSTACK_ABOVE_1TB
    if args.data_path:
        from persia_tpu_torch.datasets import CriteoTSV

        file_batches = list(CriteoTSV(args.data_path).batches(
            batch_size=args.batch_size, limit_batches=args.steps + args.eval_steps))
        if len(file_batches) <= args.eval_steps:
            raise SystemExit(f"{args.data_path} yields only {len(file_batches)} batches at "
                             f"batch_size={args.batch_size}; need > {args.eval_steps}")
        args.steps = len(file_batches) - args.eval_steps
        train_set = _FileStream(file_batches[:args.steps], True)
        test_set = _FileStream(file_batches[args.steps:], False)
    else:
        train_set, test_set = datasets(args.scale, args.steps, args.eval_steps, args.batch_size)

    ctx = build_ctx(vocabs, ps_replicas=args.ps_replicas, hashstack_above=hashstack_above, tier=args.tier,
                    admit_touches=args.admit_touches, wire=args.wire, dynamic_loss_scale=args.dynamic_loss_scale,
                    fused_vocab_cap=args.fused_vocab_cap, device=args.device)
    with ctx:
        losses, dt = train(ctx, args.tier, train_set.batches(batch_size=args.batch_size), args.deterministic)
        if args.tier == "cached":
            published = ctx.publish()  # serving freshness before eval
            print(f"published {published} resident rows to the PS", flush=True)
        sps = args.steps * args.batch_size / dt
        preds, labels = predict(ctx, test_set.batches(batch_size=args.batch_size, requires_grad=False))
        auc = roc_auc(labels, preds)
        print(f"criteo-dlrm[{args.scale}] steps={args.steps} loss={np.mean(losses):.4f} test_auc={auc:.6f} "
              f"throughput={sps:,.0f} samples/sec", flush=True)
        if args.ckpt_dir:
            ctx.dump_checkpoint(args.ckpt_dir)
            print(f"checkpoint written to {args.ckpt_dir}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
