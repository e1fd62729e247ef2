"""The Avazu example through the port (counterpart of
``examples/avazu/train.py``): DeepFM or DCN-v2 on the Avazu-shaped
synthetic stream (21 categorical fields of dim 16 and the cyclical hour
features), on one of two tiers, with the example's configuration.

- ``hybrid``: ``ps_replicas`` numpy ``EmbeddingStore`` replicas of 2^20
  rows and 16 shards (Adagrad(0.05), seeds 11, 12, ...) behind an
  ``EmbeddingWorker``, ``TrainCtx`` through the ``DataLoader`` (4 lookup
  threads, staleness 4; ``--deterministic``: 1 thread, staleness 1, in
  order);
- ``fused``: ``FusedTrainCtx(fold_ids=True)``, the 21 field tables on the
  card at ``AVAZU_VOCABS``' sizes (9,449,205 rows in all), each capped at
  ``--fused-vocab-cap`` rows (ids fold by modulo), one step program.

Both: deep MLP (256, 128), DCN-v2 with 3 full-rank cross layers, Adam(1e-3)
on the dense half, Adagrad(0.05) on the embeddings. The dense weights and
the fused tables are drawn by torch from seed 0 (the reference's come from
``jax.random.PRNGKey(0)``, which no torch generator reproduces), so the
tests give both packages the same weights. One departure: the
``DataLoader``'s gradients are flushed before eval (the reference
evaluates while the last ones may still be in flight).

Run:  python -m persia_tpu_torch.testing.avazu [--model deepfm|dcnv2]
      [--tier hybrid|fused] [--steps N] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import numpy as np
import torch

from persia_tpu_torch.testing.criteo_dlrm import predict, train
from persia_tpu_torch.testing.datasets import AVAZU_VOCABS, AvazuSynthetic
from persia_tpu_torch.testing.synthetic import roc_auc

EMB_DIM = 16
DEEP = (256, 128)
DENSE_DIM = 2  # the cyclical hour features
MODELS = ("deepfm", "dcnv2")
TIERS = ("hybrid", "fused")
SEED = 0  # the dense weights' and the fused tables' seed


def build_model(model_name: str, num_fields: int) -> torch.nn.Module:
    """The example's DeepFM or DCN-v2 on the CPU, its weights drawn from
    ``SEED``."""
    from persia_tpu_torch.models import DCNv2, DeepFM

    gen = torch.Generator().manual_seed(SEED)
    if model_name == "deepfm":
        return DeepFM(DENSE_DIM, num_fields, EMB_DIM, DEEP, device="cpu", generator=gen)
    if model_name == "dcnv2":
        return DCNv2(DENSE_DIM, num_fields, EMB_DIM, 3, None, DEEP, device="cpu", generator=gen)
    raise ValueError(f"model must be one of {MODELS}, got {model_name!r}")


def fused_specs(num_fields: int, fused_vocab_cap: Optional[int] = None):
    """``field_i`` of ``AVAZU_VOCABS[i]`` rows (capped at
    ``fused_vocab_cap``), dim 16."""
    from persia_tpu_torch.parallel.fused_step import FusedSlotSpec

    vocabs = AVAZU_VOCABS[:num_fields]
    cap = fused_vocab_cap or max(vocabs)
    return {f"field_{i}": FusedSlotSpec(vocab=int(min(v, cap)), dim=EMB_DIM) for i, v in enumerate(vocabs)}


def build_ctx(model_name: str, num_fields: int, ps_replicas: int = 2, tier: str = "hybrid",
              fused_vocab_cap: Optional[int] = None, device=None):
    """The example's ``build_ctx`` through the port, on ``device`` (``cuda``
    unless given). Returns the ctx, not entered."""
    from persia_tpu_torch.embedding.optim import Adagrad

    if tier not in TIERS:
        raise ValueError(f"tier must be one of {TIERS}, got {tier!r}")
    model = build_model(model_name, num_fields)
    adam = torch.optim.Adam(model.parameters(), lr=1e-3)
    if tier == "fused":
        from persia_tpu_torch.parallel.fused_ctx import FusedTrainCtx

        return FusedTrainCtx(model, adam, Adagrad(lr=0.05), fused_specs(num_fields, fused_vocab_cap),
                             fold_ids=True, seed=SEED, device=device)
    from persia_tpu_torch.config import EmbeddingConfig, SlotConfig
    from persia_tpu_torch.ctx import TrainCtx
    from persia_tpu_torch.embedding.store import EmbeddingStore
    from persia_tpu_torch.embedding.worker import EmbeddingWorker

    cfg = EmbeddingConfig(slots_config={f"field_{i}": SlotConfig(dim=EMB_DIM) for i in range(num_fields)},
                          feature_index_prefix_bit=8)
    stores = [EmbeddingStore(capacity=1 << 20, num_internal_shards=16, optimizer=Adagrad(lr=0.05).config,
                             seed=11 + r) for r in range(ps_replicas)]
    return TrainCtx(model, adam, Adagrad(lr=0.05), EmbeddingWorker(cfg, stores), cfg, device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="DeepFM / DCN-v2 on Avazu-shaped data through the PyTorch port")
    ap.add_argument("--model", choices=MODELS, default="deepfm")
    ap.add_argument("--batch-size", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--eval-steps", type=int, default=8)
    ap.add_argument("--ps-replicas", type=int, default=2)
    ap.add_argument("--tier", choices=TIERS, default="hybrid",
                    help="hybrid = host-PS lookups; fused = tables on the card, one step program")
    ap.add_argument("--fused-vocab-cap", type=int, default=None,
                    help="fused tier: cap each table at N rows (ids fold)")
    ap.add_argument("--deterministic", action="store_true",
                    help="reproducible mode: ordered batches, staleness=1")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    train_set = AvazuSynthetic(num_samples=args.steps * args.batch_size, seed=42)
    test_set = AvazuSynthetic(num_samples=args.eval_steps * args.batch_size, seed=4242)
    ctx = build_ctx(args.model, num_fields=len(AVAZU_VOCABS), ps_replicas=args.ps_replicas, tier=args.tier,
                    fused_vocab_cap=args.fused_vocab_cap, device=args.device)
    with ctx:
        losses, dt = train(ctx, args.tier, train_set.batches(batch_size=args.batch_size), args.deterministic)
        sps = args.steps * args.batch_size / dt
        preds, labels = predict(ctx, test_set.batches(batch_size=args.batch_size, requires_grad=False))
        auc = roc_auc(labels, preds)
        print(f"avazu-{args.model} steps={args.steps} loss={np.mean(losses):.4f} test_auc={auc:.6f} "
              f"throughput={sps:,.0f} samples/sec", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
