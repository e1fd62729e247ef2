"""The 100-trillion-parameter regime's harness through the port
(counterpart of ``examples/synthetic_100t/train.py``): the hybrid tier
against many parameter-server replicas under ids drawn uniformly from
2^63, with the example's configuration — 128 numpy replicas of 2^16 rows
and 8 shards (Adagrad(0.05), seeds 100, 101, ...), 8 slots of 4 ids a
sample at B=1024, DLRM bottom (32, 16) and top (64, 32), Adam(1e-3),
through the ``DataLoader`` (4 lookup threads, staleness 4;
``--deterministic``: 1 thread, staleness 1, in order).

It reports samples/s, ids/s through the sharded router, the rows resident,
the bytes a row (embedding, optimizer state, sign key and the LRU's links
and slot) and the extrapolation to 10^14 parameters at that density.

One departure: ``--out`` names a JSON file for the record and defaults to
none (the reference's default writes ``BENCH_100T.json`` at the root).

Run:  python -m persia_tpu_torch.testing.synthetic_100t [--steps N]
      [--ps-replicas 128] [--device cpu] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from persia_tpu_torch.testing.datasets import Synthetic100T

EMB_DIM = 16
DENSE_DIM = 4
BOTTOM, TOP = (32, EMB_DIM), (64, 32)
TOTAL_PARAMS = 100e12


def build_ctx(num_slots: int = 8, ps_replicas: int = 128, capacity_per_replica: int = 1 << 16, device=None):
    """The example's ``build_ctx`` through the port, on ``device`` (``cuda``
    unless given), the dense weights drawn from seed 0: (ctx not entered,
    stores)."""
    from persia_tpu_torch.config import EmbeddingConfig, SlotConfig
    from persia_tpu_torch.ctx import TrainCtx
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.embedding.store import EmbeddingStore
    from persia_tpu_torch.embedding.worker import EmbeddingWorker
    from persia_tpu_torch.models import DLRM

    cfg = EmbeddingConfig(slots_config={f"slot_{i}": SlotConfig(dim=EMB_DIM) for i in range(num_slots)},
                          feature_index_prefix_bit=8)
    stores = [EmbeddingStore(capacity=capacity_per_replica, num_internal_shards=8, optimizer=Adagrad(lr=0.05).config,
                             seed=100 + r) for r in range(ps_replicas)]
    model = DLRM(DENSE_DIM, num_slots, EMB_DIM, BOTTOM, TOP, device="cpu",
                 generator=torch.Generator().manual_seed(0))
    ctx = TrainCtx(model, torch.optim.Adam(model.parameters(), lr=1e-3), Adagrad(lr=0.05),
                   EmbeddingWorker(cfg, stores), cfg, device=device)
    return ctx, stores


def dataset(steps: int, batch_size: int = 1024, num_slots: int = 8, ids_per_sample: int = 4) -> Synthetic100T:
    return Synthetic100T(num_samples=steps * batch_size, num_slots=num_slots, ids_per_sample=ids_per_sample,
                         seed=42)


def train(ctx, batches, deterministic: bool = False) -> Tuple[List[float], float]:
    """The harness's loop over ``batches`` through the ``DataLoader``, its
    gradients flushed at the end: (losses, seconds)."""
    from persia_tpu_torch.data_loader import DataLoader

    loader = DataLoader(batches, ctx, num_workers=1 if deterministic else 4, staleness=1 if deterministic else 4,
                        reproducible=deterministic)
    losses = []
    try:
        t0 = time.perf_counter()
        for tb in loader:
            losses.append(float(ctx.train_step_prepared(tb, loader)["loss"]))
        loader.flush()
        return losses, time.perf_counter() - t0
    finally:
        loader.shutdown()


def record(stores, losses, seconds, steps, batch_size=1024, num_slots=8, ids_per_sample=4,
           capacity_per_replica=1 << 16, deterministic=False) -> Dict:
    """The example's record: throughput, capacity and the 100T
    extrapolation at the measured density."""
    sps = steps * batch_size / seconds
    ids_ps = steps * batch_size * num_slots * ids_per_sample / seconds
    rows = sum(s.size() for s in stores)
    # dim f32 weights + the optimizer's state + the sign key + LRU links
    # (2x u32) + the hash map's slot
    bytes_per_row = (EMB_DIM + stores[0]._state_dim(EMB_DIM)) * 4 + 8 + 8 + 16
    rows_for_100t = TOTAL_PARAMS / EMB_DIM
    tb_needed = rows_for_100t * bytes_per_row / 1e12
    return {
        "metric": "synthetic_100t_regime",
        "config": {"ps_replicas": len(stores), "steps": steps, "batch_size": batch_size, "num_slots": num_slots,
                   "ids_per_sample": ids_per_sample, "capacity_per_replica": capacity_per_replica,
                   "embedding_dim": EMB_DIM, "deterministic": deterministic},
        "throughput": {"samples_per_sec": sps, "ids_per_sec_through_router": ids_ps},
        "loss_mean": float(np.mean(losses)),
        "capacity": {"rows_resident": int(rows), "bytes_per_row": int(bytes_per_row),
                     "rows_for_100t_params": int(rows_for_100t), "tb_needed_for_100t": tb_needed,
                     "hosts_at_512gb": int(np.ceil(tb_needed / 0.512))},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="The 100T-parameter regime's harness through the PyTorch port")
    ap.add_argument("--batch-size", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--num-slots", type=int, default=8)
    ap.add_argument("--ids-per-sample", type=int, default=4)
    ap.add_argument("--ps-replicas", type=int, default=128)
    ap.add_argument("--capacity-per-replica", type=int, default=1 << 16)
    ap.add_argument("--deterministic", action="store_true",
                    help="reproducible mode: ordered batches, staleness=1")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--out", default="", help="JSON file for the record (default: none)")
    args = ap.parse_args(argv)

    data = dataset(args.steps, args.batch_size, args.num_slots, args.ids_per_sample)
    ctx, stores = build_ctx(args.num_slots, args.ps_replicas, args.capacity_per_replica, device=args.device)
    with ctx:
        losses, seconds = train(ctx, data.batches(batch_size=args.batch_size), args.deterministic)
    rec = record(stores, losses, seconds, args.steps, args.batch_size, args.num_slots, args.ids_per_sample,
                 args.capacity_per_replica, args.deterministic)
    th, cap = rec["throughput"], rec["capacity"]
    print(f"synthetic-100t ps_replicas={args.ps_replicas} steps={args.steps} loss={rec['loss_mean']:.4f} "
          f"throughput={th['samples_per_sec']:,.0f} samples/sec ({th['ids_per_sec_through_router']:,.0f} ids/sec)",
          flush=True)
    print(f"capacity: {cap['rows_resident']:,} rows resident across {args.ps_replicas} replicas; "
          f"{cap['bytes_per_row']} B/row → 100T params (dim {EMB_DIM}) = {cap['rows_for_100t_params']:,} rows ≈ "
          f"{cap['tb_needed_for_100t']:,.1f} TB ≈ {cap['hosts_at_512gb']:,} hosts @ 512 GB", flush=True)
    if args.out:
        rec["datetime"] = time.strftime("%Y-%m-%dT%H:%M:%S")
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
