"""The cache tier's train and eval steps (counterpart of
``persia_tpu/embedding/hbm_cache/step.py``).

A train step, on the card, in place on the state:

    cache rows → gather-pool and update keys (K13, one launch a group's
        stacked slots and one a raw slot) → model forward and backward →
        Adam on the dense tower → per group, the per-position gradients
        and ``torch.sort`` + K5 over the routed keys (one sparse update)

The pooled rows are the step's differentiated leaves for the stacked
slots (``ops.cached_gather.PooledRows``: its backward hands back the
per-position gradients), the raw rows for a raw slot. The keys route the
pad row C to K5's sentinel, so the update needs no mask and never touches
the pad row, weight decay included. The aux program (K12) runs before
the step, apart (``CachedTrainCtx._apply_feed``).

This slice has a static loss scale, no sentinel probe and no
parameter-server tier inside the step: asking for one raises.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch

from persia_tpu_torch.embedding.hbm_cache.groups import (
    CachedTrainState,
    CacheGroup,
    CacheLayout,
    _model_emb_from_gathered,
    _slot_group_of,
)
from persia_tpu_torch.embedding.optim import OptimizerConfig
from persia_tpu_torch.ops.cached_gather import PooledRows, cached_gather
from persia_tpu_torch.ops.sparse_update import sparse_update
from persia_tpu_torch.parallel.train_step import default_loss_fn


def _unsupported(**options) -> None:
    on = sorted(k for k, v in options.items() if v)
    if on:
        raise NotImplementedError(f"the cache tier's synchronous step has no {', '.join(on)} yet")


def build_cached_train_step(
    model: torch.nn.Module,
    dense_optimizer: torch.optim.Optimizer,
    sparse_cfg: OptimizerConfig,
    groups: Sequence[CacheGroup],
    loss_fn: Callable = default_loss_fn,
    dynamic_loss_scale: bool = False,
    sentinel_probe: bool = False,
    ps_grad_wire=None,
):
    """``step(state, batch, layout) -> header``: header is the device f32
    ``[loss, sigmoid(logits)...]``, the reference's layout.

    batch = {"dense": [(B, F) f32], "labels": [(B, 1) f32],
    "stacked_rows": {group: (S, B, L) int32, pad C}, "stacked_scale":
    {group: (S, B) f32} (absent where no slot scales), "raw_rows": {slot:
    (B, L) int32}}, tensors on the state's device."""
    _unsupported(dynamic_loss_scale=dynamic_loss_scale, sentinel_probe=sentinel_probe,
                 ps_grad_wire=ps_grad_wire is not None)
    anchors: Dict[torch.device, torch.Tensor] = {}
    betas: Dict[torch.device, torch.Tensor] = {}

    def step(state: CachedTrainState, batch: Dict, layout: CacheLayout) -> torch.Tensor:
        dev = state.emb_batch_state.device
        if dev not in anchors:
            anchors[dev] = torch.zeros((), device=dev, requires_grad=True)
            betas[dev] = torch.tensor([sparse_cfg.beta1, sparse_cfg.beta2], dtype=torch.float32, device=dev)
        scales = batch.get("stacked_scale", {})
        sinks: Dict[str, Dict] = {}
        pooled = {}
        for gname, rows in batch["stacked_rows"].items():
            sinks[gname] = {}
            pooled[gname] = PooledRows.apply(anchors[dev], state.tables[gname], rows, scales.get(gname),
                                             sinks[gname])
        raw_leaves = {}
        raw = {}
        for name, rows in batch["raw_rows"].items():
            got, mask, keys = cached_gather(state.tables[_slot_group_of(groups, name)], rows, pool=False,
                                            keys=True)
            leaf = got.detach().requires_grad_(True)
            raw_leaves[name] = (leaf, keys)
            raw[name] = (leaf, mask)
        model.train()
        logits = model(batch["dense"], _model_emb_from_gathered(layout, pooled, raw))
        loss = loss_fn(logits, batch["labels"][0])
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()

        state.emb_batch_state.mul_(betas[dev])
        for g in groups:
            keys, grads = [], []
            if g.name in sinks:
                sink = sinks[g.name]
                keys.append(sink["keys"])
                grads.append(sink.get("grads", torch.zeros((sink["keys"].numel(), g.dim), device=dev)))
            for name in g.raw_slots:
                if name in raw_leaves:
                    leaf, k = raw_leaves[name]
                    keys.append(k)
                    grads.append((leaf.grad if leaf.grad is not None else torch.zeros_like(leaf))
                                 .reshape(-1, g.dim))
            if not keys:
                continue
            sparse_update(sparse_cfg, state.tables[g.name], state.emb_state[g.name],
                          torch.cat(keys) if len(keys) > 1 else keys[0],
                          torch.cat(grads) if len(grads) > 1 else grads[0], state.emb_batch_state)
        state.step.add_(1)
        return torch.cat([loss.detach().reshape(1).float(), torch.sigmoid(logits.detach()).reshape(-1).float()])

    return step


def build_cached_eval_step(model: torch.nn.Module, groups: Sequence[CacheGroup]):
    """``eval_step(state, batch, layout) -> preds``: the eval batch adds
    ``miss_tables`` {group: (M, dim) f32}; a row > C reads its miss table
    (K13's eval mode), and nothing of the cache is written."""

    @torch.no_grad()
    def eval_step(state: CachedTrainState, batch: Dict, layout: CacheLayout) -> torch.Tensor:
        scales = batch.get("stacked_scale", {})
        pooled = {gname: cached_gather(state.tables[gname], rows, pool=True, scale=scales.get(gname),
                                       miss_table=batch["miss_tables"][gname])
                  for gname, rows in batch["stacked_rows"].items()}
        raw = {}
        for name, rows in batch["raw_rows"].items():
            gname = _slot_group_of(groups, name)
            raw[name] = cached_gather(state.tables[gname], rows, pool=False, miss_table=batch["miss_tables"][gname])
        model.eval()
        return torch.sigmoid(model(batch["dense"], _model_emb_from_gathered(layout, pooled, raw)))

    return eval_step
