"""The cache tier's train and eval steps (counterpart of
``persia_tpu/embedding/hbm_cache/step.py``).

A train step, on the card, in place on the state:

    cache rows → gather-pool and update keys (K13, one launch a group's
        stacked slots and one a raw slot) → the parameter-server slots'
        inputs (``batch["ps_emb"]``: device-pooled slots pooled by K1, raw
        ones gathered by K6) → model forward and backward → Adam on the
        dense tower → per group, the per-position gradients and
        ``torch.sort`` + K5 over the routed keys (one sparse update) →
        the PS slots' gradients packed for the host (int8 wire: K15)

The pooled rows are the step's differentiated leaves for the stacked
slots (``ops.cached_gather.PooledRows``: its backward hands back the
per-position gradients), the raw rows for a raw slot, the entries' float
rows for a PS slot. The keys route the pad row C to K5's sentinel, so the
update needs no mask and never touches the pad row, weight decay
included. The aux program (K12) runs before the step, apart
(``CachedTrainCtx._apply_feed``).

This slice has a static loss scale and no sentinel probe (asking for
either raises), so the PS wire carries no ``[scale | finite]`` tail.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
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
from persia_tpu_torch.ops.quantize_int8 import quantize_int8_ef
from persia_tpu_torch.ops.sparse_update import sparse_update
from persia_tpu_torch.parallel.train_step import LossScaleState, _embedding_model_inputs, _split_emb, default_loss_fn

PS_GRAD_WIRES = ("float32", "bfloat16", "int8")
_SENTINEL = int(np.iinfo(np.int32).max)  # K5's update key that names no row


def _unsupported(**options) -> None:
    on = sorted(k for k, v in options.items() if v)
    if on:
        raise NotImplementedError(f"the cache tier's synchronous step has no {', '.join(on)} yet")


def _pack_ps_grads(grads: List[torch.Tensor], int8: bool, residual: Optional[torch.Tensor], gate=None):
    """The PS slots' gradients for the host, slot after slot: flat in
    their own dtype (the entries' wire dtype: f32, or bf16 for the bf16
    wire), or with ``int8`` quantized a slot a segment against
    ``residual`` (zeros where None): ``(q int8, scales f32 (slots,), new
    residual)``. ``gate`` (the loss scale's ``(scale, inv, finite f32)``):
    the flat buffer ends in ``[scale | finite]``; the int8 wire unscales by
    ``inv`` and its scales end in ``finite``."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    if not int8:
        if gate is None:
            return flat
        return torch.cat([flat, torch.stack([gate[0], gate[2]]).to(flat.dtype)])
    offsets = [0]
    for g in grads:
        offsets.append(offsets[-1] + g.numel())
    if residual is None:
        residual = torch.zeros(flat.shape, dtype=torch.float32, device=flat.device)
    if gate is None:
        return quantize_int8_ef(flat, residual, offsets)
    return quantize_int8_ef(flat, residual, offsets, gate[1], gate[2])


def init_loss_scale(init: float, device) -> LossScaleState:
    """The cache tier's loss scale on ``device``: an f32 scale (``init``
    rounded to f32) and an int32 count of finite steps."""
    return LossScaleState(scale=torch.tensor(float(np.float32(init)), dtype=torch.float32, device=device),
                          good_steps=torch.zeros((), dtype=torch.int32, device=device))


def _gate(grads: Sequence[torch.Tensor], scale: torch.Tensor):
    """(finite bool, inv f32): one flag over every gradient; ``1 / scale``
    where finite, else 0."""
    finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
    return finite, torch.where(finite, torch.reciprocal(scale), torch.zeros_like(scale))


def _unscaled(g: torch.Tensor, finite: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """``g * inv`` where finite, else 0 (selected first: inf × 0 is NaN)."""
    return torch.where(finite, g, torch.zeros_like(g)) * inv.to(g.dtype)


def _dense_state(optimizer: torch.optim.Optimizer) -> List[torch.Tensor]:
    """The parameters and every state tensor of ``optimizer``."""
    out = [p for group in optimizer.param_groups for p in group["params"]]
    for st in optimizer.state.values():
        out.extend(v for v in st.values() if torch.is_tensor(v))
    return out


def build_cached_train_step(
    model: torch.nn.Module,
    dense_optimizer: torch.optim.Optimizer,
    sparse_cfg: OptimizerConfig,
    groups: Sequence[CacheGroup],
    loss_fn: Callable = default_loss_fn,
    dynamic_loss_scale: bool = False,
    sentinel_probe: bool = False,
    ps_grad_wire: str = "float32",
    growth_interval: int = 2000,
    growth_factor: float = 2.0,
    backoff_factor: float = 0.5,
    max_scale: float = float(2 ** 24),
):
    """``step(state, batch, layout) -> (header, ps_gpacked)``: header is the
    device f32 ``[loss, sigmoid(logits)...]``, the reference's layout;
    ``ps_gpacked`` the PS slots' gradients for the host (None without PS
    slots): with ``ps_grad_wire`` "float32" / "bfloat16" one flat
    tensor in the entries' dtype (their wire dtype), with "int8" ``(q
    int8, scales f32 a slot, new residual f32)`` (K15; the residual read
    from ``batch["ps_gres"]``, zeros where absent).

    batch = {"dense": [(B, F) f32], "labels": [(B, 1) f32],
    "stacked_rows": {group: (S, B, L) int32, pad C}, "stacked_scale":
    {group: (S, B) f32} (absent where no slot scales), "raw_rows": {slot:
    (B, L) int32}, "ps_emb": [the PS slots' entries, as
    ``persia_tpu_torch.ctx.stage_embeddings`` makes them], "ps_gres": (n,)
    f32}, tensors on the state's device.

    ``dynamic_loss_scale``: the state carries a ``LossScaleState`` of
    device tensors (``init_loss_scale``); see the module's docstring. The
    header is then ``[loss | scale used | finite | preds]``."""
    _unsupported(sentinel_probe=sentinel_probe)
    if ps_grad_wire not in PS_GRAD_WIRES:
        raise ValueError(f"ps_grad_wire must be one of {PS_GRAD_WIRES}, got {ps_grad_wire!r}")
    int8 = ps_grad_wire == "int8"
    anchors: Dict[torch.device, torch.Tensor] = {}
    betas: Dict[torch.device, torch.Tensor] = {}

    def step(state: CachedTrainState, batch: Dict, layout: CacheLayout) -> Tuple[torch.Tensor, object]:
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
        ps_diff, ps_static = _split_emb(batch.get("ps_emb", []))
        ps_leaves = [d.detach().requires_grad_(True) for d in ps_diff]
        model.train()
        logits = model(batch["dense"], _model_emb_from_gathered(layout, pooled, raw,
                                                                _embedding_model_inputs(ps_leaves, ps_static)))
        loss = loss_fn(logits, batch["labels"][0])
        state.optimizer.zero_grad(set_to_none=True)
        ls = state.loss_scale if dynamic_loss_scale else None
        (loss if ls is None else loss * ls.scale).backward()

        # each group's update keys and per-position gradients (a bf16
        # pool's rounded to bf16, as the reference's cotangents are)
        updates = {}
        for g in groups:
            keys, grads = [], []
            if g.name in sinks:
                sink = sinks[g.name]
                keys.append(sink["keys"])
                grads.append(sink.get("grads", torch.zeros((sink["keys"].numel(), g.dim), device=dev)))
            for name in g.raw_slots:
                if name in raw_leaves:
                    leaf, k = raw_leaves[name]
                    rg = (leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)).reshape(-1, g.dim)
                    keys.append(k)
                    grads.append(rg.to(torch.bfloat16).float() if state.tables[g.name].dtype == torch.bfloat16
                                 else rg)
            if keys:
                updates[g.name] = (torch.cat(keys) if len(keys) > 1 else keys[0],
                                   torch.cat(grads) if len(grads) > 1 else grads[0])
        ps_grads = [l.grad if l.grad is not None else torch.zeros_like(l) for l in ps_leaves]

        gate = None
        if ls is not None:
            params = [p for p in model.parameters() if p.grad is not None]
            finite, inv = _gate([p.grad for p in params] + [u[1] for u in updates.values()] + ps_grads, ls.scale)
            for p in params:
                p.grad.copy_(_unscaled(p.grad, finite, inv))
            updates = {n: (torch.where(finite, k, torch.full_like(k, _SENTINEL)), _unscaled(gr, finite, inv))
                       for n, (k, gr) in updates.items()}
            with torch.no_grad():
                before = [t.clone() for t in _dense_state(state.optimizer)]
            state.optimizer.step()
            with torch.no_grad():  # an overflow leaves the dense state as it was
                for t, old in zip(_dense_state(state.optimizer), before):
                    t.copy_(torch.where(finite, t, old))
            gate = (ls.scale.clone(), inv, finite.float())
        else:
            state.optimizer.step()

        state.emb_batch_state.mul_(betas[dev])
        for gname, (keys, grads) in updates.items():
            sparse_update(sparse_cfg, state.tables[gname], state.emb_state[gname], keys, grads, state.emb_batch_state)
        state.step.add_(1)
        head = [loss.detach().reshape(1).float()]
        if ls is not None:
            head += [gate[0].reshape(1), gate[2].reshape(1)]
            good = torch.where(finite, ls.good_steps + 1, torch.zeros_like(ls.good_steps))
            grown = good >= growth_interval
            scale = torch.where(finite, torch.where(grown, ls.scale * growth_factor, ls.scale),
                                ls.scale * backoff_factor)
            ls.scale.copy_(torch.clamp(scale, 1.0, float(np.float32(max_scale))))
            ls.good_steps.copy_(torch.where(grown, torch.zeros_like(good), good))
        header = torch.cat(head + [torch.sigmoid(logits.detach()).reshape(-1).float()])
        if not ps_leaves:
            return header, None
        return header, _pack_ps_grads(ps_grads, int8, batch.get("ps_gres"), gate)

    return step


def build_cached_eval_step(model: torch.nn.Module, groups: Sequence[CacheGroup]):
    """``eval_step(state, batch, layout) -> preds``: the eval batch adds
    ``miss_tables`` {group: (M, dim) f32}; a row > C reads its miss table
    (K13's eval mode), and nothing of the cache is written. PS slots read
    their ``ps_emb`` entries (the servers' infer lookup)."""

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
        ps_diff, ps_static = _split_emb(batch.get("ps_emb", []))
        model.eval()
        return torch.sigmoid(model(batch["dense"], _model_emb_from_gathered(
            layout, pooled, raw, _embedding_model_inputs(ps_diff, ps_static))))

    return eval_step
