"""The train and eval steps and the embedding inputs of a model (counterpart
of ``persia_tpu/parallel/train_step.py``).

Batch convention (built by ``persia_tpu_torch.ctx.EmbeddingCtx.prepare_features``,
every leaf a tensor on the ctx's device; float leaves of the embedding
entries are in the wire dtype):

    batch = {
      "dense":  [ (B, F) f32 ... ],
      "labels": [ (B, 1) f32 ... ],
      "emb":    [ {"pooled": (B, D)}                                   # host-pooled slot
                | {"distinct": (P, D), "pool_index": (B, L) i32,
                   ["pool_counts": (B, 1) i32],
                   ["pool_order": (B*L,) i32, "pool_offsets": (P+1,) i32]}  # device-pooled slot
                | {"distinct": (P, D), "index": (B, L) i32,
                   "mask": (B, L) bool,
                   ["order": (B*L,) i32, "offsets": (P+1,) i32,
                    "long_chunks": (M, 2) i32]} ... ],  # raw slot
    }

The train step runs forward, loss, backward and the dense optimizer's
update, and returns the embedding inputs' gradients packed for one
device→host copy. Device-pooled slots of one dim and dtype are pooled by one
``ops.embedding_pool`` launch (its backward, another, gives the
per-distinct gradients); raw slots of one dim, dtype and (B, L) gather by
one ``ops.raw_gather`` launch, whose backward scatters back onto the
distinct rows.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from persia_tpu_torch.ops import PoolSlot, RawSlot, embedding_pool, raw_gather


def _embedding_model_inputs(emb_diff: List, emb_static: List) -> List:
    """Rebuild per-slot model inputs from (differentiable, static) halves."""
    out: List = [None] * len(emb_diff)
    groups: Dict[Tuple, List[int]] = {}  # device-pooled slots by (device, dtype, dim)
    raw_groups: Dict[Tuple, List[int]] = {}  # raw slots by (device, dtype, dim, (B, L))
    for i, (diff, static) in enumerate(zip(emb_diff, emb_static)):
        if static is None:  # pooled slot: diff IS the (B, dim) tensor
            out[i] = diff
        elif isinstance(static, PoolSlot):
            groups.setdefault((diff.device, diff.dtype, diff.shape[1]), []).append(i)
        else:  # raw slot: (RawSlot, mask) → (gathered (B, L, dim), mask)
            key = (diff.device, diff.dtype, diff.shape[1], tuple(static[0].index.shape))
            raw_groups.setdefault(key, []).append(i)
    for members in groups.values():
        pooled = embedding_pool([emb_diff[i] for i in members], [emb_static[i] for i in members])
        for i, p in zip(members, pooled):
            out[i] = p
    for members in raw_groups.values():
        gathered = raw_gather([emb_diff[i] for i in members], [emb_static[i][0] for i in members])
        for i, g in zip(members, gathered):
            out[i] = (g, emb_static[i][1])
    return out


def _split_emb(emb: List[Dict]) -> Tuple[List, List]:
    diff, static = [], []
    for e in emb:
        if "pooled" in e:
            diff.append(e["pooled"])
            static.append(None)
        elif "pool_index" in e:
            diff.append(e["distinct"])
            static.append(PoolSlot(
                e["pool_index"], e.get("pool_counts"), e.get("pool_order"), e.get("pool_offsets"),
            ))
        else:
            diff.append(e["distinct"])
            static.append((RawSlot(e["index"], e.get("order"), e.get("offsets"), e.get("long_chunks")), e["mask"]))
    return diff, static


logger = logging.getLogger("persia_tpu_torch.train_step")


def _note_nonfinite_loss(loss: float) -> float:
    """Finite guard on a host loss read: a NaN or Inf loss is logged
    instead of flowing on silently (the reference also counts it in its
    metrics registry, which the port does not have yet)."""
    if not np.isfinite(loss):
        logger.warning("non-finite loss %r", loss)
    return loss


def default_loss_fn(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy with logits, averaged."""
    return F.binary_cross_entropy_with_logits(logits, labels)


@dataclass
class LossScaleState:
    """Dynamic loss scale, held on the host in f32 steps: the step syncs on
    its finite check anyway."""

    scale: float
    good_steps: int = 0


@dataclass
class TrainState:
    """The dense side's training state: the module holds the parameters
    and any batch statistics (its batch norms' buffers, flax's
    ``batch_stats``), ``optimizer`` (a ``torch.optim.Adam`` over them) its
    moments; ``step`` counts the steps taken, skipped ones included."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    loss_scale: Optional[LossScaleState] = None


def init_train_state(
    model: torch.nn.Module, optimizer: torch.optim.Optimizer, loss_scale_init: Optional[float] = None,
) -> TrainState:
    ls = None if loss_scale_init is None else LossScaleState(float(np.float32(loss_scale_init)))
    return TrainState(model=model, optimizer=optimizer, loss_scale=ls)


def build_train_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    loss_fn: Callable = default_loss_fn,
    dynamic_loss_scale: bool = False,
    growth_interval: int = 2000,
    growth_factor: float = 2.0,
    backoff_factor: float = 0.5,
    max_scale: float = float(2 ** 24),
):
    """Returns ``step(state, batch) -> (header, gpacked)``, which updates
    ``state`` (the model's parameters through ``optimizer``, ``step``, the
    loss scale) in place.

    ``header`` is f32 on the device, ``[loss | preds]`` (with
    ``dynamic_loss_scale``: ``[loss | scale used | finite | preds]``).
    ``gpacked`` is ONE flat tensor of every embedding input's gradient,
    slot after slot, in the wire dtype: (B, dim) for host-pooled slots,
    (P, dim) for the others (rows past the true distinct count are padding
    the host slices off).

    The model runs in train mode: a batch norm normalises with the batch's
    statistics and moves its running ones in place during the forward.

    ``dynamic_loss_scale``: the loss is multiplied by the running scale
    before backward. A finite check over every dense and embedding gradient
    decides the step: finite → the dense update applies and ``good_steps``
    counts up, the scale growing by ``growth_factor`` after
    ``growth_interval`` of them; overflow → the dense update is skipped,
    the scale backs off by ``backoff_factor`` and ``good_steps`` resets.
    The scale stays within [1, ``max_scale``]. A skipped step still moves
    the running statistics, as the reference's does (it takes the
    forward's new ``batch_stats`` whatever the finite check says).
    Embedding gradients ship scaled; the header's scale lets the worker
    divide it out."""
    params = [p for p in model.parameters() if p.requires_grad]
    f32 = np.float32

    def step(state: TrainState, batch: Dict):
        model.train()
        emb_diff, emb_static = _split_emb(batch["emb"])
        leaves = [d.detach().requires_grad_(True) for d in emb_diff]
        logits = model(batch["dense"], _embedding_model_inputs(leaves, emb_static))
        loss = loss_fn(logits, batch["labels"][0])
        scale = state.loss_scale.scale if dynamic_loss_scale else 1.0
        optimizer.zero_grad(set_to_none=True)
        (loss * scale if dynamic_loss_scale else loss).backward()
        emb_grads = [l.grad if l.grad is not None else torch.zeros_like(l) for l in leaves]
        param_grads = [p.grad for p in params if p.grad is not None]

        if dynamic_loss_scale:
            finite_t = torch.stack([torch.isfinite(g).all() for g in param_grads + emb_grads]).all()
            finite = bool(finite_t)  # a sync: the update is skipped on overflow
            ls = state.loss_scale
            if finite:
                inv = torch.tensor(1.0 / f32(scale), dtype=torch.float32)
                for g in param_grads:
                    g.mul_(inv.to(g.device))
                optimizer.step()
                good = ls.good_steps + 1
                grown = good >= growth_interval
                new_scale = f32(scale) * f32(growth_factor) if grown else f32(scale)
                ls.good_steps = 0 if grown else good
            else:
                new_scale = f32(scale) * f32(backoff_factor)
                ls.good_steps = 0
            ls.scale = float(np.clip(new_scale, f32(1.0), f32(max_scale)))
        else:
            optimizer.step()
        state.step += 1

        head = [loss.detach().reshape(1).float()]
        if dynamic_loss_scale:
            head.append(torch.full((1,), scale, dtype=torch.float32, device=loss.device))
            head.append(finite_t.reshape(1).float())
        head.append(torch.sigmoid(logits.detach()).reshape(-1).float())
        header = torch.cat(head)
        gpacked = (
            torch.cat([g.reshape(-1) for g in emb_grads])
            if emb_grads else torch.zeros(0, device=loss.device)
        )
        return header, gpacked

    return step


def unpack_step_header(header: np.ndarray, batch: Dict):
    """Host view of the step's small output: (loss, preds). A NaN or Inf
    loss is logged (``_note_nonfinite_loss``)."""
    shape = tuple(batch["labels"][0].shape)
    n = int(np.prod(shape))
    return _note_nonfinite_loss(float(header[0])), header[1:1 + n].reshape(shape)


def unpack_step_header_dynamic(header: np.ndarray, batch: Dict):
    """Header view for a ``dynamic_loss_scale`` step:
    (loss, preds, scale_used, grads_finite). A NaN or Inf loss is logged."""
    shape = tuple(batch["labels"][0].shape)
    n = int(np.prod(shape))
    loss = _note_nonfinite_loss(float(header[0]))
    return loss, header[3:3 + n].reshape(shape), float(header[1]), bool(header[2] > 0.5)


def unpack_step_grads(gpacked: np.ndarray, batch: Dict) -> List[np.ndarray]:
    """Split the host copy of the packed gradients into per-slot arrays
    (shapes from the batch the step consumed)."""
    grads = []
    off = 0
    for e in batch["emb"]:
        shape = tuple((e["pooled"] if "pooled" in e else e["distinct"]).shape)
        k = int(np.prod(shape))
        grads.append(np.ascontiguousarray(gpacked[off:off + k]).reshape(shape))
        off += k
    return grads


def unpack_step_output(header: np.ndarray, gpacked: np.ndarray, batch: Dict):
    """(loss, preds, emb_grads) from the host copies of the step's two
    outputs."""
    loss, preds = unpack_step_header(header, batch)
    return loss, preds, unpack_step_grads(gpacked, batch)


def build_eval_step(model: torch.nn.Module) -> Callable[[Dict], torch.Tensor]:
    """Returns ``eval_step(batch) -> preds``: sigmoid of the model's logits,
    computed under ``torch.inference_mode`` with the model in eval mode
    (batch norms on their running statistics, which stay as they are). The
    parameters are the module's own."""

    @torch.inference_mode()
    def eval_step(batch: Dict) -> torch.Tensor:
        model.eval()
        model_emb = _embedding_model_inputs(*_split_emb(batch["emb"]))
        return torch.sigmoid(model(batch["dense"], model_emb))

    return eval_step
