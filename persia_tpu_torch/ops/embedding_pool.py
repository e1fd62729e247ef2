"""Grouped gather-pool of device-pooled slots: the CUDA kernels
(``csrc/embedding_pool.cu``, geometry from ``plans.pool_plan``) and their
plain PyTorch versions.

A device-pooled sum slot arrives as its distinct rows ``(P, dim)`` (f32 or
bf16, the wire dtype; rows past the true distinct count D are zero) and an
index ``(B, L)`` int32 whose pads point at row D, with optional per-sample
id counts ``(B, 1)`` for sqrt scaling. For a group of slots of one dim and
one dtype:

- forward (``gather_pool_fwd``): ``out[b, s] = scale_s[b] * sum_l
  rows_s[index_s[b, l]]``, summed in f32, ``out`` (B, S, dim) f32, with
  ``scale = rsqrt(max(count, 1))`` where the slot has counts, else 1;
- backward (``gather_pool_bwd``): ``grad_rows_s[r] = sum over positions
  (b, l) with index_s[b, l] == r of scale_s[b] * g[b, s]``, summed in f32
  and rounded once to the wire dtype. Pads sum into row D as in the
  reference's autodiff; the host slices that row off.

The reference runs both through XLA (``persia_tpu/parallel/train_step.py:
69-87``, the gather and its autodiff scatter-add, which sums in the wire
dtype). The kernel's backward walks a CSR of each slot's index (row →
its positions, ascending), built on the host by ``pool_csr``: every row
is written once, in a fixed order, so two runs give the same bits.

``embedding_pool`` is the differentiable entry point (one
``torch.autograd.Function``): a CPU tensor takes the plain versions, a
CUDA tensor the kernels.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from persia_tpu_torch.ops import _kernels, plans

_DTYPES = {torch.float32: _kernels.DTYPE_F32, torch.bfloat16: _kernels.DTYPE_BF16}
MAX_SLOTS = plans.POOL_MAX_SLOTS


class PoolSlot(NamedTuple):
    """The integer side of one device-pooled slot (on the rows' device)."""

    index: torch.Tensor  # (B, L) int32, pads == D
    counts: Optional[torch.Tensor] = None  # (B, 1) int32: sqrt scaling
    order: Optional[torch.Tensor] = None  # (B*L,) int32: positions sorted by row
    offsets: Optional[torch.Tensor] = None  # (P+1,) int32: row r's span in ``order``


def pool_csr(index: np.ndarray, rows: int):
    """(order, offsets) of a (B, L) index over ``rows`` rows: row r's
    positions (b * L + l) are ``order[offsets[r]:offsets[r + 1]]``, in
    ascending order."""
    flat = np.asarray(index, dtype=np.int64).reshape(-1)
    order = np.argsort(flat, kind="stable").astype(np.int32)
    offsets = np.zeros(rows + 1, dtype=np.int32)
    np.cumsum(np.bincount(flat, minlength=rows), out=offsets[1:])
    return order, offsets


def _scale(slot: PoolSlot) -> Optional[torch.Tensor]:
    if slot.counts is None:
        return None
    return torch.rsqrt(torch.clamp(slot.counts.reshape(-1), min=1).float())


def gather_pool_fwd_reference(rows: Sequence[torch.Tensor], slots: Sequence[PoolSlot]) -> torch.Tensor:
    """Plain forward: index gather, f32 sum over L, sqrt scale; (B, S, dim)."""
    out = []
    for r, slot in zip(rows, slots):
        pooled = r[slot.index.long()].float().sum(dim=1)
        scale = _scale(slot)
        out.append(pooled if scale is None else pooled * scale[:, None])
    return torch.stack(out, dim=1)


def gather_pool_bwd_reference(
    grad: torch.Tensor, rows: Sequence[torch.Tensor], slots: Sequence[PoolSlot]
) -> List[torch.Tensor]:
    """Plain backward: ``index_add_`` of the scaled per-sample gradient in
    f32, one rounding to each slot's row dtype."""
    out = []
    for s, (r, slot) in enumerate(zip(rows, slots)):
        g = grad[:, s].float()
        scale = _scale(slot)
        if scale is not None:
            g = g * scale[:, None]
        L = slot.index.shape[1]
        pos = g[:, None, :].expand(-1, L, -1).reshape(-1, g.shape[1])
        acc = torch.zeros(r.shape, dtype=torch.float32, device=r.device)
        acc.index_add_(0, slot.index.reshape(-1).long(), pos)
        out.append(acc.to(r.dtype))
    return out


class _PoolParams(ctypes.Structure):
    """``PoolSlotsParams`` of csrc/embedding_pool.cu, passed by value to
    the kernels."""

    _fields_ = [
        ("rows", ctypes.c_void_p * MAX_SLOTS),
        ("index", ctypes.c_void_p * MAX_SLOTS),
        ("counts", ctypes.c_void_p * MAX_SLOTS),
        ("order", ctypes.c_void_p * MAX_SLOTS),
        ("offsets", ctypes.c_void_p * MAX_SLOTS),
        ("num_rows", ctypes.c_int * MAX_SLOTS),
        ("ids_per_sample", ctypes.c_int * MAX_SLOTS),
    ]


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check_group(rows: Sequence[torch.Tensor], slots: Sequence[PoolSlot]):
    if not rows or len(rows) != len(slots):
        raise ValueError("need one PoolSlot for each rows tensor, and at least one")
    dev, dtype, dim = rows[0].device, rows[0].dtype, rows[0].shape[1]
    batch = slots[0].index.shape[0]
    if dtype not in _DTYPES:
        raise TypeError(f"gather_pool takes float32 or bfloat16 rows, got {dtype}")
    for r, slot in zip(rows, slots):
        if r.device != dev or r.dtype != dtype or r.ndim != 2 or r.shape[1] != dim:
            raise ValueError("a pooled group needs (P, dim) rows of one device, dtype and dim")
        ts = [r, slot.index] + [t for t in (slot.counts, slot.order, slot.offsets) if t is not None]
        if any(t.device != dev or not t.is_contiguous() for t in ts):
            raise ValueError("gather_pool needs contiguous tensors on one device")
        if slot.index.dtype != torch.int32 or slot.index.ndim != 2 or slot.index.shape[0] != batch:
            raise ValueError("a pooled slot's index must be (B, L) int32, one B for the group")
        if slot.counts is not None and (slot.counts.dtype != torch.int32 or slot.counts.numel() != batch):
            raise ValueError("pool counts must be (B, 1) int32")
    return dev, dtype, dim, batch


def _params(rows, slots, with_csr: bool) -> _PoolParams:
    p = _PoolParams()
    for s, (r, slot) in enumerate(zip(rows, slots)):
        p.rows[s] = r.data_ptr()
        p.index[s] = slot.index.data_ptr()
        p.counts[s] = _ptr(slot.counts)
        p.num_rows[s] = r.shape[0]
        p.ids_per_sample[s] = slot.index.shape[1]
        if with_csr:
            if slot.order is None or slot.offsets is None:
                raise ValueError("gather_pool_bwd needs each slot's CSR (order, offsets)")
            if slot.order.numel() != slot.index.numel() or slot.offsets.numel() != r.shape[0] + 1:
                raise ValueError("a slot's CSR does not match its index and rows")
            if slot.order.dtype != torch.int32 or slot.offsets.dtype != torch.int32:
                raise ValueError("a slot's CSR must be int32")
            p.order[s] = slot.order.data_ptr()
            p.offsets[s] = slot.offsets.data_ptr()
    return p


def _chunks(n: int):
    return [(s0, min(n, s0 + MAX_SLOTS)) for s0 in range(0, n, MAX_SLOTS)]


def gather_pool_fwd(rows: Sequence[torch.Tensor], slots: Sequence[PoolSlot]) -> torch.Tensor:
    """Pooled (B, S, dim) f32 of a group of device-pooled slots. A CPU
    tensor takes the plain version; a CUDA tensor one kernel launch per 64
    slots."""
    dev, dtype, dim, batch = _check_group(rows, slots)
    if dev.type == "cpu":
        return gather_pool_fwd_reference(rows, slots)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n = len(rows)
    out = torch.empty((batch, n, dim), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = _kernels.library()
    for s0, s1 in _chunks(n):
        plan = plans.pool_plan(batch, s1 - s0, dim, max(r.shape[0] for r in rows[s0:s1]))
        params = _params(rows[s0:s1], slots[s0:s1], with_csr=False)
        with torch.cuda.device(dev):
            rc = lib.persia_gather_pool_fwd(
                ctypes.byref(params), out.data_ptr(), _DTYPES[dtype], s1 - s0, batch, dim, n, s0,
                plan.fwd_grid, plan.threads, _kernels.stream_handle(out),
            )
        _kernels.check(rc, "gather_pool_fwd")
        gather_pool_fwd.launches += 1
    return out


def gather_pool_bwd(
    grad: torch.Tensor, rows: Sequence[torch.Tensor], slots: Sequence[PoolSlot]
) -> List[torch.Tensor]:
    """Per-slot row gradients (P, dim) in the rows' dtype from the pooled
    gradient ``grad`` (B, S, dim) f32. A CPU tensor takes the plain
    version; a CUDA tensor one kernel launch per 64 slots, which writes
    every row once (no zeroing pass)."""
    dev, dtype, dim, batch = _check_group(rows, slots)
    if grad.shape != (batch, len(rows), dim) or grad.dtype != torch.float32 or grad.device != dev:
        raise ValueError(f"grad must be ({batch}, {len(rows)}, {dim}) float32 on {dev}")
    if dev.type == "cpu":
        return gather_pool_bwd_reference(grad, rows, slots)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    grad = grad.contiguous()
    outs = [torch.empty(r.shape, dtype=dtype, device=dev) for r in rows]
    lib = _kernels.library()
    for s0, s1 in _chunks(len(rows)):
        max_rows = max(r.shape[0] for r in rows[s0:s1])
        if max_rows * dim == 0:
            continue
        plan = plans.pool_plan(batch, s1 - s0, dim, max_rows)
        # the kernel writes the slots' gradient rows where ``rows`` points
        params = _params(outs[s0:s1], slots[s0:s1], with_csr=True)
        with torch.cuda.device(dev):
            rc = lib.persia_gather_pool_bwd(
                ctypes.byref(params), grad.data_ptr(), _DTYPES[dtype], s1 - s0, batch, dim,
                len(rows), s0, plan.bwd_grid[0], plan.threads, _kernels.stream_handle(grad),
            )
        _kernels.check(rc, "gather_pool_bwd")
        gather_pool_bwd.launches += 1
    return outs


gather_pool_fwd.launches = 0
gather_pool_bwd.launches = 0


class _EmbeddingPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, slots, *rows):
        ctx.slots = slots
        ctx.save_for_backward(*rows)
        return gather_pool_fwd(rows, slots)

    @staticmethod
    def backward(ctx, grad):
        rows = ctx.saved_tensors
        grads = gather_pool_bwd(grad.float(), rows, ctx.slots)
        return (None, *grads)


def embedding_pool(rows: Sequence[torch.Tensor], slots: Sequence[PoolSlot]) -> List[torch.Tensor]:
    """Differentiable gather-pool of a group of device-pooled slots (one
    dim, one dtype): the pooled (B, dim) f32 of each slot, views of one
    (B, S, dim) tensor. The gradient flows to each slot's rows."""
    return list(_EmbeddingPool.apply(tuple(slots), *rows).unbind(dim=1))
