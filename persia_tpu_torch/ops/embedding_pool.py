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
dtype). The kernel's backward is a two-pass segment-sum over a CSR of
each slot's index (row → its positions, ascending), built on the host by
``pool_csr``: pass 1 sums fixed chunks of the sorted positions, one warp
each, pass 2 combines the rows that cross a chunk edge (the order:
``plans.pool_bwd_model``). No atomics and one write per row, so two runs
give the same bits and a hot row costs no more than a uniform one.

``embedding_pool`` is the differentiable entry point (one
``torch.autograd.Function``): a CPU tensor takes the plain versions, a
CUDA tensor the kernels.
"""

from __future__ import annotations

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
    # a stable sort of 16-bit keys is a radix sort: several times faster
    # than a merge sort of the same keys as int64, and the same order
    keys = flat.astype(np.uint16) if rows <= 1 << 16 else flat
    order = np.argsort(keys, kind="stable").astype(np.int32)
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


# ``PoolSlotsParams`` of csrc/embedding_pool.cu, passed by value to the
# kernels: filled with numpy (one slice assignment a field) rather than
# field by field through ctypes, whose per-item cost was most of a call's
# host time
_PARAMS = np.dtype([
    ("rows", "<u8", (MAX_SLOTS,)),
    ("index", "<u8", (MAX_SLOTS,)),
    ("counts", "<u8", (MAX_SLOTS,)),
    ("order", "<u8", (MAX_SLOTS,)),
    ("offsets", "<u8", (MAX_SLOTS,)),
    ("num_rows", "<i4", (MAX_SLOTS,)),
    ("ids_per_sample", "<i4", (MAX_SLOTS,)),
])


class _Group:
    """A checked group of slots (one dim, one dtype, one device) and the
    kernels' parameter structs, one per launch of at most 64 slots. The
    autograd Function builds it in the forward and reuses it in the
    backward, which only adds the CSR and points ``rows`` at its outputs."""

    def __init__(self, rows: Sequence[torch.Tensor], slots: Sequence[PoolSlot]):
        if not rows or len(rows) != len(slots):
            raise ValueError("need one PoolSlot for each rows tensor, and at least one")
        r0 = rows[0]
        dev, dtype = r0.device, r0.dtype
        if dtype not in _DTYPES:
            raise TypeError(f"gather_pool takes float32 or bfloat16 rows, got {dtype}")
        if r0.dim() != 2:
            raise ValueError("a pooled group needs (P, dim) rows of one device, dtype and dim")
        dim, batch = r0.shape[1], slots[0].index.shape[0]
        # every slot's tensors are checked on every call, so this loop is
        # most of a call's host time: each property is read once and
        # compared on its own (no tuple built per tensor)
        i32 = torch.int32
        ptrs, index, counts, num_rows, ids = [], [], [], [], []
        for r, slot in zip(rows, slots):
            shape = r.shape
            if r.dtype is not dtype or r.device != dev or not r.is_contiguous() or len(shape) != 2 or shape[1] != dim:
                raise ValueError("a pooled group needs contiguous (P, dim) rows of one device, dtype and dim")
            idx, cnt = slot.index, slot.counts
            ishape = idx.shape
            if (idx.dtype is not i32 or idx.device != dev or not idx.is_contiguous() or len(ishape) != 2
                    or ishape[0] != batch):
                raise ValueError("a pooled slot's index must be a contiguous (B, L) int32 on the rows' "
                                 "device, one B for the group")
            if cnt is None:
                counts.append(0)
            elif cnt.dtype is not i32 or cnt.device != dev or not cnt.is_contiguous() or cnt.numel() != batch:
                raise ValueError("pool counts must be contiguous (B, 1) int32 on the rows' device")
            else:
                counts.append(cnt.data_ptr())
            ptrs.append(r.data_ptr())
            index.append(idx.data_ptr())
            num_rows.append(shape[0])
            ids.append(ishape[1])
        self.device, self.dtype, self.dim, self.batch = dev, dtype, dim, batch
        self.slots = slots
        self.num_rows, self.ids = num_rows, ids
        self.rows_aligned = all(p % 16 == 0 for p in ptrs)
        self.launches = [(s0, min(len(rows), s0 + MAX_SLOTS)) for s0 in range(0, len(rows), MAX_SLOTS)]
        self.params = np.zeros(len(self.launches), _PARAMS)
        for i, (s0, s1) in enumerate(self.launches):
            for field, values in (("rows", ptrs), ("index", index), ("counts", counts),
                                  ("num_rows", num_rows), ("ids_per_sample", ids)):
                self.params[field][i, :s1 - s0] = values[s0:s1]
        self._csr = False

    def plan(self, launch: int, aligned: bool) -> plans.PoolPlan:
        s0, s1 = self.launches[launch]
        return plans.pool_plan(self.batch, s1 - s0, self.dim, _ELEM_BYTES[self.dtype],
                               max(self.num_rows[s0:s1]), max(self.ids[s0:s1]), aligned)

    def add_csr(self) -> None:
        """Check each slot's CSR (order, offsets) and add its pointers."""
        if self._csr:
            return
        order, offsets = [], []
        i32, dev = torch.int32, self.device
        for slot, p, L in zip(self.slots, self.num_rows, self.ids):
            o, f = slot.order, slot.offsets
            if o is None or f is None:
                raise ValueError("gather_pool_bwd needs each slot's CSR (order, offsets)")
            if (o.dtype is not i32 or f.dtype is not i32 or o.device != dev or f.device != dev
                    or not o.is_contiguous() or not f.is_contiguous()):
                raise ValueError("a slot's CSR must be contiguous int32 on the rows' device")
            if o.numel() != self.batch * L or f.numel() != p + 1:
                raise ValueError("a slot's CSR does not match its index and rows")
            order.append(o.data_ptr())
            offsets.append(f.data_ptr())
        for i, (s0, s1) in enumerate(self.launches):
            self.params["order"][i, :s1 - s0] = order[s0:s1]
            self.params["offsets"][i, :s1 - s0] = offsets[s0:s1]
        self._csr = True


_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}


def _fwd(group: _Group) -> torch.Tensor:
    if group.device.type != "cuda":
        raise ValueError(f"unsupported device {group.device}")
    n = len(group.num_rows)
    out = torch.empty((group.batch, n, group.dim), dtype=torch.float32, device=group.device)
    if out.numel() == 0:
        return out
    lib = _kernels.library()
    stream = _kernels.stream_handle(out)
    with torch.cuda.device(group.device):
        for i, (s0, s1) in enumerate(group.launches):
            plan = group.plan(i, group.rows_aligned)
            rc = lib.persia_gather_pool_fwd(
                group.params[i:].ctypes.data, out.data_ptr(), _DTYPES[group.dtype], s1 - s0, group.batch,
                group.dim, n, s0, plan.fwd_vec, plan.fwd_threads, plan.fwd_grid, stream,
            )
            _kernels.check(rc, "gather_pool_fwd")
            gather_pool_fwd.launches += 1
    return out


def _bwd(group: _Group, grad: torch.Tensor) -> List[torch.Tensor]:
    if group.device.type != "cuda":
        raise ValueError(f"unsupported device {group.device}")
    group.add_csr()
    grad = grad.contiguous()
    n, dim, dtype, dev = len(group.num_rows), group.dim, group.dtype, group.device
    # one buffer for every slot's rows where they share P (the staging pads
    # them to one P), so their pointers are a stride apart
    if len(set(group.num_rows)) == 1:
        buf = torch.empty((n, group.num_rows[0], dim), dtype=dtype, device=dev)
        outs = list(buf.unbind(0))
        ptrs = buf.data_ptr() + np.arange(n, dtype=np.uint64) * np.uint64(buf.stride(0) * buf.element_size())
    else:
        outs = [torch.empty((p, dim), dtype=dtype, device=dev) for p in group.num_rows]
        ptrs = [o.data_ptr() for o in outs]
    if max(group.num_rows) * dim == 0:
        return outs
    aligned = grad.data_ptr() % 16 == 0
    lib = _kernels.library()
    stream = _kernels.stream_handle(grad)
    with torch.cuda.device(dev):
        for i, (s0, s1) in enumerate(group.launches):
            plan = group.plan(i, aligned)
            params = group.params[i:i + 1].copy()  # the kernel writes where ``rows`` points
            params["rows"][0, :s1 - s0] = ptrs[s0:s1]
            partials = torch.empty(plan.scratch_shape, dtype=torch.float32, device=dev)
            rc = lib.persia_gather_pool_bwd(
                params.ctypes.data, grad.data_ptr(), partials.data_ptr(), _DTYPES[dtype], s1 - s0,
                group.batch, dim, n, s0, plan.bwd_vec, plan.lanes_per_pos, plan.col_tiles,
                plan.max_chunks, plans.POOL_CHUNK_WARPS, plan.chunk_grid[0], *plan.row_block,
                plan.row_grid[0], stream,
            )
            _kernels.check(rc, "gather_pool_bwd")
            gather_pool_bwd.launches += 1  # both passes: one call of the kernel pair
    return outs


def _check_grad(grad: torch.Tensor, group: _Group) -> None:
    shape = (group.batch, len(group.num_rows), group.dim)
    if grad.shape != shape or grad.dtype != torch.float32 or grad.device != group.device:
        raise ValueError(f"grad must be {shape} float32 on {group.device}")


def gather_pool_fwd(rows: Sequence[torch.Tensor], slots: Sequence[PoolSlot]) -> torch.Tensor:
    """Pooled (B, S, dim) f32 of a group of device-pooled slots. A CPU
    tensor takes the plain version; a CUDA tensor one kernel launch per 64
    slots."""
    group = _Group(rows, slots)
    if group.device.type == "cpu":
        return gather_pool_fwd_reference(rows, slots)
    return _fwd(group)


def gather_pool_bwd(
    grad: torch.Tensor, rows: Sequence[torch.Tensor], slots: Sequence[PoolSlot]
) -> List[torch.Tensor]:
    """Per-slot row gradients (P, dim) in the rows' dtype from the pooled
    gradient ``grad`` (B, S, dim) f32. A CPU tensor takes the plain
    version; a CUDA tensor two kernel launches per 64 slots (counted as
    one), which write every row once (no zeroing pass)."""
    group = _Group(rows, slots)
    _check_grad(grad, group)
    if group.device.type == "cpu":
        return gather_pool_bwd_reference(grad, rows, slots)
    return _bwd(group, grad)


gather_pool_fwd.launches = 0
gather_pool_bwd.launches = 0


class _EmbeddingPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, slots, *rows):
        ctx.group = group = _Group(rows, slots)
        if group.device.type == "cpu":
            ctx.save_for_backward(*rows)
            return gather_pool_fwd_reference(rows, slots)
        return _fwd(group)

    @staticmethod
    def backward(ctx, grad):
        group = ctx.group
        grad = grad.float()
        _check_grad(grad, group)
        if group.device.type == "cpu":
            return (None, *gather_pool_bwd_reference(grad, ctx.saved_tensors, group.slots))
        return (None, *_bwd(group, grad))


def embedding_pool(rows: Sequence[torch.Tensor], slots: Sequence[PoolSlot]) -> List[torch.Tensor]:
    """Differentiable gather-pool of a group of device-pooled slots (one
    dim, one dtype): the pooled (B, dim) f32 of each slot, views of one
    (B, S, dim) tensor. The gradient flows to each slot's rows."""
    return list(_EmbeddingPool.apply(tuple(slots), *rows).unbind(dim=1))
