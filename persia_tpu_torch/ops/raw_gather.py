"""The raw-slot gather and its scatter-add: the CUDA kernels K6 and K7
(``csrc/raw_gather.cu``, geometry from ``plans.raw_gather_plan`` and
``plans.raw_gather_bwd_plan``) and their plain PyTorch versions.

A raw (sequence) slot arrives as its distinct rows ``(P, dim)`` (f32 or
bf16, the wire dtype; P = ``round_up_pow2(D + 1)``, rows past the true
distinct count D zero) and an index ``(B, L)`` int32 whose pads point at row
P - 1. For a group of slots of one dim, one dtype and one (B, L):

- forward (``raw_gather_fwd``): ``out[s, b, l] = rows_s[index_s[b, l]]``,
  ``out`` (S, B, L, dim) in the rows' dtype;
- backward (``raw_gather_bwd``): ``grad_rows_s[r] = sum over (b, l) with
  index_s[b, l] == r of g[s, b, l]``, summed in f32 and rounded once to the
  rows' dtype, for every row but the pad row P - 1: the model masks the
  pad positions, so they are left out and that row's gradient is zero.

The reference runs both through XLA (``persia_tpu/parallel/train_step.py:
88-91``: ``diff[index]`` and its autodiff scatter-add, which sums in the wire
dtype). The kernel's backward walks the slot's CSR (row -> its positions,
ascending; ``raw_csr`` on the host, which leaves the pad row's positions
out and lists the long rows' chunks): a row's positions are summed in
stream order, a long row's chunk by chunk and then the chunk sums in
order (``plans.raw_bwd_model``). No atomics on floats, one write per row,
so two runs give the same bits, and a short row gives those of the plain
version's sequential ``index_add_``.

An index outside [0, P) raises: on the CPU at once (``index_select``),
where the batch is staged (``ctx.stage_embeddings``) before the copy, and
in the forward kernel as a device-side assert, as PyTorch's own
``index_select`` does on the card (the launch's stream then reports
``cudaErrorAssert``); the backward kernel never reads the index, and stops
the same way on a CSR entry outside the slot's positions. No kernel reads
or writes outside its tensors. The reference's ``diff[index]`` clamps
instead.

``raw_gather`` is the differentiable entry point (one
``torch.autograd.Function``): a CPU tensor takes the plain versions, a CUDA
tensor the kernels.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from persia_tpu_torch.ops import _kernels, plans
from persia_tpu_torch.ops.embedding_pool import _DTYPES, _ELEM_BYTES, _PARAMS, MAX_SLOTS, pool_csr

# the backward's parameter struct (RawBwdSlots in csrc/raw_gather.cu)
_BWD_PARAMS = np.dtype([
    ("rows", "<u8", (MAX_SLOTS,)),
    ("order", "<u8", (MAX_SLOTS,)),
    ("offsets", "<u8", (MAX_SLOTS,)),
    ("long_chunks", "<u8", (MAX_SLOTS,)),
    ("num_rows", "<i4", (MAX_SLOTS,)),
    ("long_count", "<i4", (MAX_SLOTS,)),
])


class RawSlot(NamedTuple):
    """The integer side of one raw slot (on the rows' device); the backward
    kernel needs the CSR, all three fields of ``raw_csr``."""

    index: torch.Tensor  # (B, L) int32, pads == P - 1
    order: Optional[torch.Tensor] = None  # (B*L,) int32: positions sorted by row
    offsets: Optional[torch.Tensor] = None  # (P+1,) int32: row r's span in ``order``
    long_chunks: Optional[torch.Tensor] = None  # (M, 2) int32: the long rows' (row, chunk)


def raw_csr(index: np.ndarray, rows: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(order, offsets, long_chunks) of a raw slot's (B, L) index over its
    ``rows`` rows: ``pool_csr``'s order and offsets, with the pad row
    (``rows - 1``) left empty (its positions sort last in ``order`` and lie
    past ``offsets[rows]``, so the backward kernel does not walk them), and
    the chunks the backward kernel's long blocks take: (row, chunk) int32
    pairs, (M, 2), for every row but the pad row with
    ``plans.K7_LONG_MIN`` positions or more, its ceil(n / ``K7_CHUNK``)
    chunks in order, the rows ascending."""
    order, offsets = pool_csr(index, rows)
    offsets[-1] = offsets[-2]
    lens = np.diff(offsets)[:-1]
    long_rows = np.flatnonzero(lens >= plans.K7_LONG_MIN)
    chunks = -(-lens[long_rows] // plans.K7_CHUNK)
    first = np.repeat(np.cumsum(chunks) - chunks, chunks)
    long_chunks = np.stack([np.repeat(long_rows, chunks), np.arange(first.shape[0]) - first], 1)
    return order, offsets, long_chunks.astype(np.int32)


def raw_gather_fwd_reference(rows: Sequence[torch.Tensor], slots: Sequence[RawSlot]) -> torch.Tensor:
    """Plain forward: ``index_select`` of each slot's rows; (S, B, L, dim)."""
    return torch.stack([
        r.index_select(0, s.index.reshape(-1).long()).view(*s.index.shape, r.shape[1])
        for r, s in zip(rows, slots)
    ])


def raw_gather_bwd_reference(grad: torch.Tensor, rows: Sequence[torch.Tensor],
                             slots: Sequence[RawSlot]) -> List[torch.Tensor]:
    """Plain backward: ``index_add_`` of each position's gradient in f32
    (sequential on the CPU, so in stream order), one rounding to each
    slot's row dtype; the pad row's gradient zero."""
    out = []
    for g, r, s in zip(grad, rows, slots):
        acc = torch.zeros(r.shape, dtype=torch.float32, device=r.device)
        acc.index_add_(0, s.index.reshape(-1).long(), g.reshape(-1, r.shape[1]).float())
        acc[-1] = 0.0  # the pad row P - 1: its positions are masked
        out.append(acc.to(r.dtype))
    return out


class _Group:
    """A checked group of raw slots (one device, dtype, dim and (B, L)) and
    the kernels' parameter structs, one per launch of at most 64 slots:
    each slot's index is B * L positions of one id each. The autograd
    Function builds it in the forward and reuses it in the backward, which
    adds the CSR's struct and points its ``rows`` at its outputs."""

    def __init__(self, rows: Sequence[torch.Tensor], slots: Sequence[RawSlot]):
        if not rows or len(rows) != len(slots):
            raise ValueError("need one RawSlot for each rows tensor, and at least one")
        r0 = rows[0]
        dev, dtype = r0.device, r0.dtype
        if dtype not in _DTYPES:
            raise TypeError(f"raw_gather takes float32 or bfloat16 rows, got {dtype}")
        if r0.dim() != 2:
            raise ValueError("a raw group needs (P, dim) rows")
        dim, shape = r0.shape[1], tuple(slots[0].index.shape)
        if len(shape) != 2:
            raise ValueError(f"a raw slot's index must be (B, L), got {shape}")
        i32 = torch.int32
        ptrs, index, num_rows = [], [], []
        for r, slot in zip(rows, slots):
            if (r.dtype is not dtype or r.device != dev or not r.is_contiguous() or r.dim() != 2
                    or r.shape[1] != dim):
                raise ValueError("a raw group needs contiguous (P, dim) rows of one device, dtype and dim")
            idx = slot.index
            if idx.dtype is not i32 or idx.device != dev or not idx.is_contiguous() or tuple(idx.shape) != shape:
                raise ValueError("a raw slot's index must be a contiguous (B, L) int32 on the rows' device, "
                                 "one (B, L) for the group")
            ptrs.append(r.data_ptr())
            index.append(idx.data_ptr())
            num_rows.append(r.shape[0])
        self.device, self.dtype, self.dim, self.shape = dev, dtype, dim, shape
        self.positions = shape[0] * shape[1]
        self.slots = slots
        self.num_rows = num_rows
        self.rows_aligned = all(p % 16 == 0 for p in ptrs)
        self.launches = [(s0, min(len(rows), s0 + MAX_SLOTS)) for s0 in range(0, len(rows), MAX_SLOTS)]
        self.params = np.zeros(len(self.launches), _PARAMS)
        for i, (s0, s1) in enumerate(self.launches):
            for field, values in (("rows", ptrs), ("index", index), ("num_rows", num_rows)):
                self.params[field][i, :s1 - s0] = values[s0:s1]
            self.params["ids_per_sample"][i, :s1 - s0] = 1
        self._csr = False

    def add_csr(self) -> None:
        """Check each slot's CSR (order, offsets, long_chunks) and fill the
        backward's parameter structs."""
        if self._csr:
            return
        i32, dev = torch.int32, self.device
        self.bwd_params = np.zeros(len(self.launches), _BWD_PARAMS)
        self.long_counts = []
        fields = {"order": [], "offsets": [], "long_chunks": []}
        for slot, p in zip(self.slots, self.num_rows):
            o, f, c = slot.order, slot.offsets, slot.long_chunks
            if o is None or f is None or c is None:
                raise ValueError("raw_gather_bwd needs each slot's CSR (order, offsets, long_chunks: raw_csr)")
            if any(t.dtype is not i32 or t.device != dev or not t.is_contiguous() for t in (o, f, c)):
                raise ValueError("a slot's CSR must be contiguous int32 on the rows' device")
            if o.numel() != self.positions or f.numel() != p + 1 or c.dim() != 2 or c.shape[1] != 2:
                raise ValueError("a slot's CSR does not match its index and rows")
            for name, t in zip(fields, (o, f, c)):
                fields[name].append(t.data_ptr())
            self.long_counts.append(c.shape[0])
        for i, (s0, s1) in enumerate(self.launches):
            for name, values in (*fields.items(), ("num_rows", self.num_rows), ("long_count", self.long_counts)):
                self.bwd_params[name][i, :s1 - s0] = values[s0:s1]
        self._csr = True


def _fwd(group: _Group) -> torch.Tensor:
    if group.device.type != "cuda":
        raise ValueError(f"unsupported device {group.device}")
    n = len(group.num_rows)
    out = torch.empty((n, *group.shape, group.dim), dtype=group.dtype, device=group.device)
    if out.numel() == 0:
        return out
    lib = _kernels.library()
    stream = _kernels.stream_handle(out)
    elem = _ELEM_BYTES[group.dtype]
    with torch.cuda.device(group.device):
        for i, (s0, s1) in enumerate(group.launches):
            plan = plans.raw_gather_plan(group.positions, s1 - s0, group.dim, elem, group.rows_aligned)
            rc = lib.persia_raw_gather_fwd(
                group.params[i:].ctypes.data, out.data_ptr(), elem, s1 - s0, group.positions, group.dim, n, s0,
                plan.unit_bytes, plan.threads, plan.grid[0], stream,
            )
            _kernels.check(rc, "raw_gather_fwd")
            raw_gather_fwd.launches += 1
    return out


def _bwd(group: _Group, grad: torch.Tensor) -> List[torch.Tensor]:
    if group.device.type != "cuda":
        raise ValueError(f"unsupported device {group.device}")
    group.add_csr()
    grad = grad.contiguous()
    n, dim, dtype, dev = len(group.num_rows), group.dim, group.dtype, group.device
    if group.positions * dim == 0:
        return [torch.zeros((p, dim), dtype=dtype, device=dev) for p in group.num_rows]
    outs = [torch.empty((p, dim), dtype=dtype, device=dev) for p in group.num_rows]
    aligned = grad.data_ptr() % 16 == 0
    lib = _kernels.library()
    stream = _kernels.stream_handle(grad)
    with torch.cuda.device(dev):
        for i, (s0, s1) in enumerate(group.launches):
            plan = plans.raw_gather_bwd_plan(s1 - s0, dim, _ELEM_BYTES[dtype], max(group.num_rows[s0:s1]),
                                             max(group.long_counts[s0:s1]), aligned)
            params = group.bwd_params[i:i + 1].copy()  # the kernel writes where ``rows`` points
            params["rows"][0, :s1 - s0] = [o.data_ptr() for o in outs[s0:s1]]
            # the long rows' ticket counters start at 0: a memset, only where a slot lists long rows
            scratch = torch.zeros(plan.scratch_ints, dtype=torch.int32, device=dev) if plan.long_blocks else None
            rc = lib.persia_raw_gather_bwd(
                params.ctypes.data, grad.data_ptr(), None if scratch is None else scratch.data_ptr(),
                _DTYPES[dtype], s1 - s0, group.positions, dim, n, s0, plan.vec, plan.lanes, plan.threads,
                plan.short_blocks, plan.long_blocks, plan.tile_rows, plan.smem_bytes, stream,
            )
            _kernels.check(rc, "raw_gather_bwd")
            raw_gather_bwd.launches += 1
    return outs


def _check_grad(grad: torch.Tensor, group: _Group) -> None:
    shape = (len(group.num_rows), *group.shape, group.dim)
    if tuple(grad.shape) != shape or grad.dtype != group.dtype or grad.device != group.device:
        raise ValueError(f"grad must be {shape} {group.dtype} on {group.device}")


def raw_gather_fwd(rows: Sequence[torch.Tensor], slots: Sequence[RawSlot]) -> torch.Tensor:
    """Gathered (S, B, L, dim) rows of a group of raw slots, in the rows'
    dtype. A CPU tensor takes the plain version; a CUDA tensor one kernel
    launch per 64 slots."""
    group = _Group(rows, slots)
    if group.device.type == "cpu":
        return raw_gather_fwd_reference(rows, slots)
    return _fwd(group)


def raw_gather_bwd(grad: torch.Tensor, rows: Sequence[torch.Tensor], slots: Sequence[RawSlot]) -> List[torch.Tensor]:
    """Per-slot row gradients (P, dim) in the rows' dtype from the gathered
    rows' gradient ``grad`` (S, B, L, dim), same dtype; the pad row P - 1
    zero. A CPU tensor takes the plain version; a CUDA tensor one kernel
    launch per 64 slots, which walks each slot's CSR (``raw_csr``) and
    writes every row once."""
    group = _Group(rows, slots)
    _check_grad(grad, group)
    if group.device.type == "cpu":
        return raw_gather_bwd_reference(grad, rows, slots)
    return _bwd(group, grad)


raw_gather_fwd.launches = 0
raw_gather_bwd.launches = 0


class _RawGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, slots, *rows):
        ctx.group = group = _Group(rows, slots)
        if group.device.type == "cpu":
            ctx.save_for_backward(*rows)
            return raw_gather_fwd_reference(rows, slots)
        return _fwd(group)

    @staticmethod
    def backward(ctx, grad):
        group = ctx.group
        _check_grad(grad, group)
        if group.device.type == "cpu":
            return (None, *raw_gather_bwd_reference(grad, ctx.saved_tensors, group.slots))
        return (None, *_bwd(group, grad))


def raw_gather(rows: Sequence[torch.Tensor], slots: Sequence[RawSlot]) -> List[torch.Tensor]:
    """Differentiable gather of a group of raw slots (one dim, dtype and
    (B, L)): each slot's (B, L, dim) rows, views of one (S, B, L, dim)
    tensor. The gradient flows to each slot's rows."""
    return list(_RawGather.apply(tuple(slots), *rows).unbind(dim=0))
