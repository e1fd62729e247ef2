"""The fused tier's grouped row gather: the CUDA kernel K4
(``csrc/fused_gather.cu``) and its plain PyTorch version.

For one table (V, dim), f32 or bf16, and a group of slots, each with its
ids (B,) or (B, L) int32 (-1 = padding), its first row ``offset`` in the
table and its ``vocab``: the rows every position names, slot after slot,
as one (sum of B·L, dim) tensor in the table's dtype. What
``jnp.take`` computes in the reference:

- stacked (``persia_tpu/parallel/fused_step.py:242-270``): an id < 0 reads
  the table's row 0 (the mask is applied later, in the model inputs), an
  id >= vocab the slot's own last row, any other id row ``offset + id``;
- unstacked (``:145-152``, one slot, offset 0): an id < 0 reads row 0 and
  an id >= vocab gives a row of NaN, ``take``'s "fill" mode.

With ``keys=True`` the same launch also writes each position's update key
(``update_keys_reference``: id + offset for an id in the slot's [0, vocab),
else the ``INT32_MAX`` sentinel), the fused step's routing for K5.

A CPU table takes the plain version; a CUDA table one launch per group of
at most 128 slots.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

from persia_tpu_torch.ops import _kernels

MAX_SLOTS = 128
_DTYPES = {torch.float32: _kernels.DTYPE_F32, torch.bfloat16: _kernels.DTYPE_BF16}
_INT32_MAX = int(np.iinfo(np.int32).max)

# ``GatherSlots`` of csrc/fused_gather.cu, passed by value
_PARAMS = np.dtype([
    ("ids", "<u8", (MAX_SLOTS,)),
    ("start", "<i4", (MAX_SLOTS + 1,)),
    ("offset", "<i4", (MAX_SLOTS,)),
    ("vocab", "<i4", (MAX_SLOTS,)),
])


def gather_rows(ids: torch.Tensor, offset: int, vocab: int, stacked: bool) -> torch.Tensor:
    """The table row each position reads (int64, flattened); for the
    unstacked path an id >= vocab is left as it is (the caller fills NaN)."""
    i = ids.reshape(-1).long()
    if stacked:
        return torch.where(i >= 0, torch.clamp(i, max=vocab - 1) + offset, torch.zeros_like(i))
    return torch.where(i >= 0, i, torch.zeros_like(i))


def update_ids(ids: torch.Tensor, offset: int, vocab: int) -> torch.Tensor:
    """The table row each position's gradient updates (int32, flattened),
    for ``sparse_update``: padding and ids outside the slot's [0, vocab)
    go to the ``INT32_MAX`` sentinel, which updates no row (in a stacked
    table they must not write a neighbouring slot's rows)."""
    i = ids.reshape(-1)
    return torch.where((i >= 0) & (i < vocab), i + offset, _INT32_MAX).to(torch.int32)


def update_keys_reference(ids: Sequence[torch.Tensor], offsets: Sequence[int], vocabs: Sequence[int]) -> torch.Tensor:
    """Plain version of the update keys: each slot's ``update_ids``,
    concatenated."""
    return torch.cat([update_ids(i, o, v) for i, o, v in zip(ids, offsets, vocabs)])


def fused_gather_reference(
    table: torch.Tensor, ids: Sequence[torch.Tensor], offsets: Sequence[int],
    vocabs: Sequence[int], stacked: bool = True,
) -> torch.Tensor:
    """Plain version: clamp, offset and ``table[idx]``."""
    rows = torch.cat([gather_rows(i, o, v, stacked) for i, o, v in zip(ids, offsets, vocabs)])
    if stacked:
        return table[rows]
    oob = rows >= table.shape[0]
    out = table[torch.where(oob, torch.zeros_like(rows), rows)]
    out[oob] = float("nan")
    return out


def _check(table, ids, offsets, vocabs, keys: bool) -> int:
    if table.dtype not in _DTYPES or table.dim() != 2 or not table.is_contiguous():
        raise ValueError("fused_gather needs a contiguous (V, dim) float32 or bfloat16 table")
    if not ids or not (len(ids) == len(offsets) == len(vocabs)):
        raise ValueError("need ids, an offset and a vocab for each slot, and at least one slot")
    total = 0
    for i, o, v in zip(ids, offsets, vocabs):
        if i.dtype != torch.int32 or i.device != table.device or not i.is_contiguous():
            raise ValueError("a slot's ids must be contiguous int32 on the table's device")
        if v < 1 or o < 0 or o + v > table.shape[0]:
            raise ValueError(f"slot rows [{o}, {o + v}) outside the table's {table.shape[0]}")
        if keys and o + v > _INT32_MAX:
            raise ValueError(f"slot rows [{o}, {o + v}) must lie in [0, {_INT32_MAX}) for update keys")
        total += i.numel()
    if total > _INT32_MAX:
        raise ValueError("a group's positions must fit int32")
    return total


def fused_gather(
    table: torch.Tensor, ids: Sequence[torch.Tensor], offsets: Sequence[int],
    vocabs: Sequence[int], stacked: bool = True, keys: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """(sum of B·L, dim) rows in the table's dtype, slot after slot; with
    ``keys``, ``(rows, keys)``: the positions' flat int32 update keys in
    the same order, from the same launch."""
    total = _check(table, ids, offsets, vocabs, keys)
    if table.device.type == "cpu":
        rows = fused_gather_reference(table, ids, offsets, vocabs, stacked)
        return (rows, update_keys_reference(ids, offsets, vocabs)) if keys else rows
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    out = torch.empty((total, table.shape[1]), dtype=table.dtype, device=table.device)
    key_out = torch.empty(total, dtype=torch.int32, device=table.device) if keys else None
    if total == 0:
        return (out, key_out) if keys else out
    lib = _kernels.library()
    stream = _kernels.stream_handle(table)
    pos = 0
    with torch.cuda.device(table.device):
        for s0 in range(0, len(ids), MAX_SLOTS):
            part = range(s0, min(len(ids), s0 + MAX_SLOTS))
            params = np.zeros(1, _PARAMS)
            counts = [ids[s].numel() for s in part]
            params["ids"][0, :len(part)] = [ids[s].data_ptr() for s in part]
            params["start"][0, 1:len(part) + 1] = np.cumsum(counts)
            params["offset"][0, :len(part)] = [offsets[s] for s in part]
            params["vocab"][0, :len(part)] = [vocabs[s] for s in part]
            n = sum(counts)
            rc = lib.persia_fused_gather(
                table.data_ptr(), _DTYPES[table.dtype], table.shape[0], table.shape[1],
                params.ctypes.data, len(part), int(stacked), out[pos:].data_ptr(),
                key_out[pos:].data_ptr() if keys else None, stream,
            )
            _kernels.check(rc, "fused_gather")
            fused_gather.launches += 1
            pos += n
    return (out, key_out) if keys else out


fused_gather.launches = 0
