"""The cache tier's restore: the CUDA kernel K14 (``csrc/restore_rows.cu``)
and its plain PyTorch version.

For one cache group's table (C+1, dim) f32 and its optimizer state columns
(as ``ops.cache_aux``), what the reference's ``_restore_rows``
(``persia_tpu/embedding/hbm_cache/groups.py:250-256``, through
``_scatter_entry_block``, ``:225-236``) computes: the entries
``ring[src_idx]`` (``[emb | state]``, f32 or bf16: the write-back wire)
written to the rows ``dst_rows`` of the table and of each state, widened to
f32. A ``dst_row`` outside [0, C] is dropped, as ``mode="drop"`` drops it
(the host pads with C+1); a source outside the ring is clamped, as XLA's
gather clamps it (the host pads with 0).

The stream's hazard gate concatenates a step's restores of a group into one
call (``tier._admit_aux``). That is the reference's function only while no
``dst_row`` repeats within the call; the directory gives each miss its own
row, so none does, and the plain version checks it on CPU tensors and
raises.

A CPU table takes the plain version. A CUDA table launches one kernel a
call that has rows (none for a call without), which adds one to
``restore_rows.launches``.
"""

from __future__ import annotations

from typing import Dict

import torch

from persia_tpu_torch.ops import _kernels
from persia_tpu_torch.ops.cache_aux import (
    _DTYPES,
    _aligned,
    _check,
    _pool_args,
    _states,
    _write_rows,
    entry_state_cols,
)
from persia_tpu_torch.ops.plans import cache_entry_vec


def check_distinct_rows(num_rows: int, dst_rows: torch.Tensor) -> None:
    """Raise ``ValueError`` when a row inside [0, num_rows) repeats."""
    live = dst_rows.long()[(dst_rows >= 0) & (dst_rows < num_rows)]
    if live.numel() and bool(torch.bincount(live, minlength=num_rows).gt(1).any()):
        raise ValueError("a restore row repeats within one call: the concatenated restores are not the reference's")


def restore_rows_reference(table: torch.Tensor, state: Dict[str, torch.Tensor], ring: torch.Tensor,
                           src_idx: torch.Tensor, dst_rows: torch.Tensor) -> None:
    """Plain version of ``restore_rows``: a gather and ``index_put_``s, in
    place. On CPU tensors it first checks that no row repeats."""
    if table.device.type == "cpu":
        check_distinct_rows(table.shape[0], dst_rows)
    entries = ring[src_idx.long().clamp(0, ring.shape[0] - 1)].float()
    dim = table.shape[1]
    _write_rows(table, dst_rows, entries[:, :dim])
    for key, cols in entry_state_cols(state, entries[:, dim:]).items():
        _write_rows(state[key], dst_rows, cols)


def restore_rows(table: torch.Tensor, state: Dict[str, torch.Tensor], ring: torch.Tensor, src_idx: torch.Tensor,
                 dst_rows: torch.Tensor) -> None:
    """``table`` and ``state`` rows ``dst_rows`` = ``ring[src_idx]``, in
    place (the module's docstring). ``ring`` (ring_rows, dim + state_dim)
    f32 or bf16; ``src_idx`` and ``dst_rows`` (n,) int32, contiguous, on the
    table's device."""
    dim = table.shape[1]
    width = dim + sum(s.shape[1] for s in _states(state))
    states = _check(table, state, [(src_idx, None, 0), (dst_rows, None, 0)])
    if src_idx.shape != dst_rows.shape:
        raise ValueError(f"src_idx {tuple(src_idx.shape)} and dst_rows {tuple(dst_rows.shape)} differ")
    if (ring.dtype not in _DTYPES or ring.device != table.device or not ring.is_contiguous() or ring.dim() != 2
            or ring.shape[1] != width or ring.shape[0] < 1):
        raise ValueError(f"ring must be contiguous (>= 1, {width}) float32 or bfloat16 on the table's device")
    if table.device.type == "cpu":
        return restore_rows_reference(table, state, ring, src_idx, dst_rows)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    vec = cache_entry_vec([dim] + [s.shape[1] for s in states], ring.dtype == torch.bfloat16,
                          _aligned(table, *states, ring))
    lib = _kernels.library()
    with torch.cuda.device(table.device):
        rc = lib.persia_restore_rows(*_pool_args(table, states), vec, ring.data_ptr(), ring.shape[0],
                                     _DTYPES[ring.dtype], src_idx.data_ptr(), dst_rows.data_ptr(), dst_rows.shape[0],
                                     _kernels.stream_handle(table))
    _kernels.check(rc, "restore_rows")
    if dst_rows.shape[0]:
        restore_rows.launches += 1


restore_rows.launches = 0
