"""The cache tier's gather-pool: the CUDA kernel K13
(``csrc/cached_gather.cu``) and its plain PyTorch version.

For one cache group's table (C+1, dim) f32 or bf16 (the pool's dtype),
whose row C is the zero pad, and int32 cache rows: each position's row
(``table[rows]``, clamped into the table as XLA's gather clamps, a bf16
row widened to f32), its mask ``rows != C``, and:

- ``pool=True``, rows (S, B, L): the masked sum over L in order, times the
  optional ``scale`` (S, B): (S, B, dim) f32, what the reference's
  ``_model_emb_from_gathered`` makes of ``tables[g][rows]``
  (``persia_tpu/embedding/hbm_cache/groups.py:160-193``);
- ``pool=False``, rows (B, L): the rows (B, L, dim) unmasked and the mask
  (B, L) bool, a raw slot's model input;
- ``miss_table`` (M, dim) f32 (eval): a row > C reads
  ``miss_table[row - (C+1)]`` rounded to the table's dtype
  (``_gather_ext``, ``step.py:435-440``);
- ``keys=True`` (training): also each position's update key, flat int32,
  the row where row < C and K5's ``INT32_MAX`` sentinel for the pad, so the
  step passes ``sparse_update`` routed keys and no mask.

Every output is f32: a bf16 pool is pooled in f32, where the reference
sums and scales the bf16 rows in bf16 (a departure of the pooled value
within the bf16 rounding of the sum and of the scale; the tests pin it).

``PooledRows`` makes the pooled output of a training step differentiable:
its backward writes the per-position gradients (S·B·L, dim) f32, ``g``
times the scale expanded over L, for ``sparse_update`` (a masked position's
gradient goes to the sentinel's row, which nothing updates). For a bf16
pool the gradient is rounded where the reference's is: ``g`` to bf16,
times the scale rounded to bf16, the product rounded to bf16 (the
reference differentiates with respect to the bf16 gathered rows, so its
cotangents are bf16).

A CPU table takes the plain version; a CUDA table one launch a call
(``cached_gather.launches``), a thread 4 columns of the table's row where
dim and the pointers allow.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from persia_tpu_torch.ops import _kernels

_INT32_MAX = int(np.iinfo(np.int32).max)
_DTYPES = {torch.float32: _kernels.DTYPE_F32, torch.bfloat16: _kernels.DTYPE_BF16}


def _values(table: torch.Tensor, rows: torch.Tensor, miss_table: Optional[torch.Tensor]) -> torch.Tensor:
    C = table.shape[0] - 1
    r = rows.long()
    from_cache = table[r.clamp(0, C)].float()
    if miss_table is None:
        return from_cache
    from_miss = miss_table[(r - (C + 1)).clamp(0, miss_table.shape[0] - 1)].to(table.dtype).float()
    return torch.where((r > C)[..., None], from_miss, from_cache)


def update_keys_of(rows: torch.Tensor, C: int) -> torch.Tensor:
    """Flat int32 update keys: the row where 0 <= row < C, else the
    sentinel."""
    r = rows.reshape(-1)
    return torch.where((r >= 0) & (r < C), r, torch.full_like(r, _INT32_MAX)).to(torch.int32)


def cached_gather_reference(table, rows, pool=True, scale=None, keys=False, miss_table=None):
    """Plain version: index (widened to f32), mask, sum over L, scale."""
    C = table.shape[0] - 1
    got = _values(table, rows, miss_table)
    mask = rows != C
    if pool:
        out = (got * mask[..., None].to(got.dtype)).sum(dim=2)
        if scale is not None:
            out = out * scale[..., None].to(out.dtype)
        res = (out,)
    else:
        res = (got, mask)
    return res + (update_keys_of(rows, C),) if keys else (res[0] if pool else res)


def _check(table, rows, pool, scale, miss_table) -> None:
    dev = table.device
    if table.dtype not in _DTYPES or table.dim() != 2 or not table.is_contiguous() or table.shape[0] < 1:
        raise ValueError("cached_gather needs a contiguous (C+1, dim) float32 or bfloat16 table")
    if table.shape[0] - 1 > _INT32_MAX:
        raise ValueError("the cache's rows must fit int32")
    if rows.dtype != torch.int32 or rows.device != dev or not rows.is_contiguous() or rows.dim() != (3 if pool else 2):
        raise ValueError(f"rows must be contiguous {'(S, B, L)' if pool else '(B, L)'} int32 on {dev}")
    if rows.shape[-1] < 1:
        raise ValueError("rows need at least one position a sample")
    if scale is not None:
        if not pool:
            raise ValueError("scale applies to pooled rows only")
        if scale.dtype != torch.float32 or scale.device != dev or not scale.is_contiguous() \
                or scale.shape != rows.shape[:2]:
            raise ValueError(f"scale must be contiguous {tuple(rows.shape[:2])} float32")
    if miss_table is not None and (miss_table.dtype != torch.float32 or miss_table.device != dev
                                   or not miss_table.is_contiguous() or miss_table.dim() != 2
                                   or miss_table.shape[1] != table.shape[1] or miss_table.shape[0] < 1):
        raise ValueError("miss_table must be contiguous (M >= 1, dim) float32")


def cached_gather(table: torch.Tensor, rows: torch.Tensor, pool: bool = True, scale: Optional[torch.Tensor] = None,
                  keys: bool = False, miss_table: Optional[torch.Tensor] = None):
    """``pool``: the pooled (S, B, dim); else ``(rows (B, L, dim), mask (B,
    L))``; with ``keys`` the flat update keys last: ``(pooled, keys)`` or
    ``(rows, mask, keys)``."""
    _check(table, rows, pool, scale, miss_table)
    if table.device.type == "cpu":
        return cached_gather_reference(table, rows, pool, scale, keys, miss_table)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    dim = table.shape[1]
    L = rows.shape[-1]
    samples = rows.numel() // L
    dev = table.device
    out = torch.empty(rows.shape[:-1] + (dim,) if pool else rows.shape + (dim,), dtype=torch.float32, device=dev)
    key_out = torch.empty(rows.numel(), dtype=torch.int32, device=dev) if keys else None
    mask = None if pool else torch.empty(rows.shape, dtype=torch.bool, device=dev)
    lib = _kernels.library()
    with torch.cuda.device(dev):
        rc = lib.persia_cached_gather(
            table.data_ptr(), _DTYPES[table.dtype], table.shape[0], dim,
            miss_table.data_ptr() if miss_table is not None else None,
            miss_table.shape[0] if miss_table is not None else 0,
            rows.data_ptr(), samples, L, scale.data_ptr() if scale is not None else None, int(pool),
            out.data_ptr(), key_out.data_ptr() if keys else None, mask.data_ptr() if mask is not None else None,
            _kernels.stream_handle(table),
        )
    _kernels.check(rc, "cached_gather")
    cached_gather.launches += 1
    res = (out,) if pool else (out, mask)
    return res + (key_out,) if keys else (out if pool else res)


cached_gather.launches = 0


def per_position_grads(g: torch.Tensor, L: int, scale: Optional[torch.Tensor] = None,
                       bf16: bool = False) -> torch.Tensor:
    """The pooled rows' backward: (S, B, dim) ``g`` times the scale,
    repeated over the L positions, as (S·B·L, dim) f32 (a view at L=1).
    ``bf16`` (a bf16 pool): ``g``, the scale and their product each
    rounded to bf16, as the reference's bf16 cotangents are."""
    if bf16:
        g = g.to(torch.bfloat16)
        if scale is not None:
            g = g * scale[..., None].to(torch.bfloat16)
    g = g.float()
    if scale is not None and not bf16:
        g = g * scale[..., None]
    return g[:, :, None, :].expand(g.shape[0], g.shape[1], L, g.shape[2]).reshape(-1, g.shape[2])


class PooledRows(torch.autograd.Function):
    """``PooledRows.apply(anchor, table, rows, scale, sink)``: the pooled
    rows (``cached_gather`` with keys) as a differentiable output. The
    update keys land in ``sink["keys"]`` at the forward, the per-position
    gradients in ``sink["grads"]`` at the backward. ``anchor`` is any
    tensor that requires a gradient (it gets none): it makes the output
    part of the graph."""

    @staticmethod
    def forward(ctx, anchor, table, rows, scale, sink: Dict):
        pooled, keys = cached_gather(table, rows, pool=True, scale=scale, keys=True)
        sink["keys"] = keys
        ctx.sink = sink
        ctx.L = rows.shape[-1]
        ctx.save_for_backward(scale if scale is not None else torch.empty(0))
        ctx.has_scale = scale is not None
        ctx.bf16 = table.dtype == torch.bfloat16
        return pooled

    @staticmethod
    def backward(ctx, g):
        (scale,) = ctx.saved_tensors
        ctx.sink["grads"] = per_position_grads(g, ctx.L, scale if ctx.has_scale else None, ctx.bf16)
        return None, None, None, None, None
