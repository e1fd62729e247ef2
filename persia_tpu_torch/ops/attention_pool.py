"""DIN's masked attention pool: the CUDA kernels K8 and K9
(``csrc/attention_pool.cu``, geometry from ``plans.attention_pool_plan``)
and their plain PyTorch versions.

For logits (B, L) f32, a mask (B, L) bool and history rows (B, L, dim) in
the model's compute dtype T (bf16 or f32), as the reference writes it
(``persia_tpu/models/din.py:67-72``):

    w = softmax(where(any_valid, where(mask, logits, -inf), 0)) over L
    w = where(mask, w, 0)                       # f32
    out[b] = sum_l T(w[b, l]) * hist[b, l]      # f32 sum, rounded to T

so a row with no valid position pools to 0. The backward is the VJP of
those ops as ``jax.grad`` takes it: ``d_hist = T(T(w) * d_out)``; ``g =
T(d_out . hist)`` where mask, else 0; ``d_logits = w * (g - sum_l w g)``
where mask, else 0: zero, never NaN, at masked positions and on
all-masked rows.

``attention_pool`` is the differentiable entry point (one
``torch.autograd.Function``, saving the f32 weights): a CPU tensor takes
the plain versions, a CUDA tensor the kernels.
"""

from __future__ import annotations

from typing import Tuple

import torch

from persia_tpu_torch.ops import _kernels, plans

_DTYPES = {torch.float32: _kernels.DTYPE_F32, torch.bfloat16: _kernels.DTYPE_BF16}


def attention_pool_fwd_reference(logits: torch.Tensor, mask: torch.Tensor, hist: torch.Tensor
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward, the reference's ops transcribed: (out (B, dim) in
    hist's dtype, w (B, L) f32)."""
    dt = hist.dtype
    masked = torch.where(mask, logits, float("-inf"))
    any_valid = mask.any(dim=1, keepdim=True)
    w = torch.softmax(torch.where(any_valid, masked, 0.0), dim=1)
    w = torch.where(mask, w, 0.0)
    out = torch.einsum("bl,bld->bd", w.to(dt).float(), hist.float()).to(dt)
    return out, w


def attention_pool_bwd_reference(d_out: torch.Tensor, mask: torch.Tensor, hist: torch.Tensor, w: torch.Tensor
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain backward: (d_logits (B, L) f32, d_hist (B, L, dim) in hist's
    dtype)."""
    dt = hist.dtype
    d_out = d_out.float()
    d_hist = (w.to(dt).float()[:, :, None] * d_out[:, None, :]).to(dt)
    g = torch.einsum("bd,bld->bl", d_out, hist.float()).to(dt).float()
    g = torch.where(mask, g, 0.0)
    s = (w * g).sum(dim=1, keepdim=True)
    d_logits = torch.where(mask, w * (g - s), 0.0)
    return d_logits, d_hist


def _check(logits: torch.Tensor, mask: torch.Tensor, hist: torch.Tensor) -> None:
    if hist.dtype not in _DTYPES or hist.dim() != 3:
        raise TypeError(f"attention_pool takes (B, L, dim) float32 or bfloat16 history, got {hist.dtype} "
                        f"{tuple(hist.shape)}")
    b, l, _ = hist.shape
    if logits.dtype != torch.float32 or tuple(logits.shape) != (b, l):
        raise ValueError(f"logits must be ({b}, {l}) float32")
    if mask.dtype != torch.bool or tuple(mask.shape) != (b, l):
        raise ValueError(f"mask must be ({b}, {l}) bool")
    if not (logits.device == mask.device == hist.device):
        raise ValueError("logits, mask and history must lie on one device")


def _plan(hist: torch.Tensor, *others: torch.Tensor) -> plans.AttentionPoolPlan:
    b, l, dim = hist.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in (hist, *others))
    return plans.attention_pool_plan(b, l, dim, hist.element_size(), aligned)


def _fwd(logits: torch.Tensor, mask: torch.Tensor, hist: torch.Tensor):
    if hist.device.type != "cuda":
        raise ValueError(f"unsupported device {hist.device}")
    logits, mask, hist = logits.contiguous(), mask.contiguous(), hist.contiguous()
    b, l, dim = hist.shape
    out = torch.empty((b, dim), dtype=hist.dtype, device=hist.device)
    w = torch.empty((b, l), dtype=torch.float32, device=hist.device)
    if hist.numel() == 0:
        return out.zero_(), w.zero_()
    plan = _plan(hist, out)
    with torch.cuda.device(hist.device):
        rc = _kernels.library().persia_attention_pool_fwd(
            logits.data_ptr(), mask.data_ptr(), hist.data_ptr(), out.data_ptr(), w.data_ptr(), _DTYPES[hist.dtype],
            b, l, dim, plan.vec, plan.lanes, plan.warps, plan.grid, _kernels.stream_handle(hist),
        )
    _kernels.check(rc, "attention_pool_fwd")
    attention_pool_fwd.launches += 1
    return out, w


def _bwd(d_out: torch.Tensor, mask: torch.Tensor, hist: torch.Tensor, w: torch.Tensor):
    if hist.device.type != "cuda":
        raise ValueError(f"unsupported device {hist.device}")
    d_out, mask, hist, w = (t.contiguous() for t in (d_out, mask, hist, w))
    b, l, dim = hist.shape
    d_hist = torch.empty_like(hist)
    d_logits = torch.empty((b, l), dtype=torch.float32, device=hist.device)
    if hist.numel() == 0:
        return d_logits.zero_(), d_hist
    plan = _plan(hist, d_hist, d_out)
    with torch.cuda.device(hist.device):
        rc = _kernels.library().persia_attention_pool_bwd(
            d_out.data_ptr(), mask.data_ptr(), hist.data_ptr(), w.data_ptr(), d_hist.data_ptr(),
            d_logits.data_ptr(), _DTYPES[hist.dtype], b, l, dim, plan.vec, plan.lanes, plan.warps, plan.grid,
            plan.bwd_smem, _kernels.stream_handle(hist),
        )
    _kernels.check(rc, "attention_pool_bwd")
    attention_pool_bwd.launches += 1
    return d_logits, d_hist


def _check_bwd(d_out: torch.Tensor, hist: torch.Tensor, w: torch.Tensor) -> None:
    b, l, dim = hist.shape
    if d_out.dtype != hist.dtype or tuple(d_out.shape) != (b, dim) or d_out.device != hist.device:
        raise ValueError(f"d_out must be ({b}, {dim}) {hist.dtype} on {hist.device}")
    if w.dtype != torch.float32 or tuple(w.shape) != (b, l) or w.device != hist.device:
        raise ValueError(f"w must be ({b}, {l}) float32 on {hist.device}")


def attention_pool_fwd(logits: torch.Tensor, mask: torch.Tensor, hist: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pooled (B, dim) in hist's dtype, weights (B, L) f32). A CPU tensor
    takes the plain version; a CUDA tensor one kernel launch."""
    _check(logits, mask, hist)
    if hist.device.type == "cpu":
        return attention_pool_fwd_reference(logits, mask, hist)
    return _fwd(logits, mask, hist)


def attention_pool_bwd(d_out: torch.Tensor, mask: torch.Tensor, hist: torch.Tensor, w: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d_logits (B, L) f32, d_hist (B, L, dim) in hist's dtype) from the
    pooled rows' gradient and the forward's weights. A CPU tensor takes the
    plain version; a CUDA tensor one kernel launch."""
    _check_bwd(d_out, hist, w)
    if hist.device.type == "cpu":
        return attention_pool_bwd_reference(d_out, mask, hist, w)
    return _bwd(d_out, mask, hist, w)


attention_pool_fwd.launches = 0
attention_pool_bwd.launches = 0


class _AttentionPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, mask, hist):
        out, w = attention_pool_fwd(logits, mask, hist)
        ctx.save_for_backward(mask, hist, w)
        return out

    @staticmethod
    def backward(ctx, d_out):
        mask, hist, w = ctx.saved_tensors
        d_logits, d_hist = attention_pool_bwd(d_out.to(hist.dtype), mask, hist, w)
        return d_logits, None, d_hist


def attention_pool(logits: torch.Tensor, mask: torch.Tensor, hist: torch.Tensor) -> torch.Tensor:
    """Differentiable masked attention pool: (B, dim) in hist's dtype; the
    gradient flows to ``logits`` and ``hist``."""
    return _AttentionPool.apply(logits, mask, hist)
