"""flax's ``BatchNorm`` over (B, C) activations: the CUDA kernels K10
(forward, in train mode and with the running statistics) and K11 (its
backward), in ``csrc/batch_norm.cu`` with geometry from
``plans.batch_norm_plan``, and their plain PyTorch versions.

The reference's layer (``persia_tpu/models/dnn.py:39,41``: flax 0.12's
``nn.BatchNorm`` with ``use_fast_variance``, momentum 0.99, epsilon 1e-5)
promotes its bf16 input to f32 and, in train mode, normalises with the
batch's mean and its *biased* variance ``max(0, E[x²] − E[x]²)``, moving the
running statistics as ``ra = 0.99·ra + 0.01·batch``; with the running
statistics it normalises with them and changes nothing.
``torch.nn.BatchNorm1d`` keeps the unbiased variance in its running
statistics, computes it in two passes and counts momentum the other way,
so neither the port nor its plain version calls it.

The plain versions write the formulas out (``csrc/batch_norm.cu``'s head
lists them), expression for expression in the kernels' order; the two
differ only in the order of the column sums. ``batch_norm`` is the
differentiable entry point (one ``torch.autograd.Function`` on both
devices): a CPU tensor takes the plain versions, a CUDA tensor the kernels.
The running statistics are updated in place, once a forward, never by the
backward.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from persia_tpu_torch.ops import _kernels, plans

_DTYPES = {torch.float32: _kernels.DTYPE_F32, torch.bfloat16: _kernels.DTYPE_BF16}
MOMENTUM = 0.99  # flax's BatchNorm defaults, as dnn.py builds it
EPSILON = 1e-5


def batch_norm_fwd_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, running_mean: torch.Tensor,
                             running_var: torch.Tensor, training: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward: (y in x's dtype, saved (3, C) f32 = the mean, rstd and
    the gate of ``max(0, v)``'s derivative). In train mode the running
    statistics move in place."""
    xf = x.float()
    if training:
        n = float(x.shape[0])
        mean = xf.sum(0) / n
        v = (xf * xf).sum(0) / n - mean * mean
        gate = torch.where(v > 0, 1.0, torch.where(v == 0, 0.5, 0.0))
        var = torch.where(v < 0, 0.0, v)
        running_mean.copy_(MOMENTUM * running_mean + (1 - MOMENTUM) * mean)
        running_var.copy_(MOMENTUM * running_var + (1 - MOMENTUM) * var)
    else:
        mean, var = running_mean.clone(), running_var
        gate = torch.zeros_like(mean)
    rstd = 1.0 / torch.sqrt(var + EPSILON)
    y = ((xf - mean) * (rstd * scale) + bias).to(x.dtype)
    return y, torch.stack([mean, rstd, gate])


def batch_norm_bwd_reference(dy: torch.Tensor, x: torch.Tensor, scale: torch.Tensor, saved: torch.Tensor,
                             training: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain backward: (dx in x's dtype, dscale, dbias f32), the autodiff
    of the forward, the batch statistics' dependence on x included in
    train mode."""
    xf, d = x.float(), dy.float()
    mean, rstd, gate = saved
    xc = xf - mean
    sdy = d.sum(0)
    dm = (d * xc).sum(0)
    m = rstd * scale
    dscale = dm * rstd
    if training:
        n = float(x.shape[0])
        dv = -0.5 * (dm * scale) * (rstd * rstd * rstd) * gate
        k1 = m * sdy / n
        k2 = 2.0 * dv / n
        dx = (d * m - k1) + k2 * xc
    else:
        dx = d * m
    return dx.to(x.dtype), dscale, sdy


def _schedule_plan(x: torch.Tensor):
    return plans.batch_norm_plan(x.shape[0], x.shape[1], x.element_size(), x.data_ptr() % 16 == 0)


def _f32(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def batch_norm_fwd_schedule(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, running_mean: torch.Tensor,
                            running_var: torch.Tensor, training: bool
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K10 on the CPU, bit for bit: the plain forward with its column sums
    in the kernel's order (``plans.batch_norm_sum_model``), in numpy f32,
    whose every operation rounds once as the kernel's intrinsics do
    (PyTorch's CPU ``sqrt`` and scalar division do not always). Returns (y,
    saved, the new running mean, the new running variance); changes no
    input. CPU tensors, x contiguous."""
    plan = _schedule_plan(x)
    f32 = np.float32
    xf, rm, rv = _f32(x), _f32(running_mean), _f32(running_var)
    if training:
        n = f32(x.shape[0])
        mean = plans.batch_norm_sum_model(xf, plan) / n
        v = plans.batch_norm_sum_model(xf * xf, plan) / n - mean * mean
        gate = np.where(v > 0, f32(1), np.where(v == 0, f32(0.5), f32(0))).astype(f32)
        var = np.where(v < 0, f32(0), v)
        rm = f32(MOMENTUM) * rm + f32(1 - MOMENTUM) * mean
        rv = f32(MOMENTUM) * rv + f32(1 - MOMENTUM) * var
    else:
        mean, var, gate = rm.copy(), rv, np.zeros_like(rm)
    rstd = f32(1) / np.sqrt(var + f32(EPSILON))
    y = (xf - mean) * (rstd * _f32(scale)) + _f32(bias)
    out = [torch.from_numpy(np.ascontiguousarray(a, dtype=f32)) for a in (np.stack([mean, rstd, gate]), rm, rv)]
    return torch.from_numpy(y).to(x.dtype), *out


def batch_norm_bwd_schedule(dy: torch.Tensor, x: torch.Tensor, scale: torch.Tensor, saved: torch.Tensor,
                            training: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K11 on the CPU, bit for bit: the plain backward with its column sums
    in the kernel's order, in numpy f32. CPU tensors, x and dy contiguous."""
    plan = _schedule_plan(x)
    f32 = np.float32
    xf, d = _f32(x), _f32(dy.to(x.dtype))
    mean, rstd, gate = _f32(saved)
    sc = _f32(scale)
    xc = xf - mean
    sdy = plans.batch_norm_sum_model(d, plan)
    dm = plans.batch_norm_sum_model(d * xc, plan)
    m = rstd * sc
    k1 = k2 = np.zeros_like(m)
    if training:
        n = f32(x.shape[0])
        dv = f32(-0.5) * (dm * sc) * (rstd * rstd * rstd) * gate
        k1, k2 = m * sdy / n, f32(2) * dv / n
    dx = (d * m - k1) + k2 * xc
    return torch.from_numpy(dx).to(x.dtype), torch.from_numpy(dm * rstd), torch.from_numpy(sdy)


def _check(x: torch.Tensor, who: str, *params: torch.Tensor) -> None:
    if x.ndim != 2:
        raise ValueError(f"{who} takes (B, C) activations, got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{who} takes float32 or bfloat16 activations, got {x.dtype}")
    for p in params:
        if p.shape != (x.shape[1],) or p.dtype != torch.float32 or p.device != x.device or not p.is_contiguous():
            raise ValueError(f"{who}: every parameter and statistic is a contiguous ({x.shape[1]},) f32 tensor "
                             f"on {x.device}")


def _plan(*tensors: torch.Tensor):
    x = tensors[0]
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    return plans.batch_norm_plan(x.shape[0], x.shape[1], x.element_size(), aligned)


def batch_norm_fwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, running_mean: torch.Tensor,
                   running_var: torch.Tensor, training: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, saved) as ``batch_norm_fwd_reference`` gives them, the running
    statistics moved in place in train mode. A CPU tensor takes the plain
    version; a CUDA tensor the kernel (K10)."""
    _check(x, "batch_norm_fwd", scale, bias, running_mean, running_var)
    if x.device.type == "cpu":
        return batch_norm_fwd_reference(x, scale, bias, running_mean, running_var, training)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.shape[0] == 0:
        raise ValueError("batch_norm_fwd: an empty batch has no statistics")
    x = x.contiguous()
    y = torch.empty_like(x)
    saved = torch.empty((3, x.shape[1]), dtype=torch.float32, device=x.device)
    plan = _plan(x, y)
    with torch.cuda.device(x.device):
        rc = _kernels.library().persia_batch_norm_fwd(
            x.data_ptr(), y.data_ptr(), scale.data_ptr(), bias.data_ptr(), running_mean.data_ptr(),
            running_var.data_ptr(), saved.data_ptr(), _DTYPES[x.dtype], plan.rows, plan.cols, int(training),
            MOMENTUM, 1 - MOMENTUM, EPSILON, plan.vec, plan.groups, plan.threads, plan.grid, plan.slices,
            _kernels.stream_handle(x),
        )
    _kernels.check(rc, "batch_norm_fwd")
    batch_norm_fwd.launches += 1
    batch_norm_fwd.launches_by_route["train" if training else "eval"] += 1
    return y, saved


def batch_norm_bwd(dy: torch.Tensor, x: torch.Tensor, scale: torch.Tensor, saved: torch.Tensor, training: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dscale, dbias) of ``batch_norm_fwd``'s y from ``saved``. A CPU
    tensor takes the plain version; a CUDA tensor the kernel (K11)."""
    _check(x, "batch_norm_bwd", scale)
    if dy.shape != x.shape or dy.device != x.device or saved.shape != (3, x.shape[1]):
        raise ValueError(f"batch_norm_bwd: dy must be {tuple(x.shape)} and saved (3, {x.shape[1]}) on {x.device}")
    if x.device.type == "cpu":
        return batch_norm_bwd_reference(dy, x, scale, saved, training)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x = x.contiguous()
    dy = dy.to(x.dtype).contiguous()
    saved = saved.contiguous()
    dx = torch.empty_like(x)
    dscale = torch.empty_like(scale)
    dbias = torch.empty_like(scale)
    plan = _plan(x, dy, dx)
    with torch.cuda.device(x.device):
        rc = _kernels.library().persia_batch_norm_bwd(
            dy.data_ptr(), x.data_ptr(), scale.data_ptr(), saved.data_ptr(), dx.data_ptr(), dscale.data_ptr(),
            dbias.data_ptr(), _DTYPES[x.dtype], plan.rows, plan.cols, int(training), plan.vec, plan.groups,
            plan.threads, plan.grid, plan.slices, _kernels.stream_handle(x),
        )
    _kernels.check(rc, "batch_norm_bwd")
    batch_norm_bwd.launches += 1
    return dx, dscale, dbias


class _BatchNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, running_mean, running_var, training):
        y, saved = batch_norm_fwd(x, scale, bias, running_mean, running_var, training)
        ctx.save_for_backward(x, scale, saved)
        ctx.training = training
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, saved = ctx.saved_tensors
        dx, dscale, dbias = batch_norm_bwd(dy, x, scale, saved, ctx.training)
        return dx, dscale, dbias, None, None, None


def batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, running_mean: torch.Tensor,
               running_var: torch.Tensor, training: bool) -> torch.Tensor:
    """flax's ``BatchNorm`` over (B, C) ``x``, differentiable in x, scale
    and bias; ``training``: batch statistics, the running ones moved in
    place; else the running statistics. A CPU tensor goes through the plain
    versions, a CUDA tensor through K10 and K11."""
    return _BatchNorm.apply(x, scale, bias, running_mean, running_var, bool(training))


batch_norm_fwd.launches = 0
batch_norm_fwd.launches_by_route = {"train": 0, "eval": 0}
batch_norm_bwd.launches = 0
