"""DLRM dot interaction and its backward: the CUDA kernels
(``csrc/dot_interaction.cu``, geometry from ``plans.dot_plan`` and
``plans.dot_bwd_plan``) and their plain PyTorch versions.

Forward: ``feats (B, n, d)`` → ``(B, n(n-1)/2)``, the strict upper triangle
of ``feats @ feats^T`` per row, in ``triu_indices(n, k=1)`` row-major pair
order, accumulated in f32 and written in the input's dtype.

Backward: with ``g (B, n(n-1)/2)`` the gradient of that output and G the
symmetric n × n matrix that holds g(i, j) at (i, j) and (j, i) with a zero
diagonal, ``dfeats[b, i] = sum_{j != i} G[b, i, j] feats[b, j]``,
accumulated in f32 and written in the input's dtype.

The reference leaves both to XLA (``persia_tpu/models/dlrm.py:48-53`` and
its autodiff). ``dot_interaction`` is differentiable on both devices: a CPU
tensor goes through the plain einsum (PyTorch's autograd), a CUDA tensor
through a ``torch.autograd.Function`` whose forward and backward are the
kernels.
"""

from __future__ import annotations

import torch

from persia_tpu_torch.ops import _kernels, plans

_DTYPES = {torch.float32: _kernels.DTYPE_F32, torch.bfloat16: _kernels.DTYPE_BF16}


def dot_interaction_reference(feats: torch.Tensor) -> torch.Tensor:
    """Plain version: f32 einsum, triangle gather, one rounding to the
    input dtype."""
    n = feats.shape[1]
    iu, ju = torch.triu_indices(n, n, offset=1, device=feats.device)
    f = feats.float()
    inter = torch.einsum("bnd,bmd->bnm", f, f)
    return inter[:, iu, ju].to(feats.dtype)


def dot_interaction_bwd_reference(feats: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """Plain backward: PyTorch's autograd of ``dot_interaction_reference``
    (f32 inside, one rounding to the input dtype)."""
    with torch.enable_grad():
        x = feats.detach().requires_grad_(True)
        (dx,) = torch.autograd.grad(dot_interaction_reference(x), x, grad)
    return dx


def _check(feats: torch.Tensor, who: str) -> None:
    if feats.dtype not in _DTYPES:
        raise TypeError(f"{who} takes float32 or bfloat16, got {feats.dtype}")
    if not feats.is_contiguous():
        raise ValueError(f"{who} needs a contiguous (B, n, d) tensor")


def _launch_fwd(feats: torch.Tensor) -> torch.Tensor:
    _check(feats, "dot_interaction")
    b, n, d = feats.shape
    out = torch.empty((b, n * (n - 1) // 2), dtype=feats.dtype, device=feats.device)
    if out.numel() == 0:
        return out
    plan = plans.dot_plan(b, n, d, feats.element_size())
    if plan.rows_per_block == 0:
        raise ValueError(f"dot_interaction: one row of (n={n}, d={d}) exceeds shared memory")
    with torch.cuda.device(feats.device):
        rc = _kernels.library().persia_dot_interaction(
            feats.data_ptr(), out.data_ptr(), b, n, d, _DTYPES[feats.dtype], int(plan.mma),
            plan.rows_per_block, plan.feat_stride, plan.smem_bytes,
            _kernels.stream_handle(feats),
        )
    _kernels.check(rc, "dot_interaction")
    dot_interaction.launches += 1
    return out


def dot_interaction_bwd(feats: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """Gradient of ``dot_interaction`` with respect to ``feats``. A CPU
    tensor takes the plain version; a CUDA tensor the kernel."""
    if feats.ndim != 3:
        raise ValueError(f"expected feats (B, n, d), got shape {tuple(feats.shape)}")
    b, n, d = feats.shape
    if grad.shape != (b, n * (n - 1) // 2) or grad.device != feats.device:
        raise ValueError(f"grad must be ({b}, {n * (n - 1) // 2}) on {feats.device}")
    if feats.device.type == "cpu":
        return dot_interaction_bwd_reference(feats, grad)
    if feats.device.type != "cuda":
        raise ValueError(f"unsupported device {feats.device}")
    _check(feats, "dot_interaction_bwd")
    grad = grad.to(feats.dtype).contiguous()
    out = torch.empty_like(feats)
    if out.numel() == 0:
        return out
    plan = plans.dot_bwd_plan(b, n, d, feats.element_size())
    if plan.rows_per_block == 0:
        raise ValueError(f"dot_interaction_bwd: one row of (n={n}, d={d}) exceeds shared memory")
    with torch.cuda.device(feats.device):
        rc = _kernels.library().persia_dot_interaction_bwd(
            feats.data_ptr(), grad.data_ptr(), out.data_ptr(), b, n, d, _DTYPES[feats.dtype],
            int(plan.mma), plan.rows_per_block, plan.threads, plan.smem_bytes,
            _kernels.stream_handle(feats),
        )
    _kernels.check(rc, "dot_interaction_bwd")
    dot_interaction_bwd.launches += 1
    return out


class _DotInteraction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats):
        ctx.save_for_backward(feats)
        return _launch_fwd(feats)

    @staticmethod
    def backward(ctx, grad):
        (feats,) = ctx.saved_tensors
        return dot_interaction_bwd(feats, grad)


def dot_interaction(feats: torch.Tensor) -> torch.Tensor:
    """Pairwise dots of the n feature vectors of each row, differentiable. A
    CPU tensor goes through the plain version; a CUDA tensor through the
    kernel (and its backward through ``dot_interaction_bwd``)."""
    if feats.ndim != 3:
        raise ValueError(f"expected feats (B, n, d), got shape {tuple(feats.shape)}")
    if feats.device.type == "cpu":
        return dot_interaction_reference(feats)
    if feats.device.type != "cuda":
        raise ValueError(f"unsupported device {feats.device}")
    return _DotInteraction.apply(feats)


dot_interaction.launches = 0
dot_interaction_bwd.launches = 0
