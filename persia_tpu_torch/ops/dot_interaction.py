"""DLRM dot interaction: the CUDA kernel (``csrc/dot_interaction.cu``, its
geometry from ``plans.dot_plan``) and its plain PyTorch version.

``feats (B, n, d)`` → ``(B, n(n-1)/2)``: the strict upper triangle of
``feats @ feats^T`` per row, in ``triu_indices(n, k=1)`` row-major pair
order, accumulated in f32 and written in the input's dtype. The reference
leaves this to XLA (``persia_tpu/models/dlrm.py:49-53``).
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


def dot_interaction(feats: torch.Tensor) -> torch.Tensor:
    """Pairwise dots of the n feature vectors of each row. A CPU tensor goes
    through the plain version; a CUDA tensor through the kernel."""
    if feats.ndim != 3:
        raise ValueError(f"expected feats (B, n, d), got shape {tuple(feats.shape)}")
    if feats.device.type == "cpu":
        return dot_interaction_reference(feats)
    if feats.device.type != "cuda":
        raise ValueError(f"unsupported device {feats.device}")
    if feats.dtype not in _DTYPES:
        raise TypeError(f"dot_interaction takes float32 or bfloat16, got {feats.dtype}")
    if not feats.is_contiguous():
        raise ValueError("dot_interaction needs a contiguous (B, n, d) tensor")
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


dot_interaction.launches = 0
