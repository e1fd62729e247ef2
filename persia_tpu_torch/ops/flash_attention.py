"""Flash attention forward: the CUDA kernel (``csrc/flash_attention.cu``)
and its plain PyTorch version.

Counterpart of ``persia_tpu/ops/flash_attention.py`` (the repo's one Pallas
kernel). The public layout stays the reference's ``[B, L, H, D]``; the
kernel reads it strided, so there is no transpose or padding copy. The
plain version is ``reference_attention``, the dense f32 softmax of
``persia_tpu/parallel/sequence.py:126-135,184-188``. The backward (a dense
recompute in the reference) comes with the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from persia_tpu_torch.ops import _kernels

_NEG_BIG = -1e30
_DTYPES = {torch.float32: _kernels.DTYPE_F32, torch.bfloat16: _kernels.DTYPE_BF16}
HEAD_DIMS = (16, 32, 64, 128)


def reference_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain softmax attention, q, k, v [B, L, H, D], f32 throughout, the
    output cast to q's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bqhk", q.float(), k.float()) * scale
    if causal:
        lq, lk = s.shape[1], s.shape[3]
        mask = torch.arange(lk, device=s.device)[None, :] <= torch.arange(lq, device=s.device)[:, None]
        s = torch.where(mask[None, :, None, :], s, torch.full_like(s, _NEG_BIG))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqhk,bkhd->bqhd", p, v.float()).to(q.dtype)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Tiled attention: q, k, v [B, L, H, D] → [B, L, H, D]. A CPU tensor
    goes through the plain version; a CUDA tensor through the kernel."""
    if q.ndim != 4:
        raise ValueError(f"expected [B, L, H, D], got shape {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v must share one [B, L, H, D] shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return reference_attention(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must lie on one device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention takes float32 or bfloat16 q, k, v of one dtype, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    b, l, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention supports head dims {HEAD_DIMS}, got {d}")
    if b * h > 65535:
        raise ValueError(f"flash_attention: B*H = {b * h} exceeds the grid limit 65535")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous [B, L, H, D] tensors")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        rc = _kernels.library().persia_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, l, h, d, float(scale), int(bool(causal)), _DTYPES[q.dtype],
            _kernels.stream_handle(q),
        )
    _kernels.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
