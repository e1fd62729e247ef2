"""Flash attention forward: two CUDA kernels and their plain PyTorch
version.

Counterpart of ``persia_tpu/ops/flash_attention.py`` (the repo's one Pallas
kernel). The public layout stays the reference's ``[B, L, H, D]``; the
kernels read it in place, so there is no transpose or padding copy. The
route is chosen by dtype, explicitly:

- bf16 → ``csrc/flash_attention_hopper.cu`` (``wgmma_bf16``): TMA-fed
  tiles, both products on the tensor cores, P rounded to bf16 before P·V;
- f32 → ``csrc/flash_attention.cu`` (``fma_f32``): the f32 FMA pipes, which
  keep the reference's f32 numerics (TF32 tensor cores would not).

``flash_attention.launches`` counts every launch and
``flash_attention.launches_by_route`` each route's. The plain version is
``reference_attention``, the dense f32 softmax of
``persia_tpu/parallel/sequence.py:126-135,184-188``. The backward (a dense
recompute in the reference) comes with the training slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from persia_tpu_torch.ops import _kernels, plans

_NEG_BIG = -1e30
ROUTES = {torch.bfloat16: "wgmma_bf16", torch.float32: "fma_f32"}
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


def route_tolerance(v: torch.Tensor) -> Tuple[float, float]:
    """(rtol, atol) to which a kernel's output is held against
    ``reference_attention`` on the same inputs; the route follows v's dtype.

    - f32 (``fma_f32``): (1e-4, 1e-4). Both sides compute in f32; only the
      order of the sums differs.
    - bf16 (``wgmma_bf16``): rtol 2^-7 covers the one bf16 rounding of the
      output on each side. atol is 1e-3 + 2^-9 * max|v|: the kernel rounds
      each probability to bf16 before P.V (relative error <= 2^-9), which
      moves an output by at most 2^-9 * sum(p|v|) / sum(p) <= 2^-9 * max|v|.
      Over many keys these errors average out; on a row that attends to a
      few keys (the first rows under ``causal``) they do not.
    """
    if v.dtype == torch.float32:
        return 1e-4, 1e-4
    return 2 ** -7, 1e-3 + 2 ** -9 * float(v.float().abs().max())


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
    if q.dtype not in ROUTES or k.dtype != q.dtype or v.dtype != q.dtype:
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
    route = ROUTES[q.dtype]
    if route == "wgmma_bf16" and scale <= 0:
        # the kernel takes the row max of unscaled scores, so it needs
        # scale > 0; the same softmax: (-q)·k·(-scale), or 0·k·1 for 0
        q, scale = (-q, -scale) if scale < 0 else (torch.zeros_like(q), 1.0)
    lib = _kernels.library()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, l, h, d,
            float(scale), int(bool(causal)))
    with torch.cuda.device(q.device):
        stream = _kernels.stream_handle(q)
        if route == "wgmma_bf16":
            p = plans.flash_plan(b, l, h, d, causal)
            rc = lib.persia_flash_attention_fwd_wgmma(
                *args, p.grid, p.q_tiles, p.block_q, p.block_k, p.stages, p.box_cols,
                p.swizzle_bytes, p.smem_bytes, stream,
            )
        else:
            rc = lib.persia_flash_attention_fwd_fma(*args, -(-l // plans.fma_rows(d)), stream)
    _kernels.check(rc, f"flash_attention ({route})")
    flash_attention.launches += 1
    flash_attention.launches_by_route[route] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_route = {route: 0 for route in ROUTES.values()}
