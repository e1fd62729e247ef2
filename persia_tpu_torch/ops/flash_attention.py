"""Flash attention forward: CUDA kernels and their plain PyTorch versions.

Counterpart of ``persia_tpu/ops/flash_attention.py`` (the repo's one Pallas
kernel). The public layout stays the reference's ``[B, L, H, D]``. The
route is chosen by dtype, explicitly:

- bf16 → ``csrc/flash_attention_hopper.cu`` (``wgmma_bf16``): TMA-fed
  tiles read in place, both products on the tensor cores, P rounded to
  bf16 before P·V;
- f32 → ``csrc/flash_attention_tf32.cu`` (``tf32x3``): both products on the
  tensor cores in split TF32, x = hi + lo with hi = tf32(x), lo = tf32(x -
  hi), a·b taken as hi·hi + hi·lo + lo·hi with f32 sums (~2^-22 relative;
  one TF32 pass would lose ~2^-11 and miss the f32 tolerance). A pre-pass
  kernel (``tf32_split_planes``) writes the hi/lo planes the main kernel's
  TMA loads; its plain version is ``tf32_split_planes_reference``, built on
  ``tf32_split``.

``flash_attention.launches`` counts every launch of the main kernels and
``flash_attention.launches_by_route`` each route's;
``tf32_split_planes.launches`` counts the pre-pass. The plain version of
the whole is ``reference_attention``, the dense f32 softmax of
``persia_tpu/parallel/sequence.py:126-135,184-188``.

The backward is the reference's (``persia_tpu/ops/flash_attention.py:130-149``):
a dense recompute, the gradient of ``reference_attention`` at the saved q, k
and v. On the card it runs in plain PyTorch and launches no kernel of its
own.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from persia_tpu_torch.ops import _kernels, plans

_NEG_BIG = -1e30
ROUTES = {torch.bfloat16: "wgmma_bf16", torch.float32: "tf32x3"}
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


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 (the low 13 bits of its pattern zero), to
    nearest with ties away from zero, as ``cvt.rna.tf32.f32`` rounds: half
    an ulp (bit 12) is added to the magnitude, whose carry may reach the
    exponent (up to inf), and the low 13 bits are cut. ±0, inf and nan pass
    through."""
    bits = x.float().contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF  # sign-magnitude: ties round away from zero
    return torch.where(torch.isfinite(x), rounded.view(torch.float32), x.float())


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x = hi + lo to about 2^-22 relative: hi = tf32(x), lo = tf32(x - hi)
    (x - hi is exact in f32). The pre-pass kernel's arithmetic."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def tf32_split_planes_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the pre-pass: q, k, v [B, L, H, D] f32 → qk [4, B*H,
    L_pad, D] (q_hi, q_lo, k_hi, k_lo) and vt [2, B*H, D, L_pad] (v_hi,
    v_lo, keys innermost, each group of 8 in ``plans.TF32_KEY_ORDER``),
    rows past L zero (``plans.tf32_plan`` gives L_pad)."""
    _check_shapes(q, k, v)
    b, l, h, d = q.shape
    pad = plans.tf32_plan(b, l, h, d, False).seq_pad - l

    def rows(x):  # [B, L, H, D] -> [B*H, L_pad, D]
        x = x.float().permute(0, 2, 1, 3).reshape(b * h, l, d)
        return torch.nn.functional.pad(x, (0, 0, 0, pad))

    qk = torch.stack([*tf32_split(rows(q)), *tf32_split(rows(k))])
    # each group of 8 keys as (0, 2, 4, 6, 1, 3, 5, 7), made on the device
    # (no host copy, so the function can be captured in a CUDA graph)
    keys = torch.arange(l + pad, device=v.device).view(-1, 4, 2).transpose(1, 2).reshape(-1)
    vt = rows(v)[:, keys].transpose(1, 2).contiguous()
    return qk, torch.stack(tf32_split(vt))


def tf32_split_planes(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split-TF32 planes of q, k, v (layout: ``tf32_split_planes_reference``).
    A CPU tensor goes through the plain version; a CUDA tensor through the
    pre-pass kernel."""
    _check_shapes(q, k, v)
    if q.device.type == "cpu":
        return tf32_split_planes_reference(q, k, v)
    _check_cuda_inputs(q, k, v, (torch.float32,))
    b, l, h, d = q.shape
    p = plans.tf32_plan(b, l, h, d, False)
    qk_shape, vt_shape = p.plane_shapes
    qk = torch.empty(qk_shape, device=q.device, dtype=torch.float32)
    vt = torch.empty(vt_shape, device=q.device, dtype=torch.float32)
    with torch.cuda.device(q.device):
        rc = _kernels.library().persia_tf32_split(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), qk.data_ptr(), vt.data_ptr(),
            b, l, h, d, p.seq_pad, _kernels.stream_handle(q),
        )
    _kernels.check(rc, "tf32_split_planes")
    tf32_split_planes.launches += 1
    return qk, vt


tf32_split_planes.launches = 0


def route_tolerance(v: torch.Tensor) -> Tuple[float, float]:
    """(rtol, atol) to which a kernel's output is held against
    ``reference_attention`` on the same inputs; the route follows v's dtype.

    - f32 (``tf32x3``): (1e-4, 1e-4). Three TF32 passes per product lose
      about 2^-22 relative (the dropped lo·lo term and the rounding of lo),
      far inside 1e-4; beyond that only the order of the f32 sums differs.
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


def _check_shapes(q, k, v) -> None:
    if q.ndim != 4:
        raise ValueError(f"expected [B, L, H, D], got shape {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v must share one [B, L, H, D] shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )


def _check_cuda_inputs(q, k, v, dtypes) -> None:
    """Raise on what the kernels do not take: another device or dtype, a
    head dim without a kernel, a grid too tall, strided tensors."""
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must lie on one device")
    if q.dtype not in dtypes or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"the flash-attention kernels take q, k, v of one dtype in {dtypes}, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    b, l, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention supports head dims {HEAD_DIMS}, got {d}")
    if b * h > 65535:
        raise ValueError(f"flash_attention: B*H = {b * h} exceeds the grid limit 65535")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous [B, L, H, D] tensors")


class _FlashAttention(torch.autograd.Function):
    """The card's forward kernels with the reference's backward: the
    gradient of ``reference_attention`` at the caller's (q, k, v, scale)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        return _launch(q, k, v, causal, scale)

    @staticmethod
    def backward(ctx, grad):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = reference_attention(*leaves, causal=ctx.causal, scale=ctx.scale)
            dq, dk, dv = torch.autograd.grad(out, leaves, grad)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Tiled attention: q, k, v [B, L, H, D] → [B, L, H, D]. A CPU tensor
    goes through the plain version; a CUDA tensor through the kernels. Both
    are differentiable in q, k and v."""
    _check_shapes(q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return reference_attention(q, k, v, causal=causal, scale=scale)
    _check_cuda_inputs(q, k, v, tuple(ROUTES))
    return _FlashAttention.apply(q, k, v, bool(causal), float(scale))


def _launch(q, k, v, causal: bool, scale: float) -> torch.Tensor:
    """The forward kernels on checked CUDA inputs."""
    b, l, h, d = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    route = ROUTES[q.dtype]
    if scale <= 0:
        # the kernels take the row max of unscaled scores, so they need
        # scale > 0; the same softmax: (-q)·k·(-scale), or 0·k·1 for 0
        q, scale = (-q, -scale) if scale < 0 else (torch.zeros_like(q), 1.0)
    lib = _kernels.library()
    shape = (b, l, h, d, float(scale), int(causal))
    if route == "tf32x3":
        qk, vt = tf32_split_planes(q, k, v)
    with torch.cuda.device(q.device):
        stream = _kernels.stream_handle(q)
        if route == "wgmma_bf16":
            p = plans.flash_plan(b, l, h, d, causal)
            rc = lib.persia_flash_attention_fwd_wgmma(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *shape,
                p.grid, p.q_tiles, p.block_q, p.block_k, p.stages, p.box_cols,
                p.swizzle_bytes, p.smem_bytes, stream,
            )
        else:
            p = plans.tf32_plan(b, l, h, d, causal)
            rc = lib.persia_flash_attention_fwd_tf32x3(
                qk.data_ptr(), vt.data_ptr(), out.data_ptr(), *shape,
                p.grid, p.q_tiles, p.block_q, p.block_k, p.stages, p.seq_pad, p.box_cols,
                p.swizzle_bytes, p.smem_bytes, stream,
            )
    _kernels.check(rc, f"flash_attention ({route})")
    flash_attention.launches += 1
    flash_attention.launches_by_route[route] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_route = {route: 0 for route in ROUTES.values()}
