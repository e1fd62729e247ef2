"""The dense ring's block-scaled int8 wire: the CUDA kernels K16
(``block_quantize_int8``), K17 (``block_dequantize_int8``) and the ring
hop's two folded into one pass (``block_requantize_int8``) of
``csrc/block_int8.cu``, each beside its plain PyTorch version.

``block_quantize_int8(v, block_size, ef=None, err=None)`` quantizes a flat
f32 vector (its length a multiple of ``block_size``) a block at a time,
with the ring's error feedback ``x = v + ef`` where ``ef`` is given:

    scale = max(max |x|, 1e-30)            a block
    t     = clip(round(x / scale * 127), -127, 127)   (q = t as int8)
    err   = x - t * (scale / 127)

each quotient, product and sum rounded on its own, ``round`` half to even:
``persia_tpu/parallel/grad_sync.py``'s ``block_quantize_int8`` with the
ring's error (``payload - deq``). Returns ``(q int8, scales f32, err
f32)``; ``err`` (a contiguous f32 tensor like ``v``) receives the error
where given, else a new tensor does.

``block_dequantize_int8(q, scales, block_size, n=1, roll=0, base=None,
ef=None, out=None)`` takes ``n`` rows of codes (``q`` (n * chunk,)) and
their scales, and writes row j's ``q * (scale / 127)`` at chunk ``(j +
roll) % n`` of ``out``, added to ``base`` (and ``ef``, first) at the same
place where given: one ring hop's ``cur + deq`` (``n`` 1, ``out`` may be
``base``), or the all-gather's rows in chunk order (``roll`` 1).

``block_requantize_int8(q_in, sc_in, base, ef, block_size, err=None,
write_acc=False)`` is a hop's accumulate of one received row into
``base`` (``ef`` added first where given) and the quantize of that sum
without feedback, in one pass: ``block_dequantize_int8`` then
``block_quantize_int8``, bit for bit. Returns ``(q, scales, err)``; the
sum is written back to ``base`` only with ``write_acc``.

A CPU tensor takes the plain version; a CUDA tensor one launch a call
(``<wrapper>.launches``). ``plans.block_int8_plan`` and
``plans.block_dequant_plan`` choose each kernel's plan by the block size;
on the warp and vector plans every tensor must start on a 16-byte
boundary (the codes of the warp plan on one of the largest power of two
dividing 4 V bytes), as rows of a fresh tensor do.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from persia_tpu_torch.ops import _kernels, plans


def _c127(device) -> torch.Tensor:
    return torch.full((), 127.0, dtype=torch.float32, device=device)


def block_quantize_int8_reference(v: torch.Tensor, block_size: int, ef: Optional[torch.Tensor] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: ``(q, scales, err)``. Every division is tensor by
    tensor (PyTorch's CUDA division by a Python scalar multiplies by its
    reciprocal, another rounding)."""
    x = v if ef is None else v + ef
    blocks = x.reshape(-1, block_size)
    scales = torch.clamp_min(blocks.abs().amax(dim=1), 1e-30)
    t = torch.clamp(torch.round(blocks / scales[:, None] * 127.0), -127, 127)
    q = t.to(torch.int8)
    err = blocks - t * (scales / _c127(v.device))[:, None]
    return q.reshape(-1), scales, err.reshape(-1)


def block_dequantize_int8_reference(q: torch.Tensor, scales: torch.Tensor, block_size: int, n: int = 1,
                                    roll: int = 0, base: Optional[torch.Tensor] = None,
                                    ef: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: a new (n * chunk,) tensor."""
    rows = (q.reshape(n, -1, block_size).float() * (scales.reshape(n, -1) / _c127(q.device))[:, :, None]).reshape(n, -1)
    rows = torch.roll(rows, roll, dims=0).reshape(-1)
    if base is None:
        return rows
    return ((base if ef is None else base + ef) + rows)


def block_requantize_int8_reference(q_in: torch.Tensor, sc_in: torch.Tensor, base: torch.Tensor,
                                    ef: Optional[torch.Tensor], block_size: int
                                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: K17's then K16's, ``(q, scales, err, the sum)``."""
    x = block_dequantize_int8_reference(q_in, sc_in, block_size, base=base, ef=ef)
    return (*block_quantize_int8_reference(x, block_size), x)


def _check_f32(t: Optional[torch.Tensor], numel: int, device: torch.device, name: str) -> None:
    if t is not None and (t.dtype != torch.float32 or t.shape != (numel,) or t.device != device
                          or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous ({numel},) float32 tensor on {device}")


def _check_aligned(plan: plans.BlockInt8Plan, codes_bytes: int, **tensors: Optional[torch.Tensor]) -> None:
    """The warp and vector plans' 16-byte accesses (the codes' accesses of
    ``codes_bytes`` a thread, as words of up to 16 bytes)."""
    if plan.vec == 0:
        return
    for name, t in tensors.items():
        need = codes_bytes & -codes_bytes if t is not None and t.dtype == torch.int8 else 16
        if t is not None and t.data_ptr() % need:
            raise ValueError(f"{name} must start on a {need}-byte boundary on the vector plan")


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


def block_quantize_int8(v: torch.Tensor, block_size: int, ef: Optional[torch.Tensor] = None,
                        err: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(q, scales, err)``; see the module's docstring."""
    if v.dim() != 1 or v.dtype != torch.float32 or not v.is_contiguous():
        raise ValueError("v must be a contiguous (L,) float32 tensor")
    if v.numel() % block_size:
        raise ValueError(f"the length {v.numel()} is no multiple of the block size {block_size}")
    _check_f32(ef, v.numel(), v.device, "ef")
    _check_f32(err, v.numel(), v.device, "err")
    if v.device.type == "cpu":
        q, scales, e = block_quantize_int8_reference(v, block_size, ef)
        if err is None:
            return q, scales, e
        err.copy_(e)
        return q, scales, err
    if v.device.type != "cuda":
        raise ValueError(f"unsupported device {v.device}")
    blocks = v.numel() // block_size
    plan = plans.block_int8_plan(block_size, blocks)
    q = torch.empty(v.shape, dtype=torch.int8, device=v.device)
    scales = torch.empty(blocks, dtype=torch.float32, device=v.device)
    if err is None:
        err = torch.empty_like(v)
    _check_aligned(plan, 4 * plan.vec, v=v, ef=ef, err=err)
    with torch.cuda.device(v.device):
        rc = _kernels.library().persia_block_int8_quantize(
            v.data_ptr(), _ptr(ef), blocks, block_size, q.data_ptr(), scales.data_ptr(), err.data_ptr(), plan.vec,
            plan.grid, plan.threads, _kernels.stream_handle(v))
    _kernels.check(rc, "block_quantize_int8")
    block_quantize_int8.launches += 1
    return q, scales, err


block_quantize_int8.launches = 0


def block_dequantize_int8(q: torch.Tensor, scales: torch.Tensor, block_size: int, n: int = 1, roll: int = 0,
                          base: Optional[torch.Tensor] = None, ef: Optional[torch.Tensor] = None,
                          out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (n * chunk,) f32 result (``out`` where given); see the module's
    docstring."""
    if q.dim() != 1 or q.dtype != torch.int8 or not q.is_contiguous() or q.numel() % (n * block_size):
        raise ValueError(f"q must be a contiguous int8 vector of n * chunk elements, chunk a multiple of {block_size}")
    if scales.dtype != torch.float32 or scales.numel() * block_size != q.numel() or not scales.is_contiguous():
        raise ValueError(f"scales must be {q.numel() // block_size} contiguous float32 values")
    if not 0 <= roll < max(n, 1):
        raise ValueError(f"roll must lie in [0, {n})")
    if ef is not None and base is None:
        raise ValueError("ef is added to base: pass base with it")
    for t, name in ((base, "base"), (ef, "ef"), (out, "out")):
        _check_f32(t, q.numel(), q.device, name)
    if q.device.type == "cpu":
        res = block_dequantize_int8_reference(q, scales, block_size, n, roll, base, ef)
        if out is None:
            return res
        out.copy_(res)
        return out
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    plan = plans.block_dequant_plan(block_size, q.numel())
    if out is None:
        out = torch.empty(q.numel(), dtype=torch.float32, device=q.device)
    _check_aligned(plan, 16, q=q, base=base, ef=ef, out=out)
    chunk = q.numel() // n
    with torch.cuda.device(q.device):
        rc = _kernels.library().persia_block_int8_dequantize(
            q.data_ptr(), scales.data_ptr(), n, chunk, block_size, roll, _ptr(base), _ptr(ef), out.data_ptr(),
            plan.vec, plan.grid, plan.threads, _kernels.stream_handle(q))
    _kernels.check(rc, "block_dequantize_int8")
    block_dequantize_int8.launches += 1
    return out


block_dequantize_int8.launches = 0


def block_requantize_int8(q_in: torch.Tensor, sc_in: torch.Tensor, base: torch.Tensor, ef: Optional[torch.Tensor],
                          block_size: int, err: Optional[torch.Tensor] = None, write_acc: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(q, scales, err)`` of ``(base + ef) + dequantized(q_in, sc_in)``;
    see the module's docstring."""
    if base.dim() != 1 or base.dtype != torch.float32 or not base.is_contiguous():
        raise ValueError("base must be a contiguous (L,) float32 tensor")
    if base.numel() % block_size:
        raise ValueError(f"the length {base.numel()} is no multiple of the block size {block_size}")
    numel, dev = base.numel(), base.device
    if q_in.dtype != torch.int8 or q_in.shape != (numel,) or q_in.device != dev or not q_in.is_contiguous():
        raise ValueError(f"q_in must be a contiguous ({numel},) int8 tensor on {dev}")
    if sc_in.dtype != torch.float32 or sc_in.shape != (numel // block_size,) or sc_in.device != dev \
            or not sc_in.is_contiguous():
        raise ValueError(f"sc_in must be {numel // block_size} contiguous float32 values on {dev}")
    _check_f32(ef, numel, dev, "ef")
    _check_f32(err, numel, dev, "err")
    if dev.type == "cpu":
        q, scales, e, x = block_requantize_int8_reference(q_in, sc_in, base, ef, block_size)
        if write_acc:
            base.copy_(x)
        if err is None:
            return q, scales, e
        err.copy_(e)
        return q, scales, err
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    blocks = numel // block_size
    plan = plans.block_int8_plan(block_size, blocks)
    q = torch.empty(numel, dtype=torch.int8, device=dev)
    scales = torch.empty(blocks, dtype=torch.float32, device=dev)
    if err is None:
        err = torch.empty_like(base)
    _check_aligned(plan, 4 * plan.vec, q_in=q_in, base=base, ef=ef, err=err)
    with torch.cuda.device(dev):
        rc = _kernels.library().persia_block_requantize_int8(
            q_in.data_ptr(), sc_in.data_ptr(), base.data_ptr(), _ptr(ef), blocks, block_size, q.data_ptr(),
            scales.data_ptr(), err.data_ptr(), base.data_ptr() if write_acc else None, plan.vec, plan.grid,
            plan.threads, _kernels.stream_handle(base))
    _kernels.check(rc, "block_requantize_int8")
    block_requantize_int8.launches += 1
    return q, scales, err


block_requantize_int8.launches = 0
