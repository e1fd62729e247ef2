"""The int8 gradient wire of the cache tier's parameter-server slots: the
CUDA kernel K15 (``csrc/quantize_int8.cu``) and its plain PyTorch version.

Absmax int8 quantization with error feedback, a scale a segment (one PS
slot's gradient: (B, dim) host-pooled, (P, dim) device-pooled or raw),
over the step's gradients flattened into one (n,) tensor, f32 or bf16:

    v = g + residual;  scale = max(max |v|, 1e-30)
    q = clip(round(v / scale * 127), -127, 127) as int8
    new residual = v - q * (scale / 127)

each division and product rounded on its own, ``round`` half to even. It
is ``persia_tpu/parallel/grad_sync.py``'s ``quantize_int8_ef`` applied a
segment at a time, as ``persia_tpu/embedding/hbm_cache/step.py:361-415``
applies it. ``offsets`` (S+1 ascending ints from 0 to n) bound the
segments. Returns ``(q (n,) int8, scales (S,) f32, new residual (n,)
f32)``: the plain version makes a new residual, the kernel writes it over
``residual`` in place and returns that tensor.

Under the dynamic loss scale the step passes ``inv`` and ``finite``, f32
scalars on the device (nothing is read on the host): ``inv`` is 1 / the
loss scale on a finite step and 0 on an overflow, ``finite`` 1 or 0. The
gradients are then unscaled on the device, ``v = g * inv + residual``
(``g * inv`` exact: the scale is a power of two), and the scales carry
``finite`` as their tail, (S+1,). On an overflow step the codes and the
scales are 0 and the residual is left as it was; the host drops that
step's gradients, so only a finite step's scales are ever applied.

At a shared scale (the dense bytegrad all-reduce, ``persia_tpu/parallel/
grad_sync.py``'s ``bytegrad_allreduce``): ``segment_absmax(g, residual,
offsets)`` gives each segment's ``max(max |g + residual|, 1e-30)``, which
the caller all-reduces with MAX; ``quantize_int8_ef_shared(g, residual,
offsets, scale)`` then codes each segment at ``max(scale[s], 1e-30)``
(``scale`` an (S,) f32 tensor on the device) instead of its own maximum:
the same codes and residual as above at that scale, the codes as int32,
which the sum on the wire takes.

A CPU tensor takes the plain version; a CUDA tensor one launch a call
(``quantize_int8_ef.launches``, ``segment_absmax.launches``,
``quantize_int8_ef_shared.launches``), at most ``MAX_SEGMENTS`` segments.
K15 runs in the geometry of ``plans.quantize_int8_plan`` (a cluster of
blocks a segment); its two dense-sync modes are flat passes over the
whole vector (``plans.flat_quant_plan``, a span of it a CTA, one wave of
the SMs), ``segment_absmax`` combining the CTAs' maxima by atomics in a
scratch of ``MAX_SEGMENTS + 1`` words that the kernel leaves zeroed: the
wrapper keeps one for each (device, stream), and in a CUDA graph one for
each (device, stream, capture) (see ``_absmax_scratch``).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Sequence, Tuple

import torch

from persia_tpu_torch.ops import _kernels, plans

MAX_SEGMENTS = plans.QUANT_MAX_SEGMENTS  # kMaxQuantSegments in csrc/quantize_int8.cu


def quantize_int8_ef_reference(g: torch.Tensor, residual: torch.Tensor, offsets: Sequence[int],
                               inv: Optional[torch.Tensor] = None, finite: Optional[torch.Tensor] = None,
                               scale: Optional[torch.Tensor] = None,
                               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: the reference's function a segment at a time (at
    ``scale[s]`` where given), after the unscale ``g * inv`` where given; with ``finite`` the codes, the
    residual and the scales selected by it (no host read) and ``finite``
    appended to the scales. Every division is tensor by tensor: PyTorch's
    CUDA division by a Python scalar multiplies by its reciprocal, which is
    not the same rounding."""
    v = (g.float() if inv is None else g.float() * inv) + residual
    q = torch.empty(v.shape, dtype=torch.int8, device=v.device)
    new = torch.empty_like(v)
    scales = torch.empty(len(offsets) - 1, dtype=torch.float32, device=v.device)
    c127 = torch.full((), 127.0, dtype=torch.float32, device=v.device)
    for s, (a, b) in enumerate(zip(offsets[:-1], offsets[1:])):
        seg = v[a:b]
        if scale is not None:
            m = scale[s]
        else:
            m = seg.abs().amax() if b > a else torch.zeros((), dtype=torch.float32, device=v.device)
        sc = torch.clamp_min(m, 1e-30)
        t = torch.clamp(torch.round(seg / sc * 127.0), -127, 127)
        q[a:b] = t.to(torch.int8)
        new[a:b] = seg - t * (sc / c127)
        scales[s] = sc
    if finite is None:
        return q, scales, new
    ok = finite > 0.5
    q = torch.where(ok, q, torch.zeros_like(q))
    new = torch.where(ok, new, residual)
    scales = torch.cat([torch.where(ok, scales, torch.zeros_like(scales)), finite.reshape(1).float()])
    return q, scales, new


def _check(g, residual, offsets, inv=None, finite=None) -> None:
    if (inv is None) != (finite is None):
        raise ValueError("pass inv and finite together, or neither")
    for t in (inv, finite):
        if t is not None and (t.dtype != torch.float32 or t.numel() != 1 or t.device != g.device):
            raise ValueError(f"inv and finite must be one-element float32 tensors on {g.device}")
    if g.dim() != 1 or not g.is_contiguous() or g.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("g must be a contiguous (n,) float32 or bfloat16 tensor")
    if residual.dtype != torch.float32 or residual.shape != g.shape or residual.device != g.device \
            or not residual.is_contiguous():
        raise ValueError(f"residual must be a contiguous {tuple(g.shape)} float32 tensor on {g.device}")
    offs = list(offsets)
    if len(offs) < 1 or offs[0] != 0 or offs[-1] != g.numel() or any(b < a for a, b in zip(offs, offs[1:])):
        raise ValueError(f"offsets must ascend from 0 to {g.numel()}, got {offs}")
    if g.numel() >= 2 ** 31:
        raise ValueError("the gradients must have fewer than 2^31 elements")


def quantize_int8_ef(g: torch.Tensor, residual: torch.Tensor, offsets: Sequence[int],
                     inv: Optional[torch.Tensor] = None, finite: Optional[torch.Tensor] = None,
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(q, scales, new residual)``; see the module's docstring."""
    _check(g, residual, offsets, inv, finite)
    if g.device.type == "cpu":
        return quantize_int8_ef_reference(g, residual, offsets, inv, finite)
    if g.device.type != "cuda":
        raise ValueError(f"unsupported device {g.device}")
    segments = len(offsets) - 1
    if segments > MAX_SEGMENTS:
        raise ValueError(f"{segments} segments, more than the kernel's {MAX_SEGMENTS}")
    q = torch.empty(g.shape, dtype=torch.int8, device=g.device)
    scales = torch.empty(segments + (finite is not None), dtype=torch.float32, device=g.device)
    if not segments:
        if finite is not None:
            scales.copy_(finite.reshape(1))
        return q, scales, residual
    longest = max(b - a for a, b in zip(offsets[:-1], offsets[1:]))
    aligned = all(t.data_ptr() % 16 == 0 for t in (g, residual, q))
    plan = plans.quantize_int8_plan(segments, longest, g.element_size(), aligned)
    offs = (ctypes.c_int * (segments + 1))(*offsets)
    dtype = _kernels.DTYPE_F32 if g.dtype == torch.float32 else _kernels.DTYPE_BF16
    lib = _kernels.library()
    with torch.cuda.device(g.device):
        rc = lib.persia_quantize_int8_ef(g.data_ptr(), dtype, residual.data_ptr(), offs, segments,
                                         inv.data_ptr() if inv is not None else None,
                                         finite.data_ptr() if finite is not None else None, q.data_ptr(),
                                         scales.data_ptr(), residual.data_ptr(), plan.vec, plan.threads, plan.units,
                                         plan.cluster, _kernels.stream_handle(g))
    _kernels.check(rc, "quantize_int8_ef")
    quantize_int8_ef.launches += 1
    return q, scales, residual


quantize_int8_ef.launches = 0


def segment_absmax_reference(g: torch.Tensor, residual: torch.Tensor, offsets: Sequence[int]) -> torch.Tensor:
    """Plain version: (S,) ``max(max |g + residual|, 1e-30)`` a segment."""
    v = g.float() + residual
    out = torch.empty(len(offsets) - 1, dtype=torch.float32, device=v.device)
    for s, (a, b) in enumerate(zip(offsets[:-1], offsets[1:])):
        m = v[a:b].abs().amax() if b > a else torch.zeros((), dtype=torch.float32, device=v.device)
        out[s] = torch.clamp_min(m, 1e-30)
    return out


def _flat_launch_args(g, residual, offsets, q=None):
    """(the segments, the C offsets, the dtype code, the plan) of a flat pass."""
    segments = len(offsets) - 1
    if segments > MAX_SEGMENTS:
        raise ValueError(f"{segments} segments, more than the kernel's {MAX_SEGMENTS}")
    aligned = all(t.data_ptr() % 16 == 0 for t in (g, residual) + ((q,) if q is not None else ()))
    plan = plans.flat_quant_plan(g.numel(), aligned)
    offs = (ctypes.c_int * (segments + 1))(*offsets)
    dtype = _kernels.DTYPE_F32 if g.dtype == torch.float32 else _kernels.DTYPE_BF16
    return segments, offs, dtype, plan


_scratch: Dict[Tuple[int, int, Optional[int]], torch.Tensor] = {}
_scratch_lock = threading.Lock()


def _absmax_scratch(g: torch.Tensor) -> torch.Tensor:
    """``segment_absmax``'s scratch for g's device and current stream:
    (MAX_SEGMENTS + 1,) words, zero when a launch starts (each launch leaves
    them so). No two launches that may overlap share one. Outside a CUDA
    graph the key is (device, stream). In a capture it is (device, stream,
    the capture's id): the capture's first call on that stream makes the
    scratch in the capture, from the graph's own memory, and its zeroing is
    a node of the graph, run at each replay before that call; so a graph's
    scratch is its own, whatever the stream it is replayed on. A capture's
    scratch leaves the map when another capture makes one (the graph's
    pool keeps its memory while the graph lives)."""
    stream = _kernels.stream_handle(g)
    capture = _kernels.capture_id(stream)
    key = (g.device.index, stream, capture)
    with _scratch_lock:
        scratch = _scratch.get(key)
        if scratch is None:
            if capture is not None:
                for k in [k for k in _scratch if k[2] not in (None, capture)]:
                    del _scratch[k]
            scratch = _scratch[key] = torch.zeros(MAX_SEGMENTS + 1, dtype=torch.int32, device=g.device)
    return scratch


def segment_absmax(g: torch.Tensor, residual: torch.Tensor, offsets: Sequence[int]) -> torch.Tensor:
    """(S,) f32: each segment's ``max(max |g + residual|, 1e-30)`` (one
    flat pass over the vector on a CUDA tensor)."""
    _check(g, residual, offsets)
    if g.device.type == "cpu":
        return segment_absmax_reference(g, residual, offsets)
    if g.device.type != "cuda":
        raise ValueError(f"unsupported device {g.device}")
    scales = torch.empty(len(offsets) - 1, dtype=torch.float32, device=g.device)
    if scales.numel():
        segments, offs, dtype, plan = _flat_launch_args(g, residual, offsets)
        with torch.cuda.device(g.device):
            rc = _kernels.library().persia_segment_absmax(
                g.data_ptr(), dtype, residual.data_ptr(), offs, segments, _absmax_scratch(g).data_ptr(),
                scales.data_ptr(), plan.vec, plan.threads, plan.units, plan.span, plan.grid,
                _kernels.stream_handle(g))
        _kernels.check(rc, "segment_absmax")
        segment_absmax.launches += 1
    return scales


def quantize_int8_ef_shared(g: torch.Tensor, residual: torch.Tensor, offsets: Sequence[int], scale: torch.Tensor,
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(q, scales, new residual)`` at the caller's (S,) ``scale`` (K15's
    codes and residual at a shared scale, the codes as int32 for the sum;
    the residual written in place on a CUDA tensor, one flat pass over the
    vector)."""
    _check(g, residual, offsets)
    if scale.dtype != torch.float32 or scale.shape != (len(offsets) - 1,) or scale.device != g.device \
            or not scale.is_contiguous():
        raise ValueError(f"scale must be a contiguous ({len(offsets) - 1},) float32 tensor on {g.device}")
    if g.device.type == "cpu":
        q, scales, new = quantize_int8_ef_reference(g, residual, offsets, scale=scale)
        return q.to(torch.int32), scales, new
    if g.device.type != "cuda":
        raise ValueError(f"unsupported device {g.device}")
    q = torch.empty(g.shape, dtype=torch.int32, device=g.device)
    scales = torch.empty(len(offsets) - 1, dtype=torch.float32, device=g.device)
    if scales.numel():
        segments, offs, dtype, plan = _flat_launch_args(g, residual, offsets, q)
        with torch.cuda.device(g.device):
            rc = _kernels.library().persia_quantize_int8_shared(
                g.data_ptr(), dtype, residual.data_ptr(), offs, segments, scale.data_ptr(), q.data_ptr(),
                scales.data_ptr(), residual.data_ptr(), plan.vec, plan.threads, plan.units, plan.span, plan.grid,
                _kernels.stream_handle(g))
        _kernels.check(rc, "quantize_int8_ef_shared")
        quantize_int8_ef_shared.launches += 1
    return q, scales, residual


segment_absmax.launches = 0
quantize_int8_ef_shared.launches = 0
