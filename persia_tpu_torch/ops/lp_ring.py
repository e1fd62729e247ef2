"""LowPrecisionDecentralized's sync mix: the CUDA kernel K18
(``csrc/lp_ring.cu``) and its plain PyTorch version.

``lp_ring_mix(x, ss, sl, sr, q, ql, qr, s, s_l, s_r, offsets)`` takes the
flat parameters ``x`` and the three reconstruction shadows (this rank's
``ss``, the ring-left neighbour's ``sl``, the ring-right one's ``sr``),
(n,) f32 each, the int8 codes of this rank and of the two neighbours
(K15's, ``quantize_int8_ef``) and each segment's (leaf's) scale, (S,) f32
each, ``offsets`` (S+1 ascending ints from 0 to n) bounding the segments.
For each element of segment k:

    ss += q  * (s[k]   / 127)
    sl += ql * (s_l[k] / 127)
    sr += qr * (s_r[k] / 127)
    x   = ((x + sl) + sr) / 3

each quotient, product and sum rounded on its own. It is
``persia_tpu/parallel/grad_sync.py``'s ``lp_ring_sync`` after the
exchange (:445-453), over the flat vector. ``x``, ``ss``, ``sl`` and
``sr`` are rewritten in place and returned.

A CPU tensor takes the plain version; a CUDA tensor one launch a call
(``lp_ring_mix.launches``), at most ``MAX_SEGMENTS`` segments, in the
geometry of ``plans.lp_ring_mix_plan``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from persia_tpu_torch.ops import _kernels, plans

MAX_SEGMENTS = plans.LP_MIX_MAX_SEGMENTS  # kMaxMixSegments in csrc/lp_ring.cu


def lp_ring_mix_reference(x: torch.Tensor, ss: torch.Tensor, sl: torch.Tensor, sr: torch.Tensor, q: torch.Tensor,
                          ql: torch.Tensor, qr: torch.Tensor, s: torch.Tensor, s_l: torch.Tensor,
                          s_r: torch.Tensor, offsets: Sequence[int]
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: new ``(x, ss, sl, sr)``, a segment at a time. Every
    division is tensor by tensor (PyTorch's CUDA division by a Python
    scalar multiplies by its reciprocal, another rounding); nothing is
    copied from the host, so that a CUDA graph can capture it."""
    dev = x.device
    c127 = torch.full((), 127.0, dtype=torch.float32, device=dev)
    new_ss, new_sl, new_sr = torch.empty_like(ss), torch.empty_like(sl), torch.empty_like(sr)
    for k, (a, b) in enumerate(zip(offsets[:-1], offsets[1:])):
        for new, shadow, codes, scales in ((new_ss, ss, q, s), (new_sl, sl, ql, s_l), (new_sr, sr, qr, s_r)):
            new[a:b] = shadow[a:b] + codes[a:b].float() * (scales[k] / c127)
    new_x = ((x + new_sl) + new_sr) / torch.full((), 3.0, dtype=torch.float32, device=dev)
    return new_x, new_ss, new_sl, new_sr


def _check(x, ss, sl, sr, q, ql, qr, s, s_l, s_r, offsets) -> None:
    n, dev = x.numel(), x.device
    for name, t in (("x", x), ("ss", ss), ("sl", sl), ("sr", sr)):
        if t.dtype != torch.float32 or t.shape != (n,) or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({n},) float32 tensor on {dev}")
    if len({t.data_ptr() for t in (x, ss, sl, sr)}) != 4 and n:
        raise ValueError("x, ss, sl and sr must be four tensors of their own")
    for name, t in (("q", q), ("ql", ql), ("qr", qr)):
        if t.dtype != torch.int8 or t.shape != (n,) or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({n},) int8 tensor on {dev}")
    offs = list(offsets)
    if len(offs) < 1 or offs[0] != 0 or offs[-1] != n or any(b < a for a, b in zip(offs, offs[1:])):
        raise ValueError(f"offsets must ascend from 0 to {n}, got {offs}")
    for name, t in (("s", s), ("s_l", s_l), ("s_r", s_r)):
        if t.dtype != torch.float32 or t.shape != (len(offs) - 1,) or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({len(offs) - 1},) float32 tensor on {dev}")


def lp_ring_mix(x: torch.Tensor, ss: torch.Tensor, sl: torch.Tensor, sr: torch.Tensor, q: torch.Tensor,
                ql: torch.Tensor, qr: torch.Tensor, s: torch.Tensor, s_l: torch.Tensor, s_r: torch.Tensor,
                offsets: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(x, ss, sl, sr)``, rewritten in place; see the module's docstring."""
    _check(x, ss, sl, sr, q, ql, qr, s, s_l, s_r, offsets)
    if x.device.type == "cpu":
        for t, new in zip((x, ss, sl, sr), lp_ring_mix_reference(x, ss, sl, sr, q, ql, qr, s, s_l, s_r, offsets)):
            t.copy_(new)
        return x, ss, sl, sr
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    segments = len(offsets) - 1
    if segments > MAX_SEGMENTS:
        raise ValueError(f"{segments} segments, more than the kernel's {MAX_SEGMENTS}")
    if not x.numel():
        return x, ss, sl, sr
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, ss, sl, sr)) and all(t.data_ptr() % 4 == 0
                                                                             for t in (q, ql, qr))
    plan = plans.lp_ring_mix_plan(x.numel(), aligned)
    offs = (ctypes.c_int * (segments + 1))(*offsets)
    with torch.cuda.device(x.device):
        rc = _kernels.library().persia_lp_ring_mix(
            x.data_ptr(), ss.data_ptr(), sl.data_ptr(), sr.data_ptr(), q.data_ptr(), ql.data_ptr(), qr.data_ptr(),
            s.data_ptr(), s_l.data_ptr(), s_r.data_ptr(), offs, segments, plan.vec, plan.grid,
            _kernels.stream_handle(x))
    _kernels.check(rc, "lp_ring_mix")
    lp_ring_mix.launches += 1
    return x, ss, sl, sr


lp_ring_mix.launches = 0
