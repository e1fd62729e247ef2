"""Error envelopes of DIN's attention pool (``ops/attention_pool.py``):
for the same inputs, the interval every f32 evaluation of the op must land
in, whatever order it sums in, computed in f64.

A sum of n f32 terms, in any order, with or without fused multiply-adds,
lies within ``(n + 1) * 2^-24 * sum|term|`` of the exact sum; rounding to
the output dtype T (f32 or bf16, round to nearest even) is monotone, so an
output lies between T of the two ends of that interval. Where no end
straddles a rounding boundary, the envelope is one value: the check is
then exact, as tight as the dtype allows. The kernels (K8, K9) and their
plain versions are both held to it, each with the weights it computed
itself.
"""

from __future__ import annotations

from typing import Tuple

import torch

U32 = 2.0 ** -24  # f32's unit roundoff


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """f64 values as an f32 evaluation rounds them to ``dtype``: to f32,
    then to ``dtype``; back in f64."""
    return x.float().to(dtype).double()


def attention_pool_fwd_envelope(w: torch.Tensor, hist: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi), f64 (B, dim): the pooled rows ``T(sum_l T(w[b, l]) *
    hist[b, l])`` of weights ``w`` (B, L) f32 and history ``hist`` (B, L,
    dim) in T, summed in f32 in any order."""
    dt = hist.dtype
    terms = _round(w.double(), dt)[:, :, None] * hist.double()  # exact products
    s = terms.sum(dim=1)
    e = (hist.shape[1] + 1) * U32 * terms.abs().sum(dim=1)
    return _round(s - e, dt), _round(s + e, dt)


def attention_pool_bwd_envelope(d_out: torch.Tensor, mask: torch.Tensor, hist: torch.Tensor, w: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi), f64 (B, L): ``d_logits = w * (g - sum_j w_j g_j)`` where
    mask, else 0, with ``g = T(d_out . hist)`` (a dot of dim f32 terms
    rounded to T) and the sum over L in f32, each in any order; then the
    subtraction and the product, one f32 rounding each. An interval per
    g, then interval arithmetic (w >= 0) on the same value written as
    ``w_l * ((1 - w_l) g_l - sum_{j != l} w_j g_j)``, so that g_l's
    interval counts once."""
    dt = hist.dtype
    prods = d_out.double()[:, None, :] * hist.double()  # exact products
    x = prods.sum(dim=2)
    ex = (hist.shape[2] + 1) * U32 * prods.abs().sum(dim=2)
    zero = torch.zeros_like(x)
    g_lo = torch.where(mask, _round(x - ex, dt), zero)
    g_hi = torch.where(mask, _round(x + ex, dt), zero)
    w = w.double()
    g_mag = torch.maximum(g_lo.abs(), g_hi.abs())
    es = (hist.shape[1] + 1) * U32 * (w * g_mag).sum(dim=1, keepdim=True)
    s_lo = (w * g_lo).sum(dim=1, keepdim=True) - es
    s_hi = (w * g_hi).sum(dim=1, keepdim=True) + es
    own = w * (g_hi - g_lo)  # g_l's own share of the sum's interval
    lo, hi = w * (g_lo - s_hi + own), w * (g_hi - s_lo - own)
    slack = 2 * U32 * torch.maximum(lo.abs(), hi.abs())  # the subtraction's and the product's roundings
    return torch.where(mask, lo - slack, zero), torch.where(mask, hi + slack, zero)


def outside(x: torch.Tensor, envelope: Tuple[torch.Tensor, torch.Tensor]) -> int:
    """How many elements of ``x`` lie outside ``envelope``."""
    lo, hi = envelope
    x = x.double()
    return int(((x < lo) | (x > hi)).sum())
