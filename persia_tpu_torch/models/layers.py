"""Layer helpers shared by the port's models: flax ``Dense`` as the
reference runs it, a slot's one vector, and the seeded initialisation.

flax's ``Dense(dtype=bf16)`` casts its input, kernel and bias to bf16;
``Dense(1, dtype=float32)`` over bf16 activations promotes them to f32
(every model's head). Parameters stay f32 in both packages.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch
import torch.nn.functional as F
from torch import nn


def dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``nn.Dense(dtype=dtype)``: the layer in ``dtype``."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def dense_f32(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """``nn.Dense(dtype=float32)``: the input promoted to f32."""
    return F.linear(x.float(), layer.weight, layer.bias)


def sigmoid_gate(x: torch.Tensor) -> torch.Tensor:
    """``x * nn.sigmoid(x)`` as the reference writes it: two roundings in
    ``x``'s dtype, not ``F.silu``'s one."""
    return x * torch.sigmoid(x)


def slot_vector(emb, dtype: torch.dtype) -> torch.Tensor:
    """One (B, d) vector of a slot in ``dtype``: a pooled slot as it is, a
    raw (sequence) slot ``(gathered, mask)`` mean-pooled over its valid
    positions (in the rows' dtype, an empty row giving zeros), as DLRM and
    DeepFM pool it in the reference."""
    if not isinstance(emb, tuple):
        return emb.to(dtype)
    gathered, mask = emb
    m = mask[..., None].to(gathered.dtype)
    denom = torch.clamp(m.sum(dim=1), min=1.0)
    return ((gathered * m).sum(dim=1) / denom).to(dtype)


# the std of a unit normal truncated to [-2, 2] (flax's variance_scaling)
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def lecun_init_(layers: Iterable[nn.Linear], generator: Optional[torch.Generator]) -> None:
    """LeCun-normal kernels and zero biases (flax ``Dense``'s defaults),
    drawn on the CPU from ``generator`` so that a seed gives the same
    weights on every device. flax's ``lecun_normal`` is a normal truncated
    at two of its sigmas, sigma = 1 / sqrt(fan_in) / 0.87962566 (the std
    of a unit normal cut at +-2), so the kernel's std is 1 / sqrt(fan_in)
    and no |w| * sqrt(fan_in) exceeds 2.2737."""
    for layer in layers:
        sigma = layer.in_features ** -0.5 / _TRUNC_STD
        w = torch.empty(layer.weight.shape)
        torch.nn.init.trunc_normal_(w, 0.0, sigma, -2 * sigma, 2 * sigma, generator=generator)
        layer.weight.copy_(w)
        if layer.bias is not None:
            layer.bias.zero_()
