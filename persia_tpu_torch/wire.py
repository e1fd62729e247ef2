"""The bf16 embedding wire between host and device, without ``ml_dtypes``.

With ``wire_dtype="bfloat16"`` embedding rows travel host→device, and their
gradients device→host, in bf16: half the bytes of f32. numpy has no bf16,
so the host keeps the bits: f32 rounds to the nearest bf16, ties to even,
on the ``uint32`` view, and the top 16 bits go to the device as ``int16``
viewed there as ``torch.bfloat16``. Gradients come back the same way and
widen by ``<< 16``. The rounding is ``ml_dtypes``' bit for bit, subnormals,
±inf and NaN included (a NaN keeps its sign and becomes the quiet NaN
``0x7fc0``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def f32_to_bf16_bits(x: np.ndarray) -> np.ndarray:
    """bf16 bits (uint16, same shape) of f32 ``x``, rounded to nearest
    even."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    rounded = (u + (np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1)))) >> np.uint32(16)
    nan = (u & np.uint32(0x7FFFFFFF)) > np.uint32(0x7F800000)
    quiet = (u >> np.uint32(16)) & np.uint32(0x8000) | np.uint32(0x7FC0)
    return np.where(nan, quiet, rounded).astype(np.uint16)


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """f32 values of bf16 bits (uint16 or int16): exact."""
    return (np.asarray(bits).view(np.uint16).astype(np.uint32) << np.uint32(16)).view(np.float32)


@dataclass(frozen=True)
class BF16Host:
    """A host array bound for the device as bf16, held as its bits."""

    bits: np.ndarray  # uint16

    @classmethod
    def from_f32(cls, x: np.ndarray) -> "BF16Host":
        return cls(f32_to_bf16_bits(x))

    @property
    def shape(self):
        return self.bits.shape

    def to(self, device: torch.device) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(self.bits).view(np.int16))
        return t.to(device).view(torch.bfloat16)


def tensor_to_host_f32(t: torch.Tensor) -> np.ndarray:
    """A device tensor (f32 or bf16) as a host f32 array: bf16 crosses as
    its 16-bit pattern and widens on the host."""
    if t.dtype == torch.bfloat16:
        return bf16_bits_to_f32(t.view(torch.int16).cpu().numpy())
    return t.to(torch.float32).cpu().numpy()
