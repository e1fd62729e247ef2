"""Gradient wires (counterpart of ``persia_tpu/parallel/grad_sync.py``),
as far as the cache tier's parameter-server slots need them: the int8
error-feedback quantization of their gradients (``quantize_int8_ef``, the
kernel K15 beside its plain version, a scale a slot; under the dynamic
loss scale it also unscales them by ``inv`` and gates the codes and the
residual on ``finite``, both read from the card's memory, and appends the
finite flag to the scales) and its host inverse. The dense collectives of
the reference's module are not part of the port yet."""

from __future__ import annotations

import numpy as np

from persia_tpu_torch.ops.quantize_int8 import quantize_int8_ef, quantize_int8_ef_reference  # noqa: F401


def dequantize_int8_np(q: np.ndarray, scale: float) -> np.ndarray:
    """Host inverse of ``quantize_int8_ef`` for one segment: ``q`` times
    ``scale / 127`` in f32 (the write-back's numpy, off the card)."""
    return q.astype(np.float32) * (np.float32(scale) / np.float32(127.0))
