"""Versioned inference engine: the swappable core of a serving replica
(counterpart of ``persia_tpu/serving/engine.py``).

The engine holds ONE immutable handle ``(infer_ctx, version)``; a reader
grabs it with a single attribute read — atomic under the GIL — so a
concurrent :meth:`swap` never exposes a half-updated pair, and in-flight
forwards finish on the handle they started with.
"""

from __future__ import annotations

import threading
from typing import Tuple

import numpy as np

from persia_tpu_torch.data import PersiaBatch
from persia_tpu_torch.device import resolve_device


class InferenceEngine:
    """Thread-safe holder of the live ``InferCtx`` + model version. The
    engine and every ctx it holds run on one device (``cuda`` unless the
    caller passes ``device="cpu"``)."""

    def __init__(self, infer_ctx, version: str = "v0", device=None):
        self.device = resolve_device(device)
        self._check_device(infer_ctx)
        self._handle: Tuple[object, str] = (infer_ctx, version)
        self._lock = threading.Lock()  # guards swaps and the forward count
        self.forwards = 0

    def _check_device(self, ctx) -> None:
        if ctx.device != self.device:
            raise ValueError(f"InferCtx runs on {ctx.device}, the engine on {self.device}")

    @property
    def ctx(self):
        return self._handle[0]

    @property
    def version(self) -> str:
        return self._handle[1]

    def predict(self, batch: PersiaBatch) -> np.ndarray:
        ctx, _ = self._handle
        out = ctx.predict(batch)
        with self._lock:
            self.forwards += 1
        return out

    def predict_from_bytes(self, raw: bytes) -> np.ndarray:
        return self.predict(PersiaBatch.from_bytes(raw))

    def swap(self, new_ctx, version: str) -> str:
        """Atomically replace the live context. Returns the old version."""
        self._check_device(new_ctx)
        with self._lock:
            _, old_version = self._handle
            self._handle = (new_ctx, version)
        return old_version
