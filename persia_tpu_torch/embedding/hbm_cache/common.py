"""Leaf helpers of the cache tier (counterpart of
``persia_tpu/embedding/hbm_cache/common.py``); imports nothing of the
package."""

from __future__ import annotations

from persia_tpu_torch.utils import round_up_pow2


def _bucket(m: int) -> int:
    """Padded size: a power of two below 4096, then a multiple of 4096 (the
    miss arrays are the largest per-step transfer; powers of two would
    waste up to half of them)."""
    return round_up_pow2(m) if m < 4096 else -(-m // 4096) * 4096
