"""Misc utilities (counterpart of ``persia_tpu/utils``)."""

from __future__ import annotations


def round_up_pow2(n: int, floor: int = 8) -> int:
    """Smallest power of two >= n (>= floor) — the shared shape-bucketing
    primitive (a bounded set of shapes from dynamic counts)."""
    p = floor
    while p < n:
        p <<= 1
    return p
