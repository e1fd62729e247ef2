"""Which device an entry point runs on.

The port runs on the card. A caller that wants the CPU says so with
``device="cpu"`` (the tests do); with no card and no such request an entry
point raises instead of quietly running on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` → ``cuda``; an explicit device is taken as given. Raises
    ``RuntimeError`` when the result is a CUDA device and no card is
    visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    # "cuda" and "cuda:<current>" name one card: give it its index
    return dev if dev.index is not None else torch.device("cuda", torch.cuda.current_device())
