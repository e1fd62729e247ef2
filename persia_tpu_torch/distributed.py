"""Multi-process setup (counterpart of ``persia_tpu/distributed.py``).

The reference brings up the multi-host JAX runtime from its launcher's
variables and factors its devices into a ("data", "ep", "sp") mesh. The
port's dense data parallelism is one process a device over a
``torch.distributed`` process group: ``initialize_process_group`` brings
it up from torch's own variables (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``), always with a timeout, or runs as a single
process when no world is configured; ``parallel.mesh.data_parallel_mesh``
then gives the ``data`` axis. Embedding and sequence parallelism (``ep``,
``sp`` above 1) are not part of the port yet.
"""

from __future__ import annotations

import datetime
import logging
import os
from dataclasses import dataclass
from typing import Optional, Tuple

import torch.distributed as dist

from persia_tpu_torch.parallel.mesh import DEFAULT_TIMEOUT

logger = logging.getLogger("persia_tpu_torch.distributed")


@dataclass
class DistributedOption:
    """The parallel shape of a run: ``dp`` data-parallel ranks (the dense
    half); ``ep`` (embedding) and ``sp`` (sequence) parallelism raise above
    1: the port has neither yet."""

    dp: int = 1
    ep: int = 1
    sp: int = 1

    def __post_init__(self):
        if self.ep != 1 or self.sp != 1:
            raise NotImplementedError(f"ep={self.ep}, sp={self.sp}: the port has data parallelism only")
        if self.dp < 1:
            raise ValueError(f"dp must be >= 1, got {self.dp}")

    def total(self) -> int:
        return self.dp * self.ep * self.sp


def initialize_process_group(backend: Optional[str] = None, init_method: Optional[str] = None,
                             world_size: Optional[int] = None, rank: Optional[int] = None,
                             timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> bool:
    """Bring up the default process group from the arguments or torch's
    variables (``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` /
    ``RANK``; ``init_method`` such as ``tcp://localhost:<port>`` takes the
    place of the first two). ``backend``: "nccl" or "gloo" (by default
    "nccl" where a card is visible, else "gloo"). Returns True when a group
    came up, False for a single process (no world configured, or a world
    of one without an address)."""
    n = world_size if world_size is not None else int(os.environ.get("WORLD_SIZE", "1"))
    r = rank if rank is not None else int(os.environ.get("RANK", "0"))
    addr = init_method or ("env://" if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT") else None)
    if addr is None:
        if n > 1:
            raise ValueError(f"WORLD_SIZE is {n} but neither MASTER_ADDR/MASTER_PORT nor init_method is set")
        logger.info("single-process run (no process group configured)")
        return False
    if backend is None:
        import torch

        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend=backend, init_method=addr, world_size=n, rank=r, timeout=timeout)
    logger.info("process group up: rank %d of %d over %s (%s)", r, n, backend, addr)
    return True


def process_counts() -> Tuple[int, int]:
    """(rank, world size) of this process (0, 1 without a group)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1
