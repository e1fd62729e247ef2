"""The data-parallel mesh (counterpart of ``persia_tpu/parallel/mesh.py``).

The reference's ``data`` mesh axis is a set of devices under one
controller; here it is a ``torch.distributed`` process group of one
process a device (gloo on the CPU, NCCL on the card), each process one
rank. ``data_parallel_mesh(n)`` gives the group and this rank's share of a
global batch, the rows ``[r·B/n, (r+1)·B/n)``, as ``P("data")`` splits
them. At one rank nothing moves: a single process needs no process group.

The collectives the dense sync needs (``all_reduce``, ``all_gather``,
``ring_exchange`` either way round the ring, ``broadcast_object``,
``all_gather_object``) run on the group's backend; where
that is gloo and the tensor lies on a card, the payload travels through
pinned host memory (gloo's collectives take CPU tensors).
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

#: the timeout every process group of the port is made with (a rank that
#: dies leaves the others waiting at most this long)
DEFAULT_TIMEOUT = datetime.timedelta(seconds=120)


@dataclass
class DataMesh:
    """A ``data`` axis of ``size`` ranks: ``rank`` is this process's,
    ``group`` the process group (None at one rank), ``backend`` its
    backend ("gloo" or "nccl"; "local" at one rank without a group)."""

    size: int
    rank: int
    group: Optional[dist.ProcessGroup]
    backend: str

    def rows(self, batch: int) -> Tuple[int, int]:
        """This rank's rows ``[start, stop)`` of a global batch of
        ``batch`` rows (which the ranks must divide)."""
        if batch % self.size:
            raise ValueError(f"a global batch of {batch} rows does not split over {self.size} ranks")
        per = batch // self.size
        return self.rank * per, (self.rank + 1) * per

    # ------------------------------------------------------------ collectives

    def _staged(self, t: torch.Tensor) -> Tuple[torch.Tensor, bool]:
        """The tensor a collective of this backend takes: a pinned host
        copy of a card tensor under gloo."""
        if self.backend == "gloo" and t.device.type == "cuda":
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t)
            return host, True
        return t, False

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` reduced over the ranks in place ("sum" or "max")."""
        if self.size == 1:
            return t
        x, staged = self._staged(t)
        dist.all_reduce(x, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX, group=self.group)
        if staged:
            t.copy_(x)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(size, *t.shape): every rank's ``t``, in rank order."""
        if self.size == 1:
            return t.unsqueeze(0)
        x, staged = self._staged(t.contiguous())
        out = torch.empty((self.size,) + tuple(t.shape), dtype=t.dtype, device=x.device)
        if self.backend == "nccl":
            dist.all_gather_into_tensor(out, x, group=self.group)
        else:
            dist.all_gather(list(out.unbind(0)), x, group=self.group)
        return out.to(t.device) if staged else out

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's chunk ``rank`` of ``t`` (size * chunk,) summed over
        the ranks (gloo has no reduce-scatter: there an all-reduce and the
        rank's slice, the same sums)."""
        chunk = t.numel() // self.size
        if self.size == 1:
            return t
        if self.backend == "nccl":
            out = torch.empty(chunk, dtype=t.dtype, device=t.device)
            dist.reduce_scatter_tensor(out, t.contiguous(), group=self.group)
            return out
        full = self.all_reduce(t.clone())
        return full[self.rank * chunk:(self.rank + 1) * chunk].clone()

    def ring_exchange(self, tensors: List[torch.Tensor], towards: int = 1) -> List[torch.Tensor]:
        """Send ``tensors`` to rank + ``towards`` and receive the same
        shapes from rank - ``towards``: one hop of a ring (``towards`` 1,
        ring-right, the reference's ``ppermute`` over ``(i, i + 1)``; -1,
        ring-left, over ``(i, i - 1)``). At one rank a rank receives its own
        tensors, as a ``ppermute`` to itself gives them."""
        if self.size == 1:
            return list(tensors)
        dst, src = (self.rank + towards) % self.size, (self.rank - towards) % self.size
        sends, recvs, staged = [], [], []
        for t in tensors:
            x, st = self._staged(t.contiguous())
            sends.append(x)
            recvs.append(torch.empty_like(x))
            staged.append(st)
        ops = [dist.P2POp(dist.isend, x, self._peer(dst), group=self.group) for x in sends]
        ops += [dist.P2POp(dist.irecv, r, self._peer(src), group=self.group) for r in recvs]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return [r.to(t.device) if st else r for r, t, st in zip(recvs, tensors, staged)]

    def _peer(self, rank: int) -> int:
        """A group rank as the global rank the point-to-point calls take."""
        return dist.get_global_rank(self.group, rank) if self.group is not None else rank

    def broadcast_object(self, obj, src: int = 0):
        """``obj`` of rank ``src`` on every rank (pickled)."""
        if self.size == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=self._peer(src), group=self.group,
                                   device=torch.device("cuda", torch.cuda.current_device())
                                   if self.backend == "nccl" else None)
        return box[0]

    def all_gather_object(self, obj) -> List:
        """Every rank's ``obj``, in rank order (pickled)."""
        if self.size == 1:
            return [obj]
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out


def data_parallel_mesh(n_devices: Optional[int] = None) -> DataMesh:
    """The ``data`` mesh over the process group: every rank of the
    initialised default group (``n_devices``, where given, must equal its
    size), or a single process at one rank when no group is up."""
    if not dist.is_available() or not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"a mesh of {n_devices} ranks needs an initialised process group "
                             "(persia_tpu_torch.distributed.initialize_process_group)")
        return DataMesh(size=1, rank=0, group=None, backend="local")
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"requested {n_devices} ranks, the process group has {size}")
    return DataMesh(size=size, rank=dist.get_rank(), group=dist.group.WORLD, backend=dist.get_backend())
