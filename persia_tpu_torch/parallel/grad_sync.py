"""Dense gradient synchronisation over the ``data`` mesh (counterpart of
``persia_tpu/parallel/grad_sync.py``), and the cache tier's int8 gradient
wire.

The dense half trains synchronously data-parallel: every rank of the mesh
(``parallel.mesh.DataMesh``, one process a device) runs the forward and
backward of its share of the global batch, and the dense gradients meet
through one of the reference's algorithms, over ``torch.distributed``:

- ``GradientAllReduce``: the exact mean (an all-reduce of the f32
  gradients, or of their bf16 rounding with ``dtype="bfloat16"``);
- ``ByteGradAllReduce``: each leaf quantized to int8 at a scale shared by
  the ranks (a MAX all-reduce of each leaf's absmax, ``segment_absmax``),
  coded at it as int32 (``quantize_int8_ef_shared``, K15 at a shared
  scale; both one flat pass over the vector), summed as int32 and
  descaled; the rounding error is the error-feedback residual the next
  step adds back;
- ``BlockInt8Ring``: a ring all-reduce whose every hop carries block-scaled
  int8 (``block_quantize_int8``, K16; ``block_dequantize_int8``, K17):
  n - 1 hops of reduce-scatter, then an all-gather of each rank's owned
  chunk, every rank (the owner too) using the dequantized values; the
  rounding errors are the ring's error feedback ``ef``. A hop's accumulate
  and the next quantize of the same chunk are one pass
  (``block_requantize_int8``), as are the last hop's and the all-gather's.
  A rank's launches a step: at n = 1, 1 K16 and 1 K17; at n >= 2, 1 K16,
  n - 1 fused and 1 K17 (n + 1; 2n unfolded). The sharded ring's
  reduce-scatter ends on a plain K17 (the owned chunk's sum is read): at
  n >= 2, 1 K16, n - 2 fused and 1 K17 (n; 2(n - 1) unfolded); none at
  n = 1.

``sharded_update`` (``f32-sharded``, ``block-int8-ring-sharded``) shards
the dense optimizer and the weight update ZeRO-style: the gradients are
reduce-scattered (or reduced by the ring's reduce-scatter half), each rank
updates its 1/n chunk of the flat parameters with its 1/n of Adam's
moments, and the fresh parameters are all-gathered in f32. The
parameters stay the same on every rank in every mode.

The flat vector is the reference's ``ravel_pytree`` order: the model's
flax leaves (``weights.flax_leaves``) sorted by path, each in flax's
layout (a kernel (in, out)). The optimizer state the reference keeps in
``init_sync_opt_state``'s ``{"opt", "ef"}`` wrapper is ``SyncState``
here: the ring's ``ef`` (this rank's (Ppad,) row of the reference's (n,
Ppad)) and, for the sharded modes, Adam over this rank's (chunk,) shard
(row ``rank`` of the reference's (n, chunk) moments). The bytegrad
residual lives on the ctx and is not durable, as in the reference.

The step (``build_sync_train_step``) returns the embedding inputs'
gradients in the global-mean convention of the reference (pooled
cotangents / n, gathered over the ranks; distinct-row cotangents summed
over the ranks, then / n) and the header ``[mean loss | every rank's
predictions]``.

The replicas that hold their own parameters (``Decentralized``,
``LocalSGD``, ``LowPrecisionDecentralized``) update with their own
gradients (the reference's per-replica leading axis is each rank's model
and optimizer here; ``replicate_for_local`` starts every rank from rank
0's, ``collapse_local`` gives their mean), then every ``period`` steps
sync the flat parameters: with one ring neighbour (``Decentralized``,
``ring_neighbor_average``: ring-left on an even sync ordinal, ring-right
on an odd one, one parameter-sized message), over every rank (``LocalSGD``,
the mean), or with both neighbours over an int8 wire
(``LowPrecisionDecentralized``, ``lp_ring_sync``: the change since the last
sync coded by K15 ``quantize_int8_ef`` a leaf a scale, the codes and
scales sent both ways, and K18 ``lp_ring_mix`` advancing the three
reconstruction shadows and averaging, in one pass). ``QAdam`` is the
optimizer (``optimizer`` may be None): the exact mean of the gradients
and Adam's m and v during its warmup, then m of the local gradients
through ``bytegrad_allreduce`` (K15's two dense-sync modes) with v frozen.
Their state (QAdam's m, v and residual; LP's shadows and residual) is
``SyncState.algo_state``, made by ``init_sync_opt_state``; it is in no
manifest, as in the reference. A rank's launches a sync step: LP 1 K15
and 1 K18; QAdam 1 ``segment_absmax`` and 1 shared quantize after its
warmup, none within it; ``Decentralized`` and ``LocalSGD`` none.

The cache tier's parameter-server slots take the int8 error-feedback
quantization of their gradients (``quantize_int8_ef``, K15, a scale a
slot; under the dynamic loss scale with ``inv`` and ``finite``) and its
host inverse ``dequantize_int8_np``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from persia_tpu_torch.ops.block_int8 import block_dequantize_int8, block_quantize_int8, block_requantize_int8
from persia_tpu_torch.ops.lp_ring import lp_ring_mix
from persia_tpu_torch.ops.quantize_int8 import (  # noqa: F401
    quantize_int8_ef,
    quantize_int8_ef_reference,
    quantize_int8_ef_shared,
    segment_absmax,
)
from persia_tpu_torch.parallel.mesh import DataMesh
from persia_tpu_torch.parallel.train_step import (
    TrainState,
    _embedding_model_inputs,
    _split_emb,
    default_loss_fn,
)


def dequantize_int8_np(q: np.ndarray, scale: float) -> np.ndarray:
    """Host inverse of ``quantize_int8_ef`` for one segment: ``q`` times
    ``scale / 127`` in f32 (the write-back's numpy, off the card)."""
    return q.astype(np.float32) * (np.float32(scale) / np.float32(127.0))


# --------------------------------------------------------------- algorithms


@dataclass(frozen=True)
class GradientAllReduce:
    """The exact mean over ``data`` (``dtype="bfloat16"``: the gradients
    rounded to bf16 for the wire, the sum taken in bf16, then f32 / n)."""

    dtype: str = "float32"


@dataclass(frozen=True)
class ByteGradAllReduce:
    """Int8 at each leaf's shared absmax scale, an int32 sum, the rounding
    error fed back the next step."""

    error_feedback: bool = True


@dataclass(frozen=True)
class BlockInt8Ring:
    """The block-scaled int8 ring all-reduce, every hop quantized, its
    errors in the error feedback ``ef``."""

    block_size: int = 256
    error_feedback: bool = True

    def __post_init__(self):
        if self.block_size < 1:
            raise ValueError(f"block_size must be >= 1 (got {self.block_size})")


@dataclass(frozen=True)
class Decentralized:
    """No gradient collective: each rank updates with its own gradients,
    and every ``period`` steps averages its parameters with one ring
    neighbour, ring-left and ring-right in turn by the sync's ordinal."""

    period: int = 1


@dataclass(frozen=True)
class LocalSGD:
    """Local updates, the parameters' mean over the ranks every ``period``
    steps."""

    period: int = 4


@dataclass(frozen=True)
class QAdam:
    """Quantized-momentum Adam, which is the optimizer: during the warmup
    (``step <= warmup_steps``) the exact mean of the gradients and Adam's m
    and v; after it v freezes and m of the local gradients goes through the
    int8 bytegrad all-reduce, its rounding error fed back."""

    lr: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    warmup_steps: int = 100

    def __post_init__(self):
        # v freezes at the warmup's end and its bias correction with it:
        # with no warmup step both are 0, and the first update 0 / 0
        if self.warmup_steps < 1:
            raise ValueError(f"QAdam requires warmup_steps >= 1 (got {self.warmup_steps}): v freezes at warmup end, "
                             "so at least one warmup step must populate it")


@dataclass(frozen=True)
class LowPrecisionDecentralized:
    """Every ``period`` steps each rank sends its parameters' change since
    the last sync as int8 (a scale a leaf, error fed back) to both ring
    neighbours, advances its shadows of itself and of them by the
    dequantized changes, and takes ``(x + shadow_left + shadow_right) /
    3``."""

    period: int = 1


#: the algorithms whose ranks hold parameters of their own
LOCAL_ALGORITHMS = (Decentralized, LocalSGD, LowPrecisionDecentralized)


DENSE_SYNC_MODES = (
    "f32",
    "bf16",
    "bytegrad",
    "block-int8-ring",
    "f32-sharded",
    "block-int8-ring-sharded",
)


def sync_mode_algorithm(mode: str, block_size: int = 256):
    """Mode → ``(algorithm, sharded_update)``."""
    table = {
        "f32": (GradientAllReduce(), False),
        "bf16": (GradientAllReduce(dtype="bfloat16"), False),
        "bytegrad": (ByteGradAllReduce(), False),
        "block-int8-ring": (BlockInt8Ring(block_size=block_size), False),
        "f32-sharded": (GradientAllReduce(), True),
        "block-int8-ring-sharded": (BlockInt8Ring(block_size=block_size), True),
    }
    if mode not in table:
        raise ValueError(f"unknown dense sync mode {mode!r}; expected one of {DENSE_SYNC_MODES}")
    return table[mode]


def dense_param_count(model: torch.nn.Module) -> int:
    """The dense parameters' element count (the P of the wire model)."""
    return int(sum(p.numel() for p in model.parameters()))


def dense_sync_wire_bytes(mode: str, param_count: int, n: int, block_size: int = 256) -> int:
    """The modelled dense collective bytes a rank sends a step (the
    reference's model: a ring all-reduce of P elements moves ``2·(n-1)/n·P``
    of them a rank; bytegrad's int32 sum is f32-wide; the block ring's hops
    carry a byte an element and 4 a block; the sharded modes all-gather f32
    parameters in place of the gradients' half)."""
    if n <= 1:
        return 0
    ring = (n - 1) / n
    blk = 1.0 + 4.0 / block_size
    if mode in ("f32", "implicit-psum", "f32-sharded", "bytegrad"):
        return int(2 * ring * param_count * 4)
    if mode == "bf16":
        return int(2 * ring * param_count * 2)
    if mode == "block-int8-ring":
        return int(2 * ring * param_count * blk)
    if mode == "block-int8-ring-sharded":
        return int(ring * param_count * (blk + 4.0))
    if mode == "local":
        return 0
    raise ValueError(f"unknown dense sync mode {mode!r}")


# --------------------------------------------------------- the flat vector


def dense_leaves(model: torch.nn.Module):
    """(flax path, parameter, transposed) of ``model``'s parameters in the
    reference's ``ravel_pytree`` order (flax's keys sorted)."""
    from persia_tpu_torch.weights import flax_leaves

    return sorted(flax_leaves(model), key=lambda leaf: leaf[0])


def _flax_layout(t: torch.Tensor, transposed: bool) -> torch.Tensor:
    return t.t() if transposed else t


def ravel(leaves, of: Callable[[torch.nn.Parameter], torch.Tensor]) -> torch.Tensor:
    """``of(p)`` of every leaf in flax's layout, concatenated as f32."""
    return torch.cat([_flax_layout(of(p), tr).reshape(-1).float() for _path, p, tr in leaves])


def unravel_into(flat: torch.Tensor, leaves, into: Callable[[torch.nn.Parameter], torch.Tensor]) -> None:
    """Copy the pieces of ``flat`` into ``into(p)`` of each leaf (back from
    flax's layout)."""
    off = 0
    for _path, p, tr in leaves:
        n = p.numel()
        piece = flat[off:off + n].reshape(_flax_layout(p, tr).shape)
        into(p).copy_(_flax_layout(piece, tr))
        off += n


def _flat_chunk(p_total: int, n: int, block_size: int) -> Tuple[int, int]:
    """The ring's chunk a rank (a multiple of ``block_size``) and the padded
    length ``n * chunk``."""
    chunk = -(-p_total // n)
    chunk = -(-chunk // block_size) * block_size
    return chunk, n * chunk


def _div(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t / n`` as one correctly rounded division (a tensor divisor:
    PyTorch's CUDA division by a Python scalar multiplies by its
    reciprocal)."""
    return t / torch.full((), float(n), dtype=t.dtype, device=t.device)


# --------------------------------------------------------- sync primitives


def allreduce_mean(flat: torch.Tensor, mesh: DataMesh, dtype: str = "float32") -> torch.Tensor:
    """The mean over the ranks, the wire in ``dtype``."""
    x = flat.to(torch.bfloat16) if dtype == "bfloat16" else flat.clone()
    return _div(mesh.all_reduce(x).float(), mesh.size)


def bytegrad_allreduce(flat: torch.Tensor, residual: torch.Tensor, offsets: List[int], mesh: DataMesh,
                       lengths: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int8 mean of ``flat`` over the ranks, a scale a leaf
    (``offsets``): the leaves' absmax of ``flat + residual``
    (``segment_absmax``), their MAX over the ranks, the codes at it as
    int32 (K15 at a shared scale, the reference's cast to int32 in the
    same pass), an int32 sum, ``sum * (scale / 127) / n``. ``lengths``:
    the leaves' lengths (``np.diff(offsets)``) on ``flat``'s device, which
    the caller makes once. Returns ``(mean, new residual)`` (the residual
    rewritten in place on a card)."""
    scale = mesh.all_reduce(segment_absmax(flat, residual, offsets), "max")
    q, _scales, new_res = quantize_int8_ef_shared(flat, residual, offsets, scale)
    summed = mesh.all_reduce(q)
    step = torch.repeat_interleave(scale / torch.full((), 127.0, device=flat.device), lengths,
                                   output_size=offsets[-1])
    return _div(summed.float() * step, mesh.size), new_res


def init_residual(model: torch.nn.Module, device=None) -> torch.Tensor:
    """The bytegrad residual: zeros like the flat dense gradients."""
    return torch.zeros(dense_param_count(model), dtype=torch.float32, device=device)


def ring_reduce_scatter_block_int8(acc: torch.Tensor, mesh: DataMesh, block_size: int,
                                   ef: Optional[torch.Tensor], err: torch.Tensor, quantize_own: bool = False
                                   ) -> Tuple[Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]], int]:
    """The quantized ring's reduce-scatter over ``acc`` ((n * chunk,) f32,
    the padded gradients): chunk me is quantized with ``ef`` added (K16)
    and sent to ring-right; hop s receives chunk (me - s - 1) % n from
    ring-left and adds it to that chunk of ``acc``, ``ef`` first (the
    chunk is the gradients' own), and quantizes the sum for hop s + 1 in
    the same pass (``block_requantize_int8``): the chunk hop s accumulates
    is the one hop s + 1 sends. The last hop accumulates the owned chunk
    (me + 1) % n into ``acc`` (K17); with ``quantize_own`` it is the fused
    pass too, and its codes are the all-gather's (at n = 1: K16 of the
    chunk with ``ef``). Each quantized chunk's error lands in its row of
    ``err`` (n, chunk). Returns ``(the owned chunk's sum, or with
    quantize_own its (codes, scales), its index)``."""
    n, me = mesh.size, mesh.rank
    A = acc.view(n, -1)
    F = ef.view(n, -1) if ef is not None else None
    own = (me + 1) % n
    if n == 1 and not quantize_own:
        return A[own], own
    q, sc, _ = block_quantize_int8(A[me], block_size, ef=F[me] if F is not None else None, err=err[me])
    for s in range(n - 1):
        q_in, sc_in = mesh.ring_exchange([q, sc])
        ri = (me - s - 1) % n
        f = F[ri] if F is not None else None
        if s < n - 2 or quantize_own:
            q, sc, _ = block_requantize_int8(q_in, sc_in, A[ri], f, block_size, err=err[ri])
        else:
            block_dequantize_int8(q_in, sc_in, block_size, base=A[ri], ef=f, out=A[ri])
    return ((q, sc) if quantize_own else A[own]), own


def ring_allgather_block_int8(codes: Tuple[torch.Tensor, torch.Tensor], mesh: DataMesh, block_size: int
                              ) -> torch.Tensor:
    """The ring's all-gather: every rank's quantized owned chunk-sum
    (``codes``, ``ring_reduce_scatter_block_int8(..., quantize_own=True)``'s)
    gathered, and every rank, the owner too, taking the dequantized rows in
    chunk order (K17, row j to chunk (j + 1) % n). Returns the (n * chunk,)
    sum."""
    q, sc = codes
    n = mesh.size
    rows_q, rows_s = mesh.all_gather(q), mesh.all_gather(sc)
    return block_dequantize_int8(rows_q.reshape(-1), rows_s.reshape(-1), block_size, n=n, roll=1 % n)


def _block_ring_allreduce_flat(flat_g: torch.Tensor, ef: torch.Tensor, algorithm: BlockInt8Ring, mesh: DataMesh
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The quantized ring's all-reduce of the flat gradients, in sums (the
    caller divides by n): ``(sum (Ppad,), new ef (Ppad,))``."""
    bs, n = algorithm.block_size, mesh.size
    chunk, p_pad = _flat_chunk(flat_g.numel(), n, bs)
    acc = torch.zeros(p_pad, dtype=torch.float32, device=flat_g.device)
    acc[:flat_g.numel()] = flat_g
    efv = ef if algorithm.error_feedback else None
    err = torch.zeros(n, chunk, dtype=torch.float32, device=flat_g.device)
    codes, _own = ring_reduce_scatter_block_int8(acc, mesh, bs, efv, err, quantize_own=True)
    flat_sum = ring_allgather_block_int8(codes, mesh, bs)
    return flat_sum, err.reshape(-1) if algorithm.error_feedback else torch.zeros_like(acc)


def ring_neighbor_average(flat: torch.Tensor, sync_idx: int, mesh: DataMesh) -> torch.Tensor:
    """``(flat + the neighbour's flat) * 0.5``: the ring-left neighbour's
    (the reference's ``ppermute`` over ``(i, i + 1)``) on an even sync
    ordinal ``sync_idx``, the ring-right one's on an odd one; one
    parameter-sized message a sync."""
    (peer,) = mesh.ring_exchange([flat], 1 if sync_idx % 2 == 0 else -1)
    return (flat + peer) * 0.5


def lp_ring_sync(x: torch.Tensor, shadows: Dict[str, torch.Tensor], offsets: List[int], mesh: DataMesh
                 ) -> torch.Tensor:
    """One LowPrecisionDecentralized sync of the flat parameters ``x``
    (rewritten in place and returned), ``shadows`` the algorithm's state
    (``init_lp_decentralized_state``; updated in place), ``offsets`` the
    leaves: the change ``x - shadow_self`` coded by K15 with the residual,
    a scale a leaf; its int8 codes and f32 scales sent to both ring
    neighbours and theirs received (at one rank a rank's own are both, as
    a ``ppermute`` to itself gives them); K18 advances the three shadows by
    the dequantized codes and takes ``(x + shadow_left + shadow_right) /
    3``."""
    ss = shadows["shadow_self"]
    q, scales, shadows["residual"] = quantize_int8_ef(x - ss, shadows["residual"], offsets)
    ql, s_l = mesh.ring_exchange([q, scales], 1)  # the ring-left neighbour's
    qr, s_r = mesh.ring_exchange([q, scales], -1)  # the ring-right neighbour's
    lp_ring_mix(x, ss, shadows["shadow_left"], shadows["shadow_right"], q, ql, qr, scales, s_l, s_r, offsets)
    return x


def init_qadam_state(model: torch.nn.Module, device=None) -> Dict[str, torch.Tensor]:
    """QAdam's state over the flat parameters: ``m`` and ``v`` (the same on
    every rank) and ``residual`` (this rank's), zeros."""
    count = dense_param_count(model)
    return {k: torch.zeros(count, dtype=torch.float32, device=device) for k in ("m", "v", "residual")}


def init_lp_decentralized_state(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """LowPrecisionDecentralized's state over the flat parameters: the three
    shadows, each a copy of them (every rank starts from the same ones,
    ``replicate_for_local``), and a zero residual."""
    x = ravel(dense_leaves(model), lambda p: p.detach())
    return {"shadow_self": x.clone(), "shadow_left": x.clone(), "shadow_right": x.clone(),
            "residual": torch.zeros_like(x)}


def _qadam_update(algorithm: QAdam, state: Dict[str, torch.Tensor], flat_p: torch.Tensor, flat_g: torch.Tensor,
                  step_no: int, offsets: List[int], lengths: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """QAdam's step ``step_no`` (from 1): m and v in ``state`` updated (the
    residual too after the warmup); returns the new flat parameters ``p -
    lr * (m / bc1) / (sqrt(v / bc2) + eps)``, with ``bc1 = 1 - b1^t`` and
    ``bc2`` frozen at the warmup's end, both in f32."""
    b1, b2 = algorithm.beta1, algorithm.beta2
    m, v = state["m"], state["v"]
    if step_no <= algorithm.warmup_steps:
        g = allreduce_mean(flat_g, mesh)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
    else:
        m, state["residual"] = bytegrad_allreduce(b1 * m + (1 - b1) * flat_g, state["residual"], offsets, mesh,
                                                  lengths)
    state["m"], state["v"] = m, v
    f32 = np.float32
    t = f32(step_no)
    bc1 = f32(1.0) - np.power(f32(b1), t)
    bc2 = f32(1.0) - np.power(f32(b2), min(t, f32(algorithm.warmup_steps)))
    dev = flat_p.device
    bc1, bc2 = (torch.tensor(b, dtype=torch.float32, device=dev) for b in (bc1, bc2))
    return flat_p - algorithm.lr * (m / bc1) / (torch.sqrt(v / bc2) + algorithm.eps)


# ----------------------------------------------------------- the sync state


@dataclass
class SyncState:
    """The dense sync's per-rank state (the reference's ``{"opt", "ef"}``
    wrapper): ``ef`` the ring's error feedback (this rank's (Ppad,) row);
    for the sharded update ``shard`` (this rank's (chunk,) parameter
    shard) and ``shard_opt`` (Adam over it: row ``rank`` of the moments);
    ``algo_state`` the reference's third step argument, over the flat
    parameters (QAdam's ``m``, ``v``, ``residual``; LowPrecisionDecentralized's
    ``shadow_self``, ``shadow_left``, ``shadow_right``, ``residual``: this
    rank's rows). ``count`` the elements P, ``chunk``/``p_pad`` the ring's
    geometry."""

    mesh: DataMesh
    algorithm: object
    sharded: bool
    count: int
    chunk: int
    p_pad: int
    ef: Optional[torch.Tensor] = None
    shard: Optional[torch.Tensor] = None
    shard_opt: Optional[torch.optim.Optimizer] = None
    residual: Optional[torch.Tensor] = field(default=None, repr=False)
    algo_state: Optional[Dict[str, torch.Tensor]] = field(default=None, repr=False)

    @property
    def ring(self) -> bool:
        return isinstance(self.algorithm, BlockInt8Ring)

    @property
    def wrapped(self) -> bool:
        return self.ring or self.sharded

    def own_index(self) -> int:
        """The chunk this rank updates: (rank + 1) % n after the ring's
        reduce-scatter, ``rank`` after the plain one."""
        return (self.mesh.rank + 1) % self.mesh.size if self.ring else self.mesh.rank

    # ------------------------------------------------ flax's opt_state tree

    def _gather(self, t: torch.Tensor) -> np.ndarray:
        return self.mesh.all_gather(t.detach()).cpu().numpy()

    def opt_state_tree(self, plain: Dict) -> Dict:
        """The reference's wrapped ``opt_state`` from ``plain`` (the ctx's
        Adam as optax's tree): ``{"opt": ..., ["ef": (n, Ppad)]}``, the
        sharded moments as (n, chunk). A collective at n > 1 (every rank
        gathers the rows)."""
        if self.sharded:
            st = self.shard_opt.state.get(self.shard) or {}
            zeros = torch.zeros_like(self.shard)
            count = int(float(st["step"])) if st else 0
            inner = {"0": {"count": np.asarray(count, np.int32),
                           "mu": self._gather(st.get("exp_avg", zeros)),
                           "nu": self._gather(st.get("exp_avg_sq", zeros))}, "1": {}}
        else:
            inner = plain
        out = {"opt": inner}
        if self.ring:
            out["ef"] = self._gather(self.ef)
        return out

    def load_opt_state_tree(self, tree: Dict) -> Dict:
        """Load the wrapped ``opt_state`` this rank's part of: its ``ef``
        row and (sharded) its moments' row; returns the inner tree (the
        ctx's Adam loads it where not sharded)."""
        r = self.mesh.rank
        if self.ring:
            ef = np.asarray(tree["ef"])
            if ef.shape != (self.mesh.size, self.p_pad):
                raise ValueError(f"ef {ef.shape} in the bytes, ({self.mesh.size}, {self.p_pad}) here")
            self.ef.copy_(torch.from_numpy(np.array(ef[r], dtype=np.float32)))
        inner = tree["opt"]
        if self.sharded:
            adam = inner["0"]
            mu, nu = np.asarray(adam["mu"]), np.asarray(adam["nu"])
            if mu.shape != (self.mesh.size, self.chunk):
                raise ValueError(f"sharded moments {mu.shape} in the bytes, ({self.mesh.size}, {self.chunk}) here")
            st = self.shard_opt.state[self.shard]
            dev = self.shard.device
            st["step"] = torch.tensor(float(np.asarray(adam["count"])), dtype=torch.float32)
            st["exp_avg"] = torch.from_numpy(np.array(mu[r], dtype=np.float32)).to(dev)
            st["exp_avg_sq"] = torch.from_numpy(np.array(nu[r], dtype=np.float32)).to(dev)
        return inner


def init_sync_opt_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer, mesh: DataMesh, algorithm,
                        sharded_update: bool = False, device=None) -> SyncState:
    """The sync state of a fresh run: a zero ``ef`` for the ring; for the
    sharded update this rank's chunk of the flat parameters with an Adam of
    ``optimizer``'s hyperparameters over it (zero moments); QAdam's and
    LowPrecisionDecentralized's ``algo_state`` (``init_qadam_state``,
    ``init_lp_decentralized_state``: call ``replicate_for_local`` first,
    so that every rank's shadows start from rank 0's parameters)."""
    n = mesh.size
    count = dense_param_count(model)
    bs = algorithm.block_size if isinstance(algorithm, BlockInt8Ring) else 1
    chunk, p_pad = _flat_chunk(count, n, bs)
    st = SyncState(mesh=mesh, algorithm=algorithm, sharded=sharded_update, count=count, chunk=chunk, p_pad=p_pad)
    device = device or next(model.parameters()).device
    if st.ring:
        st.ef = torch.zeros(p_pad, dtype=torch.float32, device=device)
    if sharded_update:
        if not isinstance(optimizer, torch.optim.Adam):
            raise ValueError(f"the sharded update runs Adam elementwise over a shard, got {optimizer!r}")
        st.shard = torch.zeros(chunk, dtype=torch.float32, device=device, requires_grad=True)
        hp = {k: v for k, v in optimizer.defaults.items() if k in ("lr", "betas", "eps", "weight_decay")}
        st.shard_opt = torch.optim.Adam([st.shard], **hp)
    if isinstance(algorithm, QAdam):
        st.algo_state = init_qadam_state(model, device)
    elif isinstance(algorithm, LowPrecisionDecentralized):
        st.algo_state = init_lp_decentralized_state(model)
    return st


def per_replica_opt_state_bytes(model: torch.nn.Module, st: Optional[SyncState]) -> int:
    """The optimizer-state bytes this rank holds: Adam's moments (over the
    whole model, or over the shard) and its int32 count, and the ring's
    ``ef`` row."""
    if st is not None and st.sharded:
        total = 2 * st.chunk * 4 + 4
    else:
        total = 2 * dense_param_count(model) * 4 + 4
    if st is not None and st.ring:
        total += st.p_pad * 4
    return total


def _sharded_flat_update(st: SyncState, flat_p: torch.Tensor, flat_g: torch.Tensor) -> torch.Tensor:
    """The ZeRO-style update: this rank's chunk of the gradient sum (the
    ring's reduce-scatter half, its ``ef`` updated; or a reduce-scatter in
    f32 / bf16) / n, Adam on the chunk of the parameters with this rank's
    moments, the fresh chunks all-gathered in f32 (in chunk order). Returns
    the new flat parameters (P,)."""
    mesh, algorithm = st.mesh, st.algorithm
    n, p_total = mesh.size, flat_p.numel()
    gpad = torch.zeros(st.p_pad, dtype=torch.float32, device=flat_g.device)
    gpad[:p_total] = flat_g
    if st.ring:
        err = torch.zeros(n, st.chunk, dtype=torch.float32, device=flat_g.device)
        ef = st.ef if algorithm.error_feedback else None
        own_sum, own = ring_reduce_scatter_block_int8(gpad, mesh, algorithm.block_size, ef, err)
        if n == 1 and ef is not None:
            own_sum = own_sum + ef  # no hop added it: the chunk's own feedback
        g_shard = _div(own_sum, n)
        st.ef.copy_(err.reshape(-1) if algorithm.error_feedback else torch.zeros_like(gpad))
    else:
        x = gpad.to(torch.bfloat16) if algorithm.dtype == "bfloat16" else gpad
        g_shard = _div(mesh.reduce_scatter(x).float(), n)
        own = mesh.rank
    ppad = torch.zeros(st.p_pad, dtype=torch.float32, device=flat_p.device)
    ppad[:p_total] = flat_p
    with torch.no_grad():
        st.shard.copy_(ppad[own * st.chunk:(own + 1) * st.chunk])
    st.shard.grad = g_shard.contiguous()
    st.shard_opt.step()
    st.shard.grad = None
    rows = mesh.all_gather(st.shard.detach())
    if st.ring:
        rows = torch.roll(rows, 1, dims=0)  # row j is rank j's chunk (j + 1) % n
    return rows.reshape(-1)[:p_total]


# ----------------------------------------------------------- state helpers


def _host_state(obj):
    """``obj`` (a state dict, nested) with its tensors copied to the host."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _host_state(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_state(v) for v in obj)
    return obj


def replicate_for_local(model: torch.nn.Module, optimizer: Optional[torch.optim.Optimizer], mesh: DataMesh) -> None:
    """Start every rank from rank 0's parameters, batch statistics and
    optimizer state, in place (the reference broadcasts one state to its
    per-replica copies). At one rank nothing moves."""
    if mesh.size == 1:
        return
    mine = (_host_state(model.state_dict()), _host_state(optimizer.state_dict()) if optimizer is not None else None)
    sd, opt_sd = mesh.broadcast_object(mine if mesh.rank == 0 else None)
    model.load_state_dict(sd)
    if optimizer is not None:
        optimizer.load_state_dict(opt_sd)


def _tree_mean(rows: List):
    """The reference's ``collapse_local`` leaf by leaf over nested dicts of
    numpy arrays: integer and bool leaves rank 0's, others
    ``astype(float32).mean(axis=0)`` in their dtype."""
    if isinstance(rows[0], dict):
        return {k: _tree_mean([r[k] for r in rows]) for k in rows[0]}
    arr = np.stack([np.asarray(r) for r in rows])
    if np.issubdtype(arr.dtype, np.integer) or arr.dtype == np.bool_:
        return arr[0]
    return arr.astype(np.float32).mean(axis=0).astype(arr.dtype)


def collapse_local(state: TrainState, mesh: DataMesh) -> Dict:
    """The ranks' mean of a run whose ranks hold their own parameters (the
    deployable model): ``{"params", "batch_stats", "opt_state"}`` as
    flax's trees (``weights``), every rank's gathered and averaged as the
    reference's ``collapse_local`` averages its leading axis, and ``step``.
    A collective: every rank calls it."""
    from persia_tpu_torch.weights import _dense_tree

    rows = mesh.all_gather_object(_dense_tree(state))
    return {**_tree_mean(rows), "step": state.step}


# ------------------------------------------------------------ the step


def build_sync_train_step(model: torch.nn.Module, optimizer: Optional[torch.optim.Optimizer], mesh: DataMesh,
                          algorithm, loss_fn: Callable = default_loss_fn, sharded_update: bool = False):
    """Returns ``step(state, batch) -> (header, gpacked)`` over this rank's
    share of the batch (``batch``, as ``build_train_step`` takes it), which
    updates ``state`` in place (``state.sync`` the ``SyncState``; the
    bytegrad residual ``state.sync.residual``, QAdam's and
    LowPrecisionDecentralized's state ``state.sync.algo_state``).
    ``optimizer`` updates the parameters (None for ``QAdam``, which is its
    own).

    ``header`` is ``[mean loss over the ranks | every rank's predictions, in
    rank order]``; ``gpacked`` the embedding inputs' gradients of the
    global batch, slot after slot (pooled: every rank's rows / n, in rank
    order; distinct rows: summed over the ranks / n), in the wire dtype."""
    if sharded_update and not isinstance(algorithm, (GradientAllReduce, BlockInt8Ring)):
        raise ValueError("sharded_update composes with GradientAllReduce or BlockInt8Ring only "
                         f"(got {type(algorithm).__name__})")
    local = isinstance(algorithm, LOCAL_ALGORITHMS)
    qadam = isinstance(algorithm, QAdam)
    if optimizer is None and not qadam:
        raise ValueError(f"{type(algorithm).__name__} updates through the optimizer: pass one")
    leaves = dense_leaves(model)
    offsets = np.concatenate([[0], np.cumsum([p.numel() for _path, p, _tr in leaves])]).tolist()
    n = mesh.size
    # bytegrad's (and QAdam's) leaf lengths, made once on the parameters' device
    lengths = torch.tensor(np.diff(offsets), device=leaves[0][1].device) \
        if isinstance(algorithm, (ByteGradAllReduce, QAdam)) else None

    def local_sync(st: SyncState, step_no: int) -> None:
        """The parameters' sync of the algorithms whose ranks hold their
        own, every ``period`` steps."""
        if step_no % algorithm.period:
            return
        flat = ravel(leaves, lambda p: p.detach())
        if isinstance(algorithm, Decentralized):
            # the direction alternates by the sync's ordinal, not the raw
            # step: with an even period a step's parity would pick one side
            flat = ring_neighbor_average(flat, step_no // algorithm.period, mesh)
        elif isinstance(algorithm, LocalSGD):
            flat = _div(mesh.all_reduce(flat), n)
        else:
            lp_ring_sync(flat, st.algo_state, offsets, mesh)
        unravel_into(flat, leaves, lambda p: p)

    def step(state: TrainState, batch: Dict):
        st = state.sync
        model.train()
        emb_diff, emb_static = _split_emb(batch["emb"])
        emb_leaves = [d.detach().requires_grad_(True) for d in emb_diff]
        logits = model(batch["dense"], _embedding_model_inputs(emb_leaves, emb_static))
        loss = loss_fn(logits, batch["labels"][0])
        model.zero_grad(set_to_none=True)
        loss.backward()
        emb_grads = [l.grad if l.grad is not None else torch.zeros_like(l) for l in emb_leaves]
        step_no = state.step + 1
        with torch.no_grad():
            for _path, p, _tr in leaves:  # a parameter the loss does not reach syncs a zero gradient
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            # the local algorithms' gradients drive each rank's update as they are
            flat_g = None if local else ravel(leaves, lambda p: p.grad)
            if sharded_update:
                flat_p = _sharded_flat_update(st, ravel(leaves, lambda p: p), flat_g)
                unravel_into(flat_p, leaves, lambda p: p)
                model.zero_grad(set_to_none=True)
            elif qadam:
                flat_p = _qadam_update(algorithm, st.algo_state, ravel(leaves, lambda p: p), flat_g, step_no, offsets,
                                       lengths, mesh)
                unravel_into(flat_p, leaves, lambda p: p)
                model.zero_grad(set_to_none=True)
            elif not local:
                if isinstance(algorithm, BlockInt8Ring):
                    flat_sum, new_ef = _block_ring_allreduce_flat(flat_g, st.ef, algorithm, mesh)
                    st.ef.copy_(new_ef)
                    synced = _div(flat_sum[:flat_g.numel()], n)
                elif isinstance(algorithm, ByteGradAllReduce):
                    res = st.residual if algorithm.error_feedback else torch.zeros_like(flat_g)
                    synced, new_res = bytegrad_allreduce(flat_g, res, offsets, mesh, lengths)
                    if algorithm.error_feedback:
                        st.residual = new_res
                else:
                    synced = allreduce_mean(flat_g, mesh, algorithm.dtype)
                unravel_into(synced, leaves, lambda p: p.grad)
        if not (sharded_update or qadam):
            optimizer.step()
        if local:
            with torch.no_grad():
                local_sync(st, step_no)
        state.step = step_no
        with torch.no_grad():
            synced_emb = []
            for g, static in zip(emb_grads, emb_static):
                if static is None:  # pooled: this rank's rows of the global batch
                    synced_emb.append(_div(mesh.all_gather(g), n).reshape(-1))
                else:
                    synced_emb.append(_div(mesh.all_reduce(g.clone()), n).reshape(-1))
            loss_all = _div(mesh.all_reduce(loss.detach().reshape(1).float().clone()), n)
            preds = mesh.all_gather(torch.sigmoid(logits.detach()).reshape(-1).float()).reshape(-1)
            header = torch.cat([loss_all, preds])
            gpacked = torch.cat(synced_emb) if synced_emb else torch.zeros(0, device=loss.device)
        return header, gpacked

    return step
