"""The sparse optimizer update of tables resident in the card's memory
(counterpart of ``persia_tpu/ops/sparse_update.py``): the CUDA kernel K5
(``csrc/sparse_update.cu``) and its plain PyTorch version.

For the rows named by ``ids`` (N,) with gradients ``grads`` (N, dim):

1. padding (``mask`` False) is routed to the ``INT32_MAX`` sentinel, which
   sorts last and touches no row, not even through weight decay;
2. the ids are sorted stably and each id's gradients summed in f32, in
   sorted (that is, stream) order: the parameter server's per-sign
   accumulation;
3. each touched row and its optimizer state are read, and SGD, Adagrad
   (± vectorwise, the mean of g²) or Adam (with the batch's beta powers,
   read from a device tensor) applied; weight decay applies to SGD and
   Adagrad only;
4. each row is written as ``w + (new_w - w)`` in the table's dtype, its
   state as ``st + (new_st - st)``: the reference's ``table.at[uid].add(...,
   mode="drop")``. Ids outside [0, V) are dropped.

Both versions update ``table`` and ``state`` in place (the counterpart of
the reference's donated buffers) and return them. A CPU tensor takes the
plain version (``dedup_gradients``, ``_apply_rows``, ``index_add_``); a CUDA
tensor ``torch.sort`` (the reference's ``jnp.argsort``, XLA's sort outside
any kernel) and K5: a pass that lists the segments (runs of one id) as
short or long, then a block for each long segment (its rows staged into
shared memory, summed in sorted order) and a lane group for each short
one. Each segment writes only its own row, so no float is summed with
atomics, and K5 equals its plain version bit for bit. The segment lists,
in numpy, are ``plans.k5_segments``.

The routing of a table's update ids: per slot, an id in the slot's [0,
vocab) becomes id + offset, any other id the sentinel. The fused step takes
its keys from K4, which writes them as it gathers
(``fused_gather(..., keys=True)``); ``update_keys`` routes them in a launch
of its own (the ``update_keys_kernel`` of ``csrc/sparse_update.cu``) where
there is no gather: the graph step's warm-up, finding the rows it puts
back.

One difference from the reference, at the direct call only: an id < 0 that
no mask covers is dropped here, where JAX wraps it to row V + id. The fused
step routes its padding to the sentinel itself (K4's keys), so it never
passes one.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from persia_tpu_torch.embedding.optim import (
    OPTIMIZER_ADAGRAD,
    OPTIMIZER_ADAM,
    OPTIMIZER_SGD,
    OptimizerConfig,
)
from persia_tpu_torch.ops import _kernels, plans
from persia_tpu_torch.ops.fused_gather import update_keys_reference

PAD_SENTINEL = int(np.iinfo(np.int32).max)
MAX_SLOTS = 128  # slots one launch of update_keys routes
_DTYPES = {torch.float32: _kernels.DTYPE_F32, torch.bfloat16: _kernels.DTYPE_BF16}
# ``UpdateSlots`` of csrc/sparse_update.cu, passed by pointer
_SLOTS = np.dtype([
    ("ids", "<u8", (MAX_SLOTS,)),
    ("start", "<i4", (MAX_SLOTS + 1,)),
    ("offset", "<i4", (MAX_SLOTS,)),
    ("vocab", "<i4", (MAX_SLOTS,)),
])


def init_sparse_state(
    cfg: OptimizerConfig, vocab: int, dim: int, device=None
) -> Dict[str, torch.Tensor]:
    """Per-table optimizer state, f32: Adagrad ``acc`` (V, dim) or (V, 1)
    at its initial value, Adam ``m`` and ``v`` (V, dim) zeros, SGD none."""
    if cfg.kind == OPTIMIZER_SGD:
        return {}
    if cfg.kind == OPTIMIZER_ADAGRAD:
        width = 1 if cfg.vectorwise_shared else dim
        return {"acc": torch.full((vocab, width), cfg.initialization, dtype=torch.float32, device=device)}
    if cfg.kind == OPTIMIZER_ADAM:
        return {
            "m": torch.zeros((vocab, dim), dtype=torch.float32, device=device),
            "v": torch.zeros((vocab, dim), dtype=torch.float32, device=device),
        }
    raise ValueError(f"unknown optimizer kind {cfg.kind}")


def _masked(ids: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    ids = ids.to(torch.int32)
    if mask is None:
        return ids
    return torch.where(mask, ids, torch.full_like(ids, PAD_SENTINEL))


def dedup_gradients(
    ids: torch.Tensor, grads: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ids (N,), grads (N, D) → (uid (N,), gsum (N, D), valid (N,) bool).
    Row k below the number of distinct ids holds the k-th distinct id
    (ascending) and the f32 sum of its gradients in stream order; the rows
    past it are zeros flagged invalid, as is the padding sentinel's."""
    n = ids.shape[0]
    ids = _masked(ids, mask)
    if mask is not None:
        grads = grads * mask[..., None].to(grads.dtype)
    sids, order = torch.sort(ids, stable=True)
    sg = grads[order].float()
    is_new = torch.ones(n, dtype=torch.bool, device=ids.device)
    is_new[1:] = sids[1:] != sids[:-1]
    seg = torch.cumsum(is_new.long(), 0) - 1
    gsum = torch.zeros((n,) + tuple(grads.shape[1:]), dtype=torch.float32, device=ids.device)
    gsum.index_add_(0, seg, sg)  # sequential on the CPU: stream order
    uid = torch.zeros(n, dtype=ids.dtype, device=ids.device).scatter_(0, seg, sids)
    last = seg[-1] if n else torch.tensor(-1, device=ids.device)
    valid = (torch.arange(n, device=ids.device) <= last) & (uid != PAD_SENTINEL)
    return uid, gsum, valid


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root (through f64: exact for f32),
    as the kernel's ``__fsqrt_rn``; PyTorch's CPU ``sqrt`` of f32 is not."""
    return torch.sqrt(x.double()).float()


def _mean_sq(g: torch.Tensor) -> torch.Tensor:
    """Mean of g² over the last axis, summed column by column in order,
    as the kernel sums."""
    sq = g * g
    total = torch.zeros_like(sq[..., :1])
    for c in range(sq.shape[-1]):
        total = total + sq[..., c:c + 1]
    return total / sq.shape[-1]


def _apply_rows(
    cfg: OptimizerConfig,
    w: torch.Tensor,
    st: Dict[str, torch.Tensor],
    g: torch.Tensor,
    batch_state: torch.Tensor,
):
    """The optimizer on an (N, D) block of touched rows, in f32, in the
    reference's order of operations (``OptimizerConfig.update_dense``),
    each operation rounded once, as the kernel rounds."""
    w = w.float()
    g = g.float()
    if cfg.weight_decay and cfg.kind in (OPTIMIZER_SGD, OPTIMIZER_ADAGRAD):
        g = g + cfg.weight_decay * w
    if cfg.kind == OPTIMIZER_SGD:
        return w - cfg.lr * g, {}
    if cfg.kind == OPTIMIZER_ADAGRAD:
        if cfg.vectorwise_shared:
            acc = st["acc"] * cfg.g_square_momentum + _mean_sq(g)
        else:
            acc = st["acc"] * cfg.g_square_momentum + g * g
        return w - cfg.lr * g / _sqrt(acc + cfg.eps), {"acc": acc}
    if cfg.kind == OPTIMIZER_ADAM:
        m = st["m"] * cfg.beta1 + (1.0 - cfg.beta1) * g
        v = st["v"] * cfg.beta2 + (1.0 - cfg.beta2) * g * g
        m_hat = m / (1.0 - batch_state[0])
        v_hat = v / (1.0 - batch_state[1])
        return w - cfg.lr * m_hat / (_sqrt(v_hat) + cfg.eps), {"m": m, "v": v}
    raise ValueError(f"unknown optimizer kind {cfg.kind}")


def sparse_update_reference(
    cfg: OptimizerConfig,
    table: torch.Tensor,
    state: Dict[str, torch.Tensor],
    ids: torch.Tensor,
    grads: torch.Tensor,
    batch_state: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
):
    """Plain version: dedup, gather, ``_apply_rows``, ``index_add_`` of the
    deltas onto the rows kept (valid and inside the table)."""
    v_rows = table.shape[0]
    uid, gsum, valid = dedup_gradients(ids, grads, mask)
    keep = valid & (uid >= 0) & (uid < v_rows)
    rows = uid[keep].long()
    w = table[rows]
    st_rows = {k: s[rows] for k, s in state.items()}
    new_w, new_st = _apply_rows(cfg, w, st_rows, gsum[keep], batch_state)
    table.index_add_(0, rows, (new_w - w.float()).to(table.dtype))
    for k, s in state.items():
        s.index_add_(0, rows, (new_st[k] - st_rows[k]).to(s.dtype))
    return table, state


def _check(cfg, table, state, sids, perm, grads, batch_state) -> None:
    dev = table.device
    if table.dtype not in _DTYPES or table.dim() != 2 or not table.is_contiguous():
        raise ValueError("sparse_update needs a contiguous (V, dim) float32 or bfloat16 table")
    v_rows, dim = table.shape
    widths = {"acc": 1 if cfg.vectorwise_shared else dim, "m": dim, "v": dim}
    want = {OPTIMIZER_SGD: (), OPTIMIZER_ADAGRAD: ("acc",), OPTIMIZER_ADAM: ("m", "v")}[cfg.kind]
    if tuple(sorted(state)) != tuple(sorted(want)):
        raise ValueError(f"optimizer state keys {sorted(state)} do not match the optimizer ({want})")
    for k, s in state.items():
        if s.dtype != torch.float32 or s.device != dev or not s.is_contiguous() or s.shape != (v_rows, widths[k]):
            raise ValueError(f"state {k!r} must be contiguous ({v_rows}, {widths[k]}) float32 on {dev}")
    n = sids.shape[0]
    if sids.dtype != torch.int32 or perm.dtype != torch.int64 or perm.shape != (n,):
        raise ValueError("sorted ids must be int32 and the permutation int64, both (N,)")
    if grads.dtype != torch.float32 or grads.shape != (n, dim) or not grads.is_contiguous():
        raise ValueError(f"grads must be contiguous ({n}, {dim}) float32")
    if batch_state.dtype != torch.float32 or batch_state.numel() != 2:
        raise ValueError("batch_state must be float32 (beta1^t, beta2^t)")
    for t in (sids, perm, grads, batch_state):
        if t.device != dev:
            raise ValueError(f"every input must be on the table's device {dev}")


def _aligned(*tensors, bytes_: int = 16) -> bool:
    return all(t is None or t.data_ptr() % bytes_ == 0 for t in tensors)


def _launch(cfg, table, state, sids, perm, grads, batch_state) -> None:
    _check(cfg, table, state, sids, perm, grads, batch_state)
    n = sids.shape[0]
    if n == 0:
        return
    s0 = state.get("acc", state.get("m"))
    s1 = state.get("v")
    per_column = s0 if not (cfg.kind == OPTIMIZER_ADAGRAD and cfg.vectorwise_shared) else None
    aligned = _aligned(grads, per_column, s1) and _aligned(table, bytes_=4 * table.element_size())
    plan = plans.sparse_update_plan(n, table.shape[1], aligned)
    stream = _kernels.stream_handle(table)
    # K5's counters and segment lists, reset by its first stage. Freed
    # after the call, stream-ordered; under graph capture the graph's own
    # pool keeps it for the graph's life, so a replay needs no host.
    scratch = torch.empty(plan.scratch_ints, dtype=torch.int32, device=table.device)
    lib = _kernels.library()
    with torch.cuda.device(table.device):
        rc = lib.persia_sparse_update(
            table.data_ptr(), _DTYPES[table.dtype], table.shape[0], table.shape[1],
            0 if s0 is None else s0.data_ptr(), 0 if s1 is None else s1.data_ptr(),
            sids.data_ptr(), perm.data_ptr(), grads.data_ptr(), n, batch_state.data_ptr(),
            cfg.kind, int(bool(cfg.vectorwise_shared)), cfg.lr, cfg.weight_decay, cfg.g_square_momentum,
            cfg.eps, cfg.beta1, 1.0 - cfg.beta1, cfg.beta2, 1.0 - cfg.beta2,
            scratch.data_ptr(), plan.vec, plan.tile_rows, stream,
        )
    _kernels.check(rc, "sparse_update")
    sparse_update.launches += 1


def sparse_update(
    cfg: OptimizerConfig,
    table: torch.Tensor,
    state: Dict[str, torch.Tensor],
    ids: torch.Tensor,
    grads: torch.Tensor,
    batch_state: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
):
    """One sparse optimizer step of the rows named by ``ids``, in place:
    returns ``(table, state)``, the same tensors. ``batch_state`` is the
    f32[2] (beta1^t, beta2^t) for Adam (ones when None); ``mask`` (N,) bool
    marks live entries. A CPU table takes the plain version; a CUDA table
    ``torch.sort`` and K5 (its three kernels count as one launch)."""
    if batch_state is None:
        batch_state = torch.ones(2, dtype=torch.float32, device=table.device)
    if table.device.type == "cpu":
        return sparse_update_reference(cfg, table, state, ids, grads, batch_state, mask)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    sids, perm = torch.sort(_masked(ids, mask), stable=True)
    _launch(cfg, table, state, sids, perm, grads.float().contiguous(), batch_state)
    return table, state


def sparse_update_sorted(cfg, table, state, sids, perm, grads, batch_state):
    """K5 alone on ids already sorted (``torch.sort(masked_ids,
    stable=True)``): every stage ``sparse_update`` launches after its sort,
    for timing K5 apart from the sort. CUDA tensors only."""
    if table.device.type != "cuda":
        raise ValueError("sparse_update_sorted launches the kernel: CUDA tensors only")
    _launch(cfg, table, state, sids, perm, grads, batch_state)
    return table, state


sparse_update.launches = 0


def masked_flat_ids_grads(
    ids: torch.Tensor, grads: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flatten a (B,) or (B, L) slot with -1 padding and its per-position
    gradients for ``sparse_update``: (flat ids, flat grads (N, D), mask)."""
    mask = (ids >= 0).reshape(-1)
    return ids.reshape(-1), grads.reshape(-1, grads.shape[-1]), mask


def update_keys(ids: Sequence[torch.Tensor], offsets: Sequence[int], vocabs: Sequence[int]) -> torch.Tensor:
    """One table's flat int32 update keys, slot after slot: for each slot's
    ids ((B,) or (B, L) int32, -1 = padding) an id in [0, vocab) becomes
    id + offset (its row in the table), any other id ``PAD_SENTINEL``.
    A CPU tensor takes the plain version; CUDA tensors one launch per
    group of at most 128 slots."""
    if not ids or not (len(ids) == len(offsets) == len(vocabs)):
        raise ValueError("need ids, an offset and a vocab for each slot, and at least one slot")
    dev = ids[0].device
    if dev.type == "cpu":
        return update_keys_reference(ids, offsets, vocabs)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for i, o, v in zip(ids, offsets, vocabs):
        if i.dtype != torch.int32 or i.device != dev or not i.is_contiguous():
            raise ValueError("a slot's ids must be contiguous int32 on one device")
        if v < 1 or o < 0 or o + v > PAD_SENTINEL:
            raise ValueError(f"slot rows [{o}, {o + v}) must lie in [0, {PAD_SENTINEL})")
    counts = [i.numel() for i in ids]
    if sum(counts) > PAD_SENTINEL:
        raise ValueError("a table's positions must fit int32")
    out = torch.empty(sum(counts), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    lib = _kernels.library()
    stream = _kernels.stream_handle(out)
    pos = 0
    with torch.cuda.device(dev):
        for s0 in range(0, len(ids), MAX_SLOTS):
            part = range(s0, min(len(ids), s0 + MAX_SLOTS))
            params = np.zeros(1, _SLOTS)
            params["ids"][0, :len(part)] = [ids[s].data_ptr() for s in part]
            params["start"][0, 1:len(part) + 1] = np.cumsum([counts[s] for s in part])
            params["offset"][0, :len(part)] = [offsets[s] for s in part]
            params["vocab"][0, :len(part)] = [vocabs[s] for s in part]
            rc = lib.persia_update_keys(params.ctypes.data, len(part), out[pos:].data_ptr(), stream)
            _kernels.check(rc, "update_keys")
            update_keys.launches += 1
            pos += sum(counts[s] for s in part)
    return out


update_keys.launches = 0
