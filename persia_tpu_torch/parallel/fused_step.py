"""The fused all-on-card tier (counterpart of
``persia_tpu/parallel/fused_step.py``): every embedding table resident in
the card's memory, and the whole hybrid step run on the card.

    ids → gather and update-id routing (K4, one launch a table) → the
        model's forward and backward (any of the port's models: DLRM,
        DeepFM, DCN-v2, DNN, whose batch norms run K10 and K11 and move
        their running statistics in place in train mode) → Adam on the
        dense tower → sort of the update ids → sparse optimizer update of
        the touched rows (K5)

Per step only the raw batch (int32 ids, dense features, labels) goes in;
no embedding or gradient crosses to the host. The eval step runs the
model in eval mode (batch norms on their running statistics).

The state is updated in place (the counterpart of the reference's donated
buffers): ``FusedTrainState`` holds the model, its ``torch.optim.Adam``,
the tables and their optimizer state, the Adam batch powers of the sparse
optimizer (a device f32[2]) and the step count (a device int32), and a
step returns the same state object. The gathered rows are the step's
differentiated leaves, as ``jax.value_and_grad(..., argnums=(0, 1))`` in
the reference: pooling and masking stay in ``_model_inputs``, under
autograd, so the gather needs no backward kernel.

``jit=True`` on a card (the counterpart of ``jax.jit``): the step replays a
CUDA graph of the whole step (gather and routing, forward, backward, Adam,
sort, K5), captured at the first call for the batch's shapes. The batch
is copied into the graph's static input buffers; the capture's warm-up
runs on the caller's state and then restores it bit for bit (the dense
state whole, batch statistics included, the tables' and their optimizer
state's touched rows only, so a capture needs no second copy of the
tables). Adam is built
``capturable`` on a card in both the eager and the graph step, so the two
give the same bits. On the CPU both are eager.

Tables are dense-keyed [0, vocab) and seeded from a ``torch.Generator``, so
their init matches the reference's only in distribution; the tests carry
state across with ``persia_tpu_torch.weights.fused_state_from_flax``.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from persia_tpu_torch.ctx import _to_device
from persia_tpu_torch.device import resolve_device
from persia_tpu_torch.embedding.optim import OptimizerConfig
from persia_tpu_torch.ops.fused_gather import fused_gather
from persia_tpu_torch.ops.sparse_update import init_sparse_state, sparse_update, update_keys
from persia_tpu_torch.parallel.stage_graph import StageGraph
from persia_tpu_torch.parallel.train_step import default_loss_fn


@dataclass(frozen=True)
class FusedSlotSpec:
    """One card-resident slot: dense [0, vocab) rows of ``dim``.
    ``init_method`` (a ``config.InitializationMethod``) selects the init
    distribution; ``None`` is uniform over ``init_bounds``."""

    vocab: int
    dim: int
    pooled: bool = True  # embedding_summation; False → raw (B, L, D) + mask
    sqrt_scaling: bool = False
    init_bounds: Tuple[float, float] = (-0.01, 0.01)
    init_method: "object | None" = None


def _gamma(alpha: float, n: int, generator: torch.Generator, device) -> torch.Tensor:
    """Gamma(alpha, 1) draws from ``generator`` (Marsaglia and Tsang, with
    the U^(1/alpha) boost below alpha 1), f32."""
    a = alpha + 1.0 if alpha < 1.0 else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / np.sqrt(9.0 * d)
    out = torch.empty(n, dtype=torch.float32, device=device)
    todo = torch.arange(n, device=device)
    while todo.numel():
        x = torch.randn(todo.numel(), generator=generator, device=device)
        u = torch.rand(todo.numel(), generator=generator, device=device)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v + d * torch.log(v.clamp(min=1e-30)))
        out[todo[ok]] = (d * v[ok]).float()
        todo = todo[~ok]
    if alpha < 1.0:
        out *= torch.rand(n, generator=generator, device=device) ** (1.0 / alpha)
    return out


def _sample_init(generator: torch.Generator, shape, spec: FusedSlotSpec, dtype, device) -> torch.Tensor:
    """A table block drawn from the slot's init distribution (f32, then
    rounded to ``dtype``)."""
    m = spec.init_method
    out = torch.empty(shape, dtype=torch.float32, device=device)
    if m is None:
        out.uniform_(*spec.init_bounds, generator=generator)
    elif m.kind == "uniform":
        out.uniform_(m.p0, m.p1, generator=generator)
    elif m.kind == "inverse_sqrt":
        b = 1.0 / float(np.sqrt(shape[-1]))
        out.uniform_(-b, b, generator=generator)
    elif m.kind == "normal":
        out.normal_(generator=generator).mul_(m.p1).add_(m.p0)
    elif m.kind == "gamma":
        out = (_gamma(m.p0, out.numel(), generator, device) * m.p1).reshape(shape)
    elif m.kind == "poisson":
        out = torch.poisson(torch.full(shape, float(m.p0), device=device), generator=generator)
    else:
        raise ValueError(f"unknown init kind: {m.kind!r}")
    return out.to(dtype)


@dataclass
class FusedTrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer  # Adam over the model's parameters
    tables: Dict[str, torch.Tensor]
    emb_state: Dict[str, Dict[str, torch.Tensor]]
    emb_batch_state: torch.Tensor  # f32[2]: (beta1^t, beta2^t) of the sparse Adam
    step: torch.Tensor  # int32 scalar


def _slot_generators(rng: torch.Generator, names: Sequence[str], device) -> Dict[str, torch.Generator]:
    """One generator on ``device`` per slot, seeded from ``rng`` in sorted
    slot-name order: a slot's init is the same in every layout."""
    names = sorted(names)
    seeds = torch.randint(0, 2 ** 62, (max(len(names), 1),), generator=rng)
    return {n: torch.Generator(device=device).manual_seed(int(s)) for n, s in zip(names, seeds)}


def create_fused_tables(
    rng: torch.Generator, specs: Dict[str, FusedSlotSpec], sparse_cfg: OptimizerConfig,
    dtype=torch.float32, device=None,
):
    """One table per slot, seeded, and its optimizer state."""
    dev = resolve_device(device)
    gens = _slot_generators(rng, list(specs), dev)
    tables, emb_state = {}, {}
    for name in sorted(specs):
        s = specs[name]
        tables[name] = _sample_init(gens[name], (s.vocab, s.dim), s, dtype, dev)
        emb_state[name] = init_sparse_state(sparse_cfg, s.vocab, s.dim, device=dev)
    return tables, emb_state


_INT32_MAX = int(np.iinfo(np.int32).max)


@dataclass(frozen=True)
class StackGroup:
    """One physical stacked table covering several same-dim slots."""

    name: str
    slots: Tuple[str, ...]
    offsets: Tuple[int, ...]  # row offset of each slot, aligned with ``slots``
    vocab: int
    dim: int


def group_stacked_specs(specs: Dict[str, FusedSlotSpec], slot_order: Sequence[str]) -> List[StackGroup]:
    """Group slots by dim into stacked tables, in a fixed order, splitting a
    group before its rows would overflow int32 ids."""
    by_dim: Dict[int, List[str]] = {}
    for name in slot_order:
        by_dim.setdefault(specs[name].dim, []).append(name)
    groups = []
    for dim in sorted(by_dim):
        names, offsets, total, part = [], [], 0, 0
        for name in by_dim[dim]:
            v = specs[name].vocab
            if total + v > _INT32_MAX and names:
                groups.append(StackGroup(f"__stack_d{dim}_{part}", tuple(names), tuple(offsets), total, dim))
                names, offsets, total = [], [], 0
                part += 1
            names.append(name)
            offsets.append(total)
            total += v
        groups.append(StackGroup(f"__stack_d{dim}_{part}", tuple(names), tuple(offsets), total, dim))
    return groups


def create_stacked_tables(
    rng: torch.Generator, specs: Dict[str, FusedSlotSpec], groups: Sequence[StackGroup],
    sparse_cfg: OptimizerConfig, dtype=torch.float32, device=None,
):
    """Stacked tables, each slot's row range drawn from its own init, one
    slot at a time into the group table (peak memory: the table and one
    slot's rows)."""
    dev = resolve_device(device)
    gens = _slot_generators(rng, [n for g in groups for n in g.slots], dev)
    tables, emb_state = {}, {}
    for g in groups:
        tbl = torch.empty((g.vocab, g.dim), dtype=dtype, device=dev)
        for name, off in zip(g.slots, g.offsets):
            s = specs[name]
            tbl[off:off + s.vocab].copy_(_sample_init(gens[name], (s.vocab, s.dim), s, dtype, dev))
        tables[g.name] = tbl
        emb_state[g.name] = init_sparse_state(sparse_cfg, g.vocab, g.dim, device=dev)
    return tables, emb_state


def _model_inputs(specs, slot_order, gathered: Dict[str, torch.Tensor], ids: Dict[str, torch.Tensor]) -> List:
    """Per-slot model inputs from the gathered rows: single-id padding
    gives a zero embedding, bags are masked and summed (and sqrt-scaled),
    raw slots pass (rows, mask)."""
    out = []
    for name in slot_order:
        g, i = gathered[name], ids[name]
        if g.dim() == 2:  # single-id slot; -1 padding → zero embedding
            out.append(g * (i >= 0)[..., None].to(g.dtype))
            continue
        mask = i >= 0
        if specs[name].pooled:
            pooled = (g * mask[..., None].to(g.dtype)).sum(dim=1)
            if specs[name].sqrt_scaling:
                cnt = torch.clamp(mask.sum(dim=1), min=1).to(pooled.dtype)
                pooled = pooled / torch.sqrt(cnt)[..., None]
            out.append(pooled)
        else:
            out.append((g, mask))
    return out


def _plan(specs, slot_order, stack: bool):
    """(table, slots, offsets, vocabs, stacked) per gather: one per
    dim-group when stacked, one per slot otherwise."""
    if stack:
        return [(g.name, g.slots, g.offsets, tuple(specs[n].vocab for n in g.slots), True)
                for g in group_stacked_specs(specs, slot_order)]
    return [(n, (n,), (0,), (specs[n].vocab,), False) for n in slot_order]


def _gather(tables, ids, plan, leaves: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    """Per-slot gathered rows ((B, dim) or (B, L, dim)), one launch of K4 per
    table. With ``leaves``, each table's rows become a leaf that needs a
    gradient and the slots views of it; the same launch routes the table's
    update ids, and ``leaves`` keeps (leaf, update keys) by table name."""
    out = {}
    for tname, slots, offsets, vocabs, stacked in plan:
        tids = [ids[n] for n in slots]
        if leaves is None:
            rows = fused_gather(tables[tname], tids, offsets, vocabs, stacked)
        else:
            rows, keys = fused_gather(tables[tname], tids, offsets, vocabs, stacked, keys=True)
            rows = rows.detach().requires_grad_(True)
            leaves[tname] = (rows, keys)
        parts = torch.split(rows, [ids[n].numel() for n in slots])
        for n, p in zip(slots, parts):
            out[n] = p.view(*ids[n].shape, rows.shape[1])
    return out


def _gather_all(tables: Dict[str, torch.Tensor], ids: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Unstacked gather: one table per slot; an id < 0 reads row 0 and an
    id >= vocab a row of NaN (``jnp.take``'s fill mode)."""
    return _gather(tables, ids, [(n, (n,), (0,), (tables[n].shape[0],), False) for n in ids])


def _gather_all_stacked(tables, ids, groups: Sequence[StackGroup]) -> Dict[str, torch.Tensor]:
    """Stacked gather: one launch per dim-group, ids clamped to the slot's
    own [0, vocab) before its offset."""
    plan = []
    for g in groups:
        ends = list(g.offsets[1:]) + [g.vocab]
        plan.append((g.name, g.slots, g.offsets, tuple(e - o for o, e in zip(g.offsets, ends)), True))
    return _gather(tables, ids, plan)


def stacked_slot_table(tables: Dict[str, torch.Tensor], groups: Sequence[StackGroup], name: str) -> torch.Tensor:
    """Per-slot (vocab, dim) view of a stacked table."""
    for g in groups:
        if name in g.slots:
            i = g.slots.index(name)
            end = g.offsets[i + 1] if i + 1 < len(g.slots) else g.vocab
            return tables[g.name][g.offsets[i]:end]
    raise KeyError(name)


def _init_adam_state(optimizer: torch.optim.Optimizer) -> None:
    """Create Adam's state for every parameter now, as its first step
    would: the capture and the checkpoint then find it in place."""
    for group in optimizer.param_groups:
        if group.get("amsgrad"):
            raise ValueError("the fused tier's dense optimizer is Adam without amsgrad")
        for p in group["params"]:
            st = optimizer.state[p]
            if st:
                continue
            on_device = group.get("capturable") or group.get("fused")
            st["step"] = torch.zeros((), dtype=torch.float32, device=p.device if on_device else "cpu")
            st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)


def prepare_dense_optimizer(optimizer: torch.optim.Optimizer, device: torch.device) -> None:
    """Make ``optimizer`` (a ``torch.optim.Adam``) fit the fused step: on a
    card ``capturable`` (its step count on the card, no host sync), so the
    eager and the graph step run the same kernels; its state created."""
    if not isinstance(optimizer, torch.optim.Adam):
        raise TypeError(f"the fused tier's dense optimizer is torch.optim.Adam, got {type(optimizer).__name__}")
    if device.type == "cuda":
        for group in optimizer.param_groups:
            group["capturable"] = True
    _init_adam_state(optimizer)


def init_fused_state(
    model: torch.nn.Module,
    dense_optimizer: torch.optim.Optimizer,
    rng: torch.Generator,
    specs: Dict[str, FusedSlotSpec],
    sparse_cfg: OptimizerConfig,
    slot_order: Optional[Sequence[str]] = None,
    stack: bool = False,
    table_dtype=torch.float32,
    device=None,
) -> FusedTrainState:
    """Tables seeded from ``rng`` (a CPU ``torch.Generator``) on ``device``
    (``cuda`` unless given), with ``model`` (its own parameters, moved
    there) and ``dense_optimizer`` (an Adam over them)."""
    dev = resolve_device(device)
    slot_order = list(slot_order or sorted(specs))
    model.to(dev)
    prepare_dense_optimizer(dense_optimizer, dev)
    if stack:
        groups = group_stacked_specs(specs, slot_order)
        tables, emb_state = create_stacked_tables(rng, specs, groups, sparse_cfg, table_dtype, dev)
    else:
        tables, emb_state = create_fused_tables(rng, specs, sparse_cfg, table_dtype, dev)
    return FusedTrainState(
        model=model, optimizer=dense_optimizer, tables=tables, emb_state=emb_state,
        emb_batch_state=torch.ones(2, dtype=torch.float32, device=dev),
        step=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _step_body(sparse_cfg, specs, slot_order, loss_fn, plan):
    """One training step on ``state``, in place: returns (loss, preds) on
    the device. What the graph captures and the eager step runs."""
    betas = {}

    def body(state: FusedTrainState, batch: Dict):
        ids = batch["ids"]
        leaves: Dict[str, torch.Tensor] = {}
        gathered = _gather(state.tables, ids, plan, leaves)
        model = state.model
        model.train()
        logits = model(batch["dense"], _model_inputs(specs, slot_order, gathered, ids))
        loss = loss_fn(logits, batch["labels"][0])
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()

        dev = state.emb_batch_state.device
        if dev not in betas:
            betas[dev] = torch.tensor([sparse_cfg.beta1, sparse_cfg.beta2], dtype=torch.float32, device=dev)
        state.emb_batch_state.mul_(betas[dev])
        for tname, *_ in plan:
            leaf, keys = leaves[tname]
            grads = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
            sparse_update(sparse_cfg, state.tables[tname], state.emb_state[tname], keys, grads.float(),
                          state.emb_batch_state)
        state.step.add_(1)
        return loss.detach(), torch.sigmoid(logits.detach())

    return body


def _state_tensors(state: FusedTrainState) -> List[torch.Tensor]:
    """Every tensor the step updates in place."""
    return _dense_tensors(state) + list(state.tables.values()) + [
        t for st in state.emb_state.values() for t in st.values()]


def _dense_tensors(state: FusedTrainState) -> List[torch.Tensor]:
    """The state a step updates whole: the model, Adam, the powers, the step."""
    out = [p.data for p in state.model.parameters()] + list(state.model.buffers())
    for st in state.optimizer.state.values():
        out.extend(v for v in st.values() if torch.is_tensor(v))
    return out + [state.emb_batch_state, state.step]


def _batch_tensors(batch: Dict) -> List[torch.Tensor]:
    return list(batch["dense"]) + list(batch["labels"]) + [batch["ids"][k] for k in sorted(batch["ids"])]


class _GraphSteps:
    """Steps replayed from one CUDA graph, one per batch of a call. Captured at the first call
    and again whenever the batches' shapes or the state's tensors change;
    the batches are copied into static input buffers, the outputs cloned
    out of the graph's. A replay goes through no wrapper, so it adds
    nothing to the kernels' launch counts: the capture's warm-up and the
    capture itself each count once."""

    def __init__(self, body: Callable, plan):
        self.body = body
        self.plan = plan
        self.graph = None
        self.key = None

    def _key(self, state, batches):
        shapes = tuple((tuple(t.shape), t.dtype) for b in batches for t in _batch_tensors(b))
        return shapes, tuple(t.data_ptr() for t in _state_tensors(state))

    def _warm_up(self, state):
        """Run the steps once off the capture (builds, cuBLAS, the
        allocator), then put back what they wrote: the dense state whole,
        and of each table and its optimizer state only the rows the
        batches update (routed by ``update_keys``, a launch with no gather:
        the step's own keys come from K4)."""
        dense = [t.clone() for t in _dense_tensors(state)]
        rows = {}
        for tname, slots, offsets, vocabs, _ in self.plan:
            flat = torch.cat([update_keys([b["ids"][n] for n in slots], offsets, vocabs) for b in self.static])
            rows[tname] = torch.unique(flat[flat < state.tables[tname].shape[0]]).long()
        saved = {t: (state.tables[t][r], {k: s[r] for k, s in state.emb_state[t].items()})
                 for t, r in rows.items()}
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for b in self.static:
                self.body(state, b)
        torch.cuda.current_stream().wait_stream(side)
        for t, s in zip(_dense_tensors(state), dense):  # the caller's state, bit for bit
            t.copy_(s)
        for t, r in rows.items():
            state.tables[t].index_copy_(0, r, saved[t][0])
            for k, s in state.emb_state[t].items():
                s.index_copy_(0, r, saved[t][1][k])
        state.optimizer.zero_grad(set_to_none=True)

    def _capture(self, state, batches):
        self.graph = None
        torch.cuda.synchronize()
        self.static = [{
            "dense": [t.clone() for t in b["dense"]],
            "labels": [t.clone() for t in b["labels"]],
            "ids": {k: v.clone() for k, v in b["ids"].items()},
        } for b in batches]
        self._warm_up(state)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.outputs = [self.body(state, b) for b in self.static]
        self.graph = graph
        self.key = self._key(state, batches)

    def __call__(self, state: FusedTrainState, batches: Sequence[Dict]):
        if self.graph is None or self._key(state, batches) != self.key:
            self._capture(state, batches)
        for b, s in zip(batches, self.static):
            for src, dst in zip(_batch_tensors(b), _batch_tensors(s)):
                dst.copy_(src, non_blocking=True)
        self.graph.replay()
        return [(loss.clone(), preds.clone()) for loss, preds in self.outputs]


def build_fused_train_step(
    sparse_cfg: OptimizerConfig,
    specs: Dict[str, FusedSlotSpec],
    slot_order: Optional[Sequence[str]] = None,
    loss_fn: Callable = default_loss_fn,
    jit: bool = True,
    stack: bool = False,
):
    """Returns ``step(state, batch) -> (state, (loss, preds))``, which
    trains the state's model, optimizer and tables in place.

    batch = {"dense": [(B, F) f32 ...], "labels": [(B, 1) f32 ...],
             "ids": {slot: (B,) or (B, L) int32, -1 = padding}}, every
    tensor on the state's device. ``stack=True`` expects a state built with
    ``init_fused_state(stack=True)``: one gather and one sparse update per
    dim-group. ``jit=True`` replays a CUDA graph of the step on a card;
    ``jit=False``, and every CPU step, runs it eagerly."""
    slot_order = list(slot_order or sorted(specs))
    plan = _plan(specs, slot_order, stack)
    body = _step_body(sparse_cfg, specs, slot_order, loss_fn, plan)
    graphs = _GraphSteps(body, plan) if jit else None

    def step(state: FusedTrainState, batch: Dict):
        if graphs is None or state.step.device.type != "cuda":
            return state, body(state, batch)
        return state, graphs(state, [batch])[0]

    return step


def build_fused_multi_step(
    sparse_cfg: OptimizerConfig,
    specs: Dict[str, FusedSlotSpec],
    k: int,
    slot_order: Optional[Sequence[str]] = None,
    loss_fn: Callable = default_loss_fn,
    stack: bool = False,
):
    """``multi(state, batches) -> (state, (losses, preds_list))`` over a
    length-``k`` tuple of batches: on a card one CUDA graph of ``k`` steps,
    the same kernels as ``k`` single steps and so the same bits; on the CPU
    ``k`` eager steps."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    slot_order = list(slot_order or sorted(specs))
    plan = _plan(specs, slot_order, stack)
    body = _step_body(sparse_cfg, specs, slot_order, loss_fn, plan)
    graphs = _GraphSteps(body, plan)

    def multi(state: FusedTrainState, batches):
        if len(batches) != k:
            raise ValueError(f"expected {k} batches, got {len(batches)}")
        if state.step.device.type == "cuda":
            outs = graphs(state, list(batches))
        else:
            outs = [body(state, b) for b in batches]
        return state, (torch.stack([o[0] for o in outs]), [o[1] for o in outs])

    return multi


def build_fused_eval_step(specs, slot_order=None, stack: bool = False):
    """``eval_step(state, batch) -> preds``: sigmoid of the model's logits,
    under ``torch.inference_mode``, the model in eval mode (a batch norm
    reads its running statistics and moves nothing)."""
    slot_order = list(slot_order or sorted(specs))
    plan = _plan(specs, slot_order, stack)

    @torch.inference_mode()
    def eval_step(state: FusedTrainState, batch: Dict) -> torch.Tensor:
        ids = batch["ids"]
        gathered = _gather(state.tables, ids, plan)
        state.model.eval()
        return torch.sigmoid(state.model(batch["dense"], _model_inputs(specs, slot_order, gathered, ids)))

    return eval_step


def pack_ids(ids_np: Dict[str, np.ndarray], slot_order: Sequence[str]):
    """One contiguous int32 buffer of every slot's ids, for one host→device
    copy, and the slots' shapes."""
    flat = np.concatenate([np.ascontiguousarray(ids_np[n], dtype=np.int32).reshape(-1) for n in slot_order])
    return flat, [ids_np[n].shape for n in slot_order]


def unpack_ids(flat: torch.Tensor, slot_order: Sequence[str], shapes) -> Dict[str, torch.Tensor]:
    """Per-slot views of a packed id buffer."""
    out, off = {}, 0
    for name, shape in zip(slot_order, shapes):
        k = int(np.prod(shape))
        out[name] = flat[off:off + k].view(shape)
        off += k
    return out


def fused_batch_to_device(batch: Dict, device) -> Dict:
    """A fused batch of host arrays as tensors on ``device``; on a card in
    one pinned copy on the current stream, not waited for."""
    names = sorted(batch["ids"])
    arrays = list(batch["dense"]) + list(batch.get("labels", [])) + [batch["ids"][n] for n in names]
    tensors = _to_device([np.asarray(a) for a in arrays], torch.device(device), non_blocking=True)
    nd, nl = len(batch["dense"]), len(batch.get("labels", []))
    out = {"dense": tensors[:nd], "ids": dict(zip(names, tensors[nd + nl:]))}
    if "labels" in batch:
        out["labels"] = tensors[nd:nd + nl]
    return out


@dataclass
class _Staged:
    batch: Dict
    ready: Optional[torch.cuda.Event]  # recorded on the feed stream after the copy


class FusedPipeline:
    """Stage-pipelined run of the fused tier: a feed thread stages host
    batches to the card on its own stream and records an event (the FEED
    stage, up to ``depth`` batches in flight), while the caller's thread
    runs the step (the DENSE stage) after its stream waits on that event.
    Every row lives on the card and the sparse update is inside the step,
    so there are no feed hazards: the stage graph's window only bounds the
    staged batches. Batches enter the step in stream order, so with
    ``k == 1`` the result is the sequential step loop's bit for bit; ``k >
    1`` packs the dense stage into ``build_fused_multi_step`` windows.
    ``run`` drains the window before it returns."""

    def __init__(self, step, multi=None, depth: int = 2, k: int = 1, device=None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if k > 1 and multi is None:
            raise ValueError("k > 1 needs the multi-step program")
        self._step, self._multi = step, multi
        self.depth = int(depth)
        # a full pack must fit in the window, or feed and dense wait on each other
        self.k = max(1, min(int(k), self.depth))
        self.device = resolve_device(device)
        self.graph = StageGraph(self.depth)
        self._wall_s = 0.0

    def _stage(self, b: Dict, stream) -> _Staged:
        if stream is None:
            return _Staged(fused_batch_to_device(b, self.device), None)
        with torch.cuda.stream(stream):
            staged = fused_batch_to_device(b, self.device)
            ev = torch.cuda.Event()
            ev.record(stream)
        return _Staged(staged, ev)

    def run(self, state, batches):
        """Drive ``batches`` (fused batch dicts of host arrays) through the
        pipeline; the feed thread consumes the iterable, so conversion
        inside a generator rides the feed lane. Returns ``(state,
        losses)``, the per-step device losses in stream order."""
        # a fresh window each run: the last run's is aborted (the
        # reference reuses it, so its second run trains nothing)
        graph = self.graph = StageGraph(self.depth)
        q: "queue.Queue" = queue.Queue()  # bounded by the window
        errors: List[BaseException] = []
        sentinel = object()
        stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

        def feeder():
            try:
                for seq, b in enumerate(batches):
                    if errors:
                        break
                    if not graph.reserve_feed(seq, should_abort=lambda: bool(errors)):
                        break
                    with graph.lane("feed"):
                        staged = self._stage(b, stream)
                    q.put((seq, staged))
            except BaseException as e:  # noqa: BLE001 — raised again on the caller
                errors.append(e)
            finally:
                q.put(sentinel)

        t0 = time.perf_counter()
        th = threading.Thread(target=feeder, name="fused-pipe-feeder", daemon=True)
        th.start()
        losses: List[torch.Tensor] = []
        pack: List[Tuple[int, Dict]] = []
        n_seen = 0
        try:
            def ready(staged: _Staged) -> Dict:
                if staged.ready is not None:
                    cur = torch.cuda.current_stream(self.device)
                    cur.wait_event(staged.ready)
                    for t in _batch_tensors(staged.batch):
                        t.record_stream(cur)
                return staged.batch

            def flush():
                nonlocal state
                if not pack:
                    return
                if len(pack) > 1:
                    with graph.lane("dense"):
                        state, (ls, _preds) = self._multi(state, tuple(b for _, b in pack))
                    losses.extend(ls[i] for i in range(len(pack)))
                else:
                    with graph.lane("dense"):
                        state, (loss, _preds) = self._step(state, pack[0][1])
                    losses.append(loss)
                graph.note_dense(pack[-1][0])
                pack.clear()

            while True:
                item = q.get()
                if item is sentinel:
                    break
                seq, staged = item
                pack.append((seq, ready(staged)))
                n_seen += 1
                if len(pack) >= self.k:
                    flush()
            flush()
            if errors:
                raise errors[0]
            graph.drain_for_fence(n_seen, reason="end")
        finally:
            graph.abort()
            th.join(timeout=5.0)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._wall_s = time.perf_counter() - t0
        return state, losses

    def stats(self) -> Dict:
        """Stage-graph stats of the last ``run`` and its wall seconds."""
        out = self.graph.stats(self._wall_s)
        out["wall_s"] = round(self._wall_s, 6)
        return out


def build_fused_pipeline(
    sparse_cfg: OptimizerConfig,
    specs: Dict[str, FusedSlotSpec],
    slot_order: Optional[Sequence[str]] = None,
    loss_fn: Callable = default_loss_fn,
    stack: bool = False,
    depth: int = 2,
    k: int = 1,
    device=None,
) -> FusedPipeline:
    """The graph step (and, for ``k > 1``, the ``min(k, depth)``-step
    program) wrapped in a ``FusedPipeline``; reuse it across runs."""
    step = build_fused_train_step(sparse_cfg, specs, slot_order, loss_fn=loss_fn, stack=stack)
    multi = None
    if k > 1:
        multi = build_fused_multi_step(sparse_cfg, specs, min(k, depth), slot_order, loss_fn=loss_fn, stack=stack)
    return FusedPipeline(step, multi, depth=depth, k=k, device=device)
