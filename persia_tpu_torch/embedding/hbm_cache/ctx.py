"""CachedTrainCtx: the cache tier's user API (counterpart of
``persia_tpu/embedding/hbm_cache/ctx.py``), its synchronous path.

``train_step`` prepares the batch on the host (``CachedEmbeddingTier``),
copies its arrays to the card in one copy, runs the aux program (K12, a
launch a touched group) and the train step, and then writes the previous
step's evicted rows back to the parameter server: the write-back of step N
lands after step N+1 is dispatched, so the server's traffic overlaps the
card's work. The payload's copy to the host is issued on the step's stream
right after K12, into pinned memory, and waited for only at its
write-back. A miss on a sign whose write-back is still pending lands that
write-back first (``_sync_hazard_gate``), so the server's probe reads the
trained row. With sparse Adam, the server's batch powers move once a step
for every feature group the cache holds, as the card's do.

``train_stream`` (``stream.run_train_stream``) runs the same steps as a
pipeline of lanes: the admit, staging and write-back overlap the card's
work, and a miss on a sign whose write-back is still in flight is restored
on the card from the group's eviction ring, which K12 fills (``_apply_feed``
with the step's ring position) and reads (the same K12 launch writes a
step's restores). At ``pipeline_depth > 1`` a step's feed stage
(``_apply_feed``) runs from the stream's stager up to depth − 1 steps ahead
of its dense stage (``_dispatch_dense``, ``_dispatch_packed_dense``); every
feed and dense dispatch then holds ``_state_lock``.

**Durable state** (``persia_tpu_torch.jobstate``). ``_global_step`` counts
the steps trained (a stream sets it after each step). ``snapshot_job``
(the synchronous path) and the stream's fences (``train_stream(
snapshot_every=, job_state=)``) go through ``_fence_capture``: every
resident row is flushed to the servers and the pools restart cold, then
one manifest epoch holds the servers' shards, the ``CachedTrainState`` as
flax's bytes (``weights.cached_state_to_flax_bytes``: the reference's
bytes for the same arrays), the occupancy (``cache.json``), the loader's
cursor, the RNG streams and, where the touch gate is on, each directory's
touch counters (``cache/<group>.touch``, which the reference's manifest
lacks: a flush keeps them, so a resumed directory admits as the
uninterrupted one). ``resume`` rewinds the servers (or, with
``restore_ps=False``, keeps them: no gradient of the pure cache tier is
journaled), overlays the bytes now or, before ``init_state``, when it runs,
and brings back the Adam batch advances, the epoch and the step count.

**The mixed tier** (``ps_slots``, and every hash-stacked slot): slots the
cache does not hold are looked up through the worker (``_ps_forward``: a
staleness ref, the entries staged beside the step's inputs, in bf16 for
the bf16 and int8 wires) and trained from the step's gradients
(``_apply_ps_grads``, which releases the ref whatever happens). The
gradients cross to the host in ``ps_wire_dtype``: f32, bf16, or int8 with
a scale a slot and an error-feedback residual that stays on the card
(K15; ``_ps_residual``, one a flat length: a new bucketed shape starts
from zeros). The synchronous step applies them before it returns; the
stream's write-back lane batches ``psgrad_batch`` steps of them. With a
job state an apply carries the step's journal id, and a resume refuses a
manifest written under another PS slot set (moving slots between the
tiers is not part of the port).

**Precision** (the reference's ``table_dtype`` and
``dynamic_loss_scale``). ``table_dtype=torch.bfloat16`` keeps the pools in
bf16 (K12, K13 and the flush read widen a row to f32 where they read it
and round what they write; K5 updates the bf16 rows). The dynamic loss
scale lives on the card (``CachedTrainState.loss_scale``); a step's
metrics add ``loss_scale`` (the scale it used) and ``grads_finite``, and
an overflow step's PS-tier gradients are dropped on every wire
(``_apply_ps_grads`` reads the buffer's tail, after the step, on the
host), so nothing waits on the flag before the next step is enqueued.

Not in this port (their arguments raise): a device mesh, the health probe
and its scrub at a fence, tiering and the sharded feeder.
"""

from __future__ import annotations

import threading
import time
from types import SimpleNamespace
from typing import Dict, Optional, Set

import numpy as np
import torch

from persia_tpu_torch import jobstate
from persia_tpu_torch.config import EmbeddingConfig
from persia_tpu_torch.ctx import _to_device, stage_embeddings
from persia_tpu_torch.data import PersiaBatch
from persia_tpu_torch.device import resolve_device
from persia_tpu_torch.embedding.hbm_cache.groups import (
    CachedTrainState,
    CacheLayout,
    _apply_aux,
    _state_init_consts,
    init_cached_tables,
)
from persia_tpu_torch.embedding.hbm_cache.step import (
    PS_GRAD_WIRES,
    build_cached_eval_step,
    build_cached_train_step,
    init_loss_scale,
)
from persia_tpu_torch.embedding.hbm_cache.tier import CachedEmbeddingTier
from persia_tpu_torch.embedding.optim import OPTIMIZER_ADAM
from persia_tpu_torch.parallel.fused_step import prepare_dense_optimizer
from persia_tpu_torch.parallel.grad_sync import dequantize_int8_np
from persia_tpu_torch.parallel.train_step import (
    default_loss_fn,
    unpack_step_grads,
    unpack_step_header,
    unpack_step_header_dynamic,
)
from persia_tpu_torch.weights import cached_state_from_flax_bytes, cached_state_to_flax_bytes
from persia_tpu_torch.wire import tensor_to_host_f32

WB_WIRE_DTYPES = ("float32", "bfloat16")


def _flatten(tree, out):
    """The arrays of a nest of dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        for k in tree:
            _flatten(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _flatten(v, out)
    else:
        out.append(tree)
    return out


def _unflatten(tree, it):
    if isinstance(tree, dict):
        return {k: _unflatten(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, it) for v in tree)
    return next(it)


class CachedTrainCtx:
    """Training over the cache tier: ``train_step`` / ``eval_batch`` /
    ``flush`` / ``publish`` / ``dump_checkpoint`` / ``load_checkpoint``.

    ``model`` moves to the ctx's device (``cuda`` unless ``device`` says
    otherwise); ``dense_optimizer`` is a ``torch.optim.Adam`` over its
    parameters; ``embedding_optimizer`` a sparse optimizer of
    ``persia_tpu_torch.embedding.optim``, registered on every replica by
    ``__enter__``. ``cache_rows``: the capacity of each group (or {dim:
    rows}). ``wb_wire_dtype`` / ``aux_wire_dtype``: the dtype of the
    evicted rows' way to the host / of the checked-out rows' way to the
    card. ``admit_touches``: a sign enters the cache on its Nth touching
    batch. ``wb_ring_rows``: the most rows of a group's eviction ring
    (``ring_rows``), which the stream's in-flight evictions fill.
    ``ps_slots``: slots served by the parameter-server tier besides the
    hash-stacked ones; ``ps_wire_dtype`` (float32, bfloat16 or int8) the
    dtype of their gradients' way to the host. ``table_dtype``: the pools'
    dtype (``torch.float32`` or ``torch.bfloat16``). ``dynamic_loss_scale``
    with ``loss_scale_init``, ``loss_scale_growth_interval`` and
    ``loss_scale_max``: the card's loss scale (the module's docstring).
    ``feed_threads`` / ``feed_shards``: the sharded feeder
    (``CachedEmbeddingTier``); a resumed job keeps its shard count, which
    decides row assignment, while the thread count never changes an
    output (``set_feed_threads``)."""

    def __init__(
        self,
        model: torch.nn.Module,
        dense_optimizer: torch.optim.Optimizer,
        embedding_optimizer,
        worker,
        embedding_config: EmbeddingConfig,
        cache_rows=1 << 20,
        loss_fn=None,
        table_dtype=torch.float32,
        init_seed: Optional[int] = None,
        wb_wire_dtype: str = "float32",
        admit_touches: int = 1,
        aux_wire_dtype: str = "float32",
        device=None,
        mesh=None,
        ps_slots=(),
        ps_wire_dtype: str = "float32",
        dynamic_loss_scale: bool = False,
        loss_scale_init: float = float(2 ** 15),
        loss_scale_growth_interval: int = 2000,
        loss_scale_max: float = float(2 ** 24),
        health_probe: Optional[bool] = None,
        health_clip_norm: Optional[float] = None,
        feed_threads: Optional[int] = None,
        feed_shards: Optional[int] = None,
        wb_ring_rows: int = 1 << 20,
    ):
        unsupported = {
            "mesh": mesh is not None, "health_probe": bool(health_probe),
            "health_clip_norm": health_clip_norm is not None,
        }
        if any(unsupported.values()):
            raise NotImplementedError(
                f"the port's cache tier has no {', '.join(k for k, v in unsupported.items() if v)} yet")
        if wb_wire_dtype not in WB_WIRE_DTYPES:
            raise ValueError(f"wb_wire_dtype must be one of {WB_WIRE_DTYPES}, got {wb_wire_dtype!r}")
        if ps_wire_dtype not in PS_GRAD_WIRES:
            raise ValueError(f"ps_wire_dtype must be one of {PS_GRAD_WIRES}, got {ps_wire_dtype!r}")
        if table_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"table_dtype must be torch.float32 or torch.bfloat16, got {table_dtype!r}")
        self.table_dtype = table_dtype
        self.dynamic_loss_scale = bool(dynamic_loss_scale)
        self._loss_scale_init = float(loss_scale_init)
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.dense_optimizer = dense_optimizer
        self.sparse_cfg = embedding_optimizer.config
        self.worker = worker
        self.embedding_config = embedding_config
        self._wb_bf16 = wb_wire_dtype == "bfloat16"
        prepare_dense_optimizer(dense_optimizer, self.device)
        self.tier = CachedEmbeddingTier(worker, self.sparse_cfg, cache_rows, embedding_config, init_seed=init_seed,
                                        admit_touches=admit_touches, aux_wire_dtype=aux_wire_dtype,
                                        ps_slots=ps_slots, feed_threads=feed_threads, feed_shards=feed_shards)
        # the feature groups of the cached slots: their server-side Adam
        # powers move with the card's, once a step
        self._cached_groups = tuple(sorted({embedding_config.group_of(s) for g in self.tier.groups
                                            for s in g.slots}))
        self._state_consts = _state_init_consts(self.sparse_cfg)
        self._step = build_cached_train_step(model, dense_optimizer, self.sparse_cfg, self.tier.groups,
                                             loss_fn=loss_fn or default_loss_fn, ps_grad_wire=ps_wire_dtype,
                                             dynamic_loss_scale=self.dynamic_loss_scale,
                                             growth_interval=loss_scale_growth_interval, max_scale=loss_scale_max)
        # the PS slots' entries cross to the card in bf16 for the bf16 and
        # int8 gradient wires; the int8 wire's residual a flat length
        self._ps_int8 = ps_wire_dtype == "int8"
        self._ps_stage_dtype = "bfloat16" if ps_wire_dtype in ("bfloat16", "int8") else None
        self._ps_residual: Dict[int, torch.Tensor] = {}
        self._eval = build_cached_eval_step(model, self.tier.groups)
        self.state: Optional[CachedTrainState] = None
        # the deferred write-back of the last dispatched step: (evict_meta,
        # {group: host payload}, its copy's event, device header, label shape)
        self._pending = None
        self._pending_signs: Set[int] = set()
        self._last_metrics: Optional[Dict] = None
        self._empties: Dict[str, Dict[str, torch.Tensor]] = {}
        # each group's eviction ring on the card (the stream's restores read it)
        self.wb_ring_rows = int(wb_ring_rows)
        self._ev_rings: Dict[str, torch.Tensor] = {}
        # the stream's last header, unread (fetch_final=False), and its stats
        self._last_header_dev = None
        self._stream_stats: Optional[Dict] = None
        # held around every feed and dense dispatch of a stream (a
        # pipelined stream feeds from its stager thread): the state, the
        # rings and the empties are filled and updated under it
        self._state_lock = threading.Lock()
        # job state: the epoch of the last manifest, the steps trained, the
        # dense bytes a resume left for ``init_state`` to overlay, and the
        # last capture's ms by part
        self._job_epoch: Optional[int] = None
        self._global_step = 0
        self._resume_state_bytes: Optional[bytes] = None
        self.last_resume_info: Optional[Dict] = None
        self.last_capture_ms: Optional[Dict[str, float]] = None

    def __enter__(self):
        self.worker.register_optimizer(self.sparse_cfg)
        return self

    def __exit__(self, *exc):
        try:
            self.drain()
        finally:
            self.worker.close()
        return False

    def init_state(self) -> CachedTrainState:
        """Zeroed pools on the card in ``table_dtype`` and the model as it
        is, the loss scale at ``loss_scale_init``; a deferred resume's bytes
        (the state at a fence: cold pools) overlaid."""
        tables, emb_state = init_cached_tables(self.tier.groups, self.sparse_cfg, device=self.device,
                                               dtype=self.table_dtype)
        self.state = CachedTrainState(
            model=self.model, optimizer=self.dense_optimizer, tables=tables, emb_state=emb_state,
            emb_batch_state=torch.ones(2, dtype=torch.float32, device=self.device),
            step=torch.zeros((), dtype=torch.int32, device=self.device),
            loss_scale=init_loss_scale(self._loss_scale_init, self.device) if self.dynamic_loss_scale else None,
        )
        if self._resume_state_bytes is not None:
            cached_state_from_flax_bytes(self.state, self._resume_state_bytes)
            self._resume_state_bytes = None
        return self.state

    # -------------------------------------------------------------- steps

    def _sync_hazard_gate(self, gname: str, miss_signs: np.ndarray) -> None:
        if self._pending_signs and not self._pending_signs.isdisjoint(miss_signs.tolist()):
            self._land_pending()  # the server's probe then reads the trained rows

    def _stage(self, inputs, miss_aux, cold_aux, evict_aux, restore_aux=None):
        """Every host array of a step to the card, in one copy on the
        current stream: (inputs, miss_aux, cold_aux, evict_aux,
        restore_aux), each restore's three arrays included."""
        tree = (inputs, miss_aux, cold_aux, evict_aux, restore_aux or {})
        flat = _to_device(_flatten(tree, []), self.device, non_blocking=True)
        return _unflatten(tree, iter(flat))

    def _group(self, gname: str):
        return next(gr for gr in self.tier.groups if gr.name == gname)

    def _group_empties(self, gname: str) -> Dict[str, torch.Tensor]:
        """0-row stand-ins for a group's absent aux pieces."""
        em = self._empties.get(gname)
        if em is None:
            g = self._group(gname)
            dt = torch.bfloat16 if self.tier.aux_bf16 else torch.float32
            em = self._empties[gname] = {
                "rows": torch.empty(0, dtype=torch.int32, device=self.device),
                "entries": torch.empty((0, g.dim + g.state_dim), dtype=dt, device=self.device),
                "emb": torch.empty((0, g.dim), dtype=dt, device=self.device),
            }
        return em

    def ring_rows(self, gname: str) -> int:
        """A group's eviction ring height: twice its cache rows, at least
        4096, at most ``wb_ring_rows`` (a step evicts at most the cache's
        rows)."""
        return min(self.wb_ring_rows, max(4096, 2 * self._group(gname).rows))

    def _ev_ring(self, gname: str) -> torch.Tensor:
        """The group's eviction ring (ring_rows, dim + state_dim), in the
        write-back wire's dtype; made at first use."""
        ring = self._ev_rings.get(gname)
        if ring is None:
            g = self._group(gname)
            ring = self._ev_rings[gname] = torch.zeros(
                (self.ring_rows(gname), g.dim + g.state_dim),
                dtype=torch.bfloat16 if self._wb_bf16 else torch.float32, device=self.device)
        return ring

    def _apply_feed(self, miss_aux, cold_aux, evict_aux, evict_meta=None,
                    restore_aux=None) -> Dict[str, torch.Tensor]:
        """The feed stage: K12 once a touched group (a group with warm,
        cold, evicted or restored rows): the eviction payloads (each evicted
        row read before its write, by the tier's pairing), the warm entries
        and cold seeds written; a group whose evictions have a ring position
        (``evict_meta``, the stream's) also stores its payload in its ring
        there, and a group with restores (``restore_aux``, the stream's)
        writes them from its ring in the same launch. Returns the payloads.
        A stream's caller holds ``_state_lock``."""
        payloads = {}
        restore_aux = restore_aux or {}
        for gname in sorted(set(miss_aux) | set(cold_aux) | set(evict_aux) | set(restore_aux)):
            em = self._group_empties(gname)
            m_rows, m_entries, m_slot = miss_aux.get(gname, (em["rows"], em["entries"], em["rows"]))
            c_rows, c_emb, c_slot = cold_aux.get(gname, (em["rows"], em["emb"], em["rows"]))
            ev_rows, ev_free = evict_aux.get(gname, (em["rows"], em["rows"]))
            ring_pos = evict_meta[gname][2] if evict_meta and gname in evict_meta else -1
            restores = restore_aux.get(gname)
            if restores is not None and gname in evict_aux and ring_pos < 0:
                raise RuntimeError(f"group {gname}: a step that restores stores its payload into the ring")
            ring = self._ev_ring(gname) if ring_pos >= 0 or restores is not None else None
            payload = _apply_aux(self.state.tables[gname], self.state.emb_state[gname], ev_rows, m_rows, m_entries,
                                 c_rows, c_emb, self._state_consts, self._wb_bf16, m_slot=m_slot, c_slot=c_slot,
                                 ev_free=ev_free, ring=ring, ring_pos=ring_pos if ring_pos >= 0 else None,
                                 restores=restores)
            if gname in evict_aux:
                payloads[gname] = payload
        return payloads

    def _fetch_payloads(self, payloads):
        """Start the payloads' copies to the host on the step's stream, after
        K12: ({group: host tensor}, an event to wait on or None)."""
        if self.device.type != "cuda" or not payloads:
            return payloads, None
        host = {}
        for g, p in payloads.items():
            host[g] = torch.empty(p.shape, dtype=p.dtype, pin_memory=True)
            host[g].copy_(p, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    def _run_step(self, inputs, layout):
        """The step on staged inputs, the int8 wire's residual threaded
        through it: (header, ps_gpacked: None, a flat tensor or (q,
        scales))."""
        if self._ps_int8 and inputs.get("ps_emb"):
            total = sum((e["pooled"] if "pooled" in e else e["distinct"]).numel() for e in inputs["ps_emb"])
            res = self._ps_residual.get(total)
            if res is None:  # a new shape: its positions name other signs
                res = torch.zeros(total, dtype=torch.float32, device=self.device)
            inputs = dict(inputs, ps_gres=res)
        header, ps = self._step(self.state, inputs, layout)
        if self._ps_int8 and ps is not None:
            q, scales, new_res = ps
            self._ps_residual[new_res.numel()] = new_res
            ps = (q, scales)
        return header, ps

    def _dispatch(self, inputs, layout, miss_aux, cold_aux, restore_aux, evict_aux, evict_meta=None):
        """A step's card work in order, from staged tensors: K12 for every
        touched group (its restores from the group's eviction ring in the
        same launch), then the step. Returns (header, device payloads,
        ps_gpacked)."""
        payloads = self._apply_feed(miss_aux, cold_aux, evict_aux, evict_meta, restore_aux)
        header, ps = self._run_step(inputs, layout)
        return header, payloads, ps

    def _dispatch_packed(self, items):
        """K staged steps without restores or PS slots, back to back:
        ``items`` [(inputs, layout, miss_aux, cold_aux, evict_aux,
        evict_meta), ...]. Each step's K12 reads the tables the step before
        it left, as a single step's does, so a pack changes no bit. Returns
        (headers, payloads) a step."""
        headers, payloads = [], []
        for inputs, layout, miss_aux, cold_aux, evict_aux, evict_meta in items:
            payloads.append(self._apply_feed(miss_aux, cold_aux, evict_aux, evict_meta))
            headers.append(self._step(self.state, inputs, layout)[0])
        return headers, payloads

    def _dispatch_dense(self, inputs, layout):
        """The dense stage of a step whose feed a pipelined stream already
        dispatched (never one with PS slots): the step alone. Returns its
        header."""
        return self._step(self.state, inputs, layout)[0]

    def _dispatch_packed_dense(self, items):
        """K feed-done steps' dense stages back to back (``items`` [(inputs,
        layout), ...]), no aux. Returns their headers."""
        return [self._step(self.state, inputs, layout)[0] for inputs, layout in items]

    # ------------------------------------------------ the PS-tier slots

    def _ps_forward(self, batch: PersiaBatch):
        """Look the batch's PS-tier slots up through the worker: (ref, the
        worker's embedding batches, their true distinct counts, their
        staged entries), or None when the batch carries none. The ref's
        staleness slot is released by ``_apply_ps_grads``; a failure before
        that aborts it."""
        feats = [f for f in batch.id_type_features if f.name in self.tier.ps_slots]
        if not feats:
            return None
        ref = self.worker.put_forward_ids(PersiaBatch(feats, requires_grad=False))
        try:
            embs = self.worker.forward_batch_id(ref, train=True)
            entries, counts = stage_embeddings(embs, dtype=self._ps_stage_dtype, csr=self.device.type == "cuda")
        except BaseException:
            self.worker.abort_gradient(ref)
            raise
        return ref, embs, counts, entries

    @staticmethod
    def _with_ps(inputs, layout, ps_item):
        """A prepared step's inputs and layout with its PS entries."""
        if ps_item is None:
            return inputs, layout
        _ref, embs, _counts, entries = ps_item
        return dict(inputs, ps_emb=entries), CacheLayout(stacked=layout.stacked, ps=tuple(eb.name for eb in embs))

    @staticmethod
    def _ps_host(ps_gpacked):
        """The host copy of a step's ``ps_gpacked`` (a blocking read): f32
        flat, or (q int8, scales f32)."""
        if isinstance(ps_gpacked, tuple):
            return tuple(t.cpu().numpy() for t in ps_gpacked)
        return tensor_to_host_f32(ps_gpacked)

    def _apply_ps_grads(self, ps_item, host, journal_step: Optional[int] = None) -> None:
        """Return a step's PS-tier gradients to the worker from their host
        copy (``_ps_host``'s form; the int8 codes dequantized a slot by its
        scale), padding rows sliced off; under a job state with the step's
        journal id. Under the dynamic loss scale the buffer's tail decides:
        an overflow step's gradients are dropped (the ref aborted), a finite
        one's f32 or bf16 gradients are divided by the scale the tail
        carries (the worker's ``scale_factor``; int8 ones were unscaled on
        the card). The ref is released by the update, or aborted on
        failure."""
        ref, embs, counts, entries = ps_item
        try:
            scale_factor = 1.0
            if isinstance(host, tuple):
                q, scales = host
                if self.dynamic_loss_scale:
                    if not scales[-1] > 0.5:  # an overflow step: skipped
                        self.worker.abort_gradient(ref)
                        return
                    scales = scales[:-1]
                grads = [dequantize_int8_np(g, s) for g, s in zip(unpack_step_grads(q, {"emb": entries}), scales)]
            else:
                gp = np.asarray(host, dtype=np.float32)
                if self.dynamic_loss_scale:
                    if not gp[-1] > 0.5:  # an overflow step: skipped
                        self.worker.abort_gradient(ref)
                        return
                    scale_factor = float(gp[-2])
                    gp = gp[:-2]
                grads = unpack_step_grads(gp, {"emb": entries})
            slot_grads = {eb.name: (g if d is None else g[:d]) for eb, g, d in zip(embs, grads, counts)}
            jid = None
            if journal_step is not None and self._job_epoch is not None:
                jid = jobstate.make_journal_id(self._job_epoch, journal_step)
            self.worker.update_gradient_batched(ref, slot_grads, scale_factor=scale_factor, journal_id=jid)
        except BaseException:
            self.worker.abort_gradient(ref)
            raise

    def train_step(self, batch: PersiaBatch, fetch_metrics: bool = True) -> Optional[Dict]:
        """One step; returns {"loss", "preds"} (the step's, read back from
        the card) or, with ``fetch_metrics=False``, None (``drain`` /
        ``last_metrics`` read them later). The PS-tier slots' gradients are
        applied before it returns."""
        inputs, layout, miss_aux, cold_aux, _restore, evict_aux, evict_meta = self.tier.prepare_batch(
            batch, hazard_gate=self._sync_hazard_gate)
        ps_item = self._ps_forward(batch)
        try:
            inputs, layout = self._with_ps(inputs, layout, ps_item)
            if self.state is None:
                self.init_state()
            inputs, miss_aux, cold_aux, evict_aux = self._stage(inputs, miss_aux, cold_aux, evict_aux)[:4]
            # no restores here (the gate landed the write-back instead): K12, the
            # payloads' copy to the host behind it, then the step
            host, ev = self._fetch_payloads(self._apply_feed(miss_aux, cold_aux, evict_aux, evict_meta))
            header, ps = self._run_step(inputs, layout)
            ps_host = self._ps_host(ps) if ps_item is not None else None
        except BaseException:
            if ps_item is not None:
                self.worker.abort_gradient(ps_item[0])
            raise
        if ps_item is not None:
            # no sign of a PS-tier slot is ever in the cache (the tier's
            # checks), so these updates need no order against the write-back
            self._apply_ps_grads(ps_item, ps_host, journal_step=self._global_step)
        prev = self._pending
        self._pending = (evict_meta, host, ev, header, tuple(inputs["labels"][0].shape))
        self._pending_signs = {int(s) for ev_signs, k, _ring_pos in evict_meta.values() for s in ev_signs[:k]}
        if prev is not None:
            self._write_back_only(prev)
        if self.sparse_cfg.kind == OPTIMIZER_ADAM:
            # the cached groups' powers move here; the PS-tier groups' in
            # the worker's gradient batch (no feature group spans both)
            for grp in self._cached_groups:
                self.tier.router.advance_batch_state(grp)
        self._global_step += 1
        return self._fetch_metrics() if fetch_metrics else None

    def train_stream(self, batches, **kwargs) -> Optional[Dict]:
        """Train over an iterable of batches as a pipeline of lanes; see
        ``stream.run_train_stream`` for the options. Returns the last
        step's metrics, or None with ``fetch_final=False``
        (``last_metrics`` reads them later)."""
        from persia_tpu_torch.embedding.hbm_cache.stream import run_train_stream

        return run_train_stream(self, batches, **kwargs)

    def set_feed_threads(self, threads: int) -> None:
        """Resize the sharded feeder's walker pools (nothing on an
        unsharded tier); no output depends on the thread count."""
        self.tier.set_feed_threads(threads)

    def stream_stats(self) -> Optional[Dict]:
        """The last ``train_stream``'s accounting: ``dispatch_k``, packs,
        packed and single steps, restores, fences (``fence_ms``: each
        fence's stall by part), each lane's busy seconds and the wall
        time; on a sharded tier ``feeder`` (``feed_threads``,
        ``feed_shards`` and ``shards``: each group's
        ``tier.feeder_shard_stats()``)."""
        return self._stream_stats

    def _write_back_only(self, pending) -> None:
        evict_meta, host, ev, _header, _shape = pending
        if ev is not None:
            ev.synchronize()
        self.tier.write_back(evict_meta, host)

    def _land_pending(self) -> None:
        """Land the deferred write-back now (a hazard, or a boundary)."""
        if self._pending is not None:
            self._fetch_metrics()
            self._write_back_only(self._pending)
            self._pending = None
            self._pending_signs = set()

    def _parse_header(self, h: np.ndarray, label_shape) -> Dict:
        """The step header's host view: {"loss", "preds"}, and under the
        dynamic loss scale "loss_scale" (the scale the step used) and
        "grads_finite" (the layout's decoders are
        ``parallel.train_step.unpack_step_header[_dynamic]``)."""
        shaped = {"labels": [SimpleNamespace(shape=label_shape)]}
        if self.dynamic_loss_scale:
            loss, preds, scale, finite = unpack_step_header_dynamic(h, shaped)
            return {"loss": loss, "preds": preds, "loss_scale": scale, "grads_finite": finite}
        loss, preds = unpack_step_header(h, shaped)
        return {"loss": loss, "preds": preds}

    def _fetch_metrics(self) -> Dict:
        if self._pending is None:
            return self._last_metrics or {}
        header, shape = self._pending[3], self._pending[4]
        self._last_metrics = self._parse_header(header.cpu().numpy(), shape)
        self._last_header_dev = None  # fresher than a stream's unread header
        return self._last_metrics

    def drain(self) -> Optional[Dict]:
        """Land the deferred write-back; the last step's metrics."""
        self._land_pending()
        return self.last_metrics()

    def last_metrics(self) -> Optional[Dict]:
        """The last step's metrics, read from the card if they were not yet
        (a deferred step, or a stream's ``fetch_final=False`` header)."""
        if self._pending is not None:
            return self._fetch_metrics()
        if self._last_header_dev is not None:
            header, shape = self._last_header_dev
            self._last_metrics = self._parse_header(header.cpu().numpy(), shape)
            self._last_header_dev = None
        return self._last_metrics

    def eval_batch(self, batch: PersiaBatch) -> np.ndarray:
        """Predictions (B, 1), changing neither the cache nor the server
        (the deferred write-back lands first: eval's misses read the
        server, as its PS-tier slots do)."""
        self._land_pending()
        if self.state is None:
            raise RuntimeError("eval before any train_step/init_state")
        inputs, layout = self.tier.prepare_eval_batch(batch)
        feats = [f for f in batch.id_type_features if f.name in self.tier.ps_slots]
        if feats:  # the servers' infer lookup, f32 entries (as the reference stages them)
            embs = self.worker.forward_directly(PersiaBatch(feats, requires_grad=False), train=False)
            inputs["ps_emb"] = stage_embeddings(embs)[0]
            layout = CacheLayout(stacked=layout.stacked, ps=tuple(eb.name for eb in embs))
        inputs = self._stage(inputs, {}, {}, {})[0]
        return self._eval(self.state, inputs, layout).float().cpu().numpy()

    # ----------------------------------------------------- durable state

    def publish(self) -> int:
        """Write every resident row to the server without evicting (the
        serving-freshness valve); returns the rows written."""
        self._land_pending()
        if self.state is None:
            return 0
        return self.tier.publish(self.state.tables, self.state.emb_state)

    def flush(self) -> None:
        """Write every cached row back to the server; the cache restarts
        cold (its pools reset in place)."""
        self._land_pending()
        self._flush_tier()

    def _flush_tier(self) -> None:
        if self.state is None:
            return
        self.tier.flush(self.state.tables, self.state.emb_state)
        for name, table in self.state.tables.items():
            table.zero_()
            for key, val in self._state_consts:
                self.state.emb_state[name][key].fill_(val)

    def dump_checkpoint(self, dst: str) -> None:
        """``flush``, then the server's checkpoint (``EmbeddingWorker.dump``)."""
        self.flush()
        self.worker.dump(dst)

    def load_checkpoint(self, src: str) -> None:
        """``flush``, then load a server checkpoint of either package."""
        self.flush()
        self.worker.load(src)

    # ------------------------------------------------------------ job state

    @staticmethod
    def _touch_blob(gname: str) -> str:
        return f"cache/{gname}.touch"

    def _fence_capture(self, job_mgr, step: int, occupancy: Dict) -> jobstate.Manifest:
        """Commit one job-state epoch at a drained fence (a stream's, or
        ``snapshot_job``'s): every resident row flushed to the servers and
        the pools reset in place, then the servers' shards, the state's
        flax bytes (cold pools), ``cache.json`` (``occupancy``, taken before
        the flush), ``loader.json``, the RNG streams and the touch gate's
        counters, as one manifest. Its ms by part: ``last_capture_ms``."""
        ms: Dict[str, float] = {}
        # a resume checks the PS-tier set and the shard count
        occupancy = dict(occupancy, ps_slots=list(self.tier.ps_slots), feed_shards=self.tier.feed_shards)
        t0 = time.perf_counter()
        self._flush_tier()
        t1 = time.perf_counter()
        state_bytes = cached_state_to_flax_bytes(self.state) if self.state is not None else None
        t2 = time.perf_counter()
        router = self.tier.router
        blobs = {self._touch_blob(g): d.touch_counts().tobytes() for g, d in self.tier.dirs.items()
                 if d.admit_touches > 1}
        manifest = jobstate.snapshot_job(
            job_mgr, step, state_bytes=state_bytes, replicas=router.replicas,
            batch_advances=dict(router.batch_advances), blobs=blobs,
            components={"cache.json": occupancy, "loader.json": {"consumed_batches": step}},
            meta={"kind": "cached_ctx"}, timings=ms)
        self.last_capture_ms = {"flush": (t1 - t0) * 1e3, "ps_capture": ms["ps_capture"],
                                "dense_bytes": (t2 - t1) * 1e3 + ms["dense_write"], "commit": ms["commit"]}
        self._job_epoch = manifest.job_epoch
        self._global_step = step
        return manifest

    def snapshot_job(self, job_state, extra_occupancy: Optional[Dict] = None) -> jobstate.Manifest:
        """A step-fenced snapshot on the synchronous path: the deferred
        write-back lands, then ``_fence_capture`` at ``_global_step``
        (a stream fences itself: ``train_stream(snapshot_every=,
        job_state=)``). ``job_state`` is a ``JobStateManager`` or its root
        directory."""
        self._land_pending()
        occupancy = {"resident_rows": {g.name: len(self.tier.dirs[g.name]) for g in self.tier.groups},
                     "pending_ledger_entries": 0}
        occupancy.update(extra_occupancy or {})
        return self._fence_capture(jobstate.coerce_manager(job_state), self._global_step, occupancy)

    def resume(self, job_state, restore_ps: bool = True, generators=None) -> Optional[jobstate.Manifest]:
        """Rebuild the fence state of the newest good manifest: the servers
        rewound to it (``restore_ps``; with False they keep what the crashed
        run wrote: nothing of the cache tier is journaled, so the replayed
        steps train on those rows), the state's bytes overlaid now or, before
        ``init_state``, when it runs, the touch counters, the Adam batch
        advances, the epoch and the step count; ``generators`` as in
        ``jobstate.resume_job``. A cache this ctx still holds is dropped
        unwritten (the manifest's pools are cold). A manifest whose
        ``cache.json`` names other PS-tier slots, or another
        ``feed_shards``, raises, before anything moves. Returns the manifest
        (continue with ``train_stream(batches[manifest.step:],
        start_step=manifest.step, ...)``), or None on a cold start, which
        arms epoch 0. ``last_resume_info`` holds the recovery numbers.
        Tiering's placements and the health scrub are not part of the port's
        cache tier."""
        router = self.tier.router
        mgr = jobstate.coerce_manager(job_state)
        newest = mgr.latest()
        if newest is not None and newest.has("cache.json"):
            occ = newest.read_json("cache.json")
            saved = occ.get("ps_slots")
            if saved is not None and sorted(saved) != sorted(self.tier.ps_slots):
                raise ValueError(f"the manifest at step {newest.step} was written with PS-tier slots {sorted(saved)}, "
                                 f"this ctx has {sorted(self.tier.ps_slots)}: moving slots between the tiers is "
                                 "not part of the port")
            if "feed_shards" in occ and occ["feed_shards"] != self.tier.feed_shards:
                raise ValueError(f"the manifest at step {newest.step} was written with feed_shards "
                                 f"{occ['feed_shards']}, this ctx has {self.tier.feed_shards}: the shard count "
                                 "decides row assignment, so a resumed job keeps it (resharding is not part of "
                                 "the port)")
        manifest, info = jobstate.resume_job(mgr, replicas=router.replicas, rewind_ps=restore_ps,
                                             optimizer=self.sparse_cfg, generators=generators)
        self.last_resume_info = info
        if manifest is None:
            self._job_epoch = 0
            self._global_step = 0
            return None
        self._pending, self._pending_signs = None, set()
        for gname, d in self.tier.dirs.items():
            d.drain()
            name = self._touch_blob(gname)
            if manifest.has(name):
                d.set_touch_counts(np.frombuffer(manifest.read_blob(name), dtype=np.uint8))
            elif d.admit_touches > 1:
                d.set_touch_counts(np.zeros_like(d.touch_counts()))
        if manifest.has("dense.state"):
            raw = manifest.read_blob("dense.state")
            if self.state is not None:
                cached_state_from_flax_bytes(self.state, raw)
            else:
                self._resume_state_bytes = raw
        router.batch_advances = dict(info["batch_advances"])
        self._job_epoch = manifest.job_epoch
        self._global_step = manifest.step
        return manifest
