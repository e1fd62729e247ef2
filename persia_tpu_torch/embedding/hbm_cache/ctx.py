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

Not in this slice (their arguments raise): the pipelined stream
(``train_stream``), a device mesh, a parameter-server tier for some slots,
a dynamic loss scale, the health probe and the sharded feeder.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Optional, Set

import numpy as np
import torch

from persia_tpu_torch.config import EmbeddingConfig
from persia_tpu_torch.ctx import _to_device
from persia_tpu_torch.data import PersiaBatch
from persia_tpu_torch.device import resolve_device
from persia_tpu_torch.embedding.hbm_cache.groups import (
    CachedTrainState,
    _apply_aux,
    _state_init_consts,
    init_cached_tables,
)
from persia_tpu_torch.embedding.hbm_cache.step import build_cached_eval_step, build_cached_train_step
from persia_tpu_torch.embedding.hbm_cache.tier import CachedEmbeddingTier
from persia_tpu_torch.embedding.optim import OPTIMIZER_ADAM
from persia_tpu_torch.parallel.fused_step import prepare_dense_optimizer
from persia_tpu_torch.parallel.train_step import default_loss_fn, unpack_step_header

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
    batch."""

    def __init__(
        self,
        model: torch.nn.Module,
        dense_optimizer: torch.optim.Optimizer,
        embedding_optimizer,
        worker,
        embedding_config: EmbeddingConfig,
        cache_rows=1 << 20,
        loss_fn=None,
        init_seed: Optional[int] = None,
        wb_wire_dtype: str = "float32",
        admit_touches: int = 1,
        aux_wire_dtype: str = "float32",
        device=None,
        mesh=None,
        ps_slots=(),
        ps_wire_dtype: str = "float32",
        dynamic_loss_scale: bool = False,
        health_probe: Optional[bool] = None,
        health_clip_norm: Optional[float] = None,
        feed_threads: Optional[int] = None,
        feed_shards: Optional[int] = None,
    ):
        unsupported = {
            "mesh": mesh is not None, "ps_slots": bool(ps_slots), "ps_wire_dtype": ps_wire_dtype != "float32",
            "dynamic_loss_scale": dynamic_loss_scale, "health_probe": bool(health_probe),
            "health_clip_norm": health_clip_norm is not None,
            "feed_threads": feed_threads not in (None, 1), "feed_shards": feed_shards is not None,
        }
        if any(unsupported.values()):
            raise NotImplementedError(
                f"the port's cache tier has no {', '.join(k for k, v in unsupported.items() if v)} yet")
        if wb_wire_dtype not in WB_WIRE_DTYPES:
            raise ValueError(f"wb_wire_dtype must be one of {WB_WIRE_DTYPES}, got {wb_wire_dtype!r}")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.dense_optimizer = dense_optimizer
        self.sparse_cfg = embedding_optimizer.config
        self.worker = worker
        self.embedding_config = embedding_config
        self._wb_bf16 = wb_wire_dtype == "bfloat16"
        prepare_dense_optimizer(dense_optimizer, self.device)
        self.tier = CachedEmbeddingTier(worker, self.sparse_cfg, cache_rows, embedding_config, init_seed=init_seed,
                                        admit_touches=admit_touches, aux_wire_dtype=aux_wire_dtype)
        # the feature groups of the cached slots: their server-side Adam
        # powers move with the card's, once a step
        self._cached_groups = tuple(sorted({embedding_config.group_of(s) for g in self.tier.groups
                                            for s in g.slots}))
        self._state_consts = _state_init_consts(self.sparse_cfg)
        self._step = build_cached_train_step(model, dense_optimizer, self.sparse_cfg, self.tier.groups,
                                             loss_fn=loss_fn or default_loss_fn)
        self._eval = build_cached_eval_step(model, self.tier.groups)
        self.state: Optional[CachedTrainState] = None
        # the deferred write-back of the last dispatched step: (evict_meta,
        # {group: host payload}, its copy's event, device header, label shape)
        self._pending = None
        self._pending_signs: Set[int] = set()
        self._last_metrics: Optional[Dict] = None
        self._empties: Dict[str, Dict[str, torch.Tensor]] = {}

    def __enter__(self):
        self.worker.register_optimizer(self.sparse_cfg)
        return self

    def __exit__(self, *exc):
        self.drain()
        return False

    def init_state(self) -> CachedTrainState:
        """Zeroed pools on the card and the model as it is."""
        tables, emb_state = init_cached_tables(self.tier.groups, self.sparse_cfg, device=self.device)
        self.state = CachedTrainState(
            model=self.model, optimizer=self.dense_optimizer, tables=tables, emb_state=emb_state,
            emb_batch_state=torch.ones(2, dtype=torch.float32, device=self.device),
            step=torch.zeros((), dtype=torch.int32, device=self.device),
        )
        return self.state

    # -------------------------------------------------------------- steps

    def _sync_hazard_gate(self, gname: str, miss_signs: np.ndarray) -> None:
        if self._pending_signs and not self._pending_signs.isdisjoint(miss_signs.tolist()):
            self._land_pending()  # the server's probe then reads the trained rows

    def _stage(self, inputs, miss_aux, cold_aux, evict_aux):
        """Every host array of a step to the card, in one copy."""
        tree = (inputs, miss_aux, cold_aux, evict_aux)
        flat = _to_device(_flatten(tree, []), self.device, non_blocking=True)
        return _unflatten(tree, iter(flat))

    def _group_empties(self, gname: str) -> Dict[str, torch.Tensor]:
        """0-row stand-ins for a group's absent aux pieces."""
        em = self._empties.get(gname)
        if em is None:
            g = next(gr for gr in self.tier.groups if gr.name == gname)
            dt = torch.bfloat16 if self.tier.aux_bf16 else torch.float32
            em = self._empties[gname] = {
                "rows": torch.empty(0, dtype=torch.int32, device=self.device),
                "entries": torch.empty((0, g.dim + g.state_dim), dtype=dt, device=self.device),
                "emb": torch.empty((0, g.dim), dtype=dt, device=self.device),
            }
        return em

    def _apply_feed(self, miss_aux, cold_aux, evict_aux) -> Dict[str, torch.Tensor]:
        """K12 once a touched group: the eviction payloads (each evicted row
        read before its write, by the tier's pairing), the warm entries and
        cold seeds written. Returns the payloads."""
        payloads = {}
        for gname in sorted(set(miss_aux) | set(cold_aux) | set(evict_aux)):
            em = self._group_empties(gname)
            m_rows, m_entries, m_slot = miss_aux.get(gname, (em["rows"], em["entries"], em["rows"]))
            c_rows, c_emb, c_slot = cold_aux.get(gname, (em["rows"], em["emb"], em["rows"]))
            ev_rows, ev_free = evict_aux.get(gname, (em["rows"], em["rows"]))
            payload = _apply_aux(self.state.tables[gname], self.state.emb_state[gname], ev_rows, m_rows, m_entries,
                                 c_rows, c_emb, self._state_consts, self._wb_bf16, m_slot=m_slot, c_slot=c_slot,
                                 ev_free=ev_free)
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

    def _dispatch(self, inputs, layout, miss_aux, cold_aux, evict_aux):
        """K12 for every touched group, then the step: (header, host
        payloads, their event)."""
        host, ev = self._fetch_payloads(self._apply_feed(miss_aux, cold_aux, evict_aux))
        header = self._step(self.state, inputs, layout)
        return header, host, ev

    def train_step(self, batch: PersiaBatch, fetch_metrics: bool = True) -> Optional[Dict]:
        """One step; returns {"loss", "preds"} (the step's, read back from
        the card) or, with ``fetch_metrics=False``, None (``drain`` /
        ``last_metrics`` read them later)."""
        inputs, layout, miss_aux, cold_aux, evict_aux, evict_meta = self.tier.prepare_batch(
            batch, hazard_gate=self._sync_hazard_gate)
        if self.state is None:
            self.init_state()
        inputs, miss_aux, cold_aux, evict_aux = self._stage(inputs, miss_aux, cold_aux, evict_aux)
        header, host, ev = self._dispatch(inputs, layout, miss_aux, cold_aux, evict_aux)
        prev = self._pending
        self._pending = (evict_meta, host, ev, header, tuple(inputs["labels"][0].shape))
        self._pending_signs = {int(s) for ev_signs, k in evict_meta.values() for s in ev_signs[:k]}
        if prev is not None:
            self._write_back_only(prev)
        if self.sparse_cfg.kind == OPTIMIZER_ADAM:
            for grp in self._cached_groups:
                self.tier.router.advance_batch_state(grp)
        return self._fetch_metrics() if fetch_metrics else None

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

    @staticmethod
    def _parse_header(h: np.ndarray, label_shape) -> Dict:
        """The step header's host view: {"loss", "preds"} (the layout's one
        decoder is ``parallel.train_step.unpack_step_header``)."""
        loss, preds = unpack_step_header(h, {"labels": [SimpleNamespace(shape=label_shape)]})
        return {"loss": loss, "preds": preds}

    def _fetch_metrics(self) -> Dict:
        if self._pending is None:
            return self._last_metrics or {}
        header, shape = self._pending[3], self._pending[4]
        self._last_metrics = self._parse_header(header.cpu().numpy(), shape)
        return self._last_metrics

    def drain(self) -> Optional[Dict]:
        """Land the deferred write-back; the last step's metrics."""
        self._land_pending()
        return self._last_metrics

    def last_metrics(self) -> Optional[Dict]:
        return self._fetch_metrics() if self._pending is not None else self._last_metrics

    def eval_batch(self, batch: PersiaBatch) -> np.ndarray:
        """Predictions (B, 1), changing neither the cache nor the server
        (the deferred write-back lands first: eval's misses read the
        server)."""
        self._land_pending()
        if self.state is None:
            raise RuntimeError("eval before any train_step/init_state")
        inputs, layout = self.tier.prepare_eval_batch(batch)
        (inputs,) = self._stage(inputs, {}, {}, {})[:1]
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
