"""User-facing contexts (counterpart of ``persia_tpu/ctx.py``):
``stage_embeddings`` and ``EmbeddingCtx.prepare_features`` turn the
worker's numpy outputs into tensors on the ctx's device; ``TrainCtx`` runs
the synchronous hybrid training step (lookup → forward, backward and dense
update on the device → gradient return to the parameter servers) and the
pipelined one, on batches a ``persia_tpu_torch.data_loader.DataLoader``
looked up and staged; ``InferCtx`` runs the lookup-direct forward.

Data parallelism: ``TrainCtx(mesh=data_parallel_mesh(), dense_sync=mode)``
trains the dense half synchronously over the mesh's ranks (one process a
device, ``parallel.mesh``), every rank calling ``train_step`` with the same
global batch, or ``train_step_prepared`` (rank 0 with its ``DataLoader``'s
batch, the others with None). Rank 0 holds the worker: it looks the batch
up, hands every rank the staged embeddings (each rank takes its rows), and
applies the global batch's embedding gradients, which the step gathers,
once. The
dense gradients meet through ``mode`` (``parallel.grad_sync``); at one
rank nothing moves.

Durable state: ``EmbeddingCtx.dump_checkpoint`` / ``load_checkpoint`` write
and read a checkpoint directory (the dense state in flax's bytes, the
tables as per-shard files), and ``TrainCtx.snapshot_job`` / ``resume``
commit and rebuild step-fenced job manifests (``persia_tpu_torch.jobstate``):
a resumed run replays from the fence bit for bit, each gradient batch
reaching the parameter servers through their apply-journal."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from persia_tpu_torch import jobstate
from persia_tpu_torch.checkpoint import dump_dense, load_dense
from persia_tpu_torch.config import EmbeddingConfig
from persia_tpu_torch.data import PersiaBatch
from persia_tpu_torch.device import resolve_device
from persia_tpu_torch.embedding.worker import (
    DevicePooledBatch,
    EmbeddingWorker,
    FeatureEmbeddingBatch,
    SumEmbeddingBatch,
)
from persia_tpu_torch.ops.embedding_pool import pool_csr
from persia_tpu_torch.ops.raw_gather import raw_csr
from persia_tpu_torch.parallel.mesh import DataMesh
from persia_tpu_torch.parallel.train_step import (
    TrainState,
    build_eval_step,
    build_train_step,
    init_train_state,
    unpack_step_grads,
    unpack_step_header,
    unpack_step_header_dynamic,
)
from persia_tpu_torch.utils import round_up_pow2
from persia_tpu_torch.weights import train_state_from_flax_bytes, train_state_to_flax_bytes
from persia_tpu_torch.wire import BF16Host, bf16_bits_to_f32, tensor_to_host_f32

WIRE_DTYPES = (None, "float32", "bfloat16")


def _pad_bucket(n: int) -> int:
    """Padded-distinct bucket: pow2 below 512, then 512-quantum (the
    reference's bucketing, kept so both packages stage the same shapes)."""
    if n <= 512:
        return round_up_pow2(n)
    return -(-n // 512) * 512


def _wire(arr: np.ndarray, bf16: bool):
    return BF16Host.from_f32(arr) if bf16 else arr


def stage_embeddings(
    emb_batches: Sequence[FeatureEmbeddingBatch],
    dtype: Optional[str] = None,
    csr: bool = False,
) -> Tuple[List[Dict], List[Optional[int]]]:
    """Convert worker outputs into the device batch's ``emb`` entries
    (host arrays). Raw and device-pooled slots pad their distinct rows to a
    bucketed size, zero rows absorbing padded index entries; device-pooled
    slots share one bucket. ``dtype="bfloat16"`` ships the float rows as
    bf16 (``BF16Host``). ``csr`` adds each device-pooled and raw slot's
    row → positions CSR (``pool_order``, ``pool_offsets``; ``order``,
    ``offsets``, without the pad row's positions, and ``long_chunks``),
    which the backward kernels walk. A raw slot's index is
    range-checked against its P rows here, before the copy: the card's
    gather never reads outside them. Returns (entries, true distinct counts)
    — None for host-pooled slots."""
    if dtype not in WIRE_DTYPES:
        raise ValueError(f"wire dtype must be one of {WIRE_DTYPES}, got {dtype!r}")
    bf16 = dtype == "bfloat16"
    entries: List[Dict] = []
    counts: List[Optional[int]] = []
    shared_p = 0
    for eb in emb_batches:
        if isinstance(eb, DevicePooledBatch):
            shared_p = max(shared_p, eb.distinct.shape[0] + 1)
    if shared_p:
        shared_p = _pad_bucket(shared_p)
    for eb in emb_batches:
        if isinstance(eb, SumEmbeddingBatch):
            entries.append({"pooled": _wire(eb.pooled, bf16)})
            counts.append(None)
        elif isinstance(eb, DevicePooledBatch):
            d, dim = eb.distinct.shape
            padded = np.zeros((shared_p, dim), dtype=np.float32)
            padded[:d] = eb.distinct
            entry = {
                "distinct": _wire(padded, bf16),
                "pool_index": np.ascontiguousarray(eb.index, dtype=np.int32),
            }
            if eb.sqrt_scaling:
                entry["pool_counts"] = eb.counts.reshape(-1, 1).astype(np.int32)
            if csr:
                entry["pool_order"], entry["pool_offsets"] = pool_csr(eb.index, shared_p)
            entries.append(entry)
            counts.append(d)
        else:
            d, dim = eb.distinct.shape
            p = round_up_pow2(d + 1)
            padded = np.zeros((p, dim), dtype=np.float32)
            padded[:d] = eb.distinct
            index = np.where(eb.index == d, p - 1, eb.index).astype(np.int32)
            if index.size and (index.min() < 0 or index.max() >= p):
                raise ValueError(f"raw slot {eb.name!r}: an index lies outside its {p} rows")
            entry = {"distinct": _wire(padded, bf16), "index": index, "mask": eb.index != d}
            if csr:
                entry["order"], entry["offsets"], entry["long_chunks"] = raw_csr(index, p)
            entries.append(entry)
            counts.append(d)
    return entries, counts


def _host_bits(arr) -> Tuple[np.ndarray, Optional[torch.dtype]]:
    """A host array's contiguous bytes as numpy, and the dtype to view them
    as once on the device (None: their own); bf16 travels as int16 bits."""
    if isinstance(arr, BF16Host):
        return np.ascontiguousarray(arr.bits).view(np.int16), torch.bfloat16
    return np.ascontiguousarray(arr), None


def _to_device(arrays: Sequence, device: torch.device, non_blocking: bool = False) -> List[torch.Tensor]:
    """Host arrays (numpy or ``BF16Host``) as tensors on ``device``. On a
    card they travel in one copy: packed at 16-byte offsets into one pinned
    buffer, copied on the current stream (``non_blocking``: without waiting
    for it), and viewed back out of the device buffer."""
    host = [_host_bits(a) for a in arrays]
    if device.type != "cuda":
        out = [torch.from_numpy(a).to(device) for a, _ in host]
    else:
        offsets, total = [], 0
        for a, _ in host:
            offsets.append(total)
            total += -(-a.nbytes // 16) * 16
        pinned = torch.empty(max(total, 16), dtype=torch.uint8, pin_memory=True)
        buf = pinned.numpy()
        for (a, _), o in zip(host, offsets):
            buf[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
        staged = pinned.to(device, non_blocking=non_blocking)
        out = [staged[o:o + a.nbytes].view(torch.from_numpy(a[:0].reshape(-1)).dtype).view(a.shape)
               for (a, _), o in zip(host, offsets)]
    return [t if as_dtype is None else t.view(as_dtype) for t, (_, as_dtype) in zip(out, host)]


def _host_features(batch: PersiaBatch) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """A batch's dense features and labels as host f32 arrays."""
    return ([f.data.astype(np.float32) for f in batch.non_id_type_features],
            [l.data.astype(np.float32) for l in batch.labels])


def staged_tensors(device_batch: Dict) -> List[torch.Tensor]:
    """Every tensor of a device batch."""
    out = list(device_batch["dense"]) + list(device_batch["labels"])
    for e in device_batch["emb"]:
        out.extend(e.values())
    return out


class EmbeddingCtx:
    """Feature preparation: worker outputs → the device batch.
    ``wire_dtype`` ("bfloat16", or None / "float32") is the dtype of the
    embedding rows and their gradients between host and device."""

    def __init__(
        self, worker: EmbeddingWorker, embedding_config: EmbeddingConfig, device=None,
        wire_dtype: Optional[str] = None, mesh: Optional[DataMesh] = None,
    ):
        if wire_dtype not in WIRE_DTYPES:
            raise ValueError(f"wire_dtype must be one of {WIRE_DTYPES}, got {wire_dtype!r}")
        self.worker = worker
        self.embedding_config = embedding_config
        self.device = resolve_device(device)
        self.wire_dtype = None if wire_dtype == "float32" else wire_dtype
        self.mesh = mesh

    @property
    def _lead(self) -> bool:
        """This rank holds the worker (rank 0, or no mesh)."""
        return self.mesh is None or self.mesh.rank == 0

    def prepare_features(
        self, batch: PersiaBatch, emb_batches: Sequence[FeatureEmbeddingBatch], csr: bool = False,
        non_blocking: bool = False,
    ) -> Tuple[Dict, List[Optional[int]]]:
        """The device batch (tensors on ``self.device``) + true distinct
        counts per slot. On a card the batch travels in one copy from pinned
        memory, on the current stream; ``non_blocking``: without waiting for
        it, the caller ordering the batch's use after it (``DataLoader``
        records an event)."""
        entries, counts = stage_embeddings(emb_batches, dtype=self.wire_dtype, csr=csr)
        dense, labels = _host_features(batch)
        keys = [list(e) for e in entries]
        flat = _to_device(dense + labels + [e[k] for e, ks in zip(entries, keys) for k in ks],
                          self.device, non_blocking)
        it = iter(flat)
        device_batch = {
            "dense": [next(it) for _ in dense],
            "labels": [next(it) for _ in labels],
            "emb": [{k: next(it) for k in ks} for ks in keys],
        }
        return device_batch, counts

    def emb_grads_to_slot_grads(
        self,
        emb_batches: Sequence[FeatureEmbeddingBatch],
        emb_grads: Sequence[np.ndarray],
        counts: Sequence[Optional[int]],
    ) -> Dict[str, np.ndarray]:
        """Strip the padding rows and key the host gradients by slot name
        for the worker's gradient path."""
        out = {}
        for eb, g, d in zip(emb_batches, emb_grads, counts):
            g = np.asarray(g, dtype=np.float32)
            out[eb.name] = g if d is None else g[:d]
        return out

    def _dense_state(self) -> Optional[TrainState]:
        """The dense training state a checkpoint carries (None: none)."""
        return None

    def dump_checkpoint(self, dst: str) -> None:
        """The dense state (``dense.ckpt``, flax's bytes) and the embedding
        tables (``EmbeddingWorker.dump``) into the directory ``dst``. Over
        a mesh every rank calls it (the dense bytes gather the ranks'
        rows) and rank 0 writes."""
        state = self._dense_state()
        raw = train_state_to_flax_bytes(state) if state is not None else None
        if self._lead:
            if raw is not None:
                dump_dense(raw, dst)
            self.worker.dump(dst)

    def load_checkpoint(self, src: str) -> None:
        """Load a checkpoint directory of either package: the dense state,
        where both it and the ctx have one, in place, and the tables (on
        rank 0; every rank reads the dense state)."""
        state = self._dense_state()
        raw = load_dense(src, missing_ok=True) if state is not None else None
        if raw is not None:
            train_state_from_flax_bytes(state, raw)
        if self._lead:
            self.worker.load(src)


class TrainCtx(EmbeddingCtx):
    """Synchronous hybrid training over the lookup-direct path.

    ``dense_optimizer`` is a ``torch.optim`` optimizer over ``model``'s
    parameters (``torch.optim.Adam`` in the reference's configs);
    ``embedding_optimizer`` a sparse one of ``persia_tpu_torch.embedding.optim``,
    registered on every parameter-server replica by ``__enter__``. The model
    moves to the ctx's device.

    ``mesh`` (``parallel.mesh.data_parallel_mesh()``) and ``dense_sync`` (a
    mode of ``grad_sync.DENSE_SYNC_MODES``; ``dense_sync_block_size`` the
    ring's block): the dense half trains data-parallel over the mesh's
    ranks (the module's docstring), every rank holding the same
    parameters; ``worker`` is rank 0's (None elsewhere). ``dense_sync``
    needs a mesh and excludes the dynamic loss scale; a mesh of more than
    one rank without it syncs as "f32" and is labelled "implicit-psum"
    (``sync_mode``). The bytegrad residual lives on the ctx and is lost on
    a resume, as the reference's; the ring's error feedback and the
    sharded moments are durable state.
    """

    def __init__(
        self,
        model: torch.nn.Module,
        dense_optimizer: torch.optim.Optimizer,
        embedding_optimizer,
        worker: Optional[EmbeddingWorker],
        embedding_config: EmbeddingConfig,
        device=None,
        grad_scale: float = 1.0,
        loss_fn=None,
        wire_dtype: Optional[str] = None,
        dynamic_loss_scale: bool = False,
        loss_scale_init: float = float(2 ** 15),
        loss_scale_growth_interval: int = 2000,
        loss_scale_max: float = float(2 ** 24),
        mesh: Optional[DataMesh] = None,
        dense_sync: Optional[str] = None,
        dense_sync_block_size: int = 256,
    ):
        super().__init__(worker, embedding_config, device=device, wire_dtype=wire_dtype, mesh=mesh)
        if worker is None and self._lead:
            raise ValueError("rank 0 (or a ctx without a mesh) needs the worker")
        self.model = model.to(self.device)
        self.dense_optimizer = dense_optimizer
        self.embedding_optimizer = embedding_optimizer
        self.grad_scale = grad_scale
        self.dynamic_loss_scale = dynamic_loss_scale
        self._loss_scale_init = loss_scale_init if dynamic_loss_scale else None
        kwargs = {} if loss_fn is None else {"loss_fn": loss_fn}
        self._train_step = build_train_step(
            self.model, dense_optimizer,
            dynamic_loss_scale=dynamic_loss_scale,
            growth_interval=loss_scale_growth_interval,
            max_scale=loss_scale_max,
            **kwargs,
        )
        # the dense sync: an explicit mode, or "f32" under the label
        # "implicit-psum" on a mesh of more than one rank
        self.dense_sync = dense_sync
        self.dense_sync_block_size = int(dense_sync_block_size)
        self._sync_algorithm, self._sync_sharded = None, False
        self._dense_wire_bytes_per_step = 0
        if dense_sync is not None:
            if mesh is None:
                raise ValueError("dense_sync requires a device mesh")
            if dynamic_loss_scale:
                raise ValueError("dense_sync and dynamic_loss_scale are mutually exclusive: the explicit-collective "
                                 "step has no loss-scale path")
        mode = dense_sync if dense_sync is not None else ("f32" if mesh is not None and mesh.size > 1 else None)
        if mode is not None:
            from persia_tpu_torch.parallel.grad_sync import build_sync_train_step, sync_mode_algorithm

            self._sync_algorithm, self._sync_sharded = sync_mode_algorithm(mode, self.dense_sync_block_size)
            self._train_step = build_sync_train_step(self.model, dense_optimizer, mesh, self._sync_algorithm,
                                                     sharded_update=self._sync_sharded, **kwargs)
        self._eval_step = build_eval_step(self.model)
        self.state: Optional[TrainState] = None
        # pipelined steps: the gradients' device→host stream (a card only),
        # and the header of the last step whose metrics were not fetched
        self._d2h_stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._deferred_header = None
        # job state: the epoch of the last manifest (None: no journal ids
        # until a snapshot or resume arms them) and the steps trained
        self._job_epoch: Optional[int] = None
        self._global_step = 0
        self.last_resume_info: Optional[Dict] = None

    def __enter__(self):
        if self.worker is not None:
            self.worker.register_optimizer(self.embedding_optimizer.config)
        return self

    def __exit__(self, *exc):
        if self.worker is not None:
            self.worker.close()
        return False

    @property
    def sync_mode(self) -> str:
        """The dense sync's label: the ``dense_sync`` mode, else
        "implicit-psum" on a mesh of more than one rank, else "local"."""
        if self.dense_sync is not None:
            return self.dense_sync
        if self.mesh is not None and self.mesh.size > 1:
            return "implicit-psum"
        return "local"

    def dense_wire_bytes_per_step(self) -> int:
        """The modelled dense collective bytes a rank sends a step
        (``grad_sync.dense_sync_wire_bytes``; 0 before ``init_state``)."""
        return self._dense_wire_bytes_per_step

    def init_state(self) -> TrainState:
        self.state = init_train_state(self.model, self.dense_optimizer, self._loss_scale_init)
        if self._sync_algorithm is not None:
            from persia_tpu_torch.parallel.grad_sync import (
                ByteGradAllReduce,
                init_residual,
                init_sync_opt_state,
            )

            sync = init_sync_opt_state(self.model, self.dense_optimizer, self.mesh, self._sync_algorithm,
                                       self._sync_sharded, device=self.device)
            if isinstance(self._sync_algorithm, ByteGradAllReduce):
                sync.residual = init_residual(self.model, self.device)
            self.state.sync = sync
        from persia_tpu_torch.parallel.grad_sync import dense_param_count, dense_sync_wire_bytes

        n = self.mesh.size if self.mesh is not None else 1
        self._dense_wire_bytes_per_step = dense_sync_wire_bytes(self.sync_mode, dense_param_count(self.model), n,
                                                                block_size=self.dense_sync_block_size)
        return self.state

    def _dense_state(self) -> TrainState:
        return self.state if self.state is not None else self.init_state()

    # ----------------------------------------------------------- job state

    def _ps_replicas(self) -> List:
        return self.worker.lookup_router.replicas

    def snapshot_job(self, job_state, loader=None, generators=None) -> jobstate.Manifest:
        """A step-fenced snapshot: ``loader`` (if given) flushed, then the
        PS shards, the dense state (flax's bytes), the loader cursor and the
        RNG streams (numpy's global one and the named ``generators``)
        committed as one manifest epoch. ``job_state`` is a
        ``JobStateManager`` or its root directory. Over a mesh every rank
        calls it; rank 0 commits (and returns) the manifest."""
        mgr = jobstate.coerce_manager(job_state)
        if loader is not None:
            loader.flush()  # the fence: no gradient in flight past here
        state_bytes = train_state_to_flax_bytes(self.state) if self.state is not None else None  # every rank's rows
        if not self._lead:
            return None  # rank 0 commits the manifest
        router = self.worker.lookup_router
        manifest = jobstate.snapshot_job(
            mgr, self._global_step,
            state_bytes=state_bytes,
            replicas=self._ps_replicas(),
            batch_advances=dict(router.batch_advances),
            components={"loader.json": {"consumed_batches": self._global_step,
                                        "staleness_outstanding": 0}},
            meta={"kind": "train_ctx"},
            generators=generators,
        )
        self._job_epoch = manifest.job_epoch
        return manifest

    def resume(self, job_state, restore_ps: bool = True, generators=None) -> Optional[jobstate.Manifest]:
        """Rebuild the fence state of the newest good manifest (the RNG
        streams too, ``generators`` as in ``snapshot_job``), or on a cold
        start arm the journal at epoch 0. Returns the manifest or None;
        ``last_resume_info`` holds the recovery numbers.

        ``restore_ps`` rewinds the PS to the fence (the replayed window
        applies again: bit for bit an uninterrupted run); without it the PS
        keeps what the crashed run applied and the journal skips the
        replayed batches it holds (exactly once). The dense state loads in
        place; the router's cumulative Adam batch advances continue from
        the fence's. Over a mesh every rank calls it: rank 0 rewinds the
        servers and hands the dense bytes on (the manifest is rank 0's
        return; None elsewhere)."""
        mgr = jobstate.coerce_manager(job_state)
        manifest, info, raw = None, None, None
        if self._lead:
            manifest, info = jobstate.resume_job(
                mgr, replicas=self._ps_replicas(), rewind_ps=restore_ps,
                optimizer=self.embedding_optimizer.config, generators=generators,
            )
            if manifest is not None and manifest.has("dense.state"):
                raw = manifest.read_blob("dense.state")
        pos = (manifest.job_epoch, manifest.step) if manifest is not None else None
        if self.mesh is not None:  # every rank loads the dense state
            pos, raw = self.mesh.broadcast_object((pos, raw))
        self.last_resume_info = info
        if pos is None:
            self._job_epoch = 0
            self._global_step = 0
            return None
        if raw is not None:
            train_state_from_flax_bytes(self._dense_state(), raw)
        if self._lead:
            self.worker.lookup_router.batch_advances = dict(info["batch_advances"])
        self._job_epoch, self._global_step = pos
        return manifest

    def _journal_id(self) -> Optional[int]:
        if self._job_epoch is None:
            return None
        return jobstate.make_journal_id(self._job_epoch, self._global_step)

    def run_step(self, device_batch: Dict):
        """The device step on a staged batch: (header, gpacked) on the
        device."""
        if self.state is None:
            self.init_state()
        return self._train_step(self.state, device_batch)

    def _metrics(self, header, device_batch: Dict) -> Dict:
        """The step header's device→host copy as metrics: {loss, preds},
        with the dynamic loss scale also {loss_scale, grads_finite}."""
        h = header.cpu().numpy()
        if self.dynamic_loss_scale:
            loss, preds, scale, finite = unpack_step_header_dynamic(h, device_batch)
            return {"loss": loss, "preds": preds, "loss_scale": scale, "grads_finite": finite}
        loss, preds = unpack_step_header(h, device_batch)
        return {"loss": loss, "preds": preds}

    def fetch_step_output(self, header, gpacked, device_batch: Dict):
        """Device→host copies of a step's outputs: (metrics, per-slot
        gradients as f32 arrays)."""
        return self._metrics(header, device_batch), unpack_step_grads(tensor_to_host_f32(gpacked), device_batch)

    def train_step(self, batch: PersiaBatch) -> Dict:
        """One synchronous hybrid step: lookup → device step → gradient
        return. Returns host metrics {loss, preds} (with the dynamic loss
        scale also {loss_scale, grads_finite}). Over a mesh of more than one
        rank every rank calls it with the same global batch; the metrics
        are the global batch's on every rank."""
        ref = emb_batches = None
        if self._lead:
            ref = self.worker.put_forward_ids(batch)
            emb_batches = self.worker.forward_batch_id(ref, train=True)
        try:
            if self.mesh is not None and self.mesh.size > 1:
                device_batch, counts, layout = self._prepare_rank_share(batch, emb_batches)
            else:
                device_batch, counts = self.prepare_features(batch, emb_batches, csr=True)
                layout = device_batch
            header, gpacked = self.run_step(device_batch)
            metrics, emb_grads = self.fetch_step_output(header, gpacked, layout)
            if self._lead:
                slot_grads = self.emb_grads_to_slot_grads(emb_batches, emb_grads, counts)
        except Exception:
            # release the staleness slot and the stashed layout
            if self._lead:
                self.worker.abort_gradient(ref)
            raise
        if self._lead:
            # embedding gradients ship scaled; the worker divides by the
            # dynamic loss scale composed with the static grad_scale
            scale = metrics.get("loss_scale", 1.0) * self.grad_scale
            self.worker.update_gradient_batched(ref, slot_grads, scale_factor=scale,
                                                journal_id=self._journal_id())
        self._global_step += 1
        return metrics

    def _prepare_rank_share(self, batch: Optional[PersiaBatch], emb_batches, lead_features: bool = False):
        """This rank's share of the global batch on the device: rank 0
        stages the looked-up embeddings and hands them to every rank; each
        takes its rows ``mesh.rows(B)`` of the dense features, the labels
        and the per-sample embedding inputs (the distinct rows whole) and
        builds the backward kernels' CSRs over its rows. The dense features
        and labels are each rank's own ``batch``'s, or with
        ``lead_features`` rank 0's, handed on with the embeddings (the other
        ranks pass None). Returns (device batch, true distinct counts, the
        global batch's layout: the shapes the step's outputs unpack by)."""
        staged = None
        if self._lead:
            staged = stage_embeddings(emb_batches, dtype=self.wire_dtype)
            if lead_features:
                staged += (_host_features(batch),)
        staged = self.mesh.broadcast_object(staged)
        entries, counts = staged[:2]
        dense, labels = staged[2] if lead_features else _host_features(batch)
        a, b = self.mesh.rows(labels[0].shape[0])

        def rows(x):
            return BF16Host(x.bits[a:b]) if isinstance(x, BF16Host) else np.ascontiguousarray(x[a:b])

        local = []
        for e in entries:
            if "pooled" in e:
                local.append({"pooled": rows(e["pooled"])})
            elif "pool_index" in e:
                le = {"distinct": e["distinct"], "pool_index": rows(e["pool_index"])}
                if "pool_counts" in e:
                    le["pool_counts"] = rows(e["pool_counts"])
                le["pool_order"], le["pool_offsets"] = pool_csr(le["pool_index"], e["distinct"].shape[0])
                local.append(le)
            else:
                le = {"distinct": e["distinct"], "index": rows(e["index"]), "mask": rows(e["mask"])}
                le["order"], le["offsets"], le["long_chunks"] = raw_csr(le["index"], e["distinct"].shape[0])
                local.append(le)
        keys = [list(e) for e in local]
        flat = _to_device([rows(d) for d in dense] + [rows(l) for l in labels]
                          + [e[k] for e, ks in zip(local, keys) for k in ks], self.device)
        it = iter(flat)
        device_batch = {
            "dense": [next(it) for _ in dense],
            "labels": [next(it) for _ in labels],
            "emb": [{k: next(it) for k in ks} for ks in keys],
        }
        meta = lambda shape: torch.empty(shape, device="meta")  # noqa: E731
        layout = {"labels": [meta(l.shape) for l in labels],
                  "emb": [{"pooled": meta(e["pooled"].shape)} if "pooled" in e else {"distinct": meta(e["distinct"].shape)}
                          for e in entries]}
        return device_batch, counts, layout

    def _grads_to_host_async(self, gpacked: torch.Tensor) -> Callable[[], np.ndarray]:
        """Start the packed gradients' copy to the host; returns a function
        that waits for it and gives the host f32 array. On a card the copy
        runs on a side stream, after the step's work on the current stream,
        into a pinned buffer that lives until that function's result is
        dropped."""
        if self._d2h_stream is None:
            return lambda: tensor_to_host_f32(gpacked)
        side = self._d2h_stream
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            host = torch.empty(gpacked.shape, dtype=gpacked.dtype, pin_memory=True)
            host.copy_(gpacked, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(side)
        gpacked.record_stream(side)  # its memory stays until the copy has read it

        def fetch() -> np.ndarray:
            copied.synchronize()
            if host.dtype == torch.bfloat16:
                return bf16_bits_to_f32(host.view(torch.int16).numpy())
            return host.numpy()

        return fetch

    def train_step_prepared(self, training_batch, loader, fetch_metrics: bool = True) -> Optional[Dict]:
        """Pipelined step on a batch from a ``DataLoader``: the device step,
        then the embedding gradients return asynchronously through the
        loader's ``BackwardEngine`` (bounded staleness). The device step of
        batch N overlaps the lookup of batch N+k.

        Over a mesh of more than one rank every rank calls it: rank 0 with
        its loader's batch and the loader, the others with None for both.
        Rank 0 hands every rank its rows of the host arrays the loader staged
        from (the loader's device batch is rank 0's whole batch, which the
        step does not read), and alone returns the gradients through the
        loader; the metrics are the global batch's on every rank.

        ``fetch_metrics=False`` (static loss scale only: the dynamic scale
        is read every step) skips the per-step header copy and returns
        None; ``last_prepared_metrics`` reads the last one after the loop."""
        meshed = self.mesh is not None and self.mesh.size > 1
        defer = not fetch_metrics and not self.dynamic_loss_scale
        if not defer:
            self._deferred_header = None  # this step's metrics are fresher
        try:
            if meshed:
                lead = self._lead
                device_batch, _counts, layout = self._prepare_rank_share(
                    training_batch.batch if lead else None, training_batch.emb_batches if lead else None,
                    lead_features=True)
            else:
                device_batch = layout = training_batch.device_batch
                if training_batch.ready is not None:
                    # the staging stream's copies first; their memory is in
                    # use on this stream until the step's work here is done
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(training_batch.ready)
                    for t in staged_tensors(device_batch):
                        t.record_stream(stream)
            header, gpacked = self.run_step(device_batch)
            fetch = self._grads_to_host_async(gpacked) if self._lead else None
            if defer:
                # keep the label shape, not the batch: holding the batch
                # would pin its device tensors until the deferred fetch
                self._deferred_header = (header, tuple(layout["labels"][0].shape))
                metrics = None
            else:
                metrics = self._metrics(header, layout)
        except Exception:
            if self._lead:
                loader.mark_consumed(training_batch)
            raise
        if self._lead:
            # as in train_step: the worker divides by the dynamic loss scale
            # composed with the static grad_scale
            scale = (metrics or {}).get("loss_scale", 1.0) * self.grad_scale
            loader.backward_packed(training_batch, fetch, scale_factor=scale, journal_id=self._journal_id())
        self._global_step += 1
        return metrics

    def last_prepared_metrics(self) -> Optional[Dict]:
        """The metrics of the last ``fetch_metrics=False`` step (one
        device→host copy), or None."""
        if self._deferred_header is None:
            return None
        header, label_shape = self._deferred_header
        self._deferred_header = None
        h = header.cpu().numpy()
        return {"loss": float(h[0]), "preds": h[1:].reshape(label_shape)}

    def eval_batch(self, batch: PersiaBatch) -> np.ndarray:
        emb_batches = self.worker.forward_directly(batch, train=False)
        device_batch, _ = self.prepare_features(batch, emb_batches)
        return self._eval_step(device_batch).cpu().numpy()


class InferCtx(EmbeddingCtx):
    """Inference: lookup-direct, zeros-on-miss. The model carries its own
    parameters; it is moved to the ctx's device and put in eval mode."""

    def __init__(self, model: torch.nn.Module, worker, embedding_config, device=None):
        super().__init__(worker, embedding_config, device=device)
        self.model = model.to(self.device).eval()
        self._eval_step = build_eval_step(self.model)

    def predict(self, batch: PersiaBatch) -> np.ndarray:
        emb_batches = self.worker.forward_directly(batch, train=False)
        device_batch, _ = self.prepare_features(batch, emb_batches)
        return self._eval_step(device_batch).cpu().numpy()

    def predict_from_bytes(self, raw: bytes) -> np.ndarray:
        return self.predict(PersiaBatch.from_bytes(raw))
