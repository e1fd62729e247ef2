"""Crash-consistent training on the port (``TrainCtx.snapshot_job`` /
``resume``), the counterparts of ``tests/test_jobstate.py``'s fast
kill/resume runs, on DLRM with ``device="cpu"`` (the flagship's shape:
bottom (32, 16), top (64, 32), four single-id slots and one raw slot, two
PS replicas), on both store backends:

- kill/resume bit-identical: snapshots every 4 steps, the trainer abandoned
  at step 9 with gradients applied past the fence, a fresh ctx resumed on
  the surviving stores; after the replay the dense state's bytes and every
  PS shard's dump equal an uninterrupted run's (through ``train_step`` and
  through the ``DataLoader``);
- journal resume exactly once: ``restore_ps=False`` keeps the PS as the
  crash left it, and the replayed window moves no entry;
- across the packages: a manifest the reference's ``TrainCtx`` wrote at
  step 4 resumes the port, and one the port wrote resumes the reference;
  the next 3 steps match at ``test_torch_train_ctx.py``'s stated
  tolerances for the bench's bf16 path (losses 2e-2, PS rows 1e-2), here
  with an f32 wire and f32 compute;
- the committed fixture ``tests/fixtures/jax_train_ctx_manifest`` (a job
  directory the reference's ``TrainCtx`` writes at step 4, which
  ``chip_smoke.py`` also reads on the card) is what the reference writes
  today, and the port resumes from it. ``python tests/test_torch_resume.py``
  writes it anew.
"""

import itertools
import json
import os
import pathlib
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import persia_tpu.config as jcfg
import persia_tpu.data as jdata
from persia_tpu import jobstate as jjob
from persia_tpu.ctx import TrainCtx as JaxTrainCtx
from persia_tpu.embedding import optim as joptim
from persia_tpu.embedding.store import EmbeddingStore as JaxStore
from persia_tpu.embedding.worker import EmbeddingWorker as JaxWorker
from persia_tpu.models import DLRM as JaxDLRM
from persia_tpu.parallel.train_step import TrainState as JaxTrainState
import persia_tpu_torch.config as tcfg
import persia_tpu_torch.data as tdata
from persia_tpu_torch import jobstate as tjob
from persia_tpu_torch.ctx import TrainCtx
from persia_tpu_torch.data_loader import BatchCursor, DataLoader
from persia_tpu_torch.embedding import optim as toptim
from persia_tpu_torch.embedding.native_store import create_store
from persia_tpu_torch.embedding.worker import EmbeddingWorker
from persia_tpu_torch.models import DLRM
from persia_tpu_torch.weights import seeded_flax_params_like, state_dict_from_flax, train_state_to_flax_bytes

DIM, BOTTOM, TOP = 16, (32, 16), (64, 32)
STEPS, K, KILL_AT = 12, 4, 9
LOSS_TOL, ROW_TOL = dict(rtol=0, atol=2e-2), dict(rtol=0, atol=1e-2)


def _cfg(cfg):
    slots = {f"cat_{i}": cfg.SlotConfig(dim=DIM) for i in range(4)}
    slots["hist"] = cfg.SlotConfig(dim=DIM, embedding_summation=False, sample_fixed_size=8)
    return cfg.EmbeddingConfig(slots_config=slots, feature_index_prefix_bit=8)


def _batch(data, seed, b=16):
    rng = np.random.default_rng(seed)
    feats = [data.IDTypeFeature(f"cat_{i}", [rng.integers(0, 100, 1, dtype=np.uint64) for _ in range(b)])
             for i in range(4)]
    feats.append(data.IDTypeFeature("hist", [rng.integers(0, 64, rng.integers(0, 8), dtype=np.uint64)
                                             for _ in range(b)]))
    return data.PersiaBatch(
        feats, non_id_type_features=[data.NonIDTypeFeature(rng.normal(size=(b, 13)).astype(np.float32))],
        labels=[data.Label(rng.integers(0, 2, (b, 1)).astype(np.float32))], requires_grad=True,
    )


def _batches(n=STEPS, data=tdata):
    return [_batch(data, 100 + i) for i in range(n)]


SPARSE = {"adagrad": lambda m: m.Adagrad(lr=0.1), "adam": lambda m: m.Adam(lr=0.01)}


def _stores(backend, n=2):
    return [create_store(backend, capacity=1 << 16, num_internal_shards=4, seed=3) for _ in range(n)]


def _ctx(stores, sparse="adagrad", dynamic=False, wire_dtype="bfloat16", compute=torch.bfloat16):
    model = DLRM(13, 5, DIM, BOTTOM, TOP, compute_dtype=compute, device="cpu")
    model.load_state_dict(state_dict_from_flax(model, seeded_flax_params_like(model, 11)))
    worker = EmbeddingWorker(_cfg(tcfg), stores, device_pooling=True)
    return TrainCtx(model, torch.optim.Adam(model.parameters(), lr=1e-3), SPARSE[sparse](toptim), worker,
                    _cfg(tcfg), device="cpu", wire_dtype=wire_dtype, dynamic_loss_scale=dynamic,
                    loss_scale_growth_interval=2).__enter__()


def _dumps(stores):
    return [st.dump_shard(i) for st in stores for i in range(st.num_internal_shards)]


@pytest.mark.parametrize("backend", ["numpy", "native"])
@pytest.mark.parametrize("sparse,dynamic", [("adagrad", False), ("adam", True)])
def test_kill_resume_bit_identical(tmp_path, backend, sparse, dynamic):
    batches = _batches()
    base_stores = _stores(backend)
    base = _ctx(base_stores, sparse, dynamic)
    for b in batches:
        base.train_step(b)

    mgr = tjob.JobStateManager(str(tmp_path / "js"))
    stores = _stores(backend)
    ctx1 = _ctx(stores, sparse, dynamic)
    assert ctx1.resume(mgr) is None  # a cold start arms the journal at epoch 0
    assert ctx1._journal_id() == tjob.make_journal_id(0, 0)
    data_rng = np.random.default_rng(1)  # a dataset's stream, captured at each fence
    for i, b in enumerate(batches[:KILL_AT]):
        ctx1.train_step(b)
        data_rng.random()
        if (i + 1) % K == 0:
            ctx1.snapshot_job(mgr, generators={"data": data_rng})
            at_fence = data_rng.random(3)
    assert stores[0].journal_len() > 0
    del ctx1  # the trainer dies; the PS stores survive

    ctx2 = _ctx(stores, sparse, dynamic)
    m = ctx2.resume(mgr, generators={"data": data_rng})
    np.testing.assert_array_equal(data_rng.random(3), at_fence)
    assert m is not None and m.step == 8 and m.job_epoch == 2
    info = ctx2.last_resume_info
    assert info["resumed"] and info["ps_entries_restored"] > 0 and info["batch_advances"]
    assert all(st.journal_len() == 0 for st in stores)
    assert ctx2.worker.lookup_router.batch_advances == info["batch_advances"]
    for b in batches[m.step:]:
        ctx2.train_step(b)
    assert train_state_to_flax_bytes(ctx2.state) == train_state_to_flax_bytes(base.state)
    assert _dumps(stores) == _dumps(base_stores)
    assert ctx2.worker.lookup_router.batch_advances == base.worker.lookup_router.batch_advances


@pytest.mark.parametrize("backend", ["numpy", "native"])
def test_journal_resume_exactly_once(tmp_path, backend):
    batches = _batches(10)
    mgr = tjob.JobStateManager(str(tmp_path / "js"))
    stores = _stores(backend)
    ctx1 = _ctx(stores)
    ctx1.resume(mgr)
    for i, b in enumerate(batches[:7]):  # a fence at 4, dies at 7
        ctx1.train_step(b)
        if (i + 1) % 4 == 0:
            ctx1.snapshot_job(mgr)
    at_crash = _dumps(stores)
    del ctx1

    ctx2 = _ctx(stores)
    m = ctx2.resume(mgr, restore_ps=False)
    assert m.step == 4 and not ctx2.last_resume_info["ps_rewound"]
    router = ctx2.worker.lookup_router
    for b in batches[4:7]:  # the window the crashed run applied replays
        ctx2.train_step(b)
    assert router.journal_skips >= 3  # every replayed batch, on each replica it reached
    after = _dumps(stores)
    # lookups touched the LRU order; no entry moved
    assert sorted(_entries(after)) == sorted(_entries(at_crash))
    ctx2.train_step(batches[7])  # past the crash: applies
    assert sorted(_entries(_dumps(stores))) != sorted(_entries(at_crash))


def _entries(dumps):
    """(sign, entry bytes) of every entry of shard dumps, in any order."""
    out = []
    for blob in dumps:
        n, off = int(np.frombuffer(blob[:4], np.uint32)[0]), 4
        for _ in range(n):
            ln = int(np.frombuffer(blob[off + 12:off + 16], np.uint32)[0])
            out.append((blob[off:off + 8], blob[off + 8:off + 16 + 4 * ln]))
            off += 16 + 4 * ln
    return out


def _train_windows(ctx, batches, mgr, start=0, stop=None):
    """Train ``batches[start:stop]`` through a reproducible loader (staleness
    1), a fresh loader for each window of K batches, each full window
    ending in a snapshot (the loader flushed: the fence)."""
    it = iter(BatchCursor(batches[:stop], skip=start))
    while window := list(itertools.islice(it, K - ctx._global_step % K)):
        loader = DataLoader(iter(window), ctx, num_workers=2, staleness=1, reproducible=True)
        for tb in loader:
            ctx.train_step_prepared(tb, loader)
        loader.flush()
        loader.shutdown()
        if ctx._global_step % K == 0:
            ctx.snapshot_job(mgr, loader=loader)


@pytest.mark.parametrize("restore_ps", [True, False])
def test_pipelined_resume(tmp_path, restore_ps):
    """The same runs through ``DataLoader`` + ``train_step_prepared``: the
    journal ids reach the PS through the ``BackwardEngine``; a rewind
    replays bit for bit, a journal resume skips the replayed window."""
    batches = _batches()
    base_stores = _stores("native")
    base = _ctx(base_stores)
    base.resume(str(tmp_path / "base"))
    _train_windows(base, batches, str(tmp_path / "base"))

    stores = _stores("native")
    ctx1 = _ctx(stores)
    mgr = str(tmp_path / "js")
    ctx1.resume(mgr)
    _train_windows(ctx1, batches, mgr, stop=KILL_AT)
    at_crash = _dumps(stores)
    del ctx1

    ctx2 = _ctx(stores)
    m = ctx2.resume(mgr, restore_ps=restore_ps)
    assert m.step == 8
    if restore_ps:
        _train_windows(ctx2, batches, mgr, start=m.step)
        assert train_state_to_flax_bytes(ctx2.state) == train_state_to_flax_bytes(base.state)
        assert _dumps(stores) == _dumps(base_stores)
    else:
        _train_windows(ctx2, batches, mgr, start=m.step, stop=KILL_AT)
        assert ctx2.worker.lookup_router.journal_skips >= 1
        assert sorted(_entries(_dumps(stores))) == sorted(_entries(at_crash))


# ------------------------------------------------------- across the packages


def _jax_ctx(stores):
    model = JaxDLRM(embedding_dim=DIM, bottom_mlp=BOTTOM, top_mlp=TOP, compute_dtype=jnp.float32)
    worker = JaxWorker(_cfg(jcfg), stores, device_pooling=True)
    return JaxTrainCtx(model, optax.adam(1e-3), joptim.Adagrad(lr=0.1), worker, _cfg(jcfg)).__enter__()


def _jax_stores():
    return [JaxStore(capacity=1 << 16, num_internal_shards=4, seed=3) for _ in range(2)]


def _compare(jctx, tctx, jbatch, tbatch):
    a, b = jctx.train_step(jbatch), tctx.train_step(tbatch)
    np.testing.assert_allclose(b["loss"], a["loss"], **LOSS_TOL)
    np.testing.assert_allclose(b["preds"], a["preds"], **LOSS_TOL)


def _compare_rows(jstores, tstores):
    for js, ts in zip(jstores, tstores):
        assert js.size() == ts.size() > 0
        for shard in js._shards:
            for sign, (_, vec) in shard.entries.items():
                np.testing.assert_allclose(ts.get_embedding_entry(sign), vec, **ROW_TOL)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_cross_package_resume(tmp_path, direction):
    jb = _batches(7, jdata)
    tb = [tdata.PersiaBatch.from_bytes(b.to_bytes()) for b in jb]
    mgr = str(tmp_path / "js")
    if direction == "jax_to_port":
        jstores = _jax_stores()
        writer = _jax_ctx(jstores)
        writer.resume(jjob.JobStateManager(mgr))
        params = jax.tree.map(jnp.asarray, seeded_flax_params_like(DLRM(13, 5, DIM, BOTTOM, TOP, device="cpu"), 11))
        writer.state = JaxTrainState(params=params, batch_stats={}, opt_state=optax.adam(1e-3).init(params),
                                     step=jnp.zeros((), jnp.int32))
        for b in jb[:4]:
            writer.train_step(b)
        m = writer.snapshot_job(jjob.JobStateManager(mgr))
        tstores = _stores("native")
        reader = _ctx(tstores, wire_dtype=None, compute=torch.float32)
        assert reader.resume(mgr).step == 4
        # a state the reference trained reads into the port and back to its bytes
        assert train_state_to_flax_bytes(reader.state) == m.read_blob("dense.state")
        jctx, tctx = writer, reader
    else:
        tstores = _stores("native")
        writer = _ctx(tstores, wire_dtype=None, compute=torch.float32)
        writer.resume(mgr)
        for b in tb[:4]:
            writer.train_step(b)
        writer.snapshot_job(mgr)
        jstores = _jax_stores()
        reader = _jax_ctx(jstores)
        assert reader.resume(jjob.JobStateManager(mgr)).step == 4
        assert reader.last_resume_info["ps_entries_restored"] == sum(s.size() for s in tstores)
        jctx, tctx = reader, writer
    for j, t in zip(jb[4:], tb[4:]):
        _compare(jctx, tctx, j, t)
    assert jctx._global_step == tctx._global_step == 7
    _compare_rows(jstores, tstores)


# ------------------------------------------------------ the committed fixture

FIXTURE = pathlib.Path(__file__).resolve().parent / "fixtures" / "jax_train_ctx_manifest"


def write_jax_manifest(root: str) -> None:
    """A job directory of the reference's ``TrainCtx`` (f32, two numpy
    replicas) after 4 steps and one snapshot."""
    jctx = _jax_ctx(_jax_stores())
    jctx.resume(jjob.JobStateManager(root))
    params = jax.tree.map(jnp.asarray, seeded_flax_params_like(DLRM(13, 5, DIM, BOTTOM, TOP, device="cpu"), 11))
    jctx.state = JaxTrainState(params=params, batch_stats={}, opt_state=optax.adam(1e-3).init(params),
                               step=jnp.zeros((), jnp.int32))
    for b in _batches(4, jdata):
        jctx.train_step(b)
    jctx.snapshot_job(jjob.JobStateManager(root))


def _layout(root):
    """A manifest's layout: its meta but the date, its components' names and
    sizes, and its dense state's leaves (path, dtype, shape)."""
    m = tjob.JobStateManager(root).latest()
    meta = {k: v for k, v in m.meta.items() if k not in ("datetime", "components")}
    from persia_tpu_torch.serialization import msgpack_restore

    leaves = jax.tree_util.tree_flatten_with_path(msgpack_restore(m.read_blob("dense.state")))[0]
    dense = [(jax.tree_util.keystr(k), str(v.dtype), v.shape) for k, v in leaves]
    return meta, {n: c["bytes"] for n, c in m.components.items()}, dense


def test_committed_jax_manifest_is_what_the_reference_writes(tmp_path):
    write_jax_manifest(str(tmp_path))
    meta, comps, dense = _layout(str(tmp_path))
    fmeta, fcomps, fdense = _layout(str(FIXTURE))
    assert (meta, dense) == (fmeta, fdense)
    assert {n: b for n, b in comps.items() if n != "rng.json"} == {n: b for n, b in fcomps.items() if n != "rng.json"}
    assert sum(p.stat().st_size for p in FIXTURE.rglob("*")) < 1 << 20


def test_port_resumes_from_the_committed_jax_manifest(tmp_path):
    """The port reads the fixture (every blob's crc checked), restores its
    two replicas' shards (re-dumped: the reference's bytes) and its dense
    state (re-serialised: the reference's bytes)."""
    root = str(tmp_path / "js")
    shutil.copytree(FIXTURE, root)
    stores = _stores("native")
    ctx = _ctx(stores, wire_dtype=None, compute=torch.float32)
    m = ctx.resume(root)
    assert m.step == 4 and ctx._global_step == 4 and ctx._journal_id() == tjob.make_journal_id(m.job_epoch, 4)
    for name in m.components:
        m.read_blob(name)
    assert train_state_to_flax_bytes(ctx.state) == m.read_blob("dense.state")
    for r, st in enumerate(stores):
        for i in range(st.num_internal_shards):
            assert st.dump_shard(i) == m.read_blob(os.path.join("ps", f"replica_{r}_shard_{i}.emb"))
    assert ctx.last_resume_info["ps_entries_restored"] == sum(st.size() for st in stores) > 0
    assert json.loads(m.read_blob("loader.json")) == {"consumed_batches": 4, "staleness_outstanding": 0}
    ctx.train_step(_batches(5)[4])


if __name__ == "__main__":
    shutil.rmtree(FIXTURE, ignore_errors=True)
    write_jax_manifest(str(FIXTURE))
    print(f"wrote {FIXTURE}", file=sys.stderr)
