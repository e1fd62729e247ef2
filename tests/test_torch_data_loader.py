"""The port's pipelined path: ``DataLoader`` + ``TrainCtx.train_step_prepared``.

Parity: in ``reproducible=True, staleness=1`` mode the port is held to
``persia_tpu``'s ``DataLoader`` + ``train_step_prepared`` over 5 steps, both
on their native worker and store cores (the flagship's shape: DLRM bottom
(32, 16), top (64, 32), four single-id slots and one raw slot, two
replicas, sparse Adagrad(0.1), dense Adam(1e-3)); with an f32 wire the
tolerances of ``test_torch_train_ctx.py`` (1e-5 relative).

Behaviour, on the port alone (CPU): the staleness bound holds, a worker's
error reaches the consumer, an eval stream returns its permits through
``mark_consumed``, a failed step releases its batch, staleness and permits
are whole again after ``flush``, deferred metrics, and reproducible runs
identical across worker counts."""

import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import persia_tpu.config as jcfg
import persia_tpu.data as jdata
from persia_tpu.ctx import TrainCtx as JaxTrainCtx
from persia_tpu.data_loader import DataLoader as JaxDataLoader
from persia_tpu.embedding import native_store as jns
from persia_tpu.embedding import native_worker as jnw
from persia_tpu.embedding import optim as joptim
from persia_tpu.embedding.worker import EmbeddingWorker as JaxWorker
from persia_tpu.embedding.worker import preprocess_batch as jpreprocess
from persia_tpu.models import DLRM as JaxDLRM
from persia_tpu.parallel.train_step import TrainState as JaxTrainState
import persia_tpu_torch.config as tcfg
import persia_tpu_torch.data as tdata
from persia_tpu_torch.ctx import TrainCtx
from persia_tpu_torch.data_loader import DataLoader
from persia_tpu_torch.embedding import native_store as tns
from persia_tpu_torch.embedding import native_worker as tnw
from persia_tpu_torch.embedding import optim as toptim
from persia_tpu_torch.embedding.worker import EmbeddingWorker
from persia_tpu_torch.embedding.worker import preprocess_batch as tpreprocess
from persia_tpu_torch.models import DLRM
from persia_tpu_torch.weights import seeded_flax_params_like, state_dict_from_flax

DIM, BOTTOM, TOP, STEPS = 16, (32, 16), (64, 32), 5
TIGHT = dict(rtol=1e-5, atol=1e-6)


def _cfg(cfg):
    slots = {f"cat_{i}": cfg.SlotConfig(dim=DIM) for i in range(4)}
    slots["hist"] = cfg.SlotConfig(dim=DIM, embedding_summation=False, sample_fixed_size=8)
    return cfg.EmbeddingConfig(slots_config=slots, feature_index_prefix_bit=8)


def _batch(data, seed, b=16, requires_grad=True):
    """The flagship's batch in ``data``'s classes (either package's)."""
    rng = np.random.default_rng(seed)
    feats = [
        data.IDTypeFeature(f"cat_{i}", [rng.integers(0, 100, 1, dtype=np.uint64) for _ in range(b)])
        for i in range(4)
    ]
    feats.append(data.IDTypeFeature(
        "hist", [rng.integers(0, 64, rng.integers(0, 8), dtype=np.uint64) for _ in range(b)]))
    return data.PersiaBatch(
        feats,
        non_id_type_features=[data.NonIDTypeFeature(rng.normal(size=(b, 13)).astype(np.float32))],
        labels=[data.Label(rng.integers(0, 2, (b, 1)).astype(np.float32))],
        requires_grad=requires_grad,
    )


def _port_ctx(store="native", wire_dtype=None, **extra):
    model = DLRM(13, 5, DIM, BOTTOM, TOP, compute_dtype=torch.float32, device="cpu")
    model.load_state_dict(state_dict_from_flax(model, seeded_flax_params_like(model, 11)))
    stores = [tns.create_store(store, capacity=1 << 16, num_internal_shards=4, seed=3) for _ in range(2)]
    worker = EmbeddingWorker(_cfg(tcfg), stores, device_pooling=True)
    return TrainCtx(model, torch.optim.Adam(model.parameters(), lr=1e-3), toptim.Adagrad(lr=0.1),
                    worker, _cfg(tcfg), device="cpu", wire_dtype=wire_dtype, **extra).__enter__()


def _jax_ctx():
    model = DLRM(13, 5, DIM, BOTTOM, TOP, device="cpu")
    params = jax.tree.map(jnp.asarray, seeded_flax_params_like(model, 11))
    stores = [jns.NativeEmbeddingStore(capacity=1 << 16, num_internal_shards=4, seed=3) for _ in range(2)]
    worker = JaxWorker(_cfg(jcfg), stores, device_pooling=True)
    jctx = JaxTrainCtx(JaxDLRM(embedding_dim=DIM, bottom_mlp=BOTTOM, top_mlp=TOP,
                               compute_dtype=jnp.float32), optax.adam(1e-3),
                       joptim.Adagrad(lr=0.1), worker, _cfg(jcfg)).__enter__()
    jctx.state = JaxTrainState(params=params, batch_stats={}, opt_state=optax.adam(1e-3).init(params),
                               step=jnp.zeros((), jnp.int32), loss_scale=None)
    return jctx


def _run_loader(ctx, loader_cls, batches, **kw):
    loader = loader_cls(iter(batches), ctx, **kw)
    out = [(tb.batch_id, ctx.train_step_prepared(tb, loader)) for tb in loader]
    loader.flush()
    loader.shutdown()
    return out, loader


def test_reproducible_loader_matches_reference():
    """5 steps through both packages' loaders (reproducible, staleness 1,
    two lookup workers), both on their native cores: per-step loss and
    predictions, the dense parameters and every PS entry the steps wrote,
    Adam's batch advances, store sizes and staleness."""
    assert jnw.available() and tnw.available() and jns.native_available() and tns.native_available()
    jbatches = [_batch(jdata, s) for s in range(STEPS)]
    tbatches = [tdata.PersiaBatch.from_bytes(b.to_bytes()) for b in jbatches]
    jctx, tctx = _jax_ctx(), _port_ctx()
    assert tns.store_backend_name(tctx.worker.lookup_router.replicas[0]) == "native"
    kw = dict(num_workers=2, staleness=1, reproducible=True)
    want, _ = _run_loader(jctx, JaxDataLoader, jbatches, **kw)
    got, loader = _run_loader(tctx, DataLoader, tbatches, **kw)
    assert [i for i, _ in got] == [i for i, _ in want] == list(range(STEPS))
    for (_, a), (_, b) in zip(want, got):
        np.testing.assert_allclose(b["loss"], a["loss"], **TIGHT)
        np.testing.assert_allclose(b["preds"], a["preds"], **TIGHT)
    ref = state_dict_from_flax(tctx.model, jax.tree.map(np.asarray, jctx.state.params))
    for k, v in tctx.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), err_msg=k, **TIGHT)
    jrouter, trouter = jctx.worker.lookup_router, tctx.worker.lookup_router
    assert trouter.batch_advances == jrouter.batch_advances == {g: STEPS for g in range(5)}
    keys = np.unique(np.concatenate([s.keys for b in jbatches for s in jpreprocess(b.id_type_features, _cfg(jcfg)).slots]))
    for jr, tr in zip(jrouter.replicas, trouter.replicas):
        assert jr.size() == tr.size() > 0
    found = 0
    for sign in keys.tolist():
        entries = [r.get_embedding_entry(sign) for r in jrouter.replicas + trouter.replicas]
        j = [e for e in entries[:2] if e is not None]
        t = [e for e in entries[2:] if e is not None]
        assert len(j) == len(t) == 1, sign
        np.testing.assert_allclose(t[0], j[0], **TIGHT)
        found += 1
    assert found == sum(r.size() for r in trouter.replicas)
    assert tctx.worker.staleness == jctx.worker.staleness == 0
    assert loader.staleness_state() == {"outstanding_gradient_batches": 0, "free_permits": 1, "staleness": 1}


@pytest.mark.parametrize("store", ["native", "numpy"])
def test_pipelined_training_drains(store):
    """Non-reproducible, 3 workers, staleness 4, bf16 wire: every loss
    finite, every gradient landed, the window whole again."""
    ctx = _port_ctx(store, wire_dtype="bfloat16")
    batches = [_batch(tdata, s) for s in range(8)]
    out, loader = _run_loader(ctx, DataLoader, batches, num_workers=3, staleness=4)
    assert sorted(i for i, _ in out) == list(range(8))
    assert all(np.isfinite(m["loss"]) for _, m in out)
    assert ctx.worker.staleness == 0 and not ctx.worker.post_forward_buffer
    assert loader.staleness_state() == {"outstanding_gradient_batches": 0, "free_permits": 4, "staleness": 4}
    assert ctx.worker.lookup_router.batch_advances == {g: 8 for g in range(5)}


def test_staleness_bound_enforced():
    """With staleness 2 and nobody training, at most 2 batches pass lookup;
    training them lets the pipeline go on."""
    ctx = _port_ctx()
    loader = DataLoader(iter([_batch(tdata, s) for s in range(6)]), ctx, num_workers=3,
                        staleness=2, timeout_s=10)
    it = iter(loader)
    a, b = next(it), next(it)
    time.sleep(0.3)  # the workers would stage more if the permits allowed
    assert ctx.worker.staleness == 2 and loader.staleness_state()["free_permits"] == 0
    for tb in (a, b):
        ctx.train_step_prepared(tb, loader)
    for tb in it:
        ctx.train_step_prepared(tb, loader)
    loader.shutdown()
    assert ctx.worker.staleness == 0 and loader.staleness_state()["free_permits"] == 2


def test_worker_error_propagates():
    class Boom:
        def __iter__(self):
            yield _batch(tdata, 0)
            raise RuntimeError("dataset exploded")

    ctx = _port_ctx()
    loader = DataLoader(Boom(), ctx, num_workers=2, staleness=4, timeout_s=10)
    with pytest.raises(RuntimeError, match="pipeline worker failed") as err:
        for tb in loader:
            ctx.train_step_prepared(tb, loader)
    loader.shutdown()
    assert str(err.value.__cause__) == "dataset exploded"


def test_eval_stream_mark_consumed():
    ctx = _port_ctx()
    ctx.train_step(_batch(tdata, 0))
    batches = [_batch(tdata, s, requires_grad=False) for s in range(1, 5)]
    loader = DataLoader(iter(batches), ctx, num_workers=2, staleness=2, timeout_s=10)
    n = 0
    for tb in loader:
        assert ctx._eval_step(tb.device_batch).shape == (16, 1)
        loader.mark_consumed(tb)
        n += 1
    loader.shutdown()
    assert n == 4 and ctx.worker.staleness == 0
    assert loader.staleness_state()["free_permits"] == 2


def test_failed_step_releases_its_batch():
    """A step that raises returns its permit and drops its batch
    (``mark_consumed``); the rest of the stream trains and drains."""
    ctx = _port_ctx()
    run_step = ctx.run_step
    calls = []

    def flaky(device_batch):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("device step failed")
        return run_step(device_batch)

    ctx.run_step = flaky
    loader = DataLoader(iter([_batch(tdata, s) for s in range(4)]), ctx, num_workers=2,
                        staleness=2, timeout_s=10)
    failures = 0
    for tb in loader:
        try:
            ctx.train_step_prepared(tb, loader)
        except RuntimeError:
            failures += 1
    loader.flush()
    loader.shutdown()
    assert failures == 1 and len(calls) == 4
    assert ctx.worker.staleness == 0 and not ctx.worker.post_forward_buffer
    assert loader.staleness_state() == {"outstanding_gradient_batches": 0, "free_permits": 2, "staleness": 2}


def test_apply_error_raises_on_flush():
    """An error in the gradient apply aborts that batch's gradient, returns
    its permit, and is raised to the consumer by the loader's flush."""
    ctx = _port_ctx()

    def broken(ref, slot_grads, scale_factor=1.0):
        raise RuntimeError("apply failed")

    ctx.worker.update_gradient_batched = broken
    loader = DataLoader(iter([_batch(tdata, 0)]), ctx, num_workers=1, staleness=1, timeout_s=10)
    with pytest.raises(RuntimeError, match="backward engine failed"):
        for tb in loader:
            ctx.train_step_prepared(tb, loader)
    loader.shutdown()
    assert ctx.worker.staleness == 0 and loader.staleness_state()["free_permits"] == 1


def test_reproducible_loader_matches_train_step_with_dynamic_loss_scale():
    """With the dynamic loss scale and a static grad_scale, the pipelined
    step reads the header every step and the worker divides the gradients
    by both, as ``train_step`` does: the same metrics and PS entries."""
    extra = dict(dynamic_loss_scale=True, grad_scale=2.0, loss_scale_growth_interval=2)
    batches = [_batch(tdata, s) for s in range(4)]
    sync = _port_ctx(**extra)
    want = [sync.train_step(b) for b in batches]
    pipe = _port_ctx(**extra)
    got, _ = _run_loader(pipe, DataLoader, batches, num_workers=2, staleness=1, reproducible=True)
    for a, (_, b) in zip(want, got):
        assert b["loss"] == a["loss"] and b["loss_scale"] == a["loss_scale"]
        assert b["grads_finite"] == a["grads_finite"]
        np.testing.assert_array_equal(b["preds"], a["preds"])
    assert pipe.state.loss_scale.scale == sync.state.loss_scale.scale
    for a, b in zip(sync.worker.lookup_router.replicas, pipe.worker.lookup_router.replicas):
        assert a.size() == b.size() > 0
    signs = np.unique(np.concatenate([s.keys for b in batches for s in
                                      tpreprocess(b.id_type_features, _cfg(tcfg))]))
    for sign in signs.tolist():
        for a, b in zip(sync.worker.lookup_router.replicas, pipe.worker.lookup_router.replicas):
            ea, eb = a.get_embedding_entry(sign), b.get_embedding_entry(sign)
            assert (ea is None) == (eb is None)
            if ea is not None:
                np.testing.assert_array_equal(ea, eb)


def test_deferred_metrics():
    """``fetch_metrics=False`` returns None; ``last_prepared_metrics`` gives
    the last step's loss and predictions, once."""
    ctx = _port_ctx()
    loader = DataLoader(iter([_batch(tdata, s) for s in range(3)]), ctx, num_workers=1,
                        staleness=1, reproducible=True)
    assert all(ctx.train_step_prepared(tb, loader, fetch_metrics=False) is None for tb in loader)
    m = ctx.last_prepared_metrics()
    assert np.isfinite(m["loss"]) and m["preds"].shape == (16, 1)
    assert ctx.last_prepared_metrics() is None
    loader.shutdown()


def test_reproducible_identical_across_worker_counts():
    def run(workers):
        ctx = _port_ctx()
        out, _ = _run_loader(ctx, DataLoader, [_batch(tdata, s) for s in range(6)],
                             num_workers=workers, staleness=1, reproducible=True)
        return [m["loss"] for _, m in out], [m["preds"] for _, m in out], ctx

    l1, p1, c1 = run(1)
    l4, p4, c4 = run(4)
    assert l1 == l4
    for a, b in zip(p1, p4):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(c1.model.state_dict().values(), c4.model.state_dict().values()):
        assert torch.equal(a, b)


def test_lookup_threads_overlap_in_the_native_cores():
    """Twelve threads (more than the cores) look up and update through one
    native store at once, the interpreter switching threads every 10 µs:
    each call releases the GIL and the shard locks keep every update. With
    SGD(lr=1) and no bound, each entry ends at its init minus one per
    update of its sign, whichever order the threads ran in."""
    store = tns.NativeEmbeddingStore(capacity=1 << 14, num_internal_shards=8, seed=1,
                                     optimizer=toptim.SGD(lr=1.0).config,
                                     hyperparams=tcfg.HyperParameters(weight_bound=0.0))
    rng = np.random.default_rng(0)
    work = [rng.integers(0, 500, 400, dtype=np.uint64) for _ in range(48)]
    signs, counts = np.unique(np.concatenate(work), return_counts=True)
    init = store.lookup(signs, 4, True)
    errors = []

    def run(i):
        try:
            for batch in work[i::12]:
                store.lookup(batch, 4, True)
                store.update_gradients(batch, np.ones((len(batch), 4), np.float32))
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    assert store.size() == len(signs) and store.grad_misses == 0
    for sign, row, n in zip(signs.tolist(), init, counts.tolist()):
        want = row.copy()
        for _ in range(n):
            want -= np.float32(1.0)
        np.testing.assert_array_equal(store.get_embedding_entry(sign), want)
