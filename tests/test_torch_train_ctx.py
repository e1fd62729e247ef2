"""The training slice: the port's ``TrainCtx.train_step`` against
``persia_tpu``'s on the flagship's shape (``__graft_entry__._flagship``:
DLRM bottom (32, 16), top (64, 32); four single-id slots and one raw slot;
two parameter-server replicas; sparse Adagrad(0.1), dense Adam(1e-3)).
Both sides train the same 5 batches from the same weights and compare the
per-step loss and predictions, the final dense parameters, and every PS
entry (embedding and optimizer state), store sizes and staleness.

Every test runs twice: with both packages' workers on their numpy
routines (dedup in sorted order), and with both on their native cores
(dedup in first-seen order, which also orders the stores' LRU).
Tolerances: f32 compute and an f32 wire, 1e-5 relative (sums in
other orders); a bf16 wire rounds the rows and gradients that cross it,
so entries to 1e-3 and dense parameters to 1e-4 (a gradient one bf16 ulp
apart moves an Adam step by up to its relative size); bf16 compute (with
the bench's bf16 wire), loss and predictions to 2e-2 as the serving tests
hold them, entries to 5e-3 (the embeddings' gradients come through the
bf16 interaction and MLPs, rounded at other points, and Adagrad's first
steps are about as large as the gradients, ~1e-2), dense parameters to
1e-2 (Adam's first steps are ±lr whatever the gradient's size, so a sign
flip of a near-zero gradient moves a parameter by 2·lr a step)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import persia_tpu.config as jcfg
import persia_tpu.data as jdata
from persia_tpu.ctx import TrainCtx as JaxTrainCtx
from persia_tpu.embedding import native_worker
from persia_tpu.embedding import optim as joptim
from persia_tpu.embedding.store import EmbeddingStore as JaxStore
from persia_tpu.embedding.worker import EmbeddingWorker as JaxWorker
from persia_tpu.models import DLRM as JaxDLRM
from persia_tpu.parallel.train_step import LossScaleState as JaxLossScale
from persia_tpu.parallel.train_step import TrainState as JaxTrainState
import persia_tpu_torch.config as tcfg
from persia_tpu_torch.ctx import TrainCtx
from persia_tpu_torch.embedding import native_worker as tnative_worker
from persia_tpu_torch.embedding import optim as toptim
from persia_tpu_torch.embedding.store import EmbeddingStore
from persia_tpu_torch.embedding.worker import EmbeddingWorker
from persia_tpu_torch.models import DLRM
from persia_tpu_torch.weights import adam_state_from_optax, seeded_flax_params_like, state_dict_from_flax

DIM, BOTTOM, TOP, STEPS = 16, (32, 16), (64, 32), 5


def _cfg(cfg):
    slots = {f"cat_{i}": cfg.SlotConfig(dim=DIM) for i in range(4)}
    slots["hist"] = cfg.SlotConfig(dim=DIM, embedding_summation=False, sample_fixed_size=8)
    return cfg.EmbeddingConfig(slots_config=slots, feature_index_prefix_bit=8)


def _batch(seed, b=16):
    """The flagship's batch (``__graft_entry__._make_batch``)."""
    rng = np.random.default_rng(seed)
    feats = [
        jdata.IDTypeFeature(f"cat_{i}", [rng.integers(0, 100, 1, dtype=np.uint64) for _ in range(b)])
        for i in range(4)
    ]
    feats.append(jdata.IDTypeFeature(
        "hist", [rng.integers(0, 64, rng.integers(0, 8), dtype=np.uint64) for _ in range(b)]))
    return jdata.PersiaBatch(
        feats,
        non_id_type_features=[jdata.NonIDTypeFeature(rng.normal(size=(b, 13)).astype(np.float32))],
        labels=[jdata.Label(rng.integers(0, 2, (b, 1)).astype(np.float32))],
        requires_grad=True,
    )


@pytest.fixture(autouse=True, params=["numpy", "native"])
def worker_core(request, monkeypatch):
    """Both workers on their numpy routines, or both on their native cores."""
    if request.param == "numpy":
        monkeypatch.setattr(native_worker, "_load_lib", lambda: None)
        monkeypatch.setattr(tnative_worker, "_load_lib", lambda: None)
    else:
        assert native_worker.available() and tnative_worker.available()
    return request.param


def _pair(device_pooling=True, wire_dtype=None, compute=torch.float32, sparse="adagrad",
          dynamic=False, grad_scale=1.0):
    """(reference ctx, port ctx) on the same weights, both entered."""
    sparse_opt = {"adagrad": lambda m: m.Adagrad(lr=0.1), "adam": lambda m: m.Adam(lr=0.01)}[sparse]
    model = DLRM(13, 5, DIM, BOTTOM, TOP, compute_dtype=compute, device="cpu")
    params = seeded_flax_params_like(model, 11)
    model.load_state_dict(state_dict_from_flax(model, params))
    kw = dict(capacity=1 << 16, num_internal_shards=4, seed=3)
    extra = dict(wire_dtype=wire_dtype, dynamic_loss_scale=dynamic, grad_scale=grad_scale,
                 loss_scale_growth_interval=2)

    jworker = JaxWorker(_cfg(jcfg), [JaxStore(optimizer=joptim.Adagrad(lr=0.1).config, **kw) for _ in range(2)],
                        device_pooling=device_pooling)
    jmodel = JaxDLRM(embedding_dim=DIM, bottom_mlp=BOTTOM, top_mlp=TOP,
                     compute_dtype=jnp.float32 if compute == torch.float32 else jnp.bfloat16)
    jctx = JaxTrainCtx(jmodel, optax.adam(1e-3), sparse_opt(joptim), jworker, _cfg(jcfg), **extra).__enter__()
    jparams = jax.tree.map(jnp.asarray, params)
    jctx.state = JaxTrainState(
        params=jparams, batch_stats={}, opt_state=optax.adam(1e-3).init(jparams),
        step=jnp.zeros((), jnp.int32),
        loss_scale=JaxLossScale(scale=jnp.asarray(2.0 ** 15, jnp.float32),
                                good_steps=jnp.zeros((), jnp.int32)) if dynamic else None,
    )

    tworker = EmbeddingWorker(_cfg(tcfg), [EmbeddingStore(optimizer=toptim.Adagrad(lr=0.1).config, **kw)
                                           for _ in range(2)], device_pooling=device_pooling)
    tctx = TrainCtx(model, torch.optim.Adam(model.parameters(), lr=1e-3), sparse_opt(toptim), tworker,
                    _cfg(tcfg), device="cpu", **extra).__enter__()
    return jctx, tctx


def _step_both(jctx, tctx, seed, tol):
    batch = _batch(seed)
    a = jctx.train_step(batch)
    b = tctx.train_step(jdata.PersiaBatch.from_bytes(batch.to_bytes()))
    np.testing.assert_allclose(b["loss"], a["loss"], **tol)
    np.testing.assert_allclose(b["preds"], a["preds"], **tol)
    assert b["preds"].shape == (16, 1)
    for k in ("loss_scale", "grads_finite"):
        assert b.get(k) == a.get(k)
    assert jctx.worker.staleness == tctx.worker.staleness == 0


def _compare_final(jctx, tctx, dense_tol, entry_tol):
    ref = state_dict_from_flax(tctx.model, jax.tree.map(np.asarray, jctx.state.params))
    for k, v in tctx.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), err_msg=k, **dense_tol)
    jrouter, trouter = jctx.worker.lookup_router, tctx.worker.lookup_router
    assert trouter.batch_advances == jrouter.batch_advances
    for jr, tr in zip(jrouter.replicas, trouter.replicas):
        assert jr.size() == tr.size() > 0
        for shard in jr._shards:
            for sign, (_, vec) in shard.entries.items():
                np.testing.assert_allclose(tr.get_embedding_entry(sign), vec, **entry_tol)


TIGHT = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("device_pooling", [False, True])
@pytest.mark.parametrize("wire_dtype", [None, "bfloat16"])
def test_train_ctx_matches_reference(device_pooling, wire_dtype):
    jctx, tctx = _pair(device_pooling, wire_dtype)
    for step in range(STEPS):
        _step_both(jctx, tctx, step, TIGHT)
    if wire_dtype is None:
        _compare_final(jctx, tctx, TIGHT, TIGHT)
    else:
        _compare_final(jctx, tctx, dict(rtol=0, atol=1e-4), dict(rtol=0, atol=1e-3))


def test_train_ctx_bf16_compute():
    jctx, tctx = _pair(device_pooling=True, wire_dtype="bfloat16", compute=torch.bfloat16)
    for step in range(STEPS):
        _step_both(jctx, tctx, step, dict(rtol=0, atol=2e-2))
    _compare_final(jctx, tctx, dict(rtol=0, atol=1e-2), dict(rtol=0, atol=5e-3))


def test_train_ctx_sparse_adam():
    """Sparse Adam: the per-group beta powers advance once a batch on every
    replica; entries are re-initialised to Adam's width at registration."""
    jctx, tctx = _pair(device_pooling=True, sparse="adam")
    for step in range(STEPS):
        _step_both(jctx, tctx, step, TIGHT)
    _compare_final(jctx, tctx, TIGHT, TIGHT)
    assert tctx.worker.lookup_router.batch_advances == {g: STEPS for g in range(5)}


def test_train_ctx_dynamic_loss_scale_with_grad_scale():
    """The worker divides the shipped gradients by the dynamic scale times
    the static grad_scale, on both sides."""
    jctx, tctx = _pair(device_pooling=True, dynamic=True, grad_scale=2.0)
    for step in range(STEPS):
        _step_both(jctx, tctx, step, TIGHT)
    _compare_final(jctx, tctx, TIGHT, TIGHT)
    assert tctx.state.loss_scale.scale == float(jctx.state.loss_scale.scale)


def test_train_ctx_resumes_from_a_jax_train_state():
    """After 2 steps on both sides, the port takes the reference's dense
    parameters and Adam moments (``adam_state_from_optax``); 3 more steps
    then match as tightly as a run from the start."""
    jctx, tctx = _pair(device_pooling=True)
    for step in range(2):
        _step_both(jctx, tctx, step, TIGHT)
    jstate = jax.tree.map(np.asarray, jctx.state)
    adam = jstate.opt_state[0]
    tctx.model.load_state_dict(state_dict_from_flax(tctx.model, jstate.params))
    opt = tctx.state.optimizer
    opt.state.update(adam_state_from_optax(tctx.model, adam.mu, adam.nu, adam.count))
    assert all(float(s["step"]) == 2 for s in opt.state.values())
    for step in range(2, STEPS):
        _step_both(jctx, tctx, step, TIGHT)
    _compare_final(jctx, tctx, TIGHT, TIGHT)


def test_failed_step_aborts_its_gradient():
    """A step that raises releases the batch's staleness slot."""
    _, tctx = _pair()

    def broken(*_):
        raise RuntimeError("device step failed")

    tctx.run_step = broken
    with pytest.raises(RuntimeError):
        tctx.train_step(jdata.PersiaBatch.from_bytes(_batch(0).to_bytes()))
    assert tctx.worker.staleness == 0 and not tctx.worker.post_forward_buffer


def test_eval_batch_matches_reference():
    jctx, tctx = _pair()
    _step_both(jctx, tctx, 0, TIGHT)
    batch = _batch(9)
    ref = np.asarray(jctx.eval_batch(batch))
    out = tctx.eval_batch(jdata.PersiaBatch.from_bytes(batch.to_bytes()))
    np.testing.assert_allclose(out, ref, **TIGHT)
