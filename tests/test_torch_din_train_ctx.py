"""DIN on Taobao-shaped data through the port's hybrid tier, against
``persia_tpu``'s: the configuration of ``examples/taobao_din/train.py``'s
``build_ctx`` cut to test size (dim 8, attention (16,), top (32,),
``max_hist=8``, an item vocabulary of 5,000, B=64): the pooled ``item`` and
``cate`` slots beside the raw ``hist_item`` and ``hist_cate`` slots, the
``items`` and ``cates`` feature groups (a candidate and its history share a
table), two numpy-store replicas, sparse Adagrad(0.05), dense Adam(1e-3).

Both sides train the same 5 ``TaobaoSynthetic`` batches from the same
weights: per-step loss and predictions, the final dense parameters and
every PS entry. Every test runs with both packages' workers on their numpy
routines and with both on their native cores. Tolerances: f32 compute,
1e-5 relative (sums in other orders); bf16 compute (the model's default),
losses and predictions within 2e-2, PS entries within 1e-2 and dense
parameters within 1e-2, as the DLRM train-ctx test holds bf16 compute
(measured on the numpy cores: losses 2.3e-5, predictions 2.0e-4, dense
parameters 2.8e-3, entries 8.3e-6).
Also the reproducible staleness-1 ``DataLoader`` against ``train_step``
(1e-5), and ``InferCtx(DIN).predict_from_bytes`` against the reference's
``InferCtx`` (2e-2)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import persia_tpu.config as jcfg
from persia_tpu.ctx import InferCtx as JaxInferCtx
from persia_tpu.ctx import TrainCtx as JaxTrainCtx
from persia_tpu.embedding import native_worker
from persia_tpu.embedding import optim as joptim
from persia_tpu.embedding.store import EmbeddingStore as JaxStore
from persia_tpu.embedding.worker import EmbeddingWorker as JaxWorker
from persia_tpu.models import DIN as JaxDIN
from persia_tpu.parallel.train_step import TrainState as JaxTrainState
from persia_tpu.testing import TaobaoSynthetic as JaxTaobao
import persia_tpu_torch.config as tcfg
from persia_tpu_torch.ctx import InferCtx, TrainCtx
from persia_tpu_torch.data import PersiaBatch
from persia_tpu_torch.data_loader import DataLoader
from persia_tpu_torch.embedding import native_worker as tnative_worker
from persia_tpu_torch.embedding import optim as toptim
from persia_tpu_torch.embedding.store import EmbeddingStore
from persia_tpu_torch.embedding.worker import EmbeddingWorker
from persia_tpu_torch.models import DIN
from persia_tpu_torch.serving.engine import InferenceEngine
from persia_tpu_torch.testing import TaobaoSynthetic
from persia_tpu_torch.weights import seeded_flax_params_like, state_dict_from_flax

DIM, HIST, B, STEPS, ITEMS = 8, 8, 64, 5, 5_000
ATT, TOP = (16,), (32,)
TIGHT = dict(rtol=1e-5, atol=1e-6)


def _cfg(cfg):
    return cfg.EmbeddingConfig(
        slots_config={
            "item": cfg.SlotConfig(dim=DIM),
            "cate": cfg.SlotConfig(dim=DIM),
            "hist_item": cfg.SlotConfig(dim=DIM, embedding_summation=False, sample_fixed_size=HIST),
            "hist_cate": cfg.SlotConfig(dim=DIM, embedding_summation=False, sample_fixed_size=HIST),
        },
        feature_index_prefix_bit=8,
        feature_groups={"items": ["item", "hist_item"], "cates": ["cate", "hist_cate"]},
    )


def _batches(n=STEPS, seed=42, requires_grad=True):
    data = JaxTaobao(num_samples=n * B, item_vocab=ITEMS, max_hist=HIST, seed=seed)
    return list(data.batches(B, requires_grad=requires_grad))


@pytest.fixture(autouse=True, params=["numpy", "native"])
def worker_core(request, monkeypatch):
    """Both workers on their numpy routines, or both on their native cores."""
    if request.param == "numpy":
        monkeypatch.setattr(native_worker, "_load_lib", lambda: None)
        monkeypatch.setattr(tnative_worker, "_load_lib", lambda: None)
    else:
        assert native_worker.available() and tnative_worker.available()
    return request.param


def _stores(cls, opt):
    return [cls(capacity=1 << 16, num_internal_shards=4, optimizer=opt, seed=13 + r) for r in range(2)]


def _port_ctx(compute=torch.bfloat16):
    model = DIN(1, 2, 2, DIM, ATT, TOP, compute_dtype=compute, device="cpu")
    model.load_state_dict(state_dict_from_flax(model, seeded_flax_params_like(model, 11)))
    worker = EmbeddingWorker(_cfg(tcfg), _stores(EmbeddingStore, toptim.Adagrad(lr=0.05).config))
    return TrainCtx(model, torch.optim.Adam(model.parameters(), lr=1e-3), toptim.Adagrad(lr=0.05), worker,
                    _cfg(tcfg), device="cpu").__enter__()


def _pair(compute=torch.bfloat16):
    tctx = _port_ctx(compute)
    jworker = JaxWorker(_cfg(jcfg), _stores(JaxStore, joptim.Adagrad(lr=0.05).config))
    jmodel = JaxDIN(embedding_dim=DIM, attention_hidden=ATT, top_mlp=TOP,
                    compute_dtype=jnp.float32 if compute == torch.float32 else jnp.bfloat16)
    jctx = JaxTrainCtx(jmodel, optax.adam(1e-3), joptim.Adagrad(lr=0.05), jworker, _cfg(jcfg)).__enter__()
    jparams = jax.tree.map(jnp.asarray, seeded_flax_params_like(tctx.model, 11))
    jctx.state = JaxTrainState(params=jparams, batch_stats={}, opt_state=optax.adam(1e-3).init(jparams),
                               step=jnp.zeros((), jnp.int32))
    return jctx, tctx


@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_train_ctx_matches_reference(compute):
    jctx, tctx = _pair(compute)
    tol = TIGHT if compute == torch.float32 else dict(rtol=0, atol=2e-2)
    batches = _batches()
    # the candidate item is in its own history in some samples: the worker
    # sums both gradients onto the item's one row (the "items" group)
    hist = batches[0].id_type_features[2].data
    cand = batches[0].id_type_features[0].data
    assert sum(int(c[0] in h) for c, h in zip(cand, hist)) > 5
    for batch in batches:
        a = jctx.train_step(batch)
        b = tctx.train_step(PersiaBatch.from_bytes(batch.to_bytes()))
        np.testing.assert_allclose(b["loss"], a["loss"], **tol)
        np.testing.assert_allclose(b["preds"], a["preds"], **tol)
        assert b["preds"].shape == (B, 1)
    assert jctx.worker.staleness == tctx.worker.staleness == 0

    dense_tol = TIGHT if compute == torch.float32 else dict(rtol=0, atol=1e-2)
    entry_tol = TIGHT if compute == torch.float32 else dict(rtol=0, atol=1e-2)
    ref = state_dict_from_flax(tctx.model, jax.tree.map(np.asarray, jctx.state.params))
    for k, v in tctx.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), err_msg=k, **dense_tol)
    jrouter, trouter = jctx.worker.lookup_router, tctx.worker.lookup_router
    n = 0
    for jr, tr in zip(jrouter.replicas, trouter.replicas):
        assert jr.size() == tr.size() > 0
        for shard in jr._shards:
            for sign, (_, vec) in shard.entries.items():
                np.testing.assert_allclose(tr.get_embedding_entry(sign), vec, **entry_tol)
                n += 1
    assert n == sum(r.size() for r in trouter.replicas)


def test_reproducible_loader_matches_train_step():
    """The staleness-1 reproducible ``DataLoader`` + ``train_step_prepared``
    against ``train_step`` on the same batches, from the same weights and
    stores: losses and every PS entry to 1e-5."""
    batches = [PersiaBatch.from_bytes(b.to_bytes()) for b in _batches()]
    sync, piped = _port_ctx(), _port_ctx()
    want = [sync.train_step(b)["loss"] for b in batches]
    loader = DataLoader(iter(batches), piped, num_workers=2, staleness=1, reproducible=True)
    got = [piped.train_step_prepared(tb, loader)["loss"] for tb in loader]
    loader.flush()
    loader.shutdown()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for a, b in zip(sync.worker.lookup_router.replicas, piped.worker.lookup_router.replicas):
        assert a.size() == b.size() > 0
        for shard in a._shards:
            for sign, (_, vec) in shard.entries.items():
                np.testing.assert_allclose(b.get_embedding_entry(sign), vec, rtol=1e-5, atol=1e-5)


def test_infer_ctx_matches_reference():
    """After 3 training steps on both sides, the port's ``InferCtx`` behind
    ``InferenceEngine`` and the reference's ``InferCtx`` predict the same
    held-out batch (some ids never trained: zeros on a miss) to 2e-2."""
    jctx, tctx = _pair()
    for batch in _batches(3):
        jctx.train_step(batch)
        tctx.train_step(PersiaBatch.from_bytes(batch.to_bytes()))
    held_out = _batches(1, seed=4242, requires_grad=False)[0]
    jinfer = JaxInferCtx(jctx.model, jctx.state, jctx.worker, _cfg(jcfg))
    engine = InferenceEngine(InferCtx(tctx.model, tctx.worker, _cfg(tcfg), device="cpu"), device="cpu")
    ref = np.asarray(jinfer.predict_from_bytes(held_out.to_bytes()))
    out = engine.predict_from_bytes(held_out.to_bytes())
    assert out.shape == (B, 1) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-2)


def test_port_generator_feeds_the_same_batches():
    """The port's own ``TaobaoSynthetic`` gives these batches byte for byte
    (so the chip run can train on it without the reference)."""
    ours = TaobaoSynthetic(num_samples=2 * B, item_vocab=ITEMS, max_hist=HIST, seed=42).batches(B)
    for a, b in zip(ours, _batches(2)):
        assert a.to_bytes() == b.to_bytes()
