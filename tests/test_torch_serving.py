"""The whole serving slice: ``persia_tpu``'s ``InferCtx.predict`` vs the
port's ``InferenceEngine.predict_from_bytes`` on the same wire bytes, the
flagship's shape (DLRM bottom (32, 16), top (64, 32); four single-id slots
plus one raw slot; two parameter-server replicas)."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import persia_tpu.config as jcfg
import persia_tpu.data as jdata
from persia_tpu.ctx import InferCtx as JaxInferCtx
from persia_tpu.embedding.optim import Adagrad as JaxAdagrad
from persia_tpu.embedding.store import EmbeddingStore as JaxStore
from persia_tpu.embedding.worker import EmbeddingWorker as JaxWorker
from persia_tpu.models import DLRM as JaxDLRM
from persia_tpu.parallel.train_step import TrainState
import persia_tpu_torch.config as tcfg
from persia_tpu_torch.ctx import InferCtx
from persia_tpu_torch.embedding.optim import Adagrad
from persia_tpu_torch.embedding.store import EmbeddingStore
from persia_tpu_torch.embedding.worker import EmbeddingWorker
from persia_tpu_torch.models import DLRM
from persia_tpu_torch.serving.engine import InferenceEngine
from persia_tpu_torch.weights import seeded_flax_params_like, state_dict_from_flax

DIM, N_CAT, BOTTOM, TOP = 16, 4, (32, 16), (64, 32)


def _cfg(cfg):
    slots = {f"cat_{i}": cfg.SlotConfig(dim=DIM) for i in range(N_CAT)}
    slots["hist"] = cfg.SlotConfig(dim=DIM, embedding_summation=False, sample_fixed_size=8)
    return cfg.EmbeddingConfig(slots_config=slots, feature_index_prefix_bit=8)


def _batch(seed, b=16):
    rng = np.random.default_rng(seed)
    feats = [
        jdata.IDTypeFeature(f"cat_{i}", [rng.integers(0, 100, 1, dtype=np.uint64) for _ in range(b)])
        for i in range(N_CAT)
    ]
    feats.append(
        jdata.IDTypeFeature(
            "hist", [rng.integers(0, 64, rng.integers(0, 8), dtype=np.uint64) for _ in range(b)]
        )
    )
    return jdata.PersiaBatch(
        feats,
        non_id_type_features=[jdata.NonIDTypeFeature(rng.normal(size=(b, 13)).astype(np.float32))],
        requires_grad=False,
    )


def _stores(cls, opt):
    return [cls(capacity=1 << 16, num_internal_shards=4, optimizer=opt, seed=3) for _ in range(2)]


def _pair(device_pooling, compute_dtype):
    """(reference InferCtx, port InferenceEngine) on the same weights, with
    each store warmed by the same admitting lookup."""
    model = DLRM(13, N_CAT + 1, DIM, BOTTOM, TOP, compute_dtype=compute_dtype, device="cpu")
    params = seeded_flax_params_like(model, 11)
    model.load_state_dict(state_dict_from_flax(model, params))
    warm = _batch(100, b=64)

    jw = JaxWorker(_cfg(jcfg), _stores(JaxStore, JaxAdagrad(lr=0.1).config), device_pooling=device_pooling)
    jw.forward_directly(warm, train=True)
    jmodel = JaxDLRM(embedding_dim=DIM, bottom_mlp=BOTTOM, top_mlp=TOP,
                     compute_dtype=jnp.float32 if compute_dtype == torch.float32 else jnp.bfloat16)
    state = TrainState(params=params, batch_stats={}, opt_state=(), step=jnp.zeros((), jnp.int32))
    jctx = JaxInferCtx(jmodel, state, jw, _cfg(jcfg))

    tw = EmbeddingWorker(_cfg(tcfg), _stores(EmbeddingStore, Adagrad(lr=0.1).config),
                         device_pooling=device_pooling)
    tw.forward_directly(jdata.PersiaBatch.from_bytes(warm.to_bytes()), train=True)
    engine = InferenceEngine(InferCtx(model, tw, _cfg(tcfg), device="cpu"), device="cpu")
    return jctx, engine


@pytest.mark.parametrize("device_pooling", [False, True])
def test_predictions_match_reference_f32(device_pooling):
    """f32 compute on both sides holds the whole path (lookup, staging,
    pooling, model): probabilities agree to 1e-5."""
    jctx, engine = _pair(device_pooling, torch.float32)
    for seed in (1, 2):
        batch = _batch(seed)  # part hits of the warm batch, part zeros-on-miss
        ref = np.asarray(jctx.predict(batch))
        out = engine.predict_from_bytes(batch.to_bytes())
        assert out.shape == (16, 1) and out.dtype == np.float32 and np.isfinite(out).all()
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    assert engine.forwards == 2


@pytest.mark.parametrize("device_pooling", [False, True])
def test_predictions_match_reference_bf16(device_pooling):
    """bf16 compute, the serving default: the two frameworks round to bf16
    at different points; probabilities (sigmoid slope <= 1/4) agree to
    2e-2."""
    jctx, engine = _pair(device_pooling, torch.bfloat16)
    batch = _batch(3)
    ref = np.asarray(jctx.predict(batch))
    out = engine.predict_from_bytes(batch.to_bytes())
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-2)


def test_engine_swap_and_version():
    _, engine = _pair(True, torch.float32)
    ctx = engine.ctx
    assert engine.version == "v0"
    assert engine.swap(ctx, "v1") == "v0"
    assert engine.version == "v1" and engine.ctx is ctx


def test_engine_rejects_ctx_on_another_device():
    _, engine = _pair(True, torch.float32)
    elsewhere = SimpleNamespace(device=torch.device("meta"))
    with pytest.raises(ValueError):
        engine.swap(elsewhere, "v1")
    assert engine.version == "v0"
