"""DeepFM and DCN-v2 on Avazu-shaped data through the port's hybrid tier,
against ``persia_tpu``'s: ``examples/avazu/train.py``'s configuration cut to
test size (the 21 fields of ``AVAZU_VOCABS`` at dim 8, deep MLP (32, 16),
DCN-v2 with 3 full-rank cross layers, B=64, two numpy-store replicas,
sparse Adagrad(0.05), dense Adam(1e-3)), with host pooling and with device
pooling. One ``TrainCtx.train_step`` on each side from the same weights:
loss and predictions, the dense parameters after Adam's step and every PS
entry. Tolerances: f32 compute 1e-5 relative; bf16 compute (the models'
default) losses and predictions within 2e-2, entries and dense parameters
within 1e-2, as the DLRM train-ctx test holds bf16 compute."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import persia_tpu.config as jcfg
from persia_tpu.ctx import TrainCtx as JaxTrainCtx
from persia_tpu.embedding import optim as joptim
from persia_tpu.embedding.store import EmbeddingStore as JaxStore
from persia_tpu.embedding.worker import EmbeddingWorker as JaxWorker
from persia_tpu.models import DCNv2 as JaxDCNv2
from persia_tpu.models import DeepFM as JaxDeepFM
from persia_tpu.parallel.train_step import TrainState as JaxTrainState
import persia_tpu_torch.config as tcfg
from persia_tpu_torch.ctx import TrainCtx
from persia_tpu_torch.data import PersiaBatch
from persia_tpu_torch.embedding import optim as toptim
from persia_tpu_torch.embedding.store import EmbeddingStore
from persia_tpu_torch.embedding.worker import EmbeddingWorker
from persia_tpu_torch.models import DCNv2, DeepFM
from persia_tpu_torch.testing import AVAZU_VOCABS, AvazuSynthetic
from persia_tpu_torch.weights import seeded_flax_params_like, state_dict_from_flax

DIM, B, DEEP = 8, 64, (32, 16)
FIELDS = len(AVAZU_VOCABS)


def _cfg(cfg):
    return cfg.EmbeddingConfig(
        slots_config={f"field_{i}": cfg.SlotConfig(dim=DIM) for i in range(FIELDS)},
        feature_index_prefix_bit=8,
    )


def _stores(cls, opt):
    return [cls(capacity=1 << 16, num_internal_shards=4, optimizer=opt, seed=11 + r) for r in range(2)]


def _pair(name, compute, device_pooling):
    jdt = jnp.float32 if compute == torch.float32 else jnp.bfloat16
    if name == "deepfm":
        model = DeepFM(2, FIELDS, DIM, DEEP, compute_dtype=compute, device="cpu")
        jmodel = JaxDeepFM(embedding_dim=DIM, deep_mlp=DEEP, compute_dtype=jdt)
    else:
        model = DCNv2(2, FIELDS, DIM, 3, None, DEEP, compute_dtype=compute, device="cpu")
        jmodel = JaxDCNv2(embedding_dim=DIM, num_cross_layers=3, deep_mlp=DEEP, compute_dtype=jdt)
    params = seeded_flax_params_like(model, 5)
    model.load_state_dict(state_dict_from_flax(model, params))
    tworker = EmbeddingWorker(_cfg(tcfg), _stores(EmbeddingStore, toptim.Adagrad(lr=0.05).config),
                              device_pooling=device_pooling)
    tctx = TrainCtx(model, torch.optim.Adam(model.parameters(), lr=1e-3), toptim.Adagrad(lr=0.05), tworker,
                    _cfg(tcfg), device="cpu").__enter__()
    jworker = JaxWorker(_cfg(jcfg), _stores(JaxStore, joptim.Adagrad(lr=0.05).config),
                        device_pooling=device_pooling)
    jctx = JaxTrainCtx(jmodel, optax.adam(1e-3), joptim.Adagrad(lr=0.05), jworker, _cfg(jcfg)).__enter__()
    jparams = jax.tree.map(jnp.asarray, params)
    jctx.state = JaxTrainState(params=jparams, batch_stats={}, opt_state=optax.adam(1e-3).init(jparams),
                               step=jnp.zeros((), jnp.int32))
    return jctx, tctx


@pytest.mark.parametrize("device_pooling", [False, True], ids=["host_pool", "device_pool"])
@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["deepfm", "dcnv2"])
def test_one_train_step_matches_reference(name, compute, device_pooling):
    jctx, tctx = _pair(name, compute, device_pooling)
    batch = next(AvazuSynthetic(num_samples=B, seed=42).batches(B))
    tight = compute == torch.float32
    a = jctx.train_step(PersiaBatch.from_bytes(batch.to_bytes()))
    b = tctx.train_step(batch)
    tol = dict(rtol=1e-5, atol=1e-6) if tight else dict(rtol=0, atol=2e-2)
    np.testing.assert_allclose(b["loss"], a["loss"], **tol)
    np.testing.assert_allclose(b["preds"], a["preds"], **tol)
    assert b["preds"].shape == (B, 1) and np.isfinite(b["preds"]).all()
    assert jctx.worker.staleness == tctx.worker.staleness == 0

    tol = dict(rtol=1e-5, atol=1e-6) if tight else dict(rtol=0, atol=1e-2)
    ref = state_dict_from_flax(tctx.model, jax.tree.map(np.asarray, jctx.state.params))
    for k, v in tctx.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), err_msg=k, **tol)
    n = 0
    for jr, tr in zip(jctx.worker.lookup_router.replicas, tctx.worker.lookup_router.replicas):
        assert jr.size() == tr.size() > 0
        for shard in jr._shards:
            for sign, (_, vec) in shard.entries.items():
                np.testing.assert_allclose(tr.get_embedding_entry(sign), vec, **tol)
                n += 1
    assert n == sum(r.size() for r in tctx.worker.lookup_router.replicas)
