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


# ------------------------------------- the example's fused tier (--tier fused)

import functools  # noqa: E402
import importlib.util  # noqa: E402
import pathlib  # noqa: E402

from persia_tpu.parallel.fused_ctx import batch_to_fused as jbatch_to_fused  # noqa: E402
from persia_tpu.testing import AvazuSynthetic as JaxAvazuSynthetic  # noqa: E402
from persia_tpu_torch import models as tmodels  # noqa: E402
from persia_tpu_torch.testing import avazu as ta  # noqa: E402
from persia_tpu_torch.testing.criteo_dlrm import predict as tpredict  # noqa: E402
from persia_tpu_torch.testing.criteo_dlrm import train as ttrain  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
CAP, FB, FSTEPS = 512, 32, 3


def _load_example():
    spec = importlib.util.spec_from_file_location("examples_avazu_train", ROOT / "examples/avazu/train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


AX = _load_example()


@pytest.fixture(params=["float32", "bfloat16"])
def fused_compute(request, monkeypatch):
    """Both packages' model compute dtype: float32 patched in on both
    sides, or the models' default bfloat16."""
    if request.param == "float32":
        for name, jcls in (("DeepFM", JaxDeepFM), ("DCNv2", JaxDCNv2)):
            monkeypatch.setattr(AX, name, functools.partial(jcls, compute_dtype=jnp.float32))
            monkeypatch.setattr(tmodels, name, functools.partial(getattr(tmodels, name), compute_dtype=torch.float32))
    return request.param


@pytest.mark.parametrize("name", ["deepfm", "dcnv2"])
def test_fused_tier_matches_the_example(tmp_path, name, fused_compute):
    """``testing/avazu.py``'s fused tier against ``examples/avazu/train.py``'s
    ``build_ctx(tier="fused")`` with ``--fused-vocab-cap 512`` (ids fold by
    modulo): the same 21 capped specs, the reference's state carried
    through its checkpoint files, then 3 steps of B=32 (losses), every
    table and the held-out predictions. f32 compute: losses 1e-5
    relative, tables and predictions rtol 2e-4 / atol 2e-5 (Adam's
    normalised steps over 21 tables); bf16 compute: losses 2e-2,
    predictions 2e-2, tables 1e-2, the bounds of the hybrid test above."""
    ref_train = list(JaxAvazuSynthetic(num_samples=FSTEPS * FB, seed=42).batches(FB))
    ref_test = list(JaxAvazuSynthetic(num_samples=FB, seed=4242).batches(FB, requires_grad=False))
    train = list(AvazuSynthetic(num_samples=FSTEPS * FB, seed=42).batches(FB))
    test = list(AvazuSynthetic(num_samples=FB, seed=4242).batches(FB, requires_grad=False))
    assert [b.to_bytes() for b in train + test] == [b.to_bytes() for b in ref_train + ref_test]
    jctx = AX.build_ctx(name, num_fields=FIELDS, tier="fused", fused_vocab_cap=CAP)
    jctx._ensure_state(jbatch_to_fused(ref_train[0], jctx.specs, fold_ids=True))
    jctx.dump_checkpoint(str(tmp_path / "ref"))
    tctx = ta.build_ctx(name, num_fields=FIELDS, tier="fused", fused_vocab_cap=CAP, device="cpu")
    assert {k: s.vocab for k, s in tctx.specs.items()} == {k: s.vocab for k, s in jctx.specs.items()}
    assert max(s.vocab for s in tctx.specs.values()) == CAP and tctx.fold_ids
    tctx._ensure_state()
    tctx.load_checkpoint(str(tmp_path / "ref"))
    losses, _ = ttrain(tctx, "fused", train)
    ref_losses = [float(jctx.train_step(b)["loss"]) for b in ref_train]
    f32 = fused_compute == "float32"
    np.testing.assert_allclose(losses, ref_losses, **(dict(rtol=1e-5) if f32 else dict(rtol=0, atol=2e-2)))
    close = dict(rtol=2e-4, atol=2e-5) if f32 else dict(rtol=0, atol=1e-2)
    for tname, table in tctx.state.tables.items():
        np.testing.assert_allclose(table.numpy(), np.asarray(jctx.state.tables[tname]), err_msg=tname, **close)
    ref_preds = np.concatenate([np.asarray(jctx.eval_batch(b)).reshape(-1, 1) for b in ref_test])
    np.testing.assert_allclose(tpredict(tctx, test)[0], ref_preds, **(close if f32 else dict(rtol=0, atol=2e-2)))


def test_fused_specs_at_full_width():
    """No cap: the 21 tables at ``AVAZU_VOCABS``' sizes, 9,449,205 rows."""
    specs = ta.fused_specs(FIELDS)
    assert [specs[f"field_{i}"].vocab for i in range(FIELDS)] == list(AVAZU_VOCABS)
    assert sum(s.vocab for s in specs.values()) == 9_449_205 and {s.dim for s in specs.values()} == {16}


@pytest.mark.parametrize("name", ["deepfm", "dcnv2"])
def test_example_cli_fused_tier(capsys, name):
    """The CLI of ``testing/avazu.py`` with the reference test's flags
    (``tests/test_examples.py``'s ``test_avazu_fused_tier``) prints the
    example's line."""
    rc = ta.main(["--model", name, "--tier", "fused", "--batch-size", "32", "--steps", "3", "--eval-steps", "1",
                  "--fused-vocab-cap", "512", "--device", "cpu"])
    assert rc == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"avazu-{name} steps=3 loss=") and " test_auc=" in line and line.endswith(" samples/sec")


def test_example_cli_hybrid_tier(capsys):
    assert ta.main(["--tier", "hybrid", "--deterministic", "--batch-size", "32", "--steps", "2",
                    "--eval-steps", "1", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("avazu-deepfm steps=2 loss=")
