"""The port's Criteo DLRM example, 100T harness and quality gate
(``persia_tpu_torch/testing/{criteo_dlrm,synthetic_100t,quality}.py``) on
the CPU against the reference's (``examples/criteo_dlrm/train.py``,
``examples/synthetic_100t/train.py`` and ``bench.py``'s quality tiers,
JAX on the CPU), at cut sizes: B=256 (the harness 128), 4 training steps,
the fused tables capped at 1,000 rows (the quality gate's at 2,000), the
quality gate's cache at 2^14 rows over a store of 2^16.

Both sides start from the same dense weights (``seeded_flax_params_like``;
the fused tier's whole state through the reference's checkpoint files);
the stores start alike (seeded by sign). Every leg runs twice: with both
packages' DLRM computing in f32 and at the example's bf16 compute. In f32
losses, predictions and PS entries hold to ``TIGHT``
(``tests/test_torch_hbm_mixed.py``'s f32 bound); the fused tier's tables
and predictions and the bf16-wire cache tier's predictions to ``ADAM``
(Adam's m / sqrt(v) magnifies last-bit differences: read up to 1.02e-5 on
a table, 7.4e-6 on a prediction), the int8 tier's predictions to ``QUANT``
(read 2.8e-4). In bf16, XLA's and PyTorch's bf16 matmuls round apart:
``BF16`` from the readings here (losses up to 1.9e-4, predictions 5.5e-3,
entries and tables 2.2e-4), two to five times over. The quality gate's
AUCs also agree within the gate's own 0.02. Each leg that starts threads
(the loader, the cache stream) runs under ``run_with_watchdog``.
"""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import persia_tpu.embedding  # noqa: F401  (imports persia_tpu.ops in the order it needs)
import persia_tpu.testing as ref_data
from persia_tpu.data_loader import DataLoader as JaxLoader
from persia_tpu.embedding import hbm_cache as jhbm
from persia_tpu.embedding.optim import Adagrad as JAdagrad
from persia_tpu.embedding.store import EmbeddingStore as JaxStore
from persia_tpu.embedding.worker import EmbeddingWorker as JaxWorker
from persia_tpu.models import DLRM as JaxDLRM
from persia_tpu.parallel import fused_step as jfused
from persia_tpu.parallel.fused_ctx import batch_to_fused as jbatch_to_fused
from persia_tpu.parallel.train_step import TrainState as JaxTrainState
import persia_tpu.config as jcfg
import persia_tpu_torch.models as tmodels
from persia_tpu_torch.parallel.fused_step import build_fused_eval_step, fused_batch_to_device
from persia_tpu_torch.testing import criteo_dlrm as cd
from persia_tpu_torch.testing import quality as q
from persia_tpu_torch.testing import synthetic_100t as sh
from persia_tpu_torch.testing.watchdog import run_with_watchdog
from persia_tpu_torch.weights import (
    cached_dense_from_flax, fused_state_from_flax, seeded_flax_params_like, state_dict_from_flax,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
B, STEPS, EVAL, CAP = 256, 4, 2, 1000
TIGHT = dict(rtol=1e-5, atol=1e-6)
ADAM = dict(rtol=2e-4, atol=2e-5)
QUANT = dict(rtol=0, atol=1e-3)
BF16 = {"loss": dict(rtol=0, atol=1e-3), "pred": dict(rtol=0, atol=1e-2), "entry": dict(rtol=0, atol=1e-3)}


def _load(rel):
    spec = importlib.util.spec_from_file_location(rel.replace("/", "_")[:-3], ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


EX = _load("examples/criteo_dlrm/train.py")
HX = _load("examples/synthetic_100t/train.py")


@pytest.fixture(params=["float32", "bfloat16"])
def compute(request, monkeypatch):
    """Both packages' DLRM compute dtype: float32 patched in on both sides,
    or the default bfloat16."""
    if request.param == "float32":
        monkeypatch.setattr(EX, "DLRM", functools.partial(JaxDLRM, compute_dtype=jnp.float32))
        monkeypatch.setattr(HX, "DLRM", functools.partial(JaxDLRM, compute_dtype=jnp.float32))
        monkeypatch.setattr(tmodels, "DLRM", functools.partial(tmodels.DLRM, compute_dtype=torch.float32))
    return request.param


def _tol(compute, kind, f32=TIGHT):
    """The bound for ``kind`` ("loss", "pred" or "entry"): ``f32`` in f32
    compute, else ``BF16``'s."""
    return f32 if compute == "float32" else BF16[kind]


def _watch(fn, what):
    return run_with_watchdog(fn, timeout=60.0, what=what)


def _streams(scale, steps=STEPS, eval_steps=EVAL, batch=B):
    """(train, test) batches: the reference's, and the port's own (byte for
    byte the same, held here too)."""
    vocabs = cd.vocabs_of(scale)
    ref_train = list(ref_data.CriteoSynthetic(num_samples=steps * batch, vocab_sizes=vocabs, seed=42).batches(batch))
    ref_test = list(ref_data.CriteoSynthetic(num_samples=eval_steps * batch, vocab_sizes=vocabs,
                                             seed=4242).batches(batch, requires_grad=False))
    train, test = cd.datasets(scale, steps, eval_steps, batch)
    ours = list(train.batches(batch)), list(test.batches(batch, requires_grad=False))
    assert [b.to_bytes() for b in ours[0] + ours[1]] == [b.to_bytes() for b in ref_train + ref_test]
    return (ref_train, ref_test), ours


def _jparams(model):
    """Seeded flax params for the port's ``model``, loaded into it; the
    reference's copy."""
    params = seeded_flax_params_like(model, 11)
    model.load_state_dict(state_dict_from_flax(model, params))
    return params, jax.tree.map(jnp.asarray, params)


def _entries(stores):
    return {int(s): np.array(v) for st in stores for sh_ in st._shards for s, (_, v) in sh_.entries.items()}


def _same_entries(port_stores, ref_stores, tol):
    a, b = _entries(port_stores), _entries(ref_stores)
    assert a.keys() == b.keys() and len(a) > 0
    for k in a:
        np.testing.assert_allclose(a[k], b[k], err_msg=str(k), **tol)


def _ref_preds(ctx, batches):
    return np.concatenate([np.asarray(ctx.eval_batch(b)).reshape(-1, 1) for b in batches])


# ------------------------------------------------------ the Criteo example


def test_hybrid_matches_the_example(compute):
    """Reproducible loader (1 thread, staleness 1): losses, every PS entry
    and the held-out predictions."""
    (rtrain, rtest), (train, test) = _streams("kaggle")
    vocabs = cd.vocabs_of("kaggle")
    tctx = cd.build_ctx(vocabs, device="cpu")
    _, jparams = _jparams(tctx.model)
    jctx = EX.build_ctx(vocabs)
    jctx.state = JaxTrainState(params=jparams, batch_stats={}, opt_state=optax.adam(1e-3).init(jparams),
                               step=jnp.zeros((), jnp.int32), loss_scale=None)
    with tctx, jctx:
        losses, _ = _watch(lambda: cd.train(tctx, "hybrid", train, deterministic=True), "the port's loader")

        def ref_run():
            loader = JaxLoader(iter(rtrain), jctx, num_workers=1, staleness=1, reproducible=True)
            out = [float(jctx.train_step_prepared(tb, loader)["loss"]) for tb in loader]
            loader.flush()
            return out

        ref_losses = _watch(ref_run, "the reference's loader")
        np.testing.assert_allclose(losses, ref_losses, **_tol(compute, "loss"))
        assert len(losses) == STEPS
        _same_entries(tctx.worker.lookup_router.replicas, jctx.worker.lookup_router.replicas,
                      _tol(compute, "entry"))
        preds, labels = cd.predict(tctx, test)
        np.testing.assert_allclose(preds, _ref_preds(jctx, rtest), **_tol(compute, "pred"))
        assert preds.shape == labels.shape == (EVAL * B, 1)


def _cached_pair(scale):
    vocabs = cd.vocabs_of(scale)
    above = cd.HASHSTACK_ABOVE_1TB if scale == "1tb" else None
    tctx = cd.build_ctx(vocabs, tier="cached", hashstack_above=above, device="cpu").__enter__()
    params, jparams = _jparams(tctx.model)
    tctx.init_state()
    zeros = jax.tree.map(np.zeros_like, params)
    cached_dense_from_flax(tctx.state, params, zeros, zeros, jnp.zeros((), jnp.int32))
    jctx = EX.build_ctx(vocabs, tier="cached", hashstack_above=above).__enter__()
    tables, emb_state = jhbm.init_cached_tables(jctx.tier.groups, jctx.sparse_cfg)
    jctx.state = jhbm.CachedTrainState(
        params=jparams, batch_stats={}, opt_state=optax.adam(1e-3).init(jparams), tables=tables,
        emb_state=emb_state, emb_batch_state=jnp.ones((2,), jnp.float32), step=jnp.zeros((), jnp.int32))
    return tctx, jctx


@pytest.mark.parametrize("scale", ["kaggle", "1tb"])
def test_cached_matches_the_example(scale, compute):
    """Kaggle: the example's stream (``on_metrics``: one step a dispatch,
    in order) on both sides. 1TB: its hash-stacked slots (over 1M ids) ride
    the PS tier, so both sides step synchronously (the stream would train
    them under bounded staleness); the port's stream runs too. Losses,
    ``publish()``, held-out predictions and, after ``flush``, every PS
    entry."""
    (rtrain, rtest), (train, test) = _streams(scale)
    tctx, jctx = _cached_pair(scale)
    assert tuple(tctx.tier.ps_slots) == tuple(jctx.tier.ps_slots)
    assert len(tctx.tier.ps_slots) == (6 if scale == "1tb" else 0)
    if scale == "kaggle":
        losses, _ = _watch(lambda: cd.train(tctx, "cached", train), "the port's stream")
        ref_losses = []
        _watch(lambda: jctx.train_stream(rtrain, on_metrics=lambda m: ref_losses.append(float(m["loss"]))),
               "the reference's stream")
    else:
        losses = [tctx.train_step(b)["loss"] for b in train]
        ref_losses = [float(jctx.train_step(b)["loss"]) for b in rtrain]
    np.testing.assert_allclose(losses, ref_losses, **_tol(compute, "loss"))
    assert tctx.publish() == jctx.publish() > 0
    np.testing.assert_allclose(cd.predict(tctx, test)[0], _ref_preds(jctx, rtest), **_tol(compute, "pred"))
    tctx.flush()
    jctx.flush()
    _same_entries(tctx.worker.lookup_router.replicas, jctx.worker.lookup_router.replicas, _tol(compute, "entry"))
    tctx.__exit__(None, None, None)
    assert tctx.worker.lookup_router._fan_pool is None
    if scale == "1tb":
        stream_ctx = cd.build_ctx(cd.vocabs_of(scale), tier="cached", hashstack_above=cd.HASHSTACK_ABOVE_1TB,
                                  device="cpu")
        with stream_ctx:
            stream_losses, _ = _watch(lambda: cd.train(stream_ctx, "cached", train), "the port's mixed stream")
        assert len(stream_losses) == STEPS and np.isfinite(stream_losses).all()


def test_fused_matches_the_example(tmp_path, compute):
    """``fold_ids=True`` over tables capped at 1,000 rows: the reference's
    state carried through its checkpoint files, then 4 steps (losses), the
    tables, and the held-out predictions."""
    (rtrain, rtest), (train, test) = _streams("kaggle")
    vocabs = cd.vocabs_of("kaggle")
    jctx = EX.build_ctx(vocabs, tier="fused", fused_vocab_cap=CAP)
    jctx._ensure_state(jbatch_to_fused(rtrain[0], jctx.specs, fold_ids=True))
    jctx.dump_checkpoint(str(tmp_path / "ref"))
    tctx = cd.build_ctx(vocabs, tier="fused", fused_vocab_cap=CAP, device="cpu")
    assert {k: s.vocab for k, s in tctx.specs.items()} == {k: s.vocab for k, s in jctx.specs.items()}
    tctx._ensure_state()
    tctx.load_checkpoint(str(tmp_path / "ref"))
    losses, _ = cd.train(tctx, "fused", train)
    ref_losses = [float(jctx.train_step(b)["loss"]) for b in rtrain]
    np.testing.assert_allclose(losses, ref_losses, **_tol(compute, "loss"))
    for name, table in tctx.state.tables.items():
        np.testing.assert_allclose(table.numpy(), np.asarray(jctx.state.tables[name]), err_msg=name,
                                   **_tol(compute, "entry", ADAM))
    np.testing.assert_allclose(cd.predict(tctx, test)[0], _ref_preds(jctx, rtest), **_tol(compute, "pred", ADAM))


def test_example_cli_runs_every_tier(capsys, tmp_path):
    for argv in (["--tier", "fused", "--fused-vocab-cap", "100"], ["--tier", "cached", "--scale", "1tb"],
                 ["--tier", "hybrid", "--deterministic", "--ckpt-dir", str(tmp_path / "ckpt")],
                 ["--tier", "hybrid", "--batch-size", "8", "--data-path",
                  str(ROOT / "tests" / "fixtures" / "criteo_tiny.tsv")]):
        assert _watch(lambda: cd.main(["--device", "cpu", "--steps", "2", "--eval-steps", "1",
                                       "--batch-size", "64", *argv]), " ".join(argv)) == 0
        line = capsys.readouterr().out.strip().splitlines()[-1 if "--ckpt-dir" not in argv else -2]
        assert line.startswith("criteo-dlrm[") and " test_auc=" in line and line.endswith(" samples/sec"), line
    assert any((tmp_path / "ckpt").iterdir())
    # the cached tier runs the example's dynamic loss scale (it raised before the port had one)
    assert _watch(lambda: cd.main(["--device", "cpu", "--tier", "cached", "--dynamic-loss-scale", "--steps", "2",
                                   "--eval-steps", "1", "--batch-size", "64"]), "--dynamic-loss-scale") == 0
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("criteo-dlrm[kaggle] steps=2 loss=")


# ---------------------------------------------------------- the 100T harness


def test_100t_harness_matches_the_example(compute):
    """8 replicas, reproducible loader, 4 steps of B=128: losses, every
    entry of every replica, and the record's capacity figures."""
    batches = list(HX.Synthetic100T(num_samples=STEPS * 128, seed=42).batches(128))
    ours = list(sh.dataset(STEPS, 128).batches(128))
    assert [b.to_bytes() for b in ours] == [b.to_bytes() for b in batches]
    tctx, stores = sh.build_ctx(ps_replicas=8, device="cpu")
    _, jparams = _jparams(tctx.model)
    jctx, jstores = HX.build_ctx(8, 8, 1 << 16)
    jctx.state = JaxTrainState(params=jparams, batch_stats={}, opt_state=optax.adam(1e-3).init(jparams),
                               step=jnp.zeros((), jnp.int32), loss_scale=None)
    with tctx, jctx:
        losses, seconds = _watch(lambda: sh.train(tctx, ours, deterministic=True), "the port's loader")

        def ref_run():
            loader = JaxLoader(iter(batches), jctx, num_workers=1, staleness=1, reproducible=True)
            out = [float(jctx.train_step_prepared(tb, loader)["loss"]) for tb in loader]
            loader.flush()
            return out

        np.testing.assert_allclose(losses, _watch(ref_run, "the reference's loader"), **_tol(compute, "loss"))
    assert tctx.worker.lookup_router._fan_pool is None
    _same_entries(stores, jstores, _tol(compute, "entry"))
    rec = sh.record(stores, losses, seconds, STEPS, batch_size=128)
    assert rec["capacity"]["rows_resident"] == sum(s.size() for s in jstores) == STEPS * 128 * 8 * 4
    assert rec["capacity"]["bytes_per_row"] == (16 + jstores[0]._state_dim(16)) * 4 + 8 + 8 + 16 == 160
    assert rec["capacity"]["hosts_at_512gb"] == 1954 and rec["config"]["ps_replicas"] == 8


def test_100t_out_defaults_to_no_file(capsys, tmp_path, monkeypatch):
    """The departure: the port's ``--out`` defaults to no file (the
    reference's to ``BENCH_100T.json`` at the root, which it overwrites)."""
    src = (ROOT / "examples" / "synthetic_100t" / "train.py").read_text()
    assert '"BENCH_100T.json"' in src
    root_file = ROOT / "BENCH_100T.json"
    before = root_file.read_bytes() if root_file.exists() else None
    monkeypatch.chdir(tmp_path)
    argv = ["--device", "cpu", "--steps", "2", "--batch-size", "32", "--ps-replicas", "4"]
    assert _watch(lambda: sh.main(argv), "the harness") == 0
    out = capsys.readouterr().out
    assert "synthetic-100t ps_replicas=4 steps=2" in out and "wrote" not in out
    assert list(tmp_path.iterdir()) == []
    assert (root_file.read_bytes() if root_file.exists() else None) == before
    assert _watch(lambda: sh.main(argv + ["--out", str(tmp_path / "rec.json")]), "the harness") == 0
    assert (tmp_path / "rec.json").exists()


# ---------------------------------------------------------- the quality gate

QV, QROWS, QSTORE, QSTEPS = 2000, 1 << 14, 1 << 16, 6


def _ref_tier_ctx(jparams, ps_all, compute):
    """``bench.py``'s ``_cached_tier_ctx`` built from the reference's
    classes at the cut sizes."""
    cfg = jcfg.EmbeddingConfig(slots_config={n: jcfg.SlotConfig(dim=16) for n in q.SLOTS},
                               feature_index_prefix_bit=8)
    store = JaxStore(capacity=QSTORE, num_internal_shards=64, optimizer=JAdagrad(lr=0.05).config, seed=1)
    model = JaxDLRM(embedding_dim=16, bottom_mlp=q.BOTTOM, top_mlp=q.TOP, compute_dtype=jnp.dtype(compute))
    kw = dict(cache_rows=8, ps_slots=list(q.SLOTS), ps_wire_dtype="int8") if ps_all else dict(
        cache_rows=QROWS, wb_wire_dtype="bfloat16", aux_wire_dtype="bfloat16", admit_touches=2)
    ctx = jhbm.CachedTrainCtx(model, optax.adam(1e-3), JAdagrad(lr=0.05),
                              JaxWorker(cfg, [store], device_pooling=True), cfg, **kw).__enter__()
    tables, emb_state = jhbm.init_cached_tables(ctx.tier.groups, ctx.sparse_cfg)
    ctx.state = jhbm.CachedTrainState(
        params=jparams, batch_stats={}, opt_state=optax.adam(1e-3).init(jparams), tables=tables,
        emb_state=emb_state, emb_batch_state=jnp.ones((2,), jnp.float32), step=jnp.zeros((), jnp.int32))
    return ctx


@pytest.mark.parametrize("tier", ["cached", "ps-stream"])
def test_quality_stream_tiers_match_reference_twins(tier, compute):
    """The port's ``tier_ctx`` + ``run_stream_tier`` against the reference's
    ctx at ``bench.py``'s configuration (cut sizes) through the same two
    streams. With 6 steps under ``psgrad_batch=16`` the PS tier's gradients
    land when each stream ends, so both sides see the same rows."""
    ps_all = tier == "ps-stream"
    train_b, eval_b = q.quality_data(QSTEPS, batch_size=B, vocab=QV)
    model = q.bench_model()
    params, jparams = _jparams(model)
    tctx = q.tier_ctx("cpu", q.bench_store("numpy", capacity=QSTORE), ps_slots=q.SLOTS if ps_all else (),
                      cache_rows=8 if ps_all else QROWS, model=model)
    zeros = jax.tree.map(np.zeros_like, params)
    cached_dense_from_flax(tctx.state, params, zeros, zeros, jnp.zeros((), jnp.int32))
    res = _watch(lambda: q.run_stream_tier(tctx, train_b, eval_b, ps_all=ps_all), "the port's tier")
    jctx = _ref_tier_ctx(jparams, ps_all, compute)
    knobs = q.PS_STREAM_KNOBS if ps_all else q.STREAM_KNOBS
    rtrain = _ref_batches(train_b)
    _watch(lambda: (jctx.train_stream(rtrain[:q.UNTIMED], **knobs), jctx.train_stream(rtrain[q.UNTIMED:], **knobs)),
           "the reference's tier")
    rtest = _ref_batches(eval_b)
    preds = np.concatenate([np.asarray(tctx.eval_batch(b)).reshape(-1) for b in eval_b])
    ref_preds = _ref_preds(jctx, rtest).reshape(-1)
    np.testing.assert_allclose(preds, ref_preds, **_tol(compute, "pred", QUANT if ps_all else ADAM))
    labels = np.concatenate([np.asarray(b.labels[0].data).reshape(-1) for b in eval_b])
    assert abs(res["auc"] - ref_data.roc_auc(labels, ref_preds)) < q.SPREAD_LIMIT
    assert res["timed_steps"] == QSTEPS - q.UNTIMED and res["samples_per_sec"] > 0
    tctx.__exit__(None, None, None)


def _ref_batches(batches):
    import persia_tpu.data as jdata

    return [jdata.PersiaBatch.from_bytes(b.to_bytes()) for b in batches]


def test_quality_fused_tier_matches_reference_twin(compute):
    """The port's ``run_fused_tier`` from the reference's ``init_fused_state``
    (carried leaf by leaf) against ``bench.py``'s ``_quality_fused`` loop at
    2,000 rows a slot: the held-out predictions, the AUC, the tables."""
    train_b, eval_b = q.quality_data(QSTEPS, batch_size=B, vocab=QV)
    specs = {n: jfused.FusedSlotSpec(vocab=QV, dim=16) for n in q.SLOTS}
    jmodel = JaxDLRM(embedding_dim=16, bottom_mlp=q.BOTTOM, top_mlp=q.TOP, compute_dtype=jnp.dtype(compute))
    sparse_cfg = JAdagrad(lr=0.05).config
    fb = [q.fused_batch(b) for b in train_b]
    jstate = jfused.init_fused_state(jmodel, jax.random.PRNGKey(0), specs, fb[0], optax.adam(1e-3), sparse_cfg,
                                     stack=True)
    leaves = jax.tree_util.tree_leaves_with_path(jstate)
    model = q.bench_model()
    state = fused_state_from_flax([jax.tree_util.keystr(p) for p, _ in leaves], [np.asarray(x) for _, x in leaves],
                                  model, torch.optim.Adam(model.parameters(), lr=1e-3), device="cpu")
    res = q.run_fused_tier(train_b, eval_b, state, vocab=QV)
    step = jfused.build_fused_train_step(jmodel, optax.adam(1e-3), sparse_cfg, specs, sorted(specs), stack=True)
    for b in fb:
        jstate, _ = step(jstate, b)
    jeval = jfused.build_fused_eval_step(jmodel, specs, sorted(specs), stack=True)
    ref_preds = np.concatenate([np.asarray(jeval(jstate, q.fused_batch(b))).reshape(-1) for b in eval_b])
    teval = build_fused_eval_step(q.fused_specs(QV), stack=True)  # the state was trained in place
    preds = np.concatenate([teval(state, fused_batch_to_device(q.fused_batch(b), "cpu")).numpy().reshape(-1)
                            for b in eval_b])
    np.testing.assert_allclose(preds, ref_preds, **_tol(compute, "pred"))
    labels = np.concatenate([np.asarray(b.labels[0].data).reshape(-1) for b in eval_b])
    assert res["auc"] == ref_data.roc_auc(labels, preds)
    assert abs(res["auc"] - ref_data.roc_auc(labels, ref_preds)) < q.SPREAD_LIMIT
    for name, table in state.tables.items():
        np.testing.assert_allclose(table.numpy(), np.asarray(jstate.tables[name]), err_msg=name,
                                   **_tol(compute, "entry", ADAM))
    assert res["timed_steps"] == QSTEPS - 1 and np.isfinite(res["loss_last"])


def test_quality_gate_spread_and_refusals():
    out = {"cached": {"auc": 0.61}, "ps-stream": {"auc": 0.6}, "fused": {"auc": 0.615}}
    assert q.spread(out) == pytest.approx(0.015)
    with pytest.raises(ValueError, match="steps"):
        q.bench_quality(steps=2)
    with pytest.raises(ValueError, match="tier"):
        q.run_tier("hybrid", [], [], device="cpu")


def test_entry_points_raise_without_a_card():
    """The example, the harness and the quality tiers default to the card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    vocabs = [10] * 26
    for tier in cd.TIERS:
        with pytest.raises(RuntimeError):
            cd.build_ctx(vocabs, tier=tier, ps_replicas=1, capacity=64, fused_vocab_cap=10)
    with pytest.raises(RuntimeError):
        sh.build_ctx(ps_replicas=2, capacity_per_replica=64)
    with pytest.raises(RuntimeError):
        q.tier_ctx(store=q.bench_store("numpy", capacity=64), cache_rows=64)
    with pytest.raises(RuntimeError):
        q.fused_state(vocab=10)
