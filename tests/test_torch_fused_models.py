"""DeepFM, DCN-v2 and DNN on the port's fused tier
(``persia_tpu_torch/parallel/fused_ctx.py`` and ``fused_step.py``, on the
CPU) against the reference's (``persia_tpu/parallel``, JAX on the CPU), at
cut sizes: two slots of 64 and 32 ids at dim 8, B=16, deep towers (16,),
DCN-v2 with 2 full-rank cross layers, DNN with its two batch norms.

- The port's state is loaded from the reference's own checkpoint files,
  so both start from the same seeded weights; the manifest must equal the
  reference's ``jax.tree_util.keystr`` list string for string
  (``field_weight``, ``dense_linear``, ``deep_out``, ``CrossLayerV2_i``,
  ``batch_stats``' ``BatchNorm_0`` and ``BatchNorm_1``).
- Four ``train_step``s, then every leaf (parameters, ``batch_stats``,
  Adam's moments and count, tables, their Adagrad state, the powers, the
  step) and ``eval_batch`` (the running statistics). Tolerances: f32
  compute, losses rtol 1e-5 and the rest rtol 1e-5 / atol 1e-6 (the DLRM
  fused-ctx test's bound); bf16 compute (the models' default), each bound
  (``BF16_TOL``) two to four times what this test reads on the CPU, the
  same each run: losses DeepFM 2.7e-4, DCN-v2 6.9e-5, DNN 8.0e-5;
  predictions 6.8e-4, 6.2e-4, 1.8e-3; eval predictions 9.4e-4, 4.1e-4,
  4.1e-3; every leaf 4.2e-4, 3.8e-4 and, for DNN, 2.2e-3 (its tables)
  but its Adagrad accumulator, 2.9e-2 (squared bf16 gradients summed).
- Checkpoints across the packages both ways, bit for bit.
- The mixed-dims DNN of ``tests/test_fused_step.py`` (a single-id slot,
  a sqrt-scaled bag, a dim-4 bag, a raw sequence slot) through the step
  builders, stacked and unstacked.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import persia_tpu.embedding  # noqa: F401  (imports persia_tpu.ops in the order it needs)
from persia_tpu import data as jdata
from persia_tpu.embedding.optim import Adagrad as JAdagrad
from persia_tpu.models import DCNv2 as JaxDCNv2
from persia_tpu.models import DeepFM as JaxDeepFM
from persia_tpu.models import DNN as JaxDNN
from persia_tpu.parallel import fused_ctx as jctx_mod
from persia_tpu.parallel import fused_step as jstep
from persia_tpu.parallel.fused_step import FusedSlotSpec as JSpec
from persia_tpu_torch import data as tdata
from persia_tpu_torch.embedding.optim import Adagrad
from persia_tpu_torch.models import DNN, DCNv2, DeepFM
from persia_tpu_torch.parallel import fused_ctx as tctx_mod
from persia_tpu_torch.parallel import fused_step as tstep
from persia_tpu_torch.parallel.fused_step import FusedSlotSpec
from persia_tpu_torch.weights import fused_state_from_flax, fused_state_manifest, fused_state_to_flax

TIGHT = dict(rtol=1e-5, atol=1e-6)
# bf16 compute: (losses, predictions, eval predictions, every leaf), atol
BF16_TOL = {"deepfm": (1e-3, 2e-3, 3e-3, 1e-3), "dcnv2": (2e-4, 2e-3, 1e-3, 1e-3), "dnn": (2e-4, 5e-3, 1e-2, 5e-3)}
BF16_LEAF_ATOL = {"dnn": {".emb_state['__stack_d8_0']['acc']": 6e-2}}  # leaves of their own bound
VOCABS = {"a": 64, "b": 32}
DIM, DENSE, DEEP = 8, 4, (16,)
MODELS = ("deepfm", "dcnv2", "dnn")


def _models(name, f32=True):
    dt, jdt = (torch.float32, jnp.float32) if f32 else (torch.bfloat16, jnp.bfloat16)
    if name == "deepfm":
        return (DeepFM(DENSE, 2, DIM, DEEP, compute_dtype=dt, device="cpu"),
                JaxDeepFM(embedding_dim=DIM, deep_mlp=DEEP, compute_dtype=jdt))
    if name == "dcnv2":
        return (DCNv2(DENSE, 2, DIM, 2, None, DEEP, compute_dtype=dt, device="cpu"),
                JaxDCNv2(embedding_dim=DIM, num_cross_layers=2, deep_mlp=DEEP, compute_dtype=jdt))
    return (DNN(DENSE, [DIM, DIM], 8, 16, DEEP, compute_dtype=dt, device="cpu"),
            JaxDNN(dense_mlp_size=8, sparse_mlp_size=16, hidden_sizes=DEEP, compute_dtype=jdt))


def _ctxs(name, f32=True, stack=True):
    model, jmodel = _models(name, f32)
    t = tctx_mod.FusedTrainCtx(model, torch.optim.Adam(model.parameters(), lr=LR), Adagrad(lr=0.1),
                               {k: FusedSlotSpec(vocab=v, dim=DIM) for k, v in VOCABS.items()}, stack=stack,
                               device="cpu")
    j = jctx_mod.FusedTrainCtx(jmodel, optax.adam(LR), JAdagrad(lr=0.1),
                               {k: JSpec(vocab=v, dim=DIM) for k, v in VOCABS.items()}, stack=stack)
    return j, t


def _batch(mod, seed, n=16, learnable=True):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 64, n).astype(np.uint64)
    b = rng.integers(0, 32, n).astype(np.uint64)
    dense = rng.normal(size=(n, DENSE)).astype(np.float32)
    if learnable:
        y = (((a % 2).astype(np.float32) * 2 - 1 + dense[:, 0]) > 0).astype(np.float32).reshape(-1, 1)
    else:
        y = rng.integers(0, 2, (n, 1)).astype(np.float32)
    return mod.PersiaBatch(
        [mod.IDTypeFeatureWithSingleID("a", a), mod.IDTypeFeatureWithSingleID("b", b)],
        non_id_type_features=[mod.NonIDTypeFeature(dense)], labels=[mod.Label(y)], requires_grad=True,
    )


def _pair(tmp_path, name, f32=True, stack=True):
    """Both contexts, the port's state loaded from the reference's
    checkpoint files."""
    j, t = _ctxs(name, f32, stack)
    j._ensure_state(jctx_mod.batch_to_fused(_batch(jdata, 0), j.specs))
    j.dump_checkpoint(str(tmp_path / "ref"))
    t._ensure_state()
    t.load_checkpoint(str(tmp_path / "ref"))
    return j, t


def _ref_leaves(state):
    kl = jax.tree_util.tree_leaves_with_path(state)
    return [jax.tree_util.keystr(kp) for kp, _ in kl], [np.asarray(v) for _, v in kl]


# The biases of DNN's Dense_0 and Dense_1 feed a batch norm, which takes
# the batch mean out: their true gradient is 0 and both packages compute
# float noise for it, which Adam normalises into steps of about its
# learning rate of either sign. The train step's outputs do not see them
# (the losses and predictions hold to the tolerance), so they are held
# only to the steps Adam can take, |port - reference| <= 2 * lr * steps,
# and the running means they shift to (1 - 0.99^steps) of that (the
# momentum's share); eval reads both, so DNN's eval predictions are held
# within 2e-2.
LR = 1e-2
BN_FED = {".params['Dense_0']['bias']": 1.0, ".params['Dense_1']['bias']": 1.0,
          ".batch_stats['BatchNorm_0']['mean']": None, ".batch_stats['BatchNorm_1']['mean']": None}


def _assert_same_state(j, t, steps=0, leaf_atol=None, **tol):
    want_paths, want = _ref_leaves(j.state)
    paths, got = fused_state_to_flax(t.state)
    assert paths == want_paths
    bn = isinstance(t.model, DNN)
    for p, a, b in zip(paths, got, want):
        if leaf_atol and p in leaf_atol:
            assert p not in BN_FED
            np.testing.assert_allclose(a, b, rtol=0, atol=leaf_atol[p], err_msg=p)
        elif bn and p in BN_FED and steps:
            share = BN_FED[p] or 1 - 0.99 ** steps
            np.testing.assert_allclose(a, b, rtol=0, atol=share * 2 * LR * steps + tol["atol"], err_msg=p)
        else:
            np.testing.assert_allclose(a, b, err_msg=p, **tol)


def _eval_tol(name):
    return dict(rtol=0, atol=2e-2) if name == "dnn" else TIGHT


@pytest.mark.parametrize("name", MODELS)
def test_manifest_is_the_reference_keystr_list(tmp_path, name):
    j, t = _pair(tmp_path, name)
    paths = fused_state_manifest(t.state)
    assert paths == _ref_leaves(j.state)[0]
    want = {"deepfm": [".params['field_weight']", ".params['dense_linear']['kernel']",
                       ".params['deep_out']['bias']"],
            "dcnv2": [".params['CrossLayerV2_1']['Dense_0']['kernel']"],
            "dnn": [".batch_stats['BatchNorm_0']['mean']", ".batch_stats['BatchNorm_1']['var']",
                    ".params['BatchNorm_1']['scale']"]}[name]
    assert set(want) <= set(paths)
    assert any(p.startswith(".batch_stats") for p in paths) == (name == "dnn")


@pytest.mark.parametrize("stack", [True, False], ids=["stacked", "unstacked"])
@pytest.mark.parametrize("name", MODELS)
def test_train_steps_match_reference_f32(tmp_path, name, stack):
    j, t = _pair(tmp_path, name, stack=stack)
    _assert_same_state(j, t, rtol=0, atol=0)
    for i in range(4):
        mj, mt = j.train_step(_batch(jdata, i)), t.train_step(_batch(tdata, i))
        np.testing.assert_allclose(mt["loss"], mj["loss"], rtol=1e-5)
        np.testing.assert_allclose(mt["preds"], mj["preds"], **TIGHT)
    _assert_same_state(j, t, steps=4, **TIGHT)
    np.testing.assert_allclose(t.eval_batch(_batch(tdata, 99, learnable=False)),
                               j.eval_batch(_batch(jdata, 99, learnable=False)), **_eval_tol(name))


@pytest.mark.parametrize("name", MODELS)
def test_train_steps_match_reference_bf16(tmp_path, name):
    j, t = _pair(tmp_path, name, f32=False)
    loss_tol, preds_tol, eval_tol, leaf_tol = BF16_TOL[name]
    for i in range(3):
        mj, mt = j.train_step(_batch(jdata, i)), t.train_step(_batch(tdata, i))
        np.testing.assert_allclose(mt["loss"], mj["loss"], rtol=0, atol=loss_tol)
        np.testing.assert_allclose(mt["preds"], mj["preds"], rtol=0, atol=preds_tol)
    _assert_same_state(j, t, steps=3, leaf_atol=BF16_LEAF_ATOL.get(name), rtol=0, atol=leaf_tol)
    np.testing.assert_allclose(t.eval_batch(_batch(tdata, 99, learnable=False)),
                               j.eval_batch(_batch(jdata, 99, learnable=False)), rtol=0, atol=eval_tol)


def test_dnn_batch_stats_move_in_train_and_not_in_eval(tmp_path):
    """A train step moves DNN's running statistics, as the reference's
    does; eval reads them and moves nothing."""
    j, t = _pair(tmp_path, "dnn")
    before = dict(zip(*fused_state_to_flax(t.state)))
    t.train_step(_batch(tdata, 0))
    after = dict(zip(*fused_state_to_flax(t.state)))
    stats = [p for p in after if p.startswith(".batch_stats")]
    assert len(stats) == 4 and all(not np.array_equal(before[p], after[p]) for p in stats)
    t.eval_batch(_batch(tdata, 5, learnable=False))
    again = dict(zip(*fused_state_to_flax(t.state)))
    for p in stats:
        np.testing.assert_array_equal(after[p], again[p])


@pytest.mark.parametrize("name", MODELS)
def test_port_checkpoint_loads_into_reference(tmp_path, name):
    """The port's files after three steps load into the reference's ctx
    (its ``load_checkpoint`` demands the identical manifest), bit for bit,
    and it then predicts what the port predicts."""
    j, t = _pair(tmp_path, name)
    for i in range(3):
        t.train_step(_batch(tdata, i))
    t.dump_checkpoint(str(tmp_path / "port"))
    j.train_step(_batch(jdata, 7))
    j.load_checkpoint(str(tmp_path / "port"))
    _assert_same_state(j, t, rtol=0, atol=0)
    np.testing.assert_allclose(j.eval_batch(_batch(jdata, 50, learnable=False)),
                               t.eval_batch(_batch(tdata, 50, learnable=False)), **TIGHT)


@pytest.mark.parametrize("name", MODELS)
def test_reference_checkpoint_loads_into_port(tmp_path, name):
    """A reference checkpoint written after three of its steps loads into
    a live port state in place, bit for bit."""
    j, t = _pair(tmp_path, name)
    for i in range(3):
        j.train_step(_batch(jdata, i))
    j.dump_checkpoint(str(tmp_path / "ref3"))
    t.train_step(_batch(tdata, 9))
    t.load_checkpoint(str(tmp_path / "ref3"))
    _assert_same_state(j, t, rtol=0, atol=0)


@pytest.mark.parametrize("name", MODELS)
def test_checkpoint_round_trip(tmp_path, name):
    _, t = _pair(tmp_path, name)
    for i in range(3):
        t.train_step(_batch(tdata, i))
    ref = t.eval_batch(_batch(tdata, 100, learnable=False))
    t.dump_checkpoint(str(tmp_path / "rt"))
    for i in range(3, 6):
        t.train_step(_batch(tdata, i))
    t.load_checkpoint(str(tmp_path / "rt"))
    np.testing.assert_array_equal(ref, t.eval_batch(_batch(tdata, 100, learnable=False)))
    assert int(t.state.step) == 3


def test_checkpoint_of_another_model_rejected(tmp_path):
    _, t = _pair(tmp_path, "deepfm")
    t.dump_checkpoint(str(tmp_path / "deepfm"))
    _, other = _pair(tmp_path / "o", "dnn")
    with pytest.raises(ValueError, match="layout mismatch"):
        other.load_checkpoint(str(tmp_path / "deepfm"))


# ------------------------------------------- the mixed-dims DNN, step level

MIXED = {"a": (50, 8, True, False), "b": (30, 8, True, True), "c": (20, 4, True, False), "seq": (40, 8, False, False)}


def _mixed_batch(seed, b=16):
    rng = np.random.default_rng(seed)
    return {
        "dense": [rng.normal(size=(b, 4)).astype(np.float32)],
        "labels": [rng.integers(0, 2, (b, 1)).astype(np.float32)],
        "ids": {
            "a": rng.integers(0, 50, (b,)).astype(np.int32),
            "b": np.where(rng.random((b, 3)) < 0.3, -1, rng.integers(0, 30, (b, 3))).astype(np.int32),
            "c": rng.integers(0, 20, (b, 2)).astype(np.int32),
            "seq": np.where(rng.random((b, 4)) < 0.4, -1, rng.integers(0, 40, (b, 4))).astype(np.int32),
        },
    }


@pytest.mark.parametrize("stack", [True, False], ids=["stacked", "unstacked"])
def test_mixed_dims_dnn_steps_match_reference(stack):
    """``tests/test_fused_step.py``'s mixed-dims DNN (hidden (32,), f32
    compute): the reference's initial state carried across leaf by leaf,
    three steps on each side, then every leaf (TIGHT)."""
    jspecs = {k: JSpec(vocab=v, dim=d, pooled=p, sqrt_scaling=s) for k, (v, d, p, s) in MIXED.items()}
    specs = {k: FusedSlotSpec(vocab=v, dim=d, pooled=p, sqrt_scaling=s) for k, (v, d, p, s) in MIXED.items()}
    order = sorted(MIXED)
    cfg = JAdagrad(lr=0.1).config
    jmodel = JaxDNN(hidden_sizes=(32,), compute_dtype=jnp.float32)
    jb0 = {**_mixed_batch(0), "ids": {k: jnp.asarray(v) for k, v in _mixed_batch(0)["ids"].items()}}
    jstate = jstep.init_fused_state(jmodel, jax.random.PRNGKey(0), jspecs, jb0, optax.adam(LR), cfg,
                                    slot_order=order, stack=stack)
    paths, arrays = _ref_leaves(jstate)
    model = DNN(4, [MIXED[k][1] for k in order], hidden_sizes=(32,), compute_dtype=torch.float32, device="cpu")
    state = fused_state_from_flax(paths, arrays, model, torch.optim.Adam(model.parameters(), lr=LR), "cpu")
    assert fused_state_manifest(state) == paths
    jfn = jstep.build_fused_train_step(jmodel, optax.adam(LR), cfg, jspecs, order, donate=False, stack=stack)
    fn = tstep.build_fused_train_step(Adagrad(lr=0.1).config, specs, order, stack=stack)
    for i in range(3):
        hb = _mixed_batch(i)
        jstate, (jl, jp) = jfn(jstate, {**hb, "ids": {k: jnp.asarray(v) for k, v in hb["ids"].items()}})
        state, (loss, preds) = fn(state, tstep.fused_batch_to_device(hb, "cpu"))
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
        np.testing.assert_allclose(preds.numpy(), np.asarray(jp), **TIGHT)
    for p, a, b in zip(paths, fused_state_to_flax(state)[1], _ref_leaves(jstate)[1]):
        if p in BN_FED:
            share = BN_FED[p] or 1 - 0.99 ** 3
            np.testing.assert_allclose(a, b, rtol=0, atol=share * 2 * LR * 3 + 1e-6, err_msg=p)
        else:
            np.testing.assert_allclose(a, b, err_msg=p, rtol=1e-5, atol=5e-6)
