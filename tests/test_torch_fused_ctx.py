"""The port's ``FusedTrainCtx`` (``persia_tpu_torch/parallel/fused_ctx.py``,
on the CPU) against the reference's (``persia_tpu/parallel/fused_ctx.py``,
JAX on the CPU): the state carried across through the reference's own
checkpoint files, then five ``train_step``s (losses to rtol 1e-5, state to
rtol 1e-5, atol 1e-6), ``eval_batch``, ``batch_to_fused``; checkpoints in
both directions; ``train_pipelined`` against the ``train_step`` loop."""

import numpy as np
import optax
import pytest
import torch

import persia_tpu.embedding  # noqa: F401  (imports persia_tpu.ops in the order it needs)
import jax.numpy as jnp
from persia_tpu import data as jdata
from persia_tpu.embedding.optim import Adagrad as JAdagrad
from persia_tpu.models import DLRM as JaxDLRM
from persia_tpu.parallel import fused_ctx as jctx_mod
from persia_tpu.parallel.fused_step import FusedSlotSpec as JSpec
from persia_tpu_torch import data as tdata
from persia_tpu_torch.embedding.optim import Adagrad
from persia_tpu_torch.models import DLRM
from persia_tpu_torch.parallel import fused_ctx as tctx_mod
from persia_tpu_torch.parallel.fused_step import FusedSlotSpec
from persia_tpu_torch.weights import fused_state_to_flax

TIGHT = dict(rtol=1e-5, atol=1e-6)
VOCABS = {"a": 64, "b": 32}


def _ctx(hidden=(16,), stack=True, lr=1e-3):
    model = DLRM(4, 2, 8, (16, 8), hidden, compute_dtype=torch.float32, device="cpu",
                 generator=torch.Generator().manual_seed(0))
    return tctx_mod.FusedTrainCtx(
        model, torch.optim.Adam(model.parameters(), lr=lr), Adagrad(lr=0.1),
        {k: FusedSlotSpec(vocab=v, dim=8) for k, v in VOCABS.items()}, stack=stack, device="cpu",
    )


def _jctx(hidden=(16,), stack=True):
    return jctx_mod.FusedTrainCtx(
        JaxDLRM(embedding_dim=8, bottom_mlp=(16, 8), top_mlp=hidden, compute_dtype=jnp.float32),
        optax.adam(1e-3), JAdagrad(lr=0.1), {k: JSpec(vocab=v, dim=8) for k, v in VOCABS.items()}, stack=stack,
    )


def _batch(mod, seed, n=16, learnable=True):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 64, n).astype(np.uint64)
    b = rng.integers(0, 32, n).astype(np.uint64)
    dense = rng.normal(size=(n, 4)).astype(np.float32)
    if learnable:  # the label follows slot a's parity and dense[0]
        y = (((a % 2).astype(np.float32) * 2 - 1 + dense[:, 0]) > 0).astype(np.float32).reshape(-1, 1)
    else:
        y = rng.integers(0, 2, (n, 1)).astype(np.float32)
    return mod.PersiaBatch(
        [mod.IDTypeFeatureWithSingleID("a", a), mod.IDTypeFeatureWithSingleID("b", b)],
        non_id_type_features=[mod.NonIDTypeFeature(dense)], labels=[mod.Label(y)], requires_grad=True,
    )


def _pair(tmp_path, stack=True):
    """Both contexts, the port's state loaded from the reference's
    checkpoint (the reference's files read by the port)."""
    j = _jctx(stack=stack)
    j._ensure_state(jctx_mod.batch_to_fused(_batch(jdata, 0), j.specs))
    j.dump_checkpoint(str(tmp_path / "ref"))
    t = _ctx(stack=stack)
    t._ensure_state()
    t.load_checkpoint(str(tmp_path / "ref"))
    return j, t


def _assert_same_state(j, t, **tol):
    import jax

    kl = jax.tree_util.tree_leaves_with_path(j.state)
    paths, arrays = fused_state_to_flax(t.state)
    assert paths == [jax.tree_util.keystr(kp) for kp, _ in kl]
    for p, (_, ref), got in zip(paths, kl, arrays):
        np.testing.assert_allclose(got, np.asarray(ref), err_msg=p, **tol)


@pytest.mark.parametrize("stack", [True, False], ids=["stacked", "unstacked"])
def test_train_steps_match_reference(tmp_path, stack):
    j, t = _pair(tmp_path, stack)
    _assert_same_state(j, t, rtol=0, atol=0)
    for i in range(5):
        mj, mt = j.train_step(_batch(jdata, i)), t.train_step(_batch(tdata, i))
        np.testing.assert_allclose(mt["loss"], mj["loss"], rtol=1e-5)
        np.testing.assert_allclose(mt["preds"], mj["preds"], **TIGHT)
    np.testing.assert_allclose(t.last_metrics()["loss"], mj["loss"], rtol=1e-5)
    _assert_same_state(j, t, **TIGHT)
    np.testing.assert_allclose(t.eval_batch(_batch(tdata, 99, learnable=False)),
                               j.eval_batch(_batch(jdata, 99, learnable=False)), **TIGHT)


def test_port_checkpoint_loads_into_reference(tmp_path):
    """The port's files are the reference's: the reference's
    ``load_checkpoint`` (which demands an identical manifest) takes them and
    then predicts what the port predicts."""
    t = _ctx()
    for i in range(3):
        t.train_step(_batch(tdata, i))
    t.dump_checkpoint(str(tmp_path))
    j = _jctx()
    j.train_step(_batch(jdata, 7))
    j.load_checkpoint(str(tmp_path))
    _assert_same_state(j, t, rtol=0, atol=0)
    np.testing.assert_allclose(j.eval_batch(_batch(jdata, 50, learnable=False)),
                               t.eval_batch(_batch(tdata, 50, learnable=False)), **TIGHT)


def test_trains_and_loss_drops():
    t = _ctx(lr=1e-2)  # the reference's test_fused_ctx setting
    losses = [t.train_step(_batch(tdata, i))["loss"] for i in range(30)]
    assert np.all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.05, losses


def test_checkpoint_round_trip(tmp_path):
    t = _ctx()
    for i in range(5):
        t.train_step(_batch(tdata, i))
    ref = t.eval_batch(_batch(tdata, 100, learnable=False))
    t.dump_checkpoint(str(tmp_path))
    for i in range(5, 10):  # diverge
        t.train_step(_batch(tdata, i))
    assert not np.allclose(ref, t.eval_batch(_batch(tdata, 100, learnable=False)))
    t.load_checkpoint(str(tmp_path))
    np.testing.assert_array_equal(ref, t.eval_batch(_batch(tdata, 100, learnable=False)))
    assert int(t.state.step) == 5


def test_checkpoint_layout_mismatch_rejected(tmp_path):
    t = _ctx()
    t.train_step(_batch(tdata, 0))
    t.dump_checkpoint(str(tmp_path))
    other = _ctx(hidden=(32, 16))
    other.train_step(_batch(tdata, 0))
    with pytest.raises(ValueError, match="layout mismatch"):
        other.load_checkpoint(str(tmp_path))


def _lil(mod, lists, n_dense=2):
    feat = mod.IDTypeFeature("a", [np.array(x, np.uint64) for x in lists])
    return mod.PersiaBatch(
        [feat], non_id_type_features=[mod.NonIDTypeFeature(np.zeros((len(lists), n_dense), np.float32))],
        labels=[mod.Label(np.zeros((len(lists), 1), np.float32))], requires_grad=True,
    )


@pytest.mark.parametrize("lists,want", [
    ([[1, 2, 3], [], [7]], [[1, 2, 3], [-1, -1, -1], [7, -1, -1]]),  # lil padding
    ([[1, 2], [], [7]], [[1, 2], [-1, -1], [7, -1]]),  # 3 ids over 3 samples: not single-id
    ([[4], [5], [6]], [4, 5, 6]),  # one id per sample
])
def test_batch_to_fused_matches_reference(lists, want):
    got = tctx_mod.batch_to_fused(_lil(tdata, lists))
    ref = jctx_mod.batch_to_fused(_lil(jdata, lists))
    np.testing.assert_array_equal(got["ids"]["a"], np.array(want, np.int32))
    np.testing.assert_array_equal(got["ids"]["a"], ref["ids"]["a"])
    assert got["ids"]["a"].dtype == ref["ids"]["a"].dtype
    for k in ("dense", "labels"):
        for x, y in zip(got[k], ref[k]):
            np.testing.assert_array_equal(x, y)


def _big_batch(mod):
    big = np.array([2 ** 63 + 5, 1], dtype=np.uint64)
    return mod.PersiaBatch(
        [mod.IDTypeFeatureWithSingleID("a", big), mod.IDTypeFeatureWithSingleID("b", np.array([0, 1], np.uint64))],
        non_id_type_features=[mod.NonIDTypeFeature(np.zeros((2, 4), np.float32))],
        labels=[mod.Label(np.zeros((2, 1), np.float32))], requires_grad=True,
    )


@pytest.mark.parametrize("fold", [False, True])
def test_out_of_vocab_ids_rejected_or_folded(fold):
    specs = {k: FusedSlotSpec(vocab=v, dim=8) for k, v in VOCABS.items()}
    jspecs = {k: JSpec(vocab=v, dim=8) for k, v in VOCABS.items()}
    if not fold:
        with pytest.raises(ValueError, match="outside"):
            tctx_mod.batch_to_fused(_big_batch(tdata), specs)
        return
    got = tctx_mod.batch_to_fused(_big_batch(tdata), specs, fold_ids=True)
    ref = jctx_mod.batch_to_fused(_big_batch(jdata), jspecs, fold_ids=True)
    np.testing.assert_array_equal(got["ids"]["a"], ref["ids"]["a"])
    assert got["ids"]["a"][0] == (2 ** 63 + 5) % 64
    t = _ctx()
    t.fold_ids = True
    assert np.isfinite(t.train_step(_big_batch(tdata))["loss"])


@pytest.mark.parametrize("depth,k", [(3, 1), (4, 2), (1, 1)])
def test_train_pipelined_equals_train_step_loop(depth, k):
    """The pipelined drive lands on the ``train_step`` loop's state bit for
    bit (k > 1 too: the K-step program runs the same operations), drains
    its window, and reports its stats."""
    batches = [_batch(tdata, i) for i in range(9)]
    seq = _ctx()
    for b in batches:
        seq.train_step(b, fetch_metrics=False)
    pipe = _ctx()
    m = pipe.train_pipelined(batches, pipeline_depth=depth, dispatch_k=k)
    st = pipe.pipeline_stats()
    assert st["pipeline_depth"] == depth and st["pipeline_drains"] >= 1 and st["wall_s"] > 0
    assert len(m["losses"]) == 9 and m["loss"] == m["losses"][-1]
    for i, (x, y) in enumerate(zip(fused_state_to_flax(seq.state)[1], fused_state_to_flax(pipe.state)[1])):
        np.testing.assert_array_equal(x, y, err_msg=f"leaf {i}")


def test_train_pipelined_feed_error_propagates():
    """An exception in the feed thread surfaces from ``train_pipelined``
    instead of hanging the dense loop."""
    def bad_stream():
        yield _batch(tdata, 0)
        yield _batch(tdata, 1)
        raise RuntimeError("loader died")

    with pytest.raises(RuntimeError, match="loader died"):
        _ctx().train_pipelined(bad_stream(), pipeline_depth=2)


def test_labels_of_the_ctx_surface():
    t = _ctx()
    assert t.last_metrics() is None and t.pipeline_stats() is None
    assert t.train_pipelined([]) == {}
    assert t.sync_mode == "local" and t.dense_wire_bytes_per_step() == 0
    t.train_step(_batch(tdata, 0), fetch_metrics=False)
    assert np.isfinite(t.last_metrics()["loss"])


def test_train_pipelined_runs_again():
    """A second ``train_pipelined`` call with the same (depth, k) trains all
    its batches in the port. The reference's returns {} and trains nothing
    (its cached pipeline keeps the aborted window of the first run): a
    fault of the reference the port does not copy."""
    t = _ctx()
    t.train_pipelined([_batch(tdata, i) for i in range(2)], pipeline_depth=2)
    m = t.train_pipelined([_batch(tdata, i) for i in range(2, 6)], pipeline_depth=2)
    assert len(m["losses"]) == 4 and int(t.state.step) == 6
    j = _jctx()
    j.train_pipelined([_batch(jdata, i) for i in range(2)], pipeline_depth=2)
    assert j.train_pipelined([_batch(jdata, i) for i in range(2, 6)], pipeline_depth=2) == {}
    assert int(j.state.step) == 2
