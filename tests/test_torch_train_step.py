"""The port's train step (``parallel/train_step.py``) against the
reference's jitted step: one step from the same parameters and batch gives
the same loss, predictions, per-slot embedding gradients and post-Adam
parameters; the dynamic loss scale skips, backs off and grows the same
way. The batch has every kind of slot: two host-pooled, one device-pooled
(two ids per sample, sqrt scaling) and one raw."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from persia_tpu.models import DLRM as JaxDLRM
from persia_tpu.parallel import train_step as jts
from persia_tpu_torch.models import DLRM
from persia_tpu_torch.ops.embedding_pool import pool_csr
from persia_tpu_torch.parallel import train_step as tts
from persia_tpu_torch.weights import seeded_flax_params_like, state_dict_from_flax

B, DIM, BOTTOM, TOP = 32, 16, (32, 16), (64, 32)


def _host_batch(seed, nan_dense=False):
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((B, 13)).astype(np.float32)
    if nan_dense:
        dense[3, 5] = np.nan
    pool_index = rng.integers(0, 11, (B, 2)).astype(np.int32)
    pool_index[::5, 1] = 11  # pads at row D = 11
    pool_counts = (pool_index != 11).sum(1, keepdims=True).astype(np.int32)
    raw_index = rng.integers(0, 8, (B, 4)).astype(np.int32)
    raw_index[::3, 2:] = 7  # pad row P - 1
    pooled_distinct = np.zeros((16, DIM), np.float32)
    pooled_distinct[:11] = rng.standard_normal((11, DIM)) * 0.1
    raw_distinct = np.zeros((8, DIM), np.float32)
    raw_distinct[:7] = rng.standard_normal((7, DIM)) * 0.1
    return {
        "dense": [dense],
        "labels": [rng.integers(0, 2, (B, 1)).astype(np.float32)],
        "emb": [
            {"pooled": (rng.standard_normal((B, DIM)) * 0.1).astype(np.float32)},
            {"distinct": pooled_distinct, "pool_index": pool_index, "pool_counts": pool_counts},
            {"pooled": (rng.standard_normal((B, DIM)) * 0.1).astype(np.float32)},
            {"distinct": raw_distinct, "index": raw_index, "mask": raw_index != 7},
        ],
    }


def _torch_batch(h):
    t = torch.from_numpy
    emb = []
    for e in h["emb"]:
        d = {k: t(np.ascontiguousarray(v)) for k, v in e.items()}
        if "pool_index" in e:
            d["pool_order"], d["pool_offsets"] = (t(a) for a in pool_csr(e["pool_index"], len(e["distinct"])))
        emb.append(d)
    return {"dense": [t(x) for x in h["dense"]], "labels": [t(x) for x in h["labels"]], "emb": emb}


def _jax_batch(h):
    return jax.tree.map(jnp.asarray, h)


def _pair(compute, dynamic=False, growth_interval=2000):
    model = DLRM(13, 4, DIM, BOTTOM, TOP, compute_dtype=compute, device="cpu")
    params = seeded_flax_params_like(model, 7)
    model.load_state_dict(state_dict_from_flax(model, params))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    kw = dict(dynamic_loss_scale=dynamic, growth_interval=growth_interval)
    tstate = tts.init_train_state(model, opt, loss_scale_init=2.0 ** 15 if dynamic else None)
    tstep = tts.build_train_step(model, opt, **kw)

    jmodel = JaxDLRM(embedding_dim=DIM, bottom_mlp=BOTTOM, top_mlp=TOP,
                     compute_dtype=jnp.float32 if compute == torch.float32 else jnp.bfloat16)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jts.TrainState(
        params=jparams, batch_stats={}, opt_state=optax.adam(1e-3).init(jparams),
        step=jnp.zeros((), jnp.int32),
        loss_scale=jts.LossScaleState(scale=jnp.asarray(2.0 ** 15, jnp.float32),
                                      good_steps=jnp.zeros((), jnp.int32)) if dynamic else None,
    )
    jstep = jts.build_train_step(jmodel, optax.adam(1e-3), **kw)
    return (model, tstate, tstep), (jstate, jstep)


def _params_close(model, jparams, **tol):
    ref = state_dict_from_flax(model, jax.tree.map(np.asarray, jparams))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), err_msg=k, **tol)


def test_one_step_matches_reference_f32():
    """f32 compute: loss, predictions, every slot's gradient and the
    post-Adam parameters to rtol 1e-5 (sums in other orders)."""
    (model, tstate, tstep), (jstate, jstep) = _pair(torch.float32)
    h = _host_batch(0)
    tb, jb = _torch_batch(h), _jax_batch(h)
    header, gpacked = tstep(tstate, tb)
    jstate, (jheader, jgpacked) = jstep(jstate, jb)
    loss, preds, grads = tts.unpack_step_output(header.numpy(), gpacked.numpy(), tb)
    jloss, jpreds, jgrads = jts.unpack_step_output(np.asarray(jheader), np.asarray(jgpacked), jb)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    np.testing.assert_allclose(preds, jpreds, rtol=1e-5, atol=1e-6)
    assert [g.shape for g in grads] == [g.shape for g in jgrads]
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g, jg, rtol=1e-5, atol=1e-7)
    assert tstate.step == 1
    _params_close(model, jstate.params, rtol=1e-5, atol=1e-7)


def test_one_step_matches_reference_bf16():
    """bf16 compute, the default: the frameworks round to bf16 at other
    points; loss and predictions to 2e-2, as the serving tests hold them."""
    (model, tstate, tstep), (jstate, jstep) = _pair(torch.bfloat16)
    h = _host_batch(1)
    tb, jb = _torch_batch(h), _jax_batch(h)
    header, gpacked = tstep(tstate, tb)
    _, (jheader, _) = jstep(jstate, jb)
    loss, preds = tts.unpack_step_header(header.numpy(), tb)
    jloss, jpreds = jts.unpack_step_header(np.asarray(jheader), jb)
    assert abs(loss - jloss) <= 2e-2
    np.testing.assert_allclose(preds, jpreds, rtol=0, atol=2e-2)
    assert gpacked.dtype == torch.float32 and gpacked.numel() == sum(
        int(np.prod((e["pooled"] if "pooled" in e else e["distinct"]).shape)) for e in h["emb"])


def test_dynamic_loss_scale_matches_reference():
    """Good step, overflow (a NaN dense feature: the update is skipped, the
    scale backs off, good_steps resets), then two good steps that grow the
    scale at growth_interval=2. Scale and good_steps exact; a skipped step
    leaves the parameters bit for bit as they were."""
    (model, tstate, tstep), (jstate, jstep) = _pair(torch.float32, dynamic=True, growth_interval=2)
    for i, nan in enumerate((False, True, False, False)):
        h = _host_batch(10 + i, nan_dense=nan)
        tb, jb = _torch_batch(h), _jax_batch(h)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        header, gpacked = tstep(tstate, tb)
        jstate, (jheader, jgpacked) = jstep(jstate, jb)
        loss, preds, scale, finite = tts.unpack_step_header_dynamic(header.numpy(), tb)
        jloss, jpreds, jscale, jfinite = jts.unpack_step_header_dynamic(np.asarray(jheader), jb)
        assert (scale, finite) == (jscale, jfinite) and finite == (not nan)
        assert tstate.loss_scale.scale == float(jstate.loss_scale.scale)
        assert tstate.loss_scale.good_steps == int(jstate.loss_scale.good_steps)
        if nan:
            assert np.isnan(loss) and np.isnan(jloss)
            for k, v in model.state_dict().items():
                assert torch.equal(v, before[k])
        else:
            np.testing.assert_allclose(loss, jloss, rtol=1e-5)
            np.testing.assert_allclose(preds, jpreds, rtol=1e-5, atol=1e-6)
            for g, jg in zip(tts.unpack_step_grads(gpacked.numpy(), tb),
                             jts.unpack_step_grads(np.asarray(jgpacked), jb)):
                np.testing.assert_allclose(g, jg, rtol=1e-5, atol=1e-3)  # scaled by 2^15
        _params_close(model, jstate.params, rtol=1e-5, atol=1e-7)
    assert [tstate.loss_scale.scale, tstate.step] == [2.0 ** 15, 4]


@pytest.mark.parametrize("max_scale", [2.0 ** 15, 2.0 ** 24])
def test_loss_scale_clips_at_max(max_scale):
    (model, tstate, tstep), _ = _pair(torch.float32, dynamic=True, growth_interval=1)
    tstep = tts.build_train_step(model, tstate.optimizer, dynamic_loss_scale=True, growth_interval=1,
                                 max_scale=max_scale)
    tstep(tstate, _torch_batch(_host_batch(3)))
    assert tstate.loss_scale.scale == min(2.0 ** 16, max_scale)


@pytest.mark.parametrize("loss", [float("nan"), float("inf"), 0.25])
def test_unpacked_loss_runs_the_nonfinite_guard(caplog, loss):
    """``unpack_step_header`` and ``unpack_step_header_dynamic`` pass the
    host loss through ``_note_nonfinite_loss``, as the reference does
    (``persia_tpu/parallel/train_step.py:294,304``): a NaN or Inf loss logs
    the port's warning once for each, a finite one nothing."""
    batch = {"labels": [np.zeros((4, 1), np.float32)]}
    header = np.array([loss, 0.1, 0.2, 0.3, 0.4], np.float32)
    dynamic = np.array([loss, 2.0 ** 15, 1.0, 0.1, 0.2, 0.3, 0.4], np.float32)
    with caplog.at_level("WARNING", logger="persia_tpu_torch.train_step"):
        got, preds = tts.unpack_step_header(header, batch)
        got_d, preds_d, scale, finite = tts.unpack_step_header_dynamic(dynamic, batch)
    np.testing.assert_array_equal([got, got_d], [loss, loss])
    np.testing.assert_array_equal(preds, preds_d)
    assert preds.shape == (4, 1) and (scale, finite) == (2.0 ** 15, True)
    warned = [r for r in caplog.records if "non-finite loss" in r.getMessage()]
    assert len(warned) == (0 if np.isfinite(loss) else 2)
