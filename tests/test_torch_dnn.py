"""DNN, the adult-income model, on the port's hybrid tier against
``persia_tpu``'s on the same numpy-seeded inputs and carried-over weights:

- the model (``persia_tpu_torch.models.DNN`` vs ``persia_tpu.models.DNN``)
  in train mode and with the running statistics, bf16 and f32: logits, the
  new ``batch_stats``, the gradients of the parameters and the embedding
  inputs; flax's module paths; the raw slot's masked sum;
- ``TrainCtx`` over 5 steps (host-pooled and ``device_pooling=True``, the
  f32 and the bf16 wire, f32 and bf16 compute): losses, predictions, the
  dense parameters, ``batch_stats`` and every PS entry; a dynamic-loss-
  scale overflow step, which skips the dense update but still moves the
  statistics, as the reference's does; ``eval_batch`` on the running
  statistics;
- durable state: a reference ``TrainState`` with statistics loads into the
  port, the port's bytes load into the reference
  (``flax.serialization.from_bytes``), a reference checkpoint serves through
  ``InferCtx`` and ``InferenceEngine``, checkpoints round-trip, a killed and
  resumed run ends bit for bit on the uninterrupted one, the reproducible
  staleness-1 loader equals ``train_step``;
- the adult-income example's configuration for its 4 epochs, its test AUC
  within 5e-3 of the reference's pinned ``REPRODUCIBLE_AUC``, from the
  reference's initial weights (``persia_tpu_torch/testing/
  adult_income_init.msgpack``, which a test holds to what the reference
  draws today; ``python tests/test_torch_dnn.py`` writes it anew).

Tolerances as ``tests/test_torch_train_ctx.py`` states them: f32 compute
and an f32 wire 1e-5 relative (sums in other orders); bf16 compute with the
bf16 wire, losses and predictions 2e-2, dense parameters and statistics
1e-2; the biases of the two Dense layers that feed a batch norm, whose true
gradient is 0, within Adam's step bound (``NOISE_BIASES``); the model's
bf16 gradients and the PS entries under bf16 compute as
``test_dnn_matches_reference`` and ``test_train_ctx_bf16_compute`` state.
"""

import pathlib
import sys
import types

import flax.linen
import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import persia_tpu.config as jcfg
import persia_tpu.data as jdata
import persia_tpu.testing.synthetic as jsynth
from persia_tpu.ctx import InferCtx as JaxInferCtx
from persia_tpu.ctx import TrainCtx as JaxTrainCtx
from persia_tpu.embedding import optim as joptim
from persia_tpu.embedding.store import EmbeddingStore as JaxStore
from persia_tpu.embedding.worker import EmbeddingWorker as JaxWorker
from persia_tpu.models import DNN as JaxDNN
from persia_tpu.parallel.train_step import LossScaleState as JaxLossScale
from persia_tpu.parallel.train_step import TrainState as JaxTrainState
import persia_tpu_torch.config as tcfg
from persia_tpu_torch import jobstate as tjob
from persia_tpu_torch.ctx import InferCtx, TrainCtx
from persia_tpu_torch.data import PersiaBatch
from persia_tpu_torch.data_loader import DataLoader
from persia_tpu_torch.embedding import optim as toptim
from persia_tpu_torch.embedding.native_store import create_store
from persia_tpu_torch.embedding.store import EmbeddingStore
from persia_tpu_torch.embedding.worker import EmbeddingWorker
from persia_tpu_torch.models import DNN
from persia_tpu_torch.models import dnn as dnn_module
from persia_tpu_torch.serialization import msgpack_serialize
from persia_tpu_torch.serving.engine import InferenceEngine
from persia_tpu_torch.testing import adult_income
from persia_tpu_torch.weights import (
    batch_stats_to_flax,
    flax_leaves,
    model_from_flax_bytes,
    seeded_batch_stats_like,
    seeded_flax_params_like,
    state_dict_from_flax,
    state_dict_to_flax,
    stats_leaves,
    train_state_from_flax_bytes,
    train_state_to_flax_bytes,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
VOCABS, DIM, DENSE, B, STEPS = (64, 32, 16, 100), 8, 5, 32, 5
DENSE_MLP, SPARSE_MLP, HIDDEN = 8, 16, (32,)
SEQ = ("hist", 64, 8)
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
TIGHT = dict(rtol=1e-5, atol=1e-6)
# f32 through a batch norm in train mode: (z - mean) * rstd turns the sums'
# relative error into one |mean| / std times larger (measured on the
# predictions: 1.2e-5 relative)
TIGHT_BN = dict(rtol=5e-5, atol=5e-6)


def _slots(seq):
    return len(VOCABS) + (1 if seq else 0)


def _models(compute=torch.float32, seq=False, seed=11):
    """(port model, reference model, params) on the same seeded weights."""
    model = DNN(DENSE, [DIM] * _slots(seq), DENSE_MLP, SPARSE_MLP, HIDDEN, compute_dtype=compute, device="cpu")
    params = seeded_flax_params_like(model, seed)
    model.load_state_dict(state_dict_from_flax(model, params))
    jmodel = JaxDNN(dense_mlp_size=DENSE_MLP, sparse_mlp_size=SPARSE_MLP, hidden_sizes=HIDDEN,
                    compute_dtype=JDT[compute])
    return model, jmodel, params


def _host(tree):
    return jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.float32)), tree)


# --------------------------------------------------------------- the model


def test_flax_paths_are_the_references():
    model, jmodel, _ = _models()
    v = jmodel.init(jax.random.PRNGKey(0), [jnp.zeros((4, DENSE))], [jnp.zeros((4, DIM))] * len(VOCABS),
                    train=False)
    leaves = lambda tree: sorted(jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(tree))  # noqa: E731
    mine = {"params": {}, "batch_stats": {}}
    for path, p, transposed in flax_leaves(model):
        mine["params"]["/".join(path)] = tuple(p.shape[::-1] if transposed else p.shape)
    for path, t in stats_leaves(model):
        mine["batch_stats"]["/".join(path)] = tuple(t.shape)
    for coll in ("params", "batch_stats"):
        theirs = {"/".join(k.key for k in p): tuple(a.shape) for p, a in jax.tree_util.tree_leaves_with_path(v[coll])}
        assert mine[coll] == theirs
    assert leaves(batch_stats_to_flax(model)) == leaves(v["batch_stats"])
    assert [p for p, _ in model.flax_modules()][:4] == [("Dense_0",), ("BatchNorm_0",), ("Dense_1",),
                                                        ("BatchNorm_1",)]


def _model_inputs(seed, seq):
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((B, DENSE)).astype(np.float32)
    embs = [(0.3 * rng.standard_normal((B, DIM))).astype(np.float32) for _ in VOCABS]
    raw = None
    if seq:
        raw = ((0.3 * rng.standard_normal((B, SEQ[2], DIM))).astype(np.float32),
               rng.random((B, SEQ[2])) < 0.6)
        raw[1][0] = False  # an empty row
    w = rng.standard_normal((B, 1)).astype(np.float32)
    return dense, embs, raw, w


def _reference_run(jmodel, params, stats, inputs, train, seq):
    """The reference model's logits, new statistics and the gradients of
    ``sum(logits * w)`` by its parameters, the pooled and the raw slot."""
    dense, embs, raw, w = inputs
    jstats = jax.tree.map(jnp.asarray, stats)

    def f(p, e, r):
        model_emb = list(e) + ([(r, jnp.asarray(raw[1]))] if seq else [])
        variables = {"params": p, "batch_stats": jstats}
        if train:
            return jmodel.apply(variables, [jnp.asarray(dense)], model_emb, train=True, mutable=["batch_stats"])
        return jmodel.apply(variables, [jnp.asarray(dense)], model_emb, train=False), {}

    jr = jnp.asarray(raw[0]) if seq else jnp.zeros(())
    (logits, upd), vjp = jax.vjp(f, jax.tree.map(jnp.asarray, params), [jnp.asarray(e) for e in embs], jr)
    dparams, dembs, draw = vjp((jnp.asarray(w), jax.tree.map(jnp.zeros_like, upd)))
    out = {"logits": np.asarray(logits), "raw": np.asarray(draw, np.float32)}
    out.update({f"slot {i}": np.asarray(g, np.float32) for i, g in enumerate(dembs)})
    host = _host(dparams)
    out.update({f"{a}/{b}": v for a, layer in host.items() for b, v in layer.items()})
    return out, (_host(upd["batch_stats"]) if train else stats)


@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("seq", [False, True])
def test_dnn_matches_reference(compute, train, seq, monkeypatch):
    """f32: logits, statistics and gradients to 1e-5 of the reference's
    (a tensor's scale: its largest gradient, or a tenth of the model's
    largest where that is more: the bias of a Dense that feeds a batch norm
    in train mode has a true gradient of 0, rounding noise on both sides).
    bf16: logits within 2e-2 and the statistics within 1e-2 of the
    reference's bf16 ones; each gradient within 3e-2 of its scale of the
    reference's f32 gradient taken at the port's bf16 relu masks (measured:
    2.04e-2, the noise bias ``Dense_0/bias``; 6.9e-3 past it). A bf16
    forward can give a hidden pre-activation near 0 the other sign, and
    relu then zeroes or passes a whole cotangent entry: each framework
    flips its own entries
    (``test_the_references_bf16_stray_is_its_own_relu_flip``), so neither
    bf16 run is held to the other's gradients, and the masks are the
    port's."""
    model, jmodel, params = _models(compute, seq)
    stats = seeded_batch_stats_like(model, 12)
    model.load_state_dict(state_dict_from_flax(model, params, stats))
    inputs = _model_inputs(3, seq)
    dense, embs, raw, w = inputs
    want, want_stats = _reference_run(jmodel, params, stats, inputs, train, seq)

    model.train(train)
    leaves = [torch.from_numpy(e).requires_grad_(True) for e in embs]
    t_raw = torch.from_numpy(raw[0]).requires_grad_(True) if seq else None
    masks = []  # the port's relu masks, in call order

    def relu(x):
        masks.append(x.detach() > 0)
        return F.relu(x)

    monkeypatch.setattr(dnn_module, "F", types.SimpleNamespace(relu=relu))
    out = model([torch.from_numpy(dense)], leaves + ([(t_raw, torch.from_numpy(raw[1]))] if seq else []))
    monkeypatch.undo()
    out.backward(torch.from_numpy(w))
    gp = state_dict_to_flax(model, lambda p: p.grad)
    got = {"logits": out.detach().numpy(), **{f"slot {i}": l.grad.numpy() for i, l in enumerate(leaves)}}
    got.update({"/".join(path): gp[path[0]][path[1]] for path, _, _ in flax_leaves(model)})
    if seq:
        got["raw"] = t_raw.grad.numpy()
        assert not t_raw.grad[0].any()  # the empty row's positions get nothing

    bf16 = compute == torch.bfloat16
    np.testing.assert_allclose(got["logits"], want["logits"], **(dict(rtol=0, atol=2e-2) if bf16 else TIGHT))
    got_stats = batch_stats_to_flax(model)
    for path, _ in stats_leaves(model):
        a, b = got_stats[path[0]][path[1]], want_stats[path[0]][path[1]]
        if train:
            np.testing.assert_allclose(a, b, **(dict(rtol=0, atol=1e-2) if bf16 else TIGHT), err_msg="/".join(path))
        else:  # the running statistics stay as they were
            np.testing.assert_array_equal(a, b)
    grads = [k for k in want if k != "logits" and (seq or k != "raw")]
    if bf16:  # the reference in f32, each relu taking the port's bf16 mask in turn
        it = iter([jnp.asarray(m.numpy(), jnp.float32) for m in masks])
        monkeypatch.setattr(flax.linen, "relu", lambda x: x * next(it))
        want = _reference_run(_models(torch.float32, seq)[1], params, stats, inputs, train, seq)[0]
        monkeypatch.undo()
    floor = 0.1 * max(np.abs(want[k]).max() for k in grads)
    for k in grads:
        scale = max(np.abs(want[k]).max(), floor)
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=(3e-2 if bf16 else 1e-5) * scale, err_msg=k)


def test_the_references_bf16_stray_is_its_own_relu_flip(monkeypatch):
    """Why the port's bf16 gradients are held to the reference's f32 ones at
    the port's masks and not to the reference's bf16 ones: in train mode the
    reference's bf16 forward gives some hidden pre-activation the other
    sign than its f32 forward does, and relu zeroes or passes a whole
    cotangent entry. Its bf16 gradients are more than 0.1 of their scale
    from its f32 ones, and within 3e-2 of the f32 ones taken at its own
    bf16 relu masks, but for the biases of the Dense layers that feed a
    batch norm, whose true gradient is 0 and whose value is each side's
    rounding."""
    _, jmodel, params = _models(torch.bfloat16)
    _, jmodel32, _ = _models(torch.float32)
    stats = seeded_batch_stats_like(_models()[0], 12)
    inputs = _model_inputs(3, False)
    dense, embs, _, _ = inputs

    def masks_of(module):
        out = []
        monkeypatch.setattr(flax.linen, "relu", lambda x: out.append(np.asarray(x) > 0) or jax.nn.relu(x))
        module.apply({"params": params, "batch_stats": stats}, [jnp.asarray(dense)], [jnp.asarray(e) for e in embs],
                     train=True, mutable=["batch_stats"])
        monkeypatch.undo()
        return out

    bf16_masks, f32_masks = masks_of(jmodel), masks_of(jmodel32)
    assert sum(int((a != b).sum()) for a, b in zip(bf16_masks, f32_masks)) >= 1
    bf16 = _reference_run(jmodel, params, stats, inputs, True, False)[0]
    truth = _reference_run(jmodel32, params, stats, inputs, True, False)[0]
    it = iter([jnp.asarray(m, jnp.float32) for m in bf16_masks])
    monkeypatch.setattr(flax.linen, "relu", lambda x: x * next(it))
    at_masks = _reference_run(jmodel32, params, stats, inputs, True, False)[0]
    monkeypatch.undo()
    grads = [k for k in truth if k not in ("logits", "raw")]
    floor = 0.1 * max(np.abs(truth[k]).max() for k in grads)

    def stray(want, keys):
        return max(np.abs(bf16[k] - want[k]).max() / max(np.abs(want[k]).max(), floor) for k in keys)

    assert stray(truth, grads) > 0.1
    assert stray(at_masks, [k for k in grads if k not in NOISE_GRADS]) <= 3e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_raw_slot_is_summed_not_averaged(dtype):
    from persia_tpu_torch.models.layers import masked_sum

    g = torch.arange(2 * 3 * 2, dtype=torch.float32).reshape(2, 3, 2).to(dtype)
    mask = torch.tensor([[True, False, True], [False, False, False]])
    out = masked_sum((g, mask), torch.float32)
    assert out.tolist() == [[0 + 4, 1 + 5], [0, 0]]
    assert masked_sum(g[:, 0], torch.bfloat16).dtype == torch.bfloat16


# ------------------------------------------------------------- TrainCtx


def _cfg(cfg, seq=False):
    slots = {f"cat_{i}": cfg.SlotConfig(dim=DIM) for i in range(len(VOCABS))}
    if seq:
        slots[SEQ[0]] = cfg.SlotConfig(dim=DIM, embedding_summation=False, sample_fixed_size=SEQ[2])
    return cfg.EmbeddingConfig(slots_config=slots, feature_index_prefix_bit=8)


def _batches(n=STEPS, seed=0, seq=False, requires_grad=True):
    data = jsynth.SyntheticClickDataset(num_samples=n * B, num_dense=DENSE, vocab_sizes=VOCABS,
                                        seq_slot=SEQ if seq else None, seed=seed)
    return list(data.batches(B, requires_grad=requires_grad))


def _pair(device_pooling=True, wire_dtype=None, compute=torch.float32, dynamic=False, seq=False,
          loss_scale_init=float(2 ** 15)):
    """(reference ctx, port ctx) on the same weights and statistics, both
    entered."""
    model, jmodel, params = _models(compute, seq)
    stats = seeded_batch_stats_like(model, 12)
    model.load_state_dict(state_dict_from_flax(model, params, stats))
    kw = dict(capacity=1 << 16, num_internal_shards=4, seed=3)
    extra = dict(wire_dtype=wire_dtype, dynamic_loss_scale=dynamic, loss_scale_init=loss_scale_init,
                 loss_scale_growth_interval=2)
    jworker = JaxWorker(_cfg(jcfg, seq), [JaxStore(optimizer=joptim.Adagrad(lr=0.1).config, **kw) for _ in range(2)],
                        device_pooling=device_pooling)
    jctx = JaxTrainCtx(jmodel, optax.adam(1e-3), joptim.Adagrad(lr=0.1), jworker, _cfg(jcfg, seq), **extra)
    jctx.__enter__()
    jparams = jax.tree.map(jnp.asarray, params)
    jctx.state = JaxTrainState(
        params=jparams, batch_stats=jax.tree.map(jnp.asarray, stats), opt_state=optax.adam(1e-3).init(jparams),
        step=jnp.zeros((), jnp.int32),
        loss_scale=JaxLossScale(scale=jnp.asarray(loss_scale_init, jnp.float32),
                                good_steps=jnp.zeros((), jnp.int32)) if dynamic else None,
    )
    tworker = EmbeddingWorker(_cfg(tcfg, seq), [EmbeddingStore(optimizer=toptim.Adagrad(lr=0.1).config, **kw)
                                                for _ in range(2)], device_pooling=device_pooling)
    tctx = TrainCtx(model, torch.optim.Adam(model.parameters(), lr=1e-3), toptim.Adagrad(lr=0.1), tworker,
                    _cfg(tcfg, seq), device="cpu", **extra).__enter__()
    return jctx, tctx


def _step_both(jctx, tctx, batch, tol, preds_tol=None):
    a = jctx.train_step(batch)
    b = tctx.train_step(PersiaBatch.from_bytes(batch.to_bytes()))
    np.testing.assert_allclose(b["loss"], a["loss"], **tol)
    np.testing.assert_allclose(b["preds"], a["preds"], **(preds_tol or tol))
    for k in ("loss_scale", "grads_finite"):
        assert b.get(k) == a.get(k)
    return a, b


# the biases of the Dense layers that feed a batch norm: in train mode the
# norm takes the batch mean out, so their true gradient is 0 and what each
# side computes is rounding noise, which Adam (lr 1e-3) turns into steps of
# about lr in either direction: after T steps the two sides' values differ
# by up to 2 * lr * T (measured: 0.006 after 5), and the running means those
# layers feed, which move by 0.01 of each step's batch mean, by up to
# 0.01 * lr * T * (T + 1) (measured: 1.5e-4)
NOISE_BIASES = ("layers.0.bias", "layers.1.bias")
NOISE_GRADS = ("Dense_0/bias", "Dense_1/bias")  # the same, by flax path
NOISE_MEANS = ("norms.0.mean", "norms.1.mean")


def _rows(ctx):
    """{sign: embedding} of every PS entry of a ctx of either package."""
    out = {}
    for store in ctx.worker.lookup_router.replicas:
        for shard in store._shards:
            out.update({sign: np.asarray(vec[:DIM], np.float32) for sign, (_, vec) in shard.entries.items()})
    return out


# PS entries: (absolute tolerance of the embedding, relative tolerance of
# Adagrad's accumulator). f32: the slots' gradients come out of the batch
# norm's backward, which subtracts the batch's share of each, so their
# relative error grows where that share is most of them (measured: 1.1e-5
# and 1.5e-4 relative)
ENTRY_F32 = (5e-5, 5e-4)


def _compare_final(jctx, tctx, dense_tol, entry_tol):
    jstate = jax.tree.map(np.asarray, jctx.state)
    ref = state_dict_from_flax(tctx.model, jstate.params, jstate.batch_stats)
    t = tctx.state.step
    for k, v in tctx.model.state_dict().items():
        tol = dense_tol
        if k in NOISE_BIASES:
            tol = dict(rtol=0, atol=2 * 1e-3 * t)
        elif k in NOISE_MEANS:
            tol = dict(rtol=0, atol=max(0.01 * 1e-3 * t * (t + 1), dense_tol["atol"]))
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), err_msg=k, **tol)
    if entry_tol is None:
        return
    emb_atol, state_rtol = entry_tol
    for jr, tr in zip(jctx.worker.lookup_router.replicas, tctx.worker.lookup_router.replicas):
        assert jr.size() == tr.size() > 0
        for shard in jr._shards:
            for sign, (_, vec) in shard.entries.items():
                got = tr.get_embedding_entry(sign)
                np.testing.assert_allclose(got[:DIM], vec[:DIM], rtol=0, atol=emb_atol)
                np.testing.assert_allclose(got[DIM:], vec[DIM:], rtol=state_rtol, atol=0)


@pytest.mark.parametrize("device_pooling", [False, True])
@pytest.mark.parametrize("wire_dtype", [None, "bfloat16"])
def test_train_ctx_matches_reference(device_pooling, wire_dtype):
    """f32 compute: losses and predictions to ``TIGHT_BN``, dense
    parameters and statistics to ``TIGHT``, PS entries to ``ENTRY_F32``. With the bf16 wire a
    gradient can round one bf16 ulp apart on the two sides, which moves
    that row's Adagrad(0.1) step by up to 0.1 * 2^-8; the row then crosses
    the wire one bf16 ulp apart (2^-10 at its size), and the batch norm's
    backward, which subtracts the batch's share of a gradient, passes that
    on to the other rows of the batch: losses and predictions 2e-3
    (measured 1.4e-4 and 9.5e-4), dense parameters 1e-4, PS entries 1e-3
    and Adagrad's accumulator 1e-2 relative (measured 1.1e-4 and 2.1e-3).
    Device-pooled, the reference's backward sums a row's gradients in bf16
    (XLA's scatter-add in the wire dtype), the port's in f32 with one
    rounding; at B=32 over a slot of 16 ids a row sums several: entries
    2e-2, the accumulator 0.1 relative (measured 8.1e-3 and 3.7e-2)."""
    jctx, tctx = _pair(device_pooling, wire_dtype)
    for batch in _batches():
        _step_both(jctx, tctx, batch, TIGHT_BN if wire_dtype is None else dict(rtol=0, atol=2e-3))
    if wire_dtype is None:
        _compare_final(jctx, tctx, TIGHT, ENTRY_F32)
    else:
        _compare_final(jctx, tctx, dict(rtol=0, atol=1e-4), (2e-2, 0.1) if device_pooling else (1e-3, 1e-2))


@pytest.mark.parametrize("device_pooling", [False, True])
def test_train_ctx_bf16_compute(device_pooling):
    """bf16 compute with the bf16 wire: losses 2e-2, dense parameters and
    statistics 1e-2. A single prediction is held to 0.1: in bf16 a batch of
    32 normalised by its spread quantises each normalised value to ~0.1 of
    a std, and the noise biases (above) shift which way each rounds, so
    single predictions stray by up to 0.07 (measured) where the loss, their
    mean, strays by 3e-3. The PS rows are not held to the reference's bf16
    rows: each framework's bf16 forward flips the sign of its own hidden
    pre-activations near 0, and relu then passes or zeroes a whole
    cotangent entry (``test_the_references_bf16_stray_is_its_own_relu_flip``:
    more than 0.1 of their scale), which the batch norm's backward spreads
    over the batch; Adagrad(0.1) from its 0.01
    start steps by ~g while |g| < 0.1, so a row takes the gap of its
    gradient whole (measured: 0.127 apart, 66 % of the rows past 5e-3).
    They are held instead to the reference's f32-compute run: at least as
    close to it as the reference's own bf16 rows are, and within 5e-2
    (measured: the port 0.035, the reference 0.147)."""
    jctx, tctx = _pair(device_pooling, "bfloat16", torch.bfloat16)
    for batch in _batches():
        _step_both(jctx, tctx, batch, dict(rtol=0, atol=2e-2), dict(rtol=0, atol=0.1))
    _compare_final(jctx, tctx, dict(rtol=0, atol=1e-2), None)
    # the PS rows against the reference's f32-compute run over the same
    # batches: at least as close as the reference's own bf16 rows
    exact, _ = _pair(device_pooling, "bfloat16", torch.float32)
    for batch in _batches():
        exact.train_step(batch)
    truth, ref_bf16, port = _rows(exact), _rows(jctx), _rows(tctx)
    port_err = max(np.abs(port[k] - truth[k]).max() for k in truth)
    ref_err = max(np.abs(ref_bf16[k] - truth[k]).max() for k in truth)
    assert port_err <= min(ref_err, 5e-2), (port_err, ref_err)


def test_train_ctx_with_a_raw_slot():
    """A raw slot reaches DNN summed over its valid positions, through the
    raw gather and its scatter-add."""
    jctx, tctx = _pair(True, None, seq=True)
    for batch in _batches(seq=True):
        _step_both(jctx, tctx, batch, TIGHT_BN)
    _compare_final(jctx, tctx, TIGHT, ENTRY_F32)


def test_overflow_step_skips_the_update_but_moves_the_statistics():
    """A loss scale past f32's range makes every gradient infinite: the
    dense update is skipped and the scale backs off, on both sides, while
    the batch statistics advance as the forward left them (the reference
    takes ``new_stats`` whatever the finite check says)."""
    jctx, tctx = _pair(dynamic=True, loss_scale_init=3e38)
    before = {k: v.clone() for k, v in tctx.model.state_dict().items()}
    batches = _batches(3)
    a, b = _step_both(jctx, tctx, batches[0], TIGHT_BN)
    assert a["grads_finite"] is False and b["grads_finite"] is False
    after = tctx.model.state_dict()
    for name, v in before.items():  # the statistics moved, nothing else
        assert torch.equal(after[name], v) != name.endswith((".mean", ".var")), name
    assert tctx.state.loss_scale.scale == float(jctx.state.loss_scale.scale) < 3e38
    _compare_final(jctx, tctx, TIGHT, ENTRY_F32)
    for batch in batches[1:]:  # the scale backs off into range and training goes on alike
        _step_both(jctx, tctx, batch, TIGHT_BN)
    _compare_final(jctx, tctx, TIGHT, ENTRY_F32)


def test_eval_batch_uses_the_running_statistics():
    """After 3 steps the port takes the reference's dense state (its
    parameters and statistics; the noise biases above would otherwise
    differ), and ``eval_batch`` gives the reference's predictions, the
    statistics untouched; the next train step is in train mode again."""
    jctx, tctx = _pair()
    for batch in _batches(3):
        _step_both(jctx, tctx, batch, TIGHT_BN)
    train_state_from_flax_bytes(tctx.state, flax.serialization.to_bytes(jctx.state))
    stats = batch_stats_to_flax(tctx.model)
    for batch in _batches(2, seed=9, requires_grad=False):
        want = jctx.eval_batch(batch)
        got = tctx.eval_batch(PersiaBatch.from_bytes(batch.to_bytes()))
        np.testing.assert_allclose(got, want, **TIGHT)
    after = batch_stats_to_flax(tctx.model)
    for name in stats:
        for k in ("mean", "var"):
            np.testing.assert_array_equal(after[name][k], stats[name][k])
    _step_both(jctx, tctx, _batches(1, seed=5)[0], TIGHT_BN)  # back in train mode


# --------------------------------------------------------- durable state


def _trained_pair(steps=3):
    jctx, tctx = _pair()
    for batch in _batches(steps):
        _step_both(jctx, tctx, batch, TIGHT_BN)
    return jctx, tctx


def test_reference_train_state_bytes_load_into_the_port():
    jctx, _ = _trained_pair()
    _, fresh = _pair()
    train_state_from_flax_bytes(fresh.init_state(), flax.serialization.to_bytes(jctx.state))
    jstate = jax.tree.map(np.asarray, jctx.state)
    assert batch_stats_to_flax(fresh.model).keys() == jstate.batch_stats.keys()
    for name, st in jstate.batch_stats.items():
        for k in ("mean", "var"):
            np.testing.assert_array_equal(batch_stats_to_flax(fresh.model)[name][k], st[k])
    ref = state_dict_from_flax(fresh.model, jstate.params, jstate.batch_stats)
    for k, v in fresh.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), ref[k].numpy(), err_msg=k)
    assert fresh.state.step == int(jstate.step) == 3


def test_port_bytes_load_into_the_reference():
    jctx, tctx = _trained_pair()
    restored = flax.serialization.from_bytes(jctx.state, train_state_to_flax_bytes(tctx.state))
    mine = jax.tree.map(np.asarray, restored)
    assert int(mine.step) == tctx.state.step == 3
    for name, st in mine.batch_stats.items():
        for k in ("mean", "var"):
            np.testing.assert_array_equal(st[k], batch_stats_to_flax(tctx.model)[name][k])
    want = state_dict_to_flax(tctx.model)
    for name, layer in mine.params.items():
        for k, v in layer.items():
            np.testing.assert_array_equal(v, want[name][k])
    # the restored state steps on in the reference as the port's own does
    batch = _batches(1, seed=7)[0]
    jctx.state = restored
    a, b = jctx.train_step(batch), tctx.train_step(PersiaBatch.from_bytes(batch.to_bytes()))
    np.testing.assert_allclose(b["loss"], a["loss"], **TIGHT_BN)


def test_reference_checkpoint_serves_through_infer_ctx(tmp_path):
    """A reference DNN checkpoint (``dump_checkpoint``: the dense state as
    flax's bytes, the tables) serves through the port's ``InferCtx`` and
    ``InferenceEngine``: the reference's predictions."""
    jctx, _ = _trained_pair()
    jctx.dump_checkpoint(str(tmp_path / "ckpt"))
    from persia_tpu_torch.checkpoint import load_dense

    model = DNN(DENSE, [DIM] * len(VOCABS), DENSE_MLP, SPARSE_MLP, HIDDEN, torch.float32, device="cpu")
    model_from_flax_bytes(model, load_dense(str(tmp_path / "ckpt")))
    worker = EmbeddingWorker(_cfg(tcfg), [EmbeddingStore(capacity=1 << 16, num_internal_shards=4, seed=3)
                                          for _ in range(2)])
    worker.load(str(tmp_path / "ckpt"))
    engine = InferenceEngine(InferCtx(model, worker, _cfg(tcfg), device="cpu"), device="cpu")
    jinfer = JaxInferCtx(jctx.model, jctx.state, jctx.worker, _cfg(jcfg))
    for batch in _batches(2, seed=11, requires_grad=False):
        np.testing.assert_allclose(engine.predict_from_bytes(batch.to_bytes()), jinfer.predict(batch), **TIGHT)
    assert engine.forwards == 2
    with pytest.raises(ValueError):  # a model without batch norms has no place for the statistics
        from persia_tpu_torch.models import DLRM

        model_from_flax_bytes(DLRM(DENSE, 4, 16, (16,), (16,), device="cpu"),
                              load_dense(str(tmp_path / "ckpt")))


def test_checkpoint_round_trip_carries_the_statistics(tmp_path):
    _, tctx = _trained_pair()
    tctx.dump_checkpoint(str(tmp_path / "ckpt"))
    _, fresh = _pair()
    fresh.load_checkpoint(str(tmp_path / "ckpt"))
    assert train_state_to_flax_bytes(fresh.state) == train_state_to_flax_bytes(tctx.state)
    batch = _batches(1, seed=8)[0]
    a, b = tctx.train_step(batch), fresh.train_step(batch)
    assert a["loss"] == b["loss"]


def _port_ctx(stores, compute=torch.bfloat16, wire_dtype="bfloat16"):
    model, _, params = _models(compute)
    worker = EmbeddingWorker(_cfg(tcfg), stores, device_pooling=True)
    return TrainCtx(model, torch.optim.Adam(model.parameters(), lr=1e-3), toptim.Adagrad(lr=0.1), worker,
                    _cfg(tcfg), device="cpu", wire_dtype=wire_dtype).__enter__()


def _stores(backend):
    return [create_store(backend, capacity=1 << 16, num_internal_shards=4, seed=3) for _ in range(2)]


def _dumps(stores):
    return [st.dump_shard(i) for st in stores for i in range(st.num_internal_shards)]


@pytest.mark.parametrize("backend", ["numpy", "native"])
def test_kill_resume_bit_identical(tmp_path, backend):
    """Snapshots every 4 steps, the trainer abandoned after 9; a fresh ctx
    resumed on the surviving stores replays to 12 and ends bit for bit on
    the uninterrupted run: parameters, statistics, Adam's moments (the dense
    bytes) and every PS shard."""
    batches = _batches(12, seed=21)
    base_stores = _stores(backend)
    base = _port_ctx(base_stores)
    for b in batches:
        base.train_step(b)
    mgr = tjob.JobStateManager(str(tmp_path / "js"))
    stores = _stores(backend)
    ctx1 = _port_ctx(stores)
    ctx1.resume(mgr)
    for i, b in enumerate(batches[:9]):
        ctx1.train_step(b)
        if (i + 1) % 4 == 0:
            ctx1.snapshot_job(mgr)
    del ctx1
    ctx2 = _port_ctx(stores)
    m = ctx2.resume(mgr)
    assert m.step == 8
    stats_at_fence = batch_stats_to_flax(ctx2.model)
    assert any(not np.array_equal(v["var"], np.ones_like(v["var"])) for v in stats_at_fence.values())
    for b in batches[m.step:]:
        ctx2.train_step(b)
    assert train_state_to_flax_bytes(ctx2.state) == train_state_to_flax_bytes(base.state)
    assert _dumps(stores) == _dumps(base_stores)


def test_journal_resume_exactly_once(tmp_path):
    batches = _batches(7, seed=22)
    mgr = tjob.JobStateManager(str(tmp_path / "js"))
    stores = _stores("native")
    ctx1 = _port_ctx(stores)
    ctx1.resume(mgr)
    for i, b in enumerate(batches):
        ctx1.train_step(b)
        if i == 3:
            ctx1.snapshot_job(mgr)
    del ctx1
    ctx2 = _port_ctx(stores)
    assert ctx2.resume(mgr, restore_ps=False).step == 4
    for b in batches[4:]:
        ctx2.train_step(b)
    assert ctx2.worker.lookup_router.journal_skips >= 3


def test_reproducible_loader_matches_train_step():
    batches = _batches(4, seed=23)
    sync = _port_ctx(_stores("native"))
    want = [sync.train_step(b) for b in batches]
    pipe = _port_ctx(_stores("native"))
    loader = DataLoader(iter(batches), pipe, num_workers=2, staleness=1, reproducible=True)
    got = [pipe.train_step_prepared(tb, loader) for tb in loader]
    loader.flush()
    loader.shutdown()
    for a, b in zip(want, got):
        assert a["loss"] == b["loss"]
        np.testing.assert_array_equal(a["preds"], b["preds"])
    assert train_state_to_flax_bytes(pipe.state) == train_state_to_flax_bytes(sync.state)
    assert _dumps(pipe.worker.lookup_router.replicas) == _dumps(sync.worker.lookup_router.replicas)


# ----------------------------------------------------------- adult income


def _reference_init():
    """The reference example's initial DNN variables: its model's ``init``
    with the key its ``TrainCtx`` uses (``jax.random.PRNGKey(0)``) over the
    first batch's shapes."""
    model = JaxDNN(dense_mlp_size=adult_income.DENSE_MLP, sparse_mlp_size=adult_income.SPARSE_MLP,
                   hidden_sizes=adult_income.HIDDEN)
    b = adult_income.BATCH
    v = model.init(jax.random.PRNGKey(0), [jnp.zeros((b, adult_income.DENSE_DIM))],
                   [jnp.zeros((b, adult_income.DIM))] * len(adult_income.VOCABS), train=False)
    return jax.tree.map(np.asarray, {"params": v["params"], "batch_stats": v["batch_stats"]})


def _init_bytes() -> bytes:
    v = _reference_init()
    return msgpack_serialize({"params": state_dict_sorted(v["params"]), "batch_stats": state_dict_sorted(
        v["batch_stats"])})


def state_dict_sorted(tree):
    return {k: state_dict_sorted(tree[k]) if isinstance(tree[k], dict) else tree[k] for k in sorted(tree)}


def test_adult_income_init_is_the_references():
    """The committed initial weights are what the reference draws today,
    and its example's constants are the port's."""
    import importlib.util

    assert adult_income.INIT_FILE.read_bytes() == _init_bytes()
    spec = importlib.util.spec_from_file_location("adult_train", ROOT / "examples" / "adult_income" / "train.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    assert tuple(ref.VOCABS) == adult_income.VOCABS and ref.EPOCHS == adult_income.EPOCHS
    assert adult_income.reference_auc(ROOT) == ref.REPRODUCIBLE_AUC


def test_adult_income_auc_is_the_references():
    """The example's 4 epochs through the port on the CPU: the final test
    AUC within 5e-3 of the reference's pinned one."""
    ctx, _ = adult_income.build_ctx("cpu")
    epochs = adult_income.train(ctx)
    auc = epochs[-1][1]
    assert len(epochs) == 4 and all(np.isfinite(np.mean(losses)) for losses, _ in epochs)
    assert abs(auc - adult_income.reference_auc(ROOT)) <= 5e-3, auc
    assert epochs[-1][1] > epochs[0][1]


if __name__ == "__main__":
    adult_income.INIT_FILE.write_bytes(_init_bytes())
    print(f"wrote {adult_income.INIT_FILE} ({adult_income.INIT_FILE.stat().st_size} bytes)")
    sys.exit(0)
