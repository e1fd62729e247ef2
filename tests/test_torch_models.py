"""The port's DeepFM, DCN-v2 (full-rank and rank 4) and DIN against
``persia_tpu.models`` on the same parameters (seeded numpy, carried across
by ``persia_tpu_torch.weights``) and the same staged batch, through each
package's ``_embedding_model_inputs``: forward logits, and the gradient of
a seeded cotangent against ``jax.grad`` for every parameter and every
embedding input (the pooled rows and the distinct rows of device-pooled
and raw slots).

Tolerances, measured on these inputs:
- f32 compute holds the algorithm: logits and gradients to 1e-5 of the
  tensor's largest magnitude (the port sums in other orders); DIN's
  attention-unit head bias, whose true gradient is 0 since the softmax is
  shift-invariant, is rounding noise (~5e-8) on both sides, so a tensor's
  scale is at least a tenth of the model's largest gradient;
- bf16 compute (the default): logits within 2e-2 (measured at most 6.5e-3
  on logits up to 8.8); gradients within 3e-2 of the tensor's largest
  magnitude (measured at most 1.7e-2, DIN's attention unit): the two
  frameworks round to bf16 at other points (flax rounds a layer's product
  before adding its bias, torch after) and the gradients carry that
  through every layer.

Also the reference's DIN mask cases (``tests/test_models.py``): an empty
history row trains with finite losses, and padding positions get exactly
zero gradient and no say in the output; and each model trains on the
port's ``TrainCtx`` (its loss falls)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from persia_tpu.models import DCNv2 as JaxDCNv2
from persia_tpu.models import DeepFM as JaxDeepFM
from persia_tpu.models import DIN as JaxDIN
from persia_tpu.parallel.train_step import _embedding_model_inputs as jax_model_inputs
from persia_tpu.parallel.train_step import _split_emb as jax_split_emb
from persia_tpu_torch.config import EmbeddingConfig, SlotConfig
from persia_tpu_torch.ctx import TrainCtx
from persia_tpu_torch.data import IDTypeFeature, Label, NonIDTypeFeature, PersiaBatch
from persia_tpu_torch.embedding.optim import SGD
from persia_tpu_torch.embedding.store import EmbeddingStore
from persia_tpu_torch.embedding.worker import EmbeddingWorker
from persia_tpu_torch.models import DCNv2, DeepFM, DIN, DLRM
from persia_tpu_torch.parallel.train_step import _embedding_model_inputs, _split_emb
from persia_tpu_torch.weights import seeded_flax_params_like, state_dict_from_flax

B, DENSE, DIM, L = 16, 3, 8, 6
KINDS = ("deepfm", "dcn", "dcn_rank4", "din")
TOL = {torch.float32: dict(logits=1e-5, grad=1e-5), torch.bfloat16: dict(logits=2e-2, grad=3e-2)}


def _staged_batch(seed, kind):
    """A staged batch (numpy): two host-pooled slots, then for DeepFM and
    DCN-v2 a device-pooled slot and a raw slot (mean-pooled), for DIN two
    raw slots (one all-padding row, one full row, one row of a repeated
    index). Raw pads point at row P - 1."""
    rng = np.random.default_rng(seed)
    dense = [rng.standard_normal((B, DENSE)).astype(np.float32)]
    emb = [{"pooled": rng.standard_normal((B, DIM)).astype(np.float32)} for _ in range(2)]
    if kind != "din":
        p, d = 16, 11
        distinct = np.zeros((p, DIM), np.float32)
        distinct[:d] = rng.standard_normal((d, DIM))
        index = np.where(rng.random((B, 4)) < 0.7, rng.integers(0, d, (B, 4)), d).astype(np.int32)
        emb.append({"distinct": distinct, "pool_index": index})
    for _ in range(2 if kind == "din" else 1):
        p, d = 16, 11
        distinct = np.zeros((p, DIM), np.float32)
        distinct[:d] = rng.standard_normal((d, DIM))
        index = np.where(rng.random((B, L)) < 0.6, rng.integers(0, d, (B, L)), p - 1)
        index[0] = p - 1
        index[1] = rng.integers(0, d, L)
        index[2] = 3
        emb.append({"distinct": distinct, "index": index.astype(np.int32), "mask": index != p - 1})
    return dense, emb


def _models(kind, dtype, num_slots):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    if kind == "din":
        return (DIN(DENSE, 2, 2, DIM, (16,), (32,), compute_dtype=dtype, device="cpu"),
                JaxDIN(embedding_dim=DIM, attention_hidden=(16,), top_mlp=(32,), compute_dtype=jdt))
    if kind == "deepfm":
        return (DeepFM(DENSE, num_slots, DIM, (32, 16), compute_dtype=dtype, device="cpu"),
                JaxDeepFM(embedding_dim=DIM, deep_mlp=(32, 16), compute_dtype=jdt))
    rank = 4 if kind == "dcn_rank4" else None
    return (DCNv2(DENSE, num_slots, DIM, 2, rank, (32, 16), compute_dtype=dtype, device="cpu"),
            JaxDCNv2(embedding_dim=DIM, num_cross_layers=2, cross_rank=rank, deep_mlp=(32, 16), compute_dtype=jdt))


def _jax_emb(emb):
    return [{k: jnp.asarray(v) for k, v in e.items()} for e in emb]


@pytest.mark.parametrize("kind", KINDS)
def test_layers_match_reference(kind):
    """The port's parameters, under flax's names, have the shapes of the
    reference model's ``init``, so its params load strictly."""
    dense, emb = _staged_batch(0, kind)
    model, jmodel = _models(kind, torch.float32, len(emb))
    params = seeded_flax_params_like(model, 0)
    ref = jmodel.init(jax.random.PRNGKey(0), [jnp.asarray(x) for x in dense],
                      jax_model_inputs(*jax_split_emb(_jax_emb(emb))), train=False)["params"]
    shapes = lambda p: jax.tree.map(lambda a: tuple(np.shape(a)), p)  # noqa: E731
    assert shapes(ref) == shapes(params)
    sd = state_dict_from_flax(model, params)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", KINDS)
def test_forward_and_gradients_match_reference(kind, dtype):
    dense, emb = _staged_batch(1, kind)
    model, jmodel = _models(kind, dtype, len(emb))
    params = seeded_flax_params_like(model, 2)
    model.load_state_dict(state_dict_from_flax(model, params))
    ct = np.random.default_rng(3).standard_normal((B, 1)).astype(np.float32)

    jdiff, jstatic = jax_split_emb(_jax_emb(emb))

    def loss(p, diff):
        out = jmodel.apply({"params": p}, [jnp.asarray(x) for x in dense], jax_model_inputs(diff, jstatic),
                           train=False)
        return (out * ct).sum(), out

    (_, ref), (gparams, gemb) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, params), jdiff)

    diff, static = _split_emb([{k: torch.from_numpy(v) for k, v in e.items()} for e in emb])
    leaves = [d.clone().requires_grad_(True) for d in diff]
    out = model([torch.from_numpy(x) for x in dense], _embedding_model_inputs(leaves, static))
    (out * torch.from_numpy(ct)).sum().backward()

    tol = TOL[dtype]
    assert out.dtype == torch.float32 and out.shape == (B, 1)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=0, atol=tol["logits"])
    want = {k: v.numpy() for k, v in state_dict_from_flax(model, jax.tree.map(np.asarray, gparams)).items()}
    # a tensor's scale: its largest gradient, or a tenth of the model's
    # largest where that is more (DIN's head bias, whose gradient is 0)
    floor = 0.1 * max(np.abs(w).max() for w in want.values())
    for name, p in model.named_parameters():
        w = want[name]
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=tol["grad"] * max(np.abs(w).max(), floor),
                                   err_msg=name)
    for i, (leaf, g) in enumerate(zip(leaves, gemb)):
        w = np.asarray(g, np.float32)
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=0, atol=tol["grad"] * np.abs(w).max(),
                                   err_msg=f"embedding input {i}")


def test_din_needs_a_pooled_target_and_its_raw_slots():
    with pytest.raises(ValueError, match="pooled slot"):
        DIN(DENSE, 0, 1, DIM, device="cpu")
    model = DIN(DENSE, 1, 2, DIM, device="cpu")
    dense, emb = _staged_batch(0, "din")
    with pytest.raises(ValueError, match="raw slots"):
        model([torch.from_numpy(dense[0])], _embedding_model_inputs(*_split_emb(
            [{k: torch.from_numpy(v) for k, v in e.items()} for e in emb[:3]])))


# --- on the port's TrainCtx (``tests/test_models.py``'s cases) -----------

CTX_DIM = 8


def _ctx(model):
    cfg = EmbeddingConfig(slots_config={
        "item": SlotConfig(dim=CTX_DIM),
        "user": SlotConfig(dim=CTX_DIM),
        "hist": SlotConfig(dim=CTX_DIM, embedding_summation=False, sample_fixed_size=6),
    })
    worker = EmbeddingWorker(cfg, [EmbeddingStore(capacity=65536, num_internal_shards=2, seed=5)])
    return TrainCtx(model, torch.optim.Adam(model.parameters(), lr=1e-2), SGD(lr=0.1), worker, cfg,
                    device="cpu").__enter__()


def _batch(bs=16, seed=0, empty_hist_row=False):
    rng = np.random.default_rng(seed)
    hist = [rng.integers(0, 500, rng.integers(1, 9), dtype=np.uint64) for _ in range(bs)]
    if empty_hist_row:
        hist[0] = np.array([], dtype=np.uint64)
    return PersiaBatch(
        [
            IDTypeFeature("item", [rng.integers(0, 200, 1, dtype=np.uint64) for _ in range(bs)]),
            IDTypeFeature("user", [rng.integers(0, 300, 1, dtype=np.uint64) for _ in range(bs)]),
            IDTypeFeature("hist", hist),
        ],
        non_id_type_features=[NonIDTypeFeature(rng.normal(size=(bs, 4)).astype(np.float32))],
        labels=[Label(rng.integers(0, 2, (bs, 1)).astype(np.float32))],
        requires_grad=True,
    )


CTX_MODELS = {
    "DLRM": lambda: DLRM(4, 3, CTX_DIM, (16, CTX_DIM), (32,), device="cpu"),
    "DeepFM": lambda: DeepFM(4, 3, CTX_DIM, (32, 16), device="cpu"),
    "DCNv2": lambda: DCNv2(4, 3, CTX_DIM, 2, None, (32,), device="cpu"),
    "DCNv2_lowrank": lambda: DCNv2(4, 3, CTX_DIM, 2, 4, (32,), device="cpu"),
    "DIN": lambda: DIN(4, 2, 1, CTX_DIM, (16,), (32,), device="cpu"),
}


@pytest.mark.parametrize("fan_in,fan_out", [(512, 256), (13, 256)])
def test_lecun_init_draws_flax_lecun_normal(fan_in, fan_out):
    """Every model's own initialisation (``layers.lecun_init_``) draws
    flax ``Dense``'s default kernel: a normal truncated at two sigmas whose
    std is 1 / sqrt(fan_in), so |w| * sqrt(fan_in) <= 2 / 0.87962566; zero
    biases; the std within 3 % of ``flax.linen.Dense(...).init``'s at the
    same shape."""
    import flax.linen as fnn

    from persia_tpu_torch.models.layers import lecun_init_

    layer = torch.nn.Linear(fan_in, fan_out)
    lecun_init_([layer], torch.Generator().manual_seed(0))
    w = layer.weight.detach().numpy().astype(np.float64) * np.sqrt(fan_in)
    assert np.abs(w).max() <= 2.2737 + 1e-6
    assert not layer.bias.detach().any()
    ref = fnn.Dense(fan_out).init(jax.random.PRNGKey(0), jnp.zeros((1, fan_in)))["params"]["kernel"]
    ref = np.asarray(ref, np.float64) * np.sqrt(fan_in)
    assert abs(w.std() / ref.std() - 1) < 0.03, (w.std(), ref.std())


@pytest.mark.parametrize("name", CTX_MODELS)
def test_model_trains(name):
    ctx = _ctx(CTX_MODELS[name]())
    losses = []
    for step in range(20):
        m = ctx.train_step(_batch(seed=step % 3))
        assert np.isfinite(m["loss"]) and m["preds"].shape == (16, 1)
        losses.append(m["loss"])
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), f"{name}: {losses[:3]} ... {losses[-3:]}"


@pytest.mark.parametrize("name", CTX_MODELS)
def test_model_survives_empty_sequence_row(name):
    """A sample with an empty history gives no NaN (DIN masks its whole
    softmax row; the pooling models divide by max(count, 1))."""
    ctx = _ctx(CTX_MODELS[name]())
    m = ctx.train_step(_batch(empty_hist_row=True))
    assert np.isfinite(m["loss"]) and np.isfinite(m["preds"]).all()


def test_din_attention_respects_mask():
    """Padding positions get exactly zero gradient (the rows past the true
    distinct count, the pad row among them, stay 0) and no say in the
    output: a changed pad row leaves the predictions as they were."""
    ctx = _ctx(DIN(4, 2, 1, CTX_DIM, (16,), (32,), device="cpu"))
    batch = _batch(bs=8, seed=1)
    ref = ctx.worker.put_forward_ids(batch)
    emb_batches = ctx.worker.forward_batch_id(ref, train=True)
    device_batch, counts = ctx.prepare_features(batch, emb_batches, csr=True)
    header, gpacked = ctx.run_step(device_batch)
    _, grads = ctx.fetch_step_output(header, gpacked, device_batch)
    raw = [(e, g, d) for e, g, d in zip(device_batch["emb"], grads, counts) if "mask" in e]
    assert raw and all(not e["mask"].all() for e, _, _ in raw)
    for e, g, d in raw:
        np.testing.assert_array_equal(g[d:], 0)
    ctx.worker.abort_gradient(ref)

    preds = ctx._eval_step(device_batch)
    for e, _, d in raw:
        e["distinct"][d:] = 7.0  # the pad row and the rows past D
    torch.testing.assert_close(ctx._eval_step(device_batch), preds, rtol=0, atol=0)
