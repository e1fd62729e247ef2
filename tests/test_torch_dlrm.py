"""The port's DLRM vs ``persia_tpu.models.DLRM`` on the same parameters
(seeded numpy, carried across by ``persia_tpu_torch.weights``) and the same
staged batch, covering pooled, device-pooled and raw slots through each
package's ``_embedding_model_inputs``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from persia_tpu.models import DLRM as JaxDLRM
from persia_tpu.parallel.train_step import _embedding_model_inputs as jax_model_inputs
from persia_tpu.parallel.train_step import _split_emb as jax_split_emb
from persia_tpu_torch.models import DLRM
from persia_tpu_torch.parallel.train_step import _embedding_model_inputs, _split_emb
from persia_tpu_torch.weights import seeded_flax_params_like, state_dict_from_flax

B, DENSE, DIM = 32, 13, 16
BOTTOM, TOP = (32, DIM), (64, 32)


def _staged_batch(seed=0):
    """A staged device batch (numpy) with one slot of each kind: host-pooled,
    device-pooled (uint16 index, sqrt counts), device-pooled (int32 index),
    raw (index + mask, pad row at P-1)."""
    rng = np.random.default_rng(seed)
    dense = [rng.standard_normal((B, DENSE)).astype(np.float32)]
    pooled = {"pooled": rng.standard_normal((B, DIM)).astype(np.float32)}
    p, d, L = 16, 11, 4
    distinct = np.zeros((p, DIM), np.float32)
    distinct[:d] = rng.standard_normal((d, DIM))
    counts = rng.integers(0, L + 1, B)
    index = np.where(np.arange(L)[None, :] < counts[:, None], rng.integers(0, d, (B, L)), d)
    dev_pooled_sqrt = {
        "distinct": distinct,
        "pool_index": index.astype(np.uint16),
        "pool_counts": counts.reshape(-1, 1).astype(np.int32),
    }
    dev_pooled = {"distinct": distinct.copy(), "pool_index": index.astype(np.int32)}
    raw_distinct = np.zeros((8, DIM), np.float32)
    raw_distinct[:5] = rng.standard_normal((5, DIM))
    raw_index = np.where(rng.random((B, 6)) < 0.6, rng.integers(0, 5, (B, 6)), 7).astype(np.int32)
    raw = {"distinct": raw_distinct, "index": raw_index, "mask": raw_index != 7}
    return dense, [pooled, dev_pooled_sqrt, dev_pooled, raw]


def _jax_logits(params, dense, emb, dtype):
    model = JaxDLRM(embedding_dim=DIM, bottom_mlp=BOTTOM, top_mlp=TOP, compute_dtype=dtype)
    emb_j = [{k: jnp.asarray(v) for k, v in e.items()} for e in emb]
    inputs = jax_model_inputs(*jax_split_emb(emb_j))
    params_j = jax.tree_util.tree_map(jnp.asarray, params)
    out = model.apply({"params": params_j}, [jnp.asarray(x) for x in dense], inputs, train=False)
    return np.asarray(out, np.float32)


def _params(seed, num_slots):
    return seeded_flax_params_like(DLRM(DENSE, num_slots, DIM, BOTTOM, TOP, device="cpu"), seed)


def _port_logits(params, dense, emb, dtype):
    model = DLRM(DENSE, len(emb), DIM, BOTTOM, TOP, compute_dtype=dtype, device="cpu")
    model.load_state_dict(state_dict_from_flax(model, params))
    emb_t = [{k: torch.from_numpy(v.astype(np.int32) if v.dtype == np.uint16 else v)
              for k, v in e.items()} for e in emb]
    with torch.no_grad():
        out = model([torch.from_numpy(x) for x in dense], _embedding_model_inputs(*_split_emb(emb_t)))
    return out.numpy()


def test_layer_widths_and_state_dict_match_reference():
    """The port's layers, in call order, have the widths of the reference's
    Dense_0 … Dense_5, so its params load by index."""
    dense, emb = _staged_batch(0)
    model = DLRM(DENSE, len(emb), DIM, BOTTOM, TOP, device="cpu")
    params = seeded_flax_params_like(model, 0)
    emb_j = [{k: jnp.asarray(v) for k, v in e.items()} for e in emb]
    ref = JaxDLRM(embedding_dim=DIM, bottom_mlp=BOTTOM, top_mlp=TOP).init(
        jax.random.PRNGKey(0), [jnp.asarray(x) for x in dense],
        jax_model_inputs(*jax_split_emb(emb_j)), train=False,
    )["params"]
    shapes = lambda p: {k: {n: tuple(a.shape) for n, a in v.items()} for k, v in p.items()}
    assert shapes(ref) == shapes(params)
    sd = state_dict_from_flax(model, params)
    model.load_state_dict(sd, strict=True)
    assert set(sd) == set(model.state_dict())
    np.testing.assert_array_equal(sd["layers.0.weight"].numpy(), params["Dense_0"]["kernel"].T)


def test_f32_logits_match_reference():
    """compute_dtype=float32 holds the algorithm: same weights, same inputs,
    f32 everywhere; sums in another order only (1e-5)."""
    dense, emb = _staged_batch(1)
    params = _params(1, len(emb))
    ref = _jax_logits(params, dense, emb, jnp.float32)
    out = _port_logits(params, dense, emb, torch.float32)
    assert out.shape == (B, 1) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_bf16_logits_match_reference():
    """bf16 compute (the default): XLA and torch round to bf16 at different
    points (flax rounds the dot before adding the bias, torch after), a few
    bf16 ulps through five layers — 5e-2 absolute on logits of order 1."""
    dense, emb = _staged_batch(2)
    params = _params(2, len(emb))
    ref = _jax_logits(params, dense, emb, jnp.bfloat16)
    out = _port_logits(params, dense, emb, torch.bfloat16)
    assert out.dtype == np.float32  # f32 head
    np.testing.assert_allclose(out, ref, rtol=5e-2, atol=5e-2)


def test_seeded_init_is_device_independent():
    a = DLRM(DENSE, 3, DIM, BOTTOM, TOP, device="cpu", generator=torch.Generator().manual_seed(5))
    b = DLRM(DENSE, 3, DIM, BOTTOM, TOP, device="cpu", generator=torch.Generator().manual_seed(5))
    for x, y in zip(a.state_dict().values(), b.state_dict().values()):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_model_without_card_raises_unless_cpu_requested():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError):
        DLRM(DENSE, 3, DIM, BOTTOM, TOP)


def test_rejects_bottom_not_ending_at_embedding_dim():
    with pytest.raises(ValueError):
        DLRM(DENSE, 3, DIM, (32, 8), TOP, device="cpu")
