"""The hybrid tier's dense state in flax's bytes
(``persia_tpu_torch/weights.py::train_state_to_flax_bytes`` /
``train_state_from_flax_bytes`` over ``persia_tpu_torch/serialization.py``):

- the bytes equal ``flax.serialization.to_bytes`` of the reference's
  ``TrainState`` carrying the same arrays, for DLRM before and after Adam's
  first step, with the dynamic loss scale on and off, and with a bf16
  layer; and of a state the reference's ``TrainCtx`` trained, loaded into
  the port;
- the round trip through ``train_state_from_flax_bytes`` is exact, in
  place (the parameter and Adam state tensors keep their identity);
- for DIN, DeepFM and DCN-v2 (full-rank and rank 4), the reference's
  ``TrainState`` after optax's Adam steps loads into the port and writes
  back byte-equal, and the port's state after its own Adam steps is read
  by ``flax.serialization.from_bytes`` and written back byte-equal;
- the msgpack subset equals flax's on other trees, and reads flax's
  chunked form of large arrays.
"""

import flax.serialization as fser
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from persia_tpu.parallel.train_step import LossScaleState as JaxLossScale
from persia_tpu.parallel.train_step import TrainState as JaxTrainState
from persia_tpu_torch import serialization
from persia_tpu_torch.models import DCNv2, DeepFM, DIN, DLRM
from persia_tpu_torch.parallel.train_step import LossScaleState, init_train_state
from persia_tpu_torch.weights import (
    seeded_flax_params_like,
    state_dict_from_flax,
    train_state_from_flax_bytes,
    train_state_to_flax_bytes,
)


def _port_state(dynamic=False, bf16_layer=False, steps=2, seed=0):
    """A port DLRM state after ``steps`` Adam steps on random gradients."""
    model = DLRM(13, 3, 8, (16, 8), (16,), device="cpu")
    model.load_state_dict(state_dict_from_flax(model, seeded_flax_params_like(model, seed)))
    if bf16_layer:
        model.layers[1].to(torch.bfloat16)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    state = init_train_state(model, opt, 2.0 ** 15 if dynamic else None)
    g = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        for p in model.parameters():
            p.grad = torch.randn(p.shape, generator=g).to(p.dtype)
        opt.step()
        state.step += 1
    if dynamic:
        state.loss_scale = LossScaleState(scale=float(np.float32(1024.0)), good_steps=3)
    return state


def _np(t):
    t = t.detach()
    return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16) if t.dtype == torch.bfloat16 else t.numpy()


def _reference_state(state):
    """The reference ``TrainState`` carrying the port state's arrays, its
    dicts in the order a state the reference's step returned has."""
    layers = state.model.layers
    opt = state.optimizer

    def tree(get):
        return {f"Dense_{i}": {"bias": jnp.asarray(get(layers[i].bias)),
                               "kernel": jnp.asarray(get(layers[i].weight).T)}
                for i in sorted(range(len(layers)), key=lambda i: f"Dense_{i}")}

    first = layers[0].weight
    count = int(opt.state[first]["step"]) if opt.state.get(first) else 0
    zeros = lambda p: np.zeros(p.shape, _np(p).dtype)
    mu = tree(lambda p: _np(opt.state[p]["exp_avg"]) if opt.state.get(p) else zeros(p))
    nu = tree(lambda p: _np(opt.state[p]["exp_avg_sq"]) if opt.state.get(p) else zeros(p))
    adam = optax.adam(1e-3).init(tree(_np))
    adam = (adam[0]._replace(count=jnp.asarray(count, jnp.int32), mu=mu, nu=nu), adam[1])
    ls = state.loss_scale
    return JaxTrainState(
        params=tree(_np), batch_stats={}, opt_state=adam, step=jnp.asarray(state.step, jnp.int32),
        loss_scale=None if ls is None else JaxLossScale(scale=jnp.asarray(ls.scale, jnp.float32),
                                                        good_steps=jnp.asarray(ls.good_steps, jnp.int32)),
    )


@pytest.mark.parametrize("steps", [0, 3])
@pytest.mark.parametrize("dynamic", [False, True])
@pytest.mark.parametrize("bf16_layer", [False, True])
def test_bytes_equal_flax_to_bytes(steps, dynamic, bf16_layer):
    state = _port_state(dynamic, bf16_layer, steps)
    raw = train_state_to_flax_bytes(state)
    assert raw == fser.to_bytes(_reference_state(state))


@pytest.mark.parametrize("dynamic", [False, True])
@pytest.mark.parametrize("bf16_layer", [False, True])
def test_round_trip_is_exact_and_in_place(dynamic, bf16_layer):
    src = _port_state(dynamic, bf16_layer, steps=3, seed=1)
    raw = train_state_to_flax_bytes(src)
    dst = _port_state(dynamic, bf16_layer, steps=1, seed=2)
    tensors = [t for st in dst.optimizer.state.values() for t in st.values()] + list(dst.model.parameters())
    assert train_state_from_flax_bytes(dst, raw) is dst
    assert train_state_to_flax_bytes(dst) == raw
    after = [t for st in dst.optimizer.state.values() for t in st.values()] + list(dst.model.parameters())
    assert all(a is b for a, b in zip(tensors, after))
    for a, b in zip(src.model.parameters(), dst.model.parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert dst.step == 3 and float(dst.optimizer.state[next(dst.model.parameters())]["step"]) == 3.0
    # into a state whose Adam has not stepped yet: its state is made
    fresh = _port_state(dynamic, bf16_layer, steps=0, seed=3)
    train_state_from_flax_bytes(fresh, raw)
    assert train_state_to_flax_bytes(fresh) == raw
    assert fresh.optimizer.state[next(fresh.model.parameters())]["step"].dtype == torch.float32


def test_reads_the_reference_bytes_and_rejects_a_mismatch():
    state = _port_state(steps=2)
    ref = _reference_state(state)
    target = _port_state(steps=0, seed=5)
    train_state_from_flax_bytes(target, fser.to_bytes(ref))
    assert train_state_to_flax_bytes(target) == train_state_to_flax_bytes(state)
    with pytest.raises(ValueError):
        train_state_from_flax_bytes(_port_state(dynamic=True), fser.to_bytes(ref))
    other = DLRM(13, 3, 8, (16, 8), (16, 16), device="cpu")
    with pytest.raises(ValueError):
        train_state_from_flax_bytes(init_train_state(other, torch.optim.Adam(other.parameters())),
                                    fser.to_bytes(ref))
    sgd = init_train_state(state.model, torch.optim.SGD(state.model.parameters(), lr=0.1))
    with pytest.raises(ValueError):
        train_state_to_flax_bytes(sgd)


OTHER_MODELS = {
    "din": lambda: DIN(1, 2, 2, 8, (16,), (32, 16), device="cpu"),
    "deepfm": lambda: DeepFM(2, 5, 8, (16, 8), device="cpu"),
    "dcnv2": lambda: DCNv2(2, 5, 8, 2, None, (16,), device="cpu"),
    "dcnv2_rank4": lambda: DCNv2(2, 5, 8, 2, 4, (16,), device="cpu"),
}


@pytest.mark.parametrize("steps", [0, 2])
@pytest.mark.parametrize("name", OTHER_MODELS)
def test_other_models_bytes_equal_flax_both_ways(name, steps):
    model = OTHER_MODELS[name]()
    params = jax.tree.map(jnp.asarray, seeded_flax_params_like(model, 3))
    adam = optax.adam(1e-3)
    opt_state = adam.init(params)
    rng = np.random.default_rng(4)
    for _ in range(steps):
        grads = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32), params)
        updates, opt_state = adam.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    ref = JaxTrainState(params=params, batch_stats={}, opt_state=opt_state, step=jnp.asarray(steps, jnp.int32),
                        loss_scale=None)
    raw = fser.to_bytes(ref)

    state = init_train_state(model, torch.optim.Adam(model.parameters(), lr=1e-3))
    train_state_from_flax_bytes(state, raw)
    assert train_state_to_flax_bytes(state) == raw
    want = state_dict_from_flax(model, jax.tree.map(np.asarray, params))
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k

    g = torch.Generator().manual_seed(5)
    for _ in range(2):
        for p in model.parameters():
            p.grad = torch.randn(p.shape, generator=g)
        state.optimizer.step()
        state.step += 1
    mine = train_state_to_flax_bytes(state)
    back = fser.from_bytes(ref, mine)
    assert int(back.opt_state[0].count) == steps + 2 and int(back.step) == steps + 2
    assert fser.to_bytes(back) == mine
    with pytest.raises(ValueError):
        train_state_from_flax_bytes(init_train_state(DLRM(13, 3, 8, (16, 8), (16,), device="cpu"),
                                                     torch.optim.Adam(model.parameters())), mine)


def test_msgpack_subset_equals_flax_on_other_trees():
    rng = np.random.default_rng(0)
    tree = {"a": {"x": rng.normal(size=(3, 4)).astype(np.float32), "y": np.int32(7),
                  "z": np.zeros((), np.int64), "h": np.arange(6, dtype=np.float16).reshape(2, 3)},
            "b": {}, "c": None, "t": True, "f": False,
            "n": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32, -33, -128, -129, -2 ** 15 - 1,
                  -2 ** 31 - 1, 1.5, "s" * 31, "s" * 32, "é" * 200, b"\x00" * 300, b""],
            "e": np.arange(70000, dtype=np.uint8), "k" + "q" * 300: np.arange(20).reshape(4, 5)}
    for i in range(20):
        tree[f"m{i}"] = {str(j): j for j in range(i)}
    raw = fser.msgpack_serialize(tree, in_place=True)
    assert serialization.msgpack_serialize(tree) == raw
    back = serialization.msgpack_restore(raw)
    ref = fser.msgpack_restore(raw)
    flat_a, tree_a = jax.tree_util.tree_flatten(back)
    flat_b, tree_b = jax.tree_util.tree_flatten(ref)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        assert type(a) is type(b)
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        serialization.msgpack_restore(raw[:-1])
    with pytest.raises(ValueError):
        serialization.msgpack_restore(raw + b"\xc0")


def test_reads_and_writes_flax_chunked_arrays(monkeypatch):
    """flax writes an array over ``MAX_CHUNK_SIZE`` bytes as a map of
    chunks; a small limit on both sides makes one here."""
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 256)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)
    state = _port_state(steps=2)
    ref = fser.to_bytes(_reference_state(state))
    assert b"__msgpack_chunked_array__" in ref
    assert train_state_to_flax_bytes(state) == ref
    target = _port_state(steps=0, seed=4)
    train_state_from_flax_bytes(target, ref)
    for a, b in zip(state.model.parameters(), target.model.parameters()):
        assert torch.equal(a, b)
    bf = np.arange(400, dtype=np.float32).astype(ml_dtypes.bfloat16).reshape(20, 20)
    raw = fser.msgpack_serialize({"w": bf}, in_place=True)
    got = serialization.msgpack_restore(raw)["w"]
    assert got.dtype == serialization.BF16 and got.shape == (20, 20)
    np.testing.assert_array_equal(got.view(np.uint16), bf.view(np.uint16))
