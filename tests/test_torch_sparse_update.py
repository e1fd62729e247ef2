"""The port's device sparse update (``persia_tpu_torch/ops/sparse_update.py``,
the plain version a CPU tensor takes) against the reference's
(``persia_tpu/ops/sparse_update.py``, jitted JAX on the CPU), on the same
numpy inputs: the dedup's integers exactly and its sums bit for bit (both
sum in stream order), and every optimizer over two steps with advanced
Adam powers, weight decay and padding, to rtol 1e-5, atol 1e-7; rows no
live id touches keep their bits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import persia_tpu.embedding  # noqa: F401  (imports persia_tpu.ops in the order it needs)
from persia_tpu.embedding import optim as jopt
from persia_tpu.ops import sparse_update as jsu
from persia_tpu_torch.embedding import optim as topt
from persia_tpu_torch.ops.sparse_update import dedup_gradients as t_dedup
from persia_tpu_torch.ops.sparse_update import init_sparse_state as t_init
from persia_tpu_torch.ops.sparse_update import masked_flat_ids_grads as t_flat
from persia_tpu_torch.ops.sparse_update import sparse_update as t_update

OPTIMIZERS = {
    "sgd": lambda m: m.SGD(lr=0.1),
    "sgd_wd": lambda m: m.SGD(lr=0.1, weight_decay=0.01),
    "adagrad": lambda m: m.Adagrad(lr=0.05),
    "adagrad_decay_wd": lambda m: m.Adagrad(lr=0.05, g_square_momentum=0.95, weight_decay=0.01),
    "adagrad_vw": lambda m: m.Adagrad(lr=0.05, vectorwise_shared=True),
    "adagrad_vw_wd": lambda m: m.Adagrad(lr=0.05, vectorwise_shared=True, weight_decay=0.02),
    "adam": lambda m: m.Adam(lr=0.01),
    "adam_wd": lambda m: m.Adam(lr=0.01, weight_decay=0.1),  # Adam takes no decay in either
}
TOL = dict(rtol=1e-5, atol=1e-7)


def _stream(seed, n=120, vocab=64, dim=8, pad=0.2, oob=True):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, n).astype(np.int32)
    ids[rng.random(n) < pad] = -1
    if oob:
        ids[5] = vocab + 3  # live but outside the table: dropped by both
    grads = rng.standard_normal((n, dim)).astype(np.float32)
    return ids, grads


@pytest.mark.parametrize("seed,masked", [(0, True), (1, True), (2, False), (3, True)])
def test_dedup_gradients_matches_reference(seed, masked):
    ids, grads = _stream(seed, oob=False)
    if not masked:
        ids = np.abs(ids)
    mask = ids >= 0 if masked else None
    uid, gsum, valid = jsu.dedup_gradients(
        jnp.asarray(ids), jnp.asarray(grads), None if mask is None else jnp.asarray(mask))
    tuid, tgsum, tvalid = t_dedup(
        torch.from_numpy(ids), torch.from_numpy(grads), None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(tuid.numpy(), np.asarray(uid))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(valid))
    np.testing.assert_array_equal(tgsum.numpy(), np.asarray(gsum))


def _both_states(cfg_j, cfg_t, vocab, dim):
    js = jsu.init_sparse_state(cfg_j, vocab, dim)
    ts = t_init(cfg_t, vocab, dim)
    assert sorted(js) == sorted(ts)
    for k in js:
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))
    return js, ts


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_sparse_update_two_steps_matches_reference(name):
    """Two steps with the Adam powers advanced each step, masked padding
    and a live id past the table. The largest differences seen: 2.4e-7 on
    the tables (SGD), 5.7e-6 on Adagrad's accumulators (values up to ~10),
    3.0e-8 on Adam's moments, an ulp or two: XLA's CPU fusions contract
    multiply-adds that PyTorch rounds apart."""
    cfg_j, cfg_t = OPTIMIZERS[name](jopt).config, OPTIMIZERS[name](topt).config
    vocab, dim = 64, 8
    table = np.random.default_rng(9).standard_normal((vocab, dim)).astype(np.float32)
    jt, tt = jnp.asarray(table), torch.from_numpy(table.copy())
    js, ts = _both_states(cfg_j, cfg_t, vocab, dim)
    jbs = jnp.ones((2,), jnp.float32)
    tbs = torch.ones(2)
    touched = set()
    for step in range(2):
        ids, grads = _stream(10 + step, vocab=vocab, dim=dim)
        touched |= {int(i) for i in ids if 0 <= i < vocab}
        jbs = jbs * jnp.array([cfg_j.beta1, cfg_j.beta2], jnp.float32)
        tbs = tbs * torch.tensor([cfg_t.beta1, cfg_t.beta2], dtype=torch.float32)
        jt, js = jax.jit(lambda t, s, i, g, b, m: jsu.sparse_update(cfg_j, t, s, i, g, b, mask=m))(
            jt, js, jnp.asarray(ids), jnp.asarray(grads), jbs, jnp.asarray(ids >= 0))
        out, _ = t_update(cfg_t, tt, ts, torch.from_numpy(ids), torch.from_numpy(grads), tbs,
                          mask=torch.from_numpy(ids >= 0))
        assert out is tt  # in place
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **TOL)
    for k in js:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), **TOL)
    untouched = sorted(set(range(vocab)) - touched)
    np.testing.assert_array_equal(tt.numpy()[untouched], table[untouched])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padding_touches_no_row(dtype):
    """Padding never touches a row, not even row 0, the last row or the
    id-0 decoy, with weight decay on; the live row moves."""
    cfg = topt.Adagrad(lr=0.1, weight_decay=0.5).config
    table = torch.from_numpy(np.random.default_rng(5).standard_normal((10, 4)).astype(np.float32))
    table = table.to(getattr(torch, dtype))
    before = table.clone()
    ids = torch.tensor([-1, 3, -1, 0], dtype=torch.int32)
    mask = torch.tensor([False, True, False, False])
    grads = torch.ones((4, 4))
    t_update(cfg, table, t_init(cfg, 10, 4), ids, grads, mask=mask)
    keep = [0, 1, 2, 4, 5, 6, 7, 8, 9]
    assert torch.equal(table[keep].view(torch.int16 if dtype == "bfloat16" else torch.int32),
                       before[keep].view(torch.int16 if dtype == "bfloat16" else torch.int32))
    assert not torch.equal(table[3], before[3])


def test_bf16_table_matches_reference():
    """A bf16 table: the delta is rounded to bf16 and added in bf16, as
    the reference's scatter-add of a bf16 delta."""
    cfg_j, cfg_t = jopt.Adagrad(lr=0.05).config, topt.Adagrad(lr=0.05).config
    table = np.random.default_rng(2).standard_normal((32, 8)).astype(np.float32)
    jt = jnp.asarray(table).astype(jnp.bfloat16)
    tt = torch.from_numpy(table).to(torch.bfloat16)
    js, ts = _both_states(cfg_j, cfg_t, 32, 8)
    ids, grads = _stream(4, vocab=32)
    jt, js = jsu.sparse_update(cfg_j, jt, js, jnp.asarray(ids), jnp.asarray(grads), mask=jnp.asarray(ids >= 0))
    t_update(cfg_t, tt, ts, torch.from_numpy(ids), torch.from_numpy(grads), mask=torch.from_numpy(ids >= 0))
    np.testing.assert_allclose(tt.float().numpy(), np.asarray(jt.astype(jnp.float32)), rtol=2 ** -8, atol=0)
    np.testing.assert_allclose(ts["acc"].numpy(), np.asarray(js["acc"]), **TOL)


@pytest.mark.parametrize("shape", [(6,), (3, 4)])
def test_masked_flat_ids_grads_matches_reference(shape):
    rng = np.random.default_rng(1)
    ids = np.where(rng.random(shape) < 0.3, -1, rng.integers(0, 9, shape)).astype(np.int32)
    grads = rng.standard_normal(shape + (5,)).astype(np.float32)
    ref = jsu.masked_flat_ids_grads(jnp.asarray(ids), jnp.asarray(grads))
    got = t_flat(torch.from_numpy(ids), torch.from_numpy(grads))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_unmasked_negative_id_is_dropped():
    """The documented difference at the direct call: an id < 0 that no
    mask covers touches no row in the port (JAX wraps it to row V + id)."""
    cfg = topt.SGD(lr=1.0).config
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    t_update(cfg, table, {}, torch.tensor([-1, 1], dtype=torch.int32), torch.ones(2, 3))
    np.testing.assert_array_equal(table.numpy(), [[0, 1, 2], [2, 3, 4], [6, 7, 8], [9, 10, 11]])
