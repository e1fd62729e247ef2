"""The port's grouped gather-pool (``ops.embedding_pool``, its plain forward
and backward on the CPU) against the reference's device-pooled branch of
``_embedding_model_inputs`` and its ``jax.vjp``; the host CSR builder
against a direct construction (the kernels on a card:
tests/test_torch_kernels_gpu.py).

The reference's autodiff scatter-adds the pooled gradient in the rows'
dtype; the port sums in f32 and rounds once. So f32 rows agree to 1e-6 and
bf16 rows' gradients to one bf16 rounding (rtol 2^-7) beyond the
reference's own bf16 sums."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from persia_tpu.parallel.train_step import _embedding_model_inputs as jax_model_inputs
from persia_tpu_torch.ops import PoolSlot, embedding_pool, gather_pool_bwd, gather_pool_fwd
from persia_tpu_torch.ops.embedding_pool import pool_csr
from persia_tpu_torch.parallel.train_step import _embedding_model_inputs, _split_emb

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _slot(rng, batch, d, p, L, with_counts):
    """Rows padded to p with zero rows past d, an index whose pads point at
    row d (samples hold 0..L ids where L > 1), optional counts."""
    rows = np.zeros((p, 16), np.float32)
    rows[:d] = rng.standard_normal((d, 16))
    counts = rng.integers(0 if L > 1 else 1, L + 1, batch).astype(np.int32)
    index = np.full((batch, L), d, np.int32)
    for b, c in enumerate(counts):
        index[b, :c] = rng.integers(0, d, c)
    return rows, index, counts.reshape(-1, 1) if with_counts else None


def _reference(rows, index, counts, dtype, grad):
    """The reference's pooled forward and the vjp of its rows."""
    static = ("pool", jnp.asarray(index), None if counts is None else jnp.asarray(counts))

    def pool(r):
        return jax_model_inputs([r], [static])[0]

    out, vjp = jax.vjp(pool, jnp.asarray(rows, dtype=dtype))
    (g,) = vjp(jnp.asarray(grad))
    return np.asarray(out), np.asarray(g.astype(jnp.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("L", [1, 4])
@pytest.mark.parametrize("with_counts", [False, True])
def test_pool_forward_and_gradient_match_reference(dtype, L, with_counts):
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(L + 2 * with_counts)
    batch, d, p = 64, 20, 32
    rows, index, counts = _slot(rng, batch, d, p, L, with_counts)
    grad = rng.standard_normal((batch, 16)).astype(np.float32)
    ref_out, ref_grad = _reference(rows, index, counts, jdt, grad)

    leaf = torch.from_numpy(rows).to(tdt).requires_grad_(True)
    slot = PoolSlot(torch.from_numpy(index), None if counts is None else torch.from_numpy(counts))
    (out,) = embedding_pool([leaf], [slot])
    assert out.shape == (batch, 16) and out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), ref_out, rtol=1e-6, atol=1e-6)
    out.backward(torch.from_numpy(grad))
    assert leaf.grad.dtype == tdt
    got = leaf.grad.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref_grad, rtol=1e-6, atol=1e-6)
    else:
        # one rounding of the f32 sum (the gradient does not depend on the
        # rows' values, so the f32 vjp is that sum) ...
        _, ref_f32 = _reference(rows, index, counts, jnp.float32, grad)
        np.testing.assert_allclose(got, ref_f32, rtol=2 ** -7, atol=1e-6)
        # ... and within one rounding of the reference's bf16 scatter on the
        # distinct rows (the pad row D sums ~B pads in bf16 there)
        np.testing.assert_allclose(got[:d], ref_grad[:d], rtol=2 ** -7, atol=2 ** -7 * np.abs(ref_grad).max())
    # rows past D take nothing; row D takes the pads' gradient, as in the
    # reference (the host drops it)
    np.testing.assert_array_equal(got[d + 1:], 0)
    np.testing.assert_array_equal(ref_grad[d + 1:], 0)


def test_group_of_slots_in_one_call():
    """Slots of one dim and dtype pool in one call: (B, S, dim), each slot
    as pooled alone, with and without counts, different L and P."""
    rng = np.random.default_rng(5)
    specs = [(7, 8, 1, False), (30, 64, 4, True), (1, 2, 2, True)]
    parts = [_slot(rng, 40, d, p, L, c) for d, p, L, c in specs]
    rows = [torch.from_numpy(r) for r, _, _ in parts]
    slots = [PoolSlot(torch.from_numpy(i), None if c is None else torch.from_numpy(c)) for _, i, c in parts]
    out = gather_pool_fwd(rows, slots)
    assert out.shape == (40, 3, 16)
    for s, (r, i, c) in enumerate(parts):
        ref, _ = _reference(r, i, c, jnp.float32, np.zeros((40, 16), np.float32))
        np.testing.assert_allclose(out[:, s].numpy(), ref, rtol=1e-6, atol=1e-6)
    g = torch.from_numpy(rng.standard_normal((40, 3, 16)).astype(np.float32))
    for s, (grad, (r, i, c)) in enumerate(zip(gather_pool_bwd(g, rows, slots), parts)):
        _, ref = _reference(r, i, c, jnp.float32, g[:, s].numpy())
        np.testing.assert_allclose(grad.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_model_inputs_group_pooled_slots_by_dim():
    """``_embedding_model_inputs`` pools each (dtype, dim) group together
    and keeps the slot order; host-pooled and raw slots pass through."""
    rng = np.random.default_rng(6)
    emb = []
    for dim in (16, 8, 16):
        emb.append({"distinct": torch.from_numpy(rng.standard_normal((9, dim)).astype(np.float32)),
                    "pool_index": torch.from_numpy(rng.integers(0, 8, (5, 2)).astype(np.int32))})
    emb.insert(1, {"pooled": torch.ones(5, 16)})
    emb.append({"distinct": torch.ones(4, 16), "index": torch.zeros(5, 3, dtype=torch.int32),
                "mask": torch.ones(5, 3, dtype=torch.bool)})
    out = _embedding_model_inputs(*_split_emb(emb))
    assert [tuple(o.shape) if torch.is_tensor(o) else "raw" for o in out] == [
        (5, 16), (5, 16), (5, 8), (5, 16), "raw"]
    for o, e in zip(out, emb):
        if "pool_index" in e:
            ref = e["distinct"][e["pool_index"].long()].sum(1)
            torch.testing.assert_close(o, ref)


def test_pool_under_inference_mode():
    rows = torch.randn(5, 16)
    slot = PoolSlot(torch.tensor([[1], [4]], dtype=torch.int32))
    with torch.inference_mode():
        (out,) = embedding_pool([rows], [slot])
    torch.testing.assert_close(out, rows[[1, 4]])


@pytest.mark.parametrize("L,rows", [(1, 9), (4, 33)])
def test_pool_csr(L, rows):
    """Row r's positions b * L + l in ascending order; offsets cover every
    row, the pad row included; exact integers."""
    rng = np.random.default_rng(L)
    index = rng.integers(0, rows - 1, (50, L)).astype(np.int32)
    index[::7, -1] = rows - 1  # pads at the last row
    order, offsets = pool_csr(index, rows)
    assert order.dtype == offsets.dtype == np.int32 and offsets.shape == (rows + 1,)
    flat = index.reshape(-1)
    for r in range(rows):
        np.testing.assert_array_equal(order[offsets[r]:offsets[r + 1]], np.flatnonzero(flat == r))
    assert offsets[0] == 0 and offsets[-1] == flat.size
