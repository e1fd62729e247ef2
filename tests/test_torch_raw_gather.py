"""The raw-slot gather (``persia_tpu_torch/ops/raw_gather.py``) against
the expression it replaces, ``distinct[index]`` in the raw branch of
``persia_tpu/parallel/train_step.py:_embedding_model_inputs`` (:88-91), and
its VJP by ``jax.vjp``.

- The forward is a copy: equal bit for bit in both wire dtypes.
- The backward: the port sums each row's gradients in f32 and rounds once;
  XLA's scatter-add sums in the wire dtype. The pad row P - 1 gathers
  only masked positions: the port leaves them out and its gradient is
  zero (the reference sums them into a row the ctx discards), so the rows
  below it are compared. In f32 the two are equal to
  1e-6 of the row's sum of magnitudes (another summation order at most);
  in bf16 XLA rounds after every add, so a row of n terms may be up to
  about n bf16 half-ulps of its sum of magnitudes off the exact sum,
  while the port is within one rounding of it: held to (n + 1) * 2^-8 *
  sum|g| per element (measured here: at most 7.1e-3 of sum|g| on rows of
  up to 42 terms, 2.7e-3 on the rows of 96 repeated terms; 0.1875 at
  most in absolute terms).
- An index outside [0, P) raises in the port (on the card as a
  device-side assert, ``tests/test_torch_kernels_gpu.py``); ``jnp`` clamps
  it to the last row (the port's pads always point inside P, so it
  departs from the reference on purpose).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from persia_tpu_torch.ctx import stage_embeddings
from persia_tpu_torch.embedding.worker import RawEmbeddingBatch
from persia_tpu_torch.ops import RawSlot, raw_csr, raw_gather, raw_gather_bwd, raw_gather_fwd
from persia_tpu_torch.ops.embedding_pool import pool_csr
from persia_tpu_torch.ops.raw_gather import raw_gather_bwd_reference, raw_gather_fwd_reference

DTYPES = {"f32": (torch.float32, np.float32), "bf16": (torch.bfloat16, ml_dtypes.bfloat16)}


def _slot(rng, b, l, d, dim, case):
    """Rows (P, dim) f32 (rows past d zero) and a (B, L) index with pads
    at P - 1: random, all padding, or one row repeated everywhere."""
    p = 1
    while p < d + 1:
        p <<= 1
    rows = np.zeros((p, dim), np.float32)
    rows[:d] = rng.standard_normal((d, dim))
    if case == "random":
        index = np.where(rng.random((b, l)) < 0.6, rng.integers(0, d, (b, l)), p - 1)
        index[0] = p - 1  # an all-padding row
        index[1] = rng.integers(0, d, l)  # a full row
    elif case == "all_masked":
        index = np.full((b, l), p - 1)
    else:
        index = np.full((b, l), 2)
    return rows, index.astype(np.int32)


def _to_torch(a, dtype):
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return t.to(dtype)


@pytest.mark.parametrize("case", ["random", "all_masked", "repeated"])
@pytest.mark.parametrize("wire", list(DTYPES))
def test_matches_the_reference_gather_and_its_vjp(wire, case):
    tdt, ndt = DTYPES[wire]
    rng = np.random.default_rng(7)
    b, l, dim = 12, 8, 16
    slots = [_slot(rng, b, l, 11, dim, case), _slot(rng, b, l, 30, dim, case)]
    grads = [rng.standard_normal((b, l, dim)).astype(np.float32) for _ in slots]

    rows_t = [_to_torch(r, tdt).requires_grad_(True) for r, _ in slots]
    index_t = [RawSlot(torch.from_numpy(i)) for _, i in slots]
    outs = raw_gather(rows_t, index_t)
    torch.autograd.backward(outs, [_to_torch(g, tdt) for g in grads])

    for (rows, index), out, rt, g in zip(slots, outs, rows_t, grads):
        jrows = jnp.asarray(rows.astype(ndt))
        ref, vjp = jax.vjp(lambda r: r[jnp.asarray(index)], jrows)
        assert out.dtype == tdt and out.shape == (b, l, dim)
        np.testing.assert_array_equal(out.detach().float().numpy(), np.asarray(ref, np.float32))
        (jgrad,) = vjp(jnp.asarray(g.astype(ndt)))
        jgrad = np.asarray(jgrad, np.float32)[:-1]
        got = rt.grad.float().numpy()
        assert not got[-1].any()  # the pad row
        got = got[:-1]
        # per row: its terms and their sum of magnitudes (of the wire values)
        gw = np.asarray(g.astype(ndt), np.float32).reshape(-1, dim)
        n = np.bincount(index.reshape(-1), minlength=rows.shape[0])[:-1, None]
        mag = np.zeros_like(rows)
        np.add.at(mag, index.reshape(-1), np.abs(gw))
        mag = mag[:-1]
        if wire == "f32":
            np.testing.assert_allclose(got, jgrad, rtol=0, atol=1e-6 * mag.max() + 1e-30)
            assert (np.abs(got - jgrad) <= 1e-6 * mag + 1e-30).all()
        else:
            assert (np.abs(got - jgrad) <= (n + 1) * 2.0 ** -8 * mag).all()
        # the port's own sum: exact f32 sums of the wire values, one rounding
        exact = np.zeros_like(rows)
        np.add.at(exact, index.reshape(-1), gw)
        np.testing.assert_array_equal(got, np.asarray(exact[:-1].astype(ndt), np.float32))


@pytest.mark.parametrize("wire", list(DTYPES))
def test_wrappers_equal_their_plain_versions_on_the_cpu(wire):
    """On a CPU tensor each wrapper is its plain version, the CSR unused."""
    tdt, _ = DTYPES[wire]
    rng = np.random.default_rng(3)
    slots = [_slot(rng, 5, 4, 9, 8, "random") for _ in range(3)]
    rows = [_to_torch(r, tdt) for r, _ in slots]
    raw = [RawSlot(torch.from_numpy(i), *map(torch.from_numpy, raw_csr(i, r.shape[0]))) for r, i in slots]
    out = raw_gather_fwd(rows, raw)
    assert out.shape == (3, 5, 4, 8)
    assert torch.equal(out, raw_gather_fwd_reference(rows, raw))
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(0)).to(tdt)
    for a, b in zip(raw_gather_bwd(g, rows, raw), raw_gather_bwd_reference(g, rows, raw)):
        assert a.dtype == tdt and torch.equal(a, b)
    with pytest.raises(ValueError):
        raw_gather_bwd(g.float() if tdt == torch.bfloat16 else g.bfloat16(), rows, raw)
    with pytest.raises(ValueError):
        raw_gather_fwd(rows, [RawSlot(s.index.long()) for s in raw])


def test_out_of_range_index_raises_where_jax_clamps():
    rows = torch.randn(8, 4)
    index = torch.tensor([[0, 8]], dtype=torch.int32)
    with pytest.raises(IndexError):
        raw_gather([rows], [RawSlot(index)])
    with pytest.raises(IndexError):
        raw_gather([rows], [RawSlot(torch.tensor([[0, -1]], dtype=torch.int32))])
    clamped = np.asarray(jnp.asarray(rows.numpy())[jnp.asarray(index.numpy())])
    np.testing.assert_array_equal(clamped[0, 1], rows.numpy()[7])


def test_staging_range_checks_the_raw_index():
    """``stage_embeddings`` pads a raw slot to P = round_up_pow2(D + 1) rows,
    points pads at P - 1, adds the CSR (without the pads) on request, and
    raises on an index outside the rows before anything is copied."""
    rows = np.arange(10 * 4, dtype=np.float32).reshape(10, 4)
    index = np.array([[0, 3, 10], [9, 10, 10]], np.int32)
    eb = RawEmbeddingBatch("h", rows, index, np.array([2, 1], np.int32))
    (entry,), (count,) = stage_embeddings([eb], csr=True)
    assert count == 10 and entry["distinct"].shape == (16, 4)
    np.testing.assert_array_equal(entry["index"], [[0, 3, 15], [9, 15, 15]])
    np.testing.assert_array_equal(entry["mask"], index != 10)
    order, offsets, long_chunks = raw_csr(entry["index"], 16)
    np.testing.assert_array_equal(entry["order"], order)
    np.testing.assert_array_equal(entry["offsets"], offsets)
    np.testing.assert_array_equal(entry["long_chunks"], long_chunks)
    assert long_chunks.shape == (0, 2)
    np.testing.assert_array_equal(offsets[[0, 1, 4, 10, 15, 16]], [0, 1, 2, 3, 3, 3])
    assert "order" not in stage_embeddings([eb])[0][0]
    for bad in (np.array([[0, 16]], np.int32), np.array([[-2, 0]], np.int32)):
        with pytest.raises(ValueError, match="outside"):
            stage_embeddings([RawEmbeddingBatch("h", rows, bad, np.array([2], np.int32))])


@pytest.mark.parametrize("case", ["random", "all_masked", "repeated"])
def test_raw_csr_leaves_the_pad_row_out(case):
    """``raw_csr`` is ``pool_csr`` with the pad row's span empty: the same
    order, whose first ``offsets[P]`` entries are the live positions, the
    pad positions after them."""
    rows, index = _slot(np.random.default_rng(4), 12, 8, 11, 4, case)
    p = rows.shape[0]
    order, offsets, _ = raw_csr(index, p)
    pool_order, pool_offsets = pool_csr(index, p)
    np.testing.assert_array_equal(order, pool_order)
    np.testing.assert_array_equal(offsets[:-1], pool_offsets[:-1])
    live = int((index != p - 1).sum())
    assert offsets[-1] == offsets[-2] == live
    flat = index.reshape(-1)
    assert (flat[order[:live]] != p - 1).all() and (flat[order[live:]] == p - 1).all()
