"""The port's DLRM dot interaction vs the reference's einsum + triu gather
(``persia_tpu/models/dlrm.py:49-53``), on the CPU through the plain
version (the kernel on a card: tests/test_torch_kernels_gpu.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from persia_tpu_torch.ops import dot_interaction


def _jax_interaction(feats: np.ndarray, dtype) -> np.ndarray:
    f = jnp.asarray(feats, dtype=dtype)
    inter = jnp.einsum("bnd,bmd->bnm", f, f)
    iu, ju = jnp.triu_indices(f.shape[1], k=1)
    return np.asarray(inter[:, iu, ju].astype(jnp.float32))


def _feats(b, n, d, seed=0):
    return np.random.default_rng(seed).standard_normal((b, n, d)).astype(np.float32)


@pytest.mark.parametrize("n", [2, 5, 27])
def test_matches_jax_f32(n):
    """f32: both sides are f32 dots of length d; only the summation order can
    differ, so 1e-5."""
    feats = _feats(16, n, 16, seed=n)
    out = dot_interaction(torch.from_numpy(feats))
    assert out.shape == (16, n * (n - 1) // 2) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), _jax_interaction(feats, jnp.float32), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [2, 5, 27])
def test_matches_jax_bf16(n):
    """bf16 in and out: both sides round the f32 dot once to bf16; allow one
    bf16 ulp (2^-7 relative) of a difference in the f32 sum before rounding."""
    feats = np.array(jnp.asarray(_feats(16, n, 16, seed=10 + n), jnp.bfloat16).astype(jnp.float32))
    out = dot_interaction(torch.from_numpy(feats).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(
        out.float().numpy(), _jax_interaction(feats, jnp.bfloat16), rtol=2 ** -7, atol=1e-6
    )


@pytest.mark.parametrize("n", [2, 5, 27])
def test_pair_order_is_triu_row_major(n):
    """Column p of the output is the dot of the p-th (i, j) of
    jnp.triu_indices(n, k=1): check it on one-hot features, where the dot of
    rows i and j is 1 only for the pair built to match."""
    iu, ju = (np.asarray(a) for a in jnp.triu_indices(n, k=1))
    for p in range(len(iu)):
        feats = np.zeros((1, n, n + 1), np.float32)
        feats[0, iu[p], n] = 1.0
        feats[0, ju[p], n] = 1.0
        out = dot_interaction(torch.from_numpy(feats)).numpy()[0]
        assert out[p] == 1.0 and out.sum() == 1.0


def test_cpu_path_launches_no_kernel():
    before = dot_interaction.launches
    dot_interaction(torch.zeros(2, 3, 4))
    assert dot_interaction.launches == before


def test_rejects_bad_rank():
    with pytest.raises(ValueError):
        dot_interaction(torch.zeros(2, 3))

