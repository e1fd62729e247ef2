"""The port's DLRM dot interaction and its backward vs the reference's
einsum + triu gather (``persia_tpu/models/dlrm.py:49-53``) and its
``jax.vjp``, on the CPU through the plain versions (the kernels on a card:
tests/test_torch_kernels_gpu.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from persia_tpu_torch.ops import dot_interaction, dot_interaction_bwd


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



def _jax_vjp(feats: np.ndarray, grad: np.ndarray, dtype) -> np.ndarray:
    def inter(f):
        out = jnp.einsum("bnd,bmd->bnm", f, f)
        iu, ju = jnp.triu_indices(f.shape[1], k=1)
        return out[:, iu, ju]

    _, vjp = jax.vjp(inter, jnp.asarray(feats, dtype=dtype))
    (g,) = vjp(jnp.asarray(grad, dtype=dtype))
    return np.asarray(g.astype(jnp.float32))


@pytest.mark.parametrize("n", [2, 5, 27])
def test_backward_matches_jax_vjp_f32(n):
    """f32: the vjp is two batched products and their sum; the port one sum
    per output over j != i. Order only, so 1e-5; the autograd of the
    differentiable entry point and ``dot_interaction_bwd`` agree exactly."""
    feats = _feats(16, n, 16, seed=20 + n)
    grad = np.random.default_rng(n).standard_normal((16, n * (n - 1) // 2)).astype(np.float32)
    x = torch.from_numpy(feats).requires_grad_(True)
    (dx,) = torch.autograd.grad(dot_interaction(x), x, torch.from_numpy(grad))
    ref = _jax_vjp(feats, grad, jnp.float32)
    np.testing.assert_allclose(dx.numpy(), ref, rtol=1e-5, atol=1e-5)
    direct = dot_interaction_bwd(torch.from_numpy(feats), torch.from_numpy(grad))
    assert torch.equal(direct, dx)


@pytest.mark.parametrize("n", [2, 5, 27])
def test_backward_matches_jax_vjp_bf16(n):
    """bf16: the reference rounds each of its two products and their sum to
    bf16, the port one f32 sum once; one bf16 ulp (2^-7 relative) of the
    largest term for the outputs that cancel."""
    rng = np.random.default_rng(30 + n)
    feats = np.array(jnp.asarray(_feats(16, n, 16, seed=30 + n), jnp.bfloat16).astype(jnp.float32))
    grad = np.array(jnp.asarray(rng.standard_normal((16, n * (n - 1) // 2)), jnp.bfloat16).astype(jnp.float32))
    dx = dot_interaction_bwd(torch.from_numpy(feats).to(torch.bfloat16), torch.from_numpy(grad).to(torch.bfloat16))
    assert dx.dtype == torch.bfloat16 and dx.shape == feats.shape
    ref = _jax_vjp(feats, grad, jnp.bfloat16)
    np.testing.assert_allclose(dx.float().numpy(), ref, rtol=2 ** -7, atol=2 ** -7 * np.abs(ref).max())


def test_backward_rejects_mismatched_grad():
    with pytest.raises(ValueError):
        dot_interaction_bwd(torch.zeros(2, 3, 4), torch.zeros(2, 2))
