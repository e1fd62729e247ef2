"""The port's flash attention vs the reference's Pallas kernel (interpret
mode on the CPU, as tests/test_flash_attention.py runs it) and its dense
oracle, on the cases of that file (the kernel on a card:
tests/test_torch_kernels_gpu.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from persia_tpu.ops import flash_attention as jax_flash_attention
from persia_tpu.parallel.sequence import reference_attention as jax_reference_attention
from persia_tpu_torch.ops import flash_attention


def _qkv(b=2, l=64, h=4, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, l, h, d)).astype(np.float32) for _ in range(3)]


def _port(arrays, dtype=torch.float32, **kw):
    q, k, v = (torch.from_numpy(a).to(dtype) for a in arrays)
    return flash_attention(q, k, v, **kw)


# (name, shape kwargs, causal, jax block sizes)
CASES = [
    ("dense", dict(), False, dict(block_q=16, block_k=16)),
    ("causal", dict(), True, dict(block_q=16, block_k=16)),
    ("ragged_l37", dict(l=37, seed=1), True, dict(block_q=16, block_k=16)),
    ("single_block_l8", dict(l=8, seed=2), False, dict()),
]


@pytest.mark.parametrize("name,shape,causal,blocks", CASES, ids=[c[0] for c in CASES])
def test_matches_jax_f32(name, shape, causal, blocks):
    """f32 on both sides: the JAX kernel's online softmax and the dense f32
    softmax agree to 1e-5, the tolerance of tests/test_flash_attention.py."""
    arrays = _qkv(**shape)
    jq, jk, jv = (jnp.asarray(a) for a in arrays)
    ref = np.asarray(jax_flash_attention(jq, jk, jv, causal=causal, **blocks))
    out = _port(arrays, causal=causal)
    assert out.shape == tuple(arrays[0].shape) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)
    dense = np.asarray(jax_reference_attention(jq, jk, jv, causal=causal))
    np.testing.assert_allclose(out.numpy(), dense, atol=1e-5, rtol=1e-5)


def test_matches_jax_bf16():
    """bf16 in and out, compared in f32 at the JAX test's own bf16
    tolerance (3e-2): inputs and outputs each carry one bf16 rounding."""
    arrays = _qkv(seed=3)
    arrays = [np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in arrays]
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in arrays)
    ref = jax_flash_attention(jq, jk, jv, causal=True, block_q=16, block_k=16)
    out = _port(arrays, dtype=torch.bfloat16, causal=True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(ref, np.float32), atol=3e-2, rtol=3e-2
    )


def test_explicit_scale():
    arrays = _qkv(l=24, seed=7)
    jq, jk, jv = (jnp.asarray(a) for a in arrays)
    ref = np.asarray(jax_flash_attention(jq, jk, jv, scale=0.3, block_q=8, block_k=8))
    np.testing.assert_allclose(_port(arrays, scale=0.3).numpy(), ref, atol=1e-5, rtol=1e-5)


def test_rejects_bad_rank_and_mismatched_shapes():
    with pytest.raises(ValueError):
        flash_attention(torch.zeros(2, 8, 4), torch.zeros(2, 8, 4), torch.zeros(2, 8, 4))
    with pytest.raises(ValueError):
        flash_attention(torch.zeros(1, 8, 2, 16), torch.zeros(1, 9, 2, 16), torch.zeros(1, 9, 2, 16))


def test_cpu_path_launches_no_kernel():
    before = flash_attention.launches
    _port(_qkv(l=8))
    assert flash_attention.launches == before

