"""The port's flash attention vs the reference's Pallas kernel (interpret
mode on the CPU, as tests/test_flash_attention.py runs it) and its dense
oracle, on the cases of that file; its q, k and v gradients vs ``jax.grad``
of the reference's (whose backward is a dense recompute); and the f32
route's split-TF32 arithmetic, emulated in torch (the kernels on a card:
tests/test_torch_kernels_gpu.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from persia_tpu.ops import flash_attention as jax_flash_attention
from persia_tpu.parallel.sequence import reference_attention as jax_reference_attention
from persia_tpu_torch.ops import flash_attention, plans, tf32_split_planes
from persia_tpu_torch.ops.flash_attention import (
    route_tolerance,
    tf32_round,
    tf32_split,
    tf32_split_planes_reference,
)


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


GRAD_CASES = [
    ("dense", dict(), False, None, torch.float32),
    ("causal", dict(), True, None, torch.float32),
    ("ragged_l37", dict(l=37, seed=1), True, None, torch.float32),
    ("scale_0.3", dict(l=24, seed=7), False, 0.3, torch.float32),
    ("bf16_causal", dict(seed=3), True, None, torch.bfloat16),
]


@pytest.mark.parametrize("name,shape,causal,scale,dtype", GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_gradients_match_jax(name, shape, causal, scale, dtype):
    """dq, dk, dv of sum(out * w): the port's autograd on the CPU vs
    ``jax.grad`` through the reference's ``custom_vjp`` (the Pallas forward
    in interpret mode, the dense recompute backward). Both differentiate
    the dense f32 softmax: f32 to 1e-5; bf16 (inputs, output and gradients
    each rounded once) to 3e-2, the bf16 forward's tolerance."""
    arrays = _qkv(**shape)
    if dtype == torch.bfloat16:
        arrays = [np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in arrays]
    w = np.random.default_rng(99).standard_normal(arrays[0].shape).astype(np.float32)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16

    def loss(q, k, v):
        out = jax_flash_attention(q, k, v, causal=causal, scale=scale, block_q=16, block_k=16)
        return jnp.sum(out.astype(jnp.float32) * w)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a, jdtype) for a in arrays))
    q, k, v = (torch.from_numpy(a).to(dtype).requires_grad_(True) for a in arrays)
    (flash_attention(q, k, v, causal=causal, scale=scale).float() * torch.from_numpy(w)).sum().backward()
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else dict(atol=3e-2, rtol=3e-2)
    for got, ref in zip((q.grad, k.grad, v.grad), want):
        assert got.dtype == dtype and got.shape == q.shape
        np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), **tol)


def test_rejects_bad_rank_and_mismatched_shapes():
    with pytest.raises(ValueError):
        flash_attention(torch.zeros(2, 8, 4), torch.zeros(2, 8, 4), torch.zeros(2, 8, 4))
    with pytest.raises(ValueError):
        flash_attention(torch.zeros(1, 8, 2, 16), torch.zeros(1, 9, 2, 16), torch.zeros(1, 9, 2, 16))


def test_tf32_split_planes_rejects_bad_rank_and_mismatched_shapes():
    with pytest.raises(ValueError):
        tf32_split_planes(torch.zeros(2, 8, 4), torch.zeros(2, 8, 4), torch.zeros(2, 8, 4))
    with pytest.raises(ValueError):
        tf32_split_planes(torch.zeros(1, 8, 2, 16), torch.zeros(1, 8, 2, 16), torch.zeros(1, 9, 2, 16))


def test_cpu_path_launches_no_kernel():
    before = flash_attention.launches
    _port(_qkv(l=8))
    assert flash_attention.launches == before



def _bits(x):
    return x.contiguous().view(torch.int32)


def _f32(*patterns):
    return torch.tensor(patterns, dtype=torch.int64).to(torch.int32).view(torch.float32)


def test_tf32_split_hi_and_lo_are_tf32_and_sum_to_x():
    rng = np.random.default_rng(11)
    x = torch.from_numpy(
        (rng.standard_normal(100_000) * 10.0 ** rng.integers(-30, 30, 100_000)).astype(np.float32)
    )
    hi, lo = tf32_split(x)
    assert not (_bits(hi) & 0x1FFF).any() and not (_bits(lo) & 0x1FFF).any()
    # hi to half a TF32 ulp (2^-11 relative), hi + lo to 2^-22
    x64 = x.double()
    assert ((hi.double() - x64).abs() <= 2.0 ** -11 * x64.abs()).all()
    assert ((hi.double() + lo.double() - x64).abs() <= 2.0 ** -22 * x64.abs()).all()


def test_tf32_round_ties_away_from_zero_and_carries():
    one_and_half_ulp = _f32(0x3F801000, -0x40800000 + 0x1000)  # ±(1 + 2^-11): exact ties
    assert tf32_round(one_and_half_ulp).tolist() == [1 + 2 ** -10, -(1 + 2 ** -10)]
    below = _f32(0x3F800FFF)  # just under the tie
    assert tf32_round(below).tolist() == [1.0]
    # a carry out of the mantissa moves the exponent, and past the largest
    # finite value (0x7F7FFFFF) reaches inf, as cvt.rna does
    assert tf32_round(_f32(0x3FFFFFFF, 0x7F7FFFFF)).tolist() == [2.0, float("inf")]
    # subnormals round on the same bits
    assert _bits(tf32_round(_f32(0x00001000, 0x00000FFF))).tolist() == [0x2000, 0]


def test_tf32_split_passes_zeros_infs_and_nans_through():
    x = torch.tensor([0.0, -0.0, float("inf"), float("-inf"), float("nan")])
    hi, lo = tf32_split(x)
    assert _bits(hi)[:4].tolist() == _bits(x)[:4].tolist()  # the sign of -0 kept
    assert torch.isnan(hi[4])
    assert lo[:2].tolist() == [0.0, 0.0]


@pytest.mark.parametrize("l", [8, 37, 64, 100])
def test_tf32_split_planes_reference_layout(l):
    b, h, d = 2, 3, 16
    q, k, v = (torch.from_numpy(a) for a in _qkv(b=b, l=l, h=h, d=d, seed=l))
    qk, vt = tf32_split_planes_reference(q, k, v)
    pad = plans.tf32_plan(b, l, h, d, False).seq_pad
    assert qk.shape == (4, b * h, pad, d) and vt.shape == (2, b * h, d, pad)
    order = plans.TF32_KEY_ORDER
    for bi, hi_, pos in [(0, 0, 0), (1, 2, l - 1), (1, 1, l // 2)]:
        bh = bi * h + hi_
        for plane, x in enumerate((q, k)):
            split = tf32_split(x[bi, pos, hi_])
            assert torch.equal(qk[2 * plane, bh, pos], split[0])
            assert torch.equal(qk[2 * plane + 1, bh, pos], split[1])
        key = pos - pos % 8 + order[pos % 8]  # position pos of a V^T row holds this key
        expect = tf32_split(v[bi, key, hi_]) if key < l else (torch.zeros(d), torch.zeros(d))
        assert torch.equal(vt[0, bh, :, pos], expect[0]) and torch.equal(vt[1, bh, :, pos], expect[1])
    # padded rows zero (V^T: past the last group of 8, whose order mixes keys)
    assert not qk[:, :, l:].any() and not vt[..., -(-l // 8) * 8:].any()
    before = tf32_split_planes.launches
    tf32_split_planes(q, k, v)  # CPU tensors: the plain version, no launch
    assert tf32_split_planes.launches == before


def _emulate_tf32(q, k, v, causal, scale=None, passes=3):
    """The f32 route's arithmetic in torch on the CPU: S and P·V from the
    pre-pass's planes, each product as hi·hi (+ hi·lo + lo·hi with three
    passes) of TF32 values with f32 sums, P split in the V^T key order, the
    softmax in f32."""
    b, l, h, d = q.shape
    scale = d ** -0.5 if scale is None else scale
    qk, (v_hi, v_lo) = tf32_split_planes_reference(q, k, v)
    q_hi, q_lo, k_hi, k_lo = qk[:, :, :l]
    s = q_hi @ k_hi.transpose(1, 2)
    if passes == 3:
        s = s + q_hi @ k_lo.transpose(1, 2) + q_lo @ k_hi.transpose(1, 2)
    if causal:
        s = s.masked_fill(torch.ones(l, l, dtype=torch.bool).triu(1), float("-inf"))
    p = torch.exp((s - s.amax(-1, keepdim=True)) * scale)
    denom = p.sum(-1, keepdim=True)
    pad = v_hi.shape[-1] - l
    keys = (torch.arange(0, l + pad, 8)[:, None] + torch.tensor(plans.TF32_KEY_ORDER)).reshape(-1)
    p_hi, p_lo = tf32_split(torch.nn.functional.pad(p, (0, pad))[..., keys])
    o = p_hi @ v_hi.transpose(1, 2)
    if passes == 3:
        o = o + p_hi @ v_lo.transpose(1, 2) + p_lo @ v_hi.transpose(1, 2)
    return (o / denom).reshape(b, h, l, d).permute(0, 2, 1, 3)


@pytest.mark.parametrize("name,shape,causal,blocks", CASES, ids=[c[0] for c in CASES])
def test_tf32x3_arithmetic_matches_jax(name, shape, causal, blocks):
    """Three TF32 passes keep the JAX kernel's f32 result to 1e-5."""
    arrays = _qkv(**shape)
    jq, jk, jv = (jnp.asarray(a) for a in arrays)
    ref = np.asarray(jax_flash_attention(jq, jk, jv, causal=causal, **blocks))
    out = _emulate_tf32(*(torch.from_numpy(a) for a in arrays), causal=causal)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_one_tf32_pass_misses_the_f32_tolerance():
    """Why the route takes three passes: at (1, 1024, 2, 64) causal one TF32
    pass exceeds the f32 route's tolerance against an f64 reference; three
    stay far inside it."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(b=1, l=1024, h=2, d=64, seed=5))
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) * 64 ** -0.5
    s = s.masked_fill(torch.ones(1024, 1024, dtype=torch.bool).triu(1), float("-inf"))
    ref = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v.double())
    rtol, atol = route_tolerance(v)
    ratio = {
        passes: float(((_emulate_tf32(q, k, v, True, passes=passes).double() - ref).abs()
                       / (atol + rtol * ref.abs())).max())
        for passes in (1, 3)
    }
    assert ratio[1] > 1.0, ratio
    assert ratio[3] < 0.05, ratio
