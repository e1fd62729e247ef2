"""DIN's masked attention pool (``persia_tpu_torch/ops/attention_pool.py``)
against the expression it replaces, ``persia_tpu/models/din.py:67-72``
(written out here in ``jnp`` as the model runs it), and its VJP by
``jax.vjp``, in f32 and bf16 history, with an all-padding row, a full row
and a row of one repeated history item.

Tolerances: the f32 weights to 1e-6 relative (exp and the sum in another
order); the pooled rows and d_logits, of the port and of the reference
alike, inside their f64 envelopes (``persia_tpu_torch.testing.envelopes``:
f32 sums in any order, then one rounding to the dtype, each side with its
own weights); d_hist is one rounding of a product on both sides, so it
differs only as the weights do (1e-6 in f32; 2^-7 in bf16, where they
round to neighbours). Masked positions and all-masked rows get exactly
zero gradient and nothing is NaN.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from persia_tpu_torch.ops import attention_pool, attention_pool_bwd, attention_pool_fwd
from persia_tpu_torch.ops.attention_pool import attention_pool_bwd_reference, attention_pool_fwd_reference
from persia_tpu_torch.testing.envelopes import attention_pool_bwd_envelope, attention_pool_fwd_envelope, outside

DTYPES = {"f32": (torch.float32, np.float32), "bf16": (torch.bfloat16, ml_dtypes.bfloat16)}


def _reference(logits, mask, hist, dt):
    """``din.py:67-72`` as the model runs it."""
    logits = jnp.where(mask, logits, -jnp.inf)
    any_valid = mask.any(axis=1, keepdims=True)
    w = jax.nn.softmax(jnp.where(any_valid, logits, 0.0), axis=1)
    w = jnp.where(mask, w, 0.0).astype(dt)
    return jnp.einsum("bl,bld->bd", w, hist)


def _inputs(seed, b=10, l=12, dim=16):
    rng = np.random.default_rng(seed)
    logits = (2 * rng.standard_normal((b, l))).astype(np.float32)
    mask = rng.random((b, l)) < 0.6
    mask[0] = False  # an all-padding row
    mask[1] = True  # a full row
    hist = rng.standard_normal((b, l, dim)).astype(np.float32)
    hist[2] = hist[2, 0]  # one history item repeated
    hist[~mask] = 0.0  # pads gather the zero row
    d_out = rng.standard_normal((b, dim)).astype(np.float32)
    return logits, mask, hist, d_out


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_matches_the_reference_and_its_vjp(dtype, seed):
    tdt, ndt = DTYPES[dtype]
    logits, mask, hist, d_out = _inputs(seed)
    hist_n = hist.astype(ndt)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    ref, vjp = jax.vjp(lambda lg, h: _reference(lg, jnp.asarray(mask), h, jdt), jnp.asarray(logits),
                       jnp.asarray(hist_n))
    jd_logits, jd_hist = vjp(jnp.asarray(d_out.astype(ndt)))

    lt = torch.from_numpy(logits).requires_grad_(True)
    ht = torch.from_numpy(hist).to(tdt).requires_grad_(True)
    out = attention_pool(lt, torch.from_numpy(mask), ht)
    out.backward(torch.from_numpy(d_out).to(tdt))

    ulp = 2.0 ** -24 if dtype == "f32" else 2.0 ** -8
    assert out.dtype == tdt and out.shape == (10, 16)
    got = out.detach().float().numpy()
    want = np.array(ref, np.float32)
    _, w = attention_pool_fwd_reference(torch.from_numpy(logits), torch.from_numpy(mask), ht.detach())
    jw = torch.from_numpy(_reference_weights(logits, mask))
    assert outside(out.detach(), attention_pool_fwd_envelope(w, ht.detach())) == 0
    assert outside(torch.from_numpy(want), attention_pool_fwd_envelope(jw, ht.detach())) == 0
    np.testing.assert_array_equal(got[0], 0)

    dl, dh = lt.grad.numpy(), ht.grad.float().numpy()
    jdl, jdh = np.array(jd_logits, np.float32), np.array(jd_hist, np.float32)
    assert np.isfinite(dl).all() and np.isfinite(dh).all()
    np.testing.assert_array_equal(dl[~mask], 0)
    np.testing.assert_array_equal(dl[0], 0)
    np.testing.assert_array_equal(dh[~mask], 0)
    d_out_t, mask_t = torch.from_numpy(d_out).to(tdt), torch.from_numpy(mask)
    assert outside(torch.from_numpy(dl), attention_pool_bwd_envelope(d_out_t, mask_t, ht.detach(), w)) == 0
    assert outside(torch.from_numpy(jdl), attention_pool_bwd_envelope(d_out_t, mask_t, ht.detach(), jw)) == 0
    # d_hist: one rounding of w_T * d_out on both sides; the weights differ
    # by the softmax's 1e-6 (f32) or round to neighbouring values (bf16)
    np.testing.assert_allclose(dh, jdh, rtol=1e-6 if dtype == "f32" else 2 * ulp, atol=1e-30)


def _reference_weights(logits, mask):
    """``din.py:67-71``'s f32 weights, before the cast."""
    lg = jnp.where(jnp.asarray(mask), jnp.asarray(logits), -jnp.inf)
    ref = jax.nn.softmax(jnp.where(jnp.asarray(mask).any(axis=1, keepdims=True), lg, 0.0), axis=1)
    return np.array(jnp.where(jnp.asarray(mask), ref, 0.0))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_weights_match_the_reference_softmax(dtype):
    tdt, _ = DTYPES[dtype]
    logits, mask, hist, _ = _inputs(3)
    _, w = attention_pool_fwd(torch.from_numpy(logits), torch.from_numpy(mask), torch.from_numpy(hist).to(tdt))
    ref = _reference_weights(logits, mask)
    assert w.dtype == torch.float32
    np.testing.assert_allclose(w.numpy(), ref, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(w.numpy().sum(axis=1)[1:], 1.0, rtol=1e-6)
    np.testing.assert_array_equal(w.numpy()[0], 0)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_wrappers_equal_their_plain_versions_on_the_cpu(dtype):
    tdt, _ = DTYPES[dtype]
    logits, mask, hist, d_out = (torch.from_numpy(a) for a in _inputs(4))
    hist, d_out = hist.to(tdt), d_out.to(tdt)
    out, w = attention_pool_fwd(logits, mask, hist)
    ref_out, ref_w = attention_pool_fwd_reference(logits, mask, hist)
    assert torch.equal(out, ref_out) and torch.equal(w, ref_w)
    got = attention_pool_bwd(d_out, mask, hist, w)
    for a, b in zip(got, attention_pool_bwd_reference(d_out, mask, hist, w)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        attention_pool_fwd(logits.double(), mask, hist)
    with pytest.raises(ValueError):
        attention_pool_fwd(logits, mask.int(), hist)
    with pytest.raises(ValueError):
        attention_pool_bwd(d_out.float() if tdt == torch.bfloat16 else d_out.bfloat16(), mask, hist, w)


def _bf16_faults(w, mask, hist, d_out):
    """The bf16 route's faults the envelopes must catch: the weights not
    rounded before the product, truncation in place of round-to-nearest,
    the lowest-weight valid position of each row dropped, and g not
    rounded before the softmax's backward."""
    exact = torch.einsum("bl,bld->bd", w.to(torch.bfloat16).double(), hist.double()).float()
    w_drop = w.clone()
    w_drop[torch.arange(w.shape[0]), torch.where(mask, w, torch.inf).argmin(dim=1)] = 0.0
    g = torch.where(mask, torch.einsum("bd,bld->bl", d_out.float(), hist.float()), 0.0)
    return {
        "unrounded_weights": torch.einsum("bl,bld->bd", w, hist.float()).bfloat16(),
        "truncated": (exact.view(torch.int32) & ~0xFFFF).view(torch.float32).bfloat16(),
        "dropped_position": torch.einsum("bl,bld->bd", w_drop.bfloat16().float(), hist.float()).bfloat16(),
    }, torch.where(mask, w * (g - (w * g).sum(dim=1, keepdim=True)), 0.0)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_envelopes_hold_the_plain_version_and_catch_bf16_faults(dtype, seed):
    """At the DIN path's shape (B=1024, L=50, dim 16, Taobao-like history
    lengths), the plain versions lie inside the envelopes the card's
    kernels are held to, and in bf16 each fault of ``_bf16_faults`` lands
    outside them."""
    tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    b, l, dim = 1024, 50, 16
    lengths = rng.integers(1, l + 1, b)
    lengths[0], lengths[1] = 0, l
    mask = torch.from_numpy(np.arange(l)[None, :] < lengths[:, None])
    hist = torch.from_numpy(rng.standard_normal((b, l, dim)).astype(np.float32)) * mask[..., None]
    hist = hist.to(tdt)
    logits = torch.from_numpy((2 * rng.standard_normal((b, l))).astype(np.float32))
    d_out = torch.from_numpy(rng.standard_normal((b, dim)).astype(np.float32)).to(tdt)
    out, w = attention_pool_fwd_reference(logits, mask, hist)
    d_logits, _ = attention_pool_bwd_reference(d_out, mask, hist, w)
    fwd_env = attention_pool_fwd_envelope(w, hist)
    bwd_env = attention_pool_bwd_envelope(d_out, mask, hist, w)
    assert outside(out, fwd_env) == 0 and outside(d_logits, bwd_env) == 0
    if tdt == torch.bfloat16:
        faults, unrounded_g = _bf16_faults(w, mask, hist, d_out)
        for name, bad in faults.items():
            assert outside(bad, fwd_env) > 100, name
        assert outside(unrounded_g, bwd_env) > 1000
