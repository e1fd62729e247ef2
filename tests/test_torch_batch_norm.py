"""flax's BatchNorm in the port (``ops.batch_norm``: K10 and K11 on the
card, their plain versions here) against ``flax.linen.BatchNorm`` as
``persia_tpu/models/dnn.py`` builds it (``use_fast_variance``, momentum
0.99, epsilon 1e-5, f32 statistics), on the same numpy-seeded inputs: the
output, the new running statistics and the gradients of the input, the
scale and the bias, in train mode and with the running statistics, bf16
and f32, at B = 1 and at a C that is not a multiple of 8; the launch
geometry (``plans.batch_norm_plan``) and the kernels' sum order
(``plans.batch_norm_sum_model``), which the card tests hold K10 and K11 to.

Tolerances: f32, 1e-5 relative with an absolute floor of 1e-5 times the
column's scale (sums in another order, the variance a difference of two of
them); bf16 outputs within one bf16 ulp (2^-7 relative) plus that floor. The
input's gradient is held to one ulp of itself plus one ulp of each of the
two paths into x: flax's autodiff rounds the direct path (``x - mean``)
and the statistics' path to the dtype apart and adds them there, the port
rounds their f32 sum once, so where the paths cancel flax's error is an
ulp of the larger path.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from persia_tpu_torch.models.layers import BatchNorm
from persia_tpu_torch.ops import batch_norm, batch_norm_bwd, batch_norm_fwd, plans

JAX_DTYPES = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}


def _inputs(b, c, seed, dtype):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, c)) * rng.uniform(0.5, 3.0, c) + rng.uniform(-2, 2, c)).astype(np.float32)
    x = torch.from_numpy(x).to(dtype).float().numpy()  # on the dtype's grid, the same values both sides
    return dict(
        x=x, dy=torch.from_numpy(rng.standard_normal((b, c)).astype(np.float32)).to(dtype).float().numpy(),
        scale=(1 + 0.2 * rng.standard_normal(c)).astype(np.float32),
        bias=(0.1 * rng.standard_normal(c)).astype(np.float32),
        mean=(0.3 * rng.standard_normal(c)).astype(np.float32),
        var=rng.uniform(0.5, 2.0, c).astype(np.float32),
    )


def _flax(inp, dtype, train):
    jdt = JAX_DTYPES[dtype]
    bn = fnn.BatchNorm(use_running_average=not train, dtype=jdt)
    stats = {"mean": jnp.asarray(inp["mean"]), "var": jnp.asarray(inp["var"])}

    def f(x, params):
        return bn.apply({"params": params, "batch_stats": stats}, x, mutable=["batch_stats"])

    params = {"scale": jnp.asarray(inp["scale"]), "bias": jnp.asarray(inp["bias"])}
    x = jnp.asarray(inp["x"]).astype(jdt)
    (y, upd), vjp = jax.vjp(f, x, params)
    dx, dp = vjp((jnp.asarray(inp["dy"]).astype(jdt), jax.tree.map(jnp.zeros_like, upd)))
    host = lambda a: np.asarray(jnp.asarray(a, jnp.float32))  # noqa: E731
    return dict(y=host(y), mean=host(upd["batch_stats"]["mean"]), var=host(upd["batch_stats"]["var"]),
                dx=host(dx), dscale=host(dp["scale"]), dbias=host(dp["bias"]))


def _port(inp, dtype, train):
    x = torch.from_numpy(inp["x"]).to(dtype).requires_grad_(True)
    scale = torch.from_numpy(inp["scale"]).requires_grad_(True)
    bias = torch.from_numpy(inp["bias"]).requires_grad_(True)
    mean, var = torch.from_numpy(inp["mean"].copy()), torch.from_numpy(inp["var"].copy())
    y = batch_norm(x, scale, bias, mean, var, train)
    y.backward(torch.from_numpy(inp["dy"]).to(dtype))
    return dict(y=y.detach().float().numpy(), mean=mean.numpy(), var=var.numpy(), dx=x.grad.float().numpy(),
                dscale=scale.grad.numpy(), dbias=bias.grad.numpy())


def _close(got, want, ulps, floor, what):
    err = np.abs(got - want)
    tol = ulps * np.abs(want) + floor
    assert (err <= tol).all(), f"{what}: max err {err.max():.3e}, worst excess {(err - tol).max():.3e}"


CASES = [(1, 10), (37, 10), (128, 64), (256, 16), (300, 128)]


@pytest.mark.parametrize("b,c", CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("train", [True, False])
def test_batch_norm_matches_flax(b, c, dtype, train):
    inp = _inputs(b, c, 7 * b + c, dtype)
    want, got = _flax(inp, dtype, train), _port(inp, dtype, train)
    rel = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    mag = np.abs(inp["x"]).max(0) + 1.0  # the column's scale
    _close(got["y"], want["y"], rel, 1e-5 * mag * np.abs(inp["scale"]).max() * 4, "y")
    _close(got["mean"], want["mean"], 1e-5, 1e-6 * mag, "running mean")
    _close(got["var"], want["var"], 1e-5, 1e-5 * mag * mag, "running var")
    # dx: flax rounds its two paths into x apart, so each path's size
    # bounds its error: the direct one dy * m, the statistics' the rest
    x64 = inp["x"].astype(np.float64)
    var = x64.var(0) if train else inp["var"].astype(np.float64)
    direct = inp["dy"] * inp["scale"] / np.sqrt(var + 1e-5)
    paths = np.abs(direct) + np.abs(want["dx"] - direct)
    _close(got["dx"], want["dx"], rel, rel * paths + 1e-6 * np.abs(direct).max(), "dx")
    dmag = np.abs(inp["dy"]).sum(0) * mag
    _close(got["dscale"], want["dscale"], 1e-4, 1e-5 * dmag, "dscale")
    _close(got["dbias"], want["dbias"], 1e-5, 1e-6 * np.abs(inp["dy"]).sum(0), "dbias")
    if not train:  # the running statistics stay as they were
        np.testing.assert_array_equal(got["mean"], inp["mean"])
        np.testing.assert_array_equal(got["var"], inp["var"])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_batch_norm_single_row(dtype):
    """B = 1: flax's variance is 0, so x - mean is 0, y = bias, and no
    gradient reaches x."""
    inp = _inputs(1, 10, 3, dtype)
    got = _port(inp, dtype, True)
    np.testing.assert_array_equal(got["y"], torch.from_numpy(inp["bias"]).to(dtype).float().numpy()[None])
    np.testing.assert_array_equal(got["var"], np.float32(0.99) * inp["var"])
    np.testing.assert_array_equal(got["dx"], np.zeros_like(got["dx"]))
    np.testing.assert_array_equal(got["dscale"], np.zeros_like(got["dscale"]))
    want = _flax(inp, dtype, True)
    np.testing.assert_array_equal(got["y"], want["y"])
    np.testing.assert_array_equal(got["dx"], want["dx"])


def test_running_variance_is_flax_biased_not_batchnorm1d():
    """The running variance moves by the biased batch variance with weight
    0.01: ``torch.nn.BatchNorm1d`` (unbiased, momentum counted the other
    way) gives another value, and fails this test."""
    inp = _inputs(16, 8, 5, torch.float32)
    x = torch.from_numpy(inp["x"])
    biased = x.var(0, unbiased=False)
    want = np.float32(0.99) * torch.ones(8) + np.float32(0.01) * biased
    bn = BatchNorm(8, device="cpu").train()
    bn(x)
    np.testing.assert_allclose(bn.var.numpy(), want.numpy(), rtol=1e-6)
    torch_bn = torch.nn.BatchNorm1d(8, momentum=0.01).train()
    torch_bn(x)
    assert not np.allclose(torch_bn.running_var.numpy(), want.numpy(), rtol=1e-6)
    np.testing.assert_allclose(bn.mean.numpy(), (np.float32(0.01) * x.mean(0)).numpy(), rtol=1e-6)


def test_running_statistics_move_once_a_forward():
    """The forward moves the running statistics; its backward does not."""
    bn = BatchNorm(8, device="cpu").train()
    x = torch.from_numpy(_inputs(32, 8, 9, torch.float32)["x"]).requires_grad_(True)
    y = bn(x)
    after_fwd = bn.mean.clone(), bn.var.clone()
    y.sum().backward()
    assert torch.equal(bn.mean, after_fwd[0]) and torch.equal(bn.var, after_fwd[1])
    assert not torch.equal(bn.var, torch.ones(8))
    bn.eval()
    with torch.inference_mode():
        bn(x.detach())
    assert torch.equal(bn.mean, after_fwd[0]) and torch.equal(bn.var, after_fwd[1])


def test_wrappers_check_their_inputs():
    x = torch.zeros(4, 8)
    ones = torch.ones(8)
    with pytest.raises(ValueError):
        batch_norm_fwd(x, torch.ones(7), ones, ones, ones, True)
    with pytest.raises(TypeError):
        batch_norm_fwd(x.half(), ones, ones, ones, ones, True)
    with pytest.raises(ValueError):
        batch_norm_bwd(torch.zeros(4, 7), x, ones, torch.zeros(3, 8), True)


@pytest.mark.parametrize("rows,cols,elem,aligned", [
    (4096, 128, 2, True), (4096, 32, 2, True), (256, 128, 2, True), (128, 64, 2, True), (128, 16, 2, True),
    (1, 10, 2, True), (37, 10, 4, True), (4096, 128, 4, True), (100, 12, 2, True), (5, 8, 2, False),
    (2049, 128, 2, True), (1 << 16, 4096, 2, True),
])
def test_batch_norm_plan_covers_every_column(rows, cols, elem, aligned):
    """Every column in one cluster, every row in one block of it, each
    lane at most ``BN_ROWS_A_LANE`` rows of a span split over a cluster
    (one row where a block walks every row) where the block's threads
    allow, and no more lanes than that needs."""
    p = plans.batch_norm_plan(rows, cols, elem, aligned)
    assert p.groups * p.vec * elem == 16
    assert 32 <= p.threads <= plans.BN_THREADS and p.threads & (p.threads - 1) == 0
    assert p.grid * p.cols_per_block >= cols > (p.grid - 1) * p.cols_per_block
    assert p.vec == (16 // elem if aligned and cols % (16 // elem) == 0 else 1)
    assert 1 <= p.slices <= plans.BN_MAX_SLICES and p.grid * p.slices <= max(p.grid, plans.BN_TARGET_BLOCKS)
    assert p.slices * p.span >= rows > (p.slices - 1) * p.span  # no block without rows
    assert p.slices == 1 or p.span >= plans.BN_SLICE_ROWS
    rows_a_lane = plans.BN_ROWS_A_LANE if p.slices > 1 else 1
    assert p.row_lanes * rows_a_lane >= p.span or p.threads == plans.BN_THREADS
    assert p.row_lanes == 32 // p.groups or (p.row_lanes // 2) * rows_a_lane < p.span


@pytest.mark.parametrize("rows,cols,blocks", [(4096, 128, 128), (4096, 32, 32), (256, 128, 16), (128, 64, 8)])
def test_batch_norm_plan_fills_the_card_at_the_path_shapes(rows, cols, blocks):
    """bf16 at the DNN paths' shapes: B=4096 splits each column group's rows
    over a cluster of 8 blocks (128 blocks at C=128, where one block a
    column group gave 16); the serving and adult-income batches stay one
    block a group."""
    p = plans.batch_norm_plan(rows, cols, 2)
    assert p.grid * p.slices == blocks


def test_batch_norm_plan_refuses_what_it_has_no_kernel_for():
    for args in ((0, 8, 2), (8, 0, 2), (8, 8, 8)):
        with pytest.raises(ValueError):
            plans.batch_norm_plan(*args)


@pytest.mark.parametrize("rows,cols,elem", [(4096, 128, 2), (129, 10, 2), (1000, 12, 4), (1, 16, 2), (2049, 128, 2)])
def test_batch_norm_sum_model_is_a_sum(rows, cols, elem):
    """The kernels' sum order, in numpy: within f32's bound of the exact
    sum, a permutation-free function of the rows (two calls agree), and
    the spans' sums added in order."""
    p = plans.batch_norm_plan(rows, cols, elem)
    v = np.random.default_rng(rows).standard_normal((rows, cols)).astype(np.float32)
    got = plans.batch_norm_sum_model(v, p)
    parts = [plans.batch_norm_sum_model(v[s * p.span:(s + 1) * p.span], dataclasses.replace(p, slices=1))
             for s in range(p.slices)]
    want = parts[0]
    for part in parts[1:]:
        want = want + part
    np.testing.assert_array_equal(got, want)
    exact = v.astype(np.float64).sum(0)
    bound = rows * np.finfo(np.float32).eps * np.abs(v).astype(np.float64).sum(0)
    assert (np.abs(got - exact) <= bound).all()
    np.testing.assert_array_equal(got, plans.batch_norm_sum_model(v, p))


@pytest.mark.parametrize("b,c", [(4096, 128), (37, 10), (1, 16), (300, 12)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("train", [True, False])
def test_kernel_schedules_are_the_plain_versions_in_another_sum_order(b, c, dtype, train):
    """``batch_norm_*_schedule`` (K10 and K11 bit for bit, the card tests
    hold them to it) are the plain versions with their column sums in the
    kernels' order: on inputs whose sums are exact in any order (small
    integers) the same bits, elsewhere within the sums' rounding."""
    from persia_tpu_torch.ops.batch_norm import (
        batch_norm_bwd_reference, batch_norm_bwd_schedule, batch_norm_fwd_reference, batch_norm_fwd_schedule,
    )

    rng = np.random.default_rng(b + c)
    for exact in (True, False):
        if exact:
            x = torch.from_numpy(rng.integers(-8, 9, (b, c)).astype(np.float32)).to(dtype)
            dy = torch.from_numpy(rng.integers(-4, 5, (b, c)).astype(np.float32)).to(dtype)
        else:
            inp = _inputs(b, c, b * c, dtype)
            x, dy = torch.from_numpy(inp["x"]).to(dtype), torch.from_numpy(inp["dy"]).to(dtype)
        scale = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))
        bias = torch.from_numpy(rng.uniform(-0.5, 0.5, c).astype(np.float32))
        rm, rv = torch.zeros(c), torch.ones(c)
        y, saved, srm, srv = batch_norm_fwd_schedule(x, scale, bias, rm, rv, train)
        assert torch.equal(rm, torch.zeros(c)) and torch.equal(rv, torch.ones(c))  # nothing changed in place
        py, psaved = batch_norm_fwd_reference(x, scale, bias, rm, rv, train)
        dx, ds, db = batch_norm_bwd_schedule(dy, x, scale, saved, train)
        pdx, pds, pdb = batch_norm_bwd_reference(dy, x, scale, psaved, train)
        if exact:  # sum(dy * (x - mean)) is not exact: dscale and dx stay close below
            for got, want in ((y, py), (saved, psaved), (srm, rm), (srv, rv), (db, pdb)):
                assert torch.equal(got, want)
        else:
            torch.testing.assert_close(saved, psaved, rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(y.float(), py.float(), rtol=2.0 ** -7, atol=1e-4)
            torch.testing.assert_close(db, pdb, rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(ds, pds, rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(dx.float(), pdx.float(), rtol=2.0 ** -7, atol=1e-4)


def _slot_grads(compute_dtype):
    """The slots' gradients of DNN at the serving bench's width in train
    mode, on the inputs of the card's
    ``test_dnn_backward_on_card_reaches_the_embeddings``."""
    from persia_tpu_torch.models import DNN
    from persia_tpu_torch.weights import seeded_flax_params_like, state_dict_from_flax

    rng = np.random.default_rng(9)
    dense = rng.standard_normal((512, 8)).astype(np.float32)
    embs = (0.3 * rng.standard_normal((8, 512, 16))).astype(np.float32)
    model = DNN(8, [16] * 8, 32, 128, (128, 64), compute_dtype=compute_dtype, device="cpu")
    model.load_state_dict(state_dict_from_flax(model, seeded_flax_params_like(model, 4)))
    leaves = [torch.from_numpy(e).requires_grad_(True) for e in embs]
    model.train()
    model([torch.from_numpy(dense)], leaves).sum().backward()
    return [leaf.grad.float() for leaf in leaves]


@pytest.mark.parametrize("term", ["k1", "k2"])
def test_a_dropped_backward_term_breaks_the_card_bound(term, monkeypatch):
    """The card test holds bf16 slot gradients to 1e-1 of their norm; a
    batch norm backward that drops its mean term (k1) or its variance term
    (k2) moves every slot's gradient by more than 0.15 of it."""
    import sys

    module = sys.modules["persia_tpu_torch.ops.batch_norm"]
    right = _slot_grads(torch.bfloat16)

    def planted(dy, x, scale, saved, training):
        mean, rstd, gate = saved
        d, xc = dy.float(), x.float() - mean
        m, n = rstd * scale, float(x.shape[0])
        dm = (d * xc).sum(0)
        k1 = torch.zeros_like(m) if term == "k1" else m * d.sum(0) / n
        k2 = torch.zeros_like(m) if term == "k2" else 2.0 * (-0.5 * (dm * scale) * (rstd * rstd * rstd) * gate) / n
        return ((d * m - k1) + k2 * xc).to(x.dtype), dm * rstd, d.sum(0)

    monkeypatch.setattr(module, "batch_norm_bwd_reference", planted)
    wrong = _slot_grads(torch.bfloat16)
    assert min(float((w - r).norm() / r.norm()) for w, r in zip(wrong, right)) > 0.15
