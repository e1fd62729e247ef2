"""The port's CUDA kernels on a card, each held to its plain version, and the
serving and training slices on the card held to the same code on the CPU.

Every test needs a card and skips without one. This file imports no JAX,
so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -q -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from persia_tpu_torch.ops import (
    PoolSlot,
    dot_interaction,
    dot_interaction_bwd,
    embedding_pool,
    flash_attention,
    gather_pool_bwd,
    gather_pool_fwd,
    tf32_split_planes,
)
from persia_tpu_torch.ops.dot_interaction import (
    dot_interaction_bwd_reference,
    dot_interaction_reference,
)
from persia_tpu_torch.ops.embedding_pool import (
    gather_pool_bwd_reference,
    gather_pool_fwd_reference,
    pool_csr,
)
from persia_tpu_torch.ops.flash_attention import (
    reference_attention,
    route_tolerance,
    tf32_split_planes_reference,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    return torch.device("cuda")


def _randn(shape, seed, dev, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dev, dtype)


@pytest.mark.parametrize(
    "dtype,rtol,atol", [(torch.float32, 1e-5, 1e-5), (torch.bfloat16, 2 ** -7, 1e-3)]
)
@pytest.mark.parametrize("b,n,d", [(4096, 27, 16), (4095, 27, 16), (33, 2, 8), (7, 60, 48), (5, 9, 24)])
def test_dot_interaction_kernel_matches_plain(cuda, b, n, d, dtype, rtol, atol):
    """f32 (the FMA walk) differs from the plain version only in summation
    order; bf16 (tensor cores where d and n allow) by at most one rounding
    of two f32 sums that differ in order."""
    feats = _randn((b, n, d), seed=n, dev=cuda, dtype=dtype)
    before = dot_interaction.launches
    out = dot_interaction(feats)
    torch.cuda.synchronize()
    assert dot_interaction.launches == before + 1
    assert out.shape == (b, n * (n - 1) // 2) and out.dtype == dtype
    torch.testing.assert_close(out.float(), dot_interaction_reference(feats).float(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l", [8, 37, 300, 1000, 1024])
def test_flash_attention_kernel_matches_plain_f32(cuda, d, causal, l):
    """f32 (split TF32, pre-pass + main kernel) vs the dense f32 plain
    version at every head dim, ragged and whole tiles; tolerance and its
    reason: route_tolerance."""
    q, k, v = (_randn((2, l, 3, d), seed=d + l + i, dev=cuda) for i in range(3))
    before = flash_attention.launches_by_route["tf32x3"], tf32_split_planes.launches
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    after = flash_attention.launches_by_route["tf32x3"], tf32_split_planes.launches
    assert after == (before[0] + 1, before[1] + 1)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, reference_attention(q, k, v, causal=causal), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", [(2, 37, 3, 16), (1, 300, 2, 32), (2, 1000, 3, 64), (1, 64, 2, 128)])
def test_tf32_split_planes_kernel_matches_plain_bitwise(cuda, shape):
    """The pre-pass rounds as cvt.rna.tf32 does: its planes equal the plain
    version's bit for bit, padding and V^T key order included."""
    q, k, v = (_randn(shape, seed=sum(shape) + i, dev=cuda) for i in range(3))
    qk, vt = tf32_split_planes(q, k, v)
    torch.cuda.synchronize()
    ref_qk, ref_vt = tf32_split_planes_reference(q, k, v)
    assert torch.equal(qk.view(torch.int32), ref_qk.view(torch.int32))
    assert torch.equal(vt.view(torch.int32), ref_vt.view(torch.int32))


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_tf32x3_many_waves(cuda, causal):
    """4096 blocks, many waves over the 132 SMs: every (b, h, q tile) once."""
    q, k, v = (_randn((8, 2048, 16, 64), seed=95 + i, dev=cuda) for i in range(3))
    out = flash_attention(q, k, v, causal=causal)
    torch.testing.assert_close(out, reference_attention(q, k, v, causal=causal), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("scale", [-0.3, 0.0])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_tf32x3_nonpositive_scale(cuda, scale, causal):
    q, k, v = (_randn((2, 100, 2, 32), seed=75 + i, dev=cuda) for i in range(3))
    out = flash_attention(q, k, v, causal=causal, scale=scale)
    ref = reference_attention(q, k, v, causal=causal, scale=scale)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_kernel_matches_plain_bf16(cuda, causal):
    """bf16 (the wgmma route) at an explicit scale; tolerance and its reason:
    route_tolerance."""
    q, k, v = (_randn((2, 200, 4, 64), seed=50 + i, dev=cuda, dtype=torch.bfloat16) for i in range(3))
    out = flash_attention(q, k, v, causal=causal, scale=0.2)
    ref = reference_attention(q, k, v, causal=causal, scale=0.2)
    assert out.dtype == torch.bfloat16
    rtol, atol = route_tolerance(v)
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l", [8, 37, 300, 1000, 1024])
def test_flash_attention_wgmma_matches_plain(cuda, d, causal, l):
    """The bf16 kernel at every head dim, ragged and whole tiles."""
    q, k, v = (_randn((2, l, 3, d), seed=7 * d + l + i, dev=cuda, dtype=torch.bfloat16) for i in range(3))
    before = dict(flash_attention.launches_by_route)
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches_by_route["wgmma_bf16"] == before["wgmma_bf16"] + 1
    rtol, atol = route_tolerance(v)
    torch.testing.assert_close(out.float(), reference_attention(q, k, v, causal=causal).float(),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_wgmma_many_waves(cuda, causal):
    """4096 blocks, many waves over the 132 SMs: every (b, h, q tile) once."""
    q, k, v = (_randn((8, 2048, 16, 64), seed=90 + i, dev=cuda, dtype=torch.bfloat16) for i in range(3))
    out = flash_attention(q, k, v, causal=causal)
    rtol, atol = route_tolerance(v)
    torch.testing.assert_close(out.float(), reference_attention(q, k, v, causal=causal).float(),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("scale", [-0.3, 0.0])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_wgmma_nonpositive_scale(cuda, scale, causal):
    """The kernel needs scale > 0; the wrapper rewrites the others into the
    same softmax."""
    q, k, v = (_randn((2, 100, 2, 32), seed=70 + i, dev=cuda, dtype=torch.bfloat16) for i in range(3))
    out = flash_attention(q, k, v, causal=causal, scale=scale)
    rtol, atol = route_tolerance(v)
    ref = reference_attention(q, k, v, causal=causal, scale=scale)
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=atol)


def test_flash_attention_routes_follow_dtype(cuda):
    q = _randn((1, 70, 2, 32), seed=3, dev=cuda)
    before = dict(flash_attention.launches_by_route)
    flash_attention(q, q, q)
    assert flash_attention.launches_by_route == {**before, "tf32x3": before["tf32x3"] + 1}
    qb = q.to(torch.bfloat16)
    flash_attention(qb, qb, qb)
    torch.cuda.synchronize()
    assert flash_attention.launches_by_route == {
        "tf32x3": before["tf32x3"] + 1, "wgmma_bf16": before["wgmma_bf16"] + 1,
    }


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((2, 16, 2, 24), device=cuda)
    with pytest.raises(ValueError):
        flash_attention(x, x, x)  # head dim 24
    x = torch.zeros((2, 16, 2, 16), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention(x, x, x)
    with pytest.raises(TypeError):
        tf32_split_planes(*(x.to(torch.bfloat16),) * 3)  # the pre-pass takes f32 only
    x = torch.zeros((2, 2, 16, 16), device=cuda).transpose(1, 2)
    with pytest.raises(ValueError):
        flash_attention(x, x, x)  # not contiguous
    with pytest.raises(TypeError):
        dot_interaction(torch.zeros((4, 3, 8), device=cuda, dtype=torch.float16))
    with pytest.raises(ValueError):
        dot_interaction(torch.zeros((4, 8, 3), device=cuda).transpose(1, 2))


def test_serving_slice_on_card_matches_cpu(cuda):
    from persia_tpu_torch.config import EmbeddingConfig, SlotConfig
    from persia_tpu_torch.ctx import InferCtx
    from persia_tpu_torch.data import IDTypeFeature, NonIDTypeFeature, PersiaBatch
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.embedding.store import EmbeddingStore
    from persia_tpu_torch.embedding.worker import EmbeddingWorker
    from persia_tpu_torch.models import DLRM
    from persia_tpu_torch.serving.engine import InferenceEngine
    from persia_tpu_torch.weights import seeded_flax_params_like, state_dict_from_flax

    slots = {f"cat_{i}": SlotConfig(dim=16) for i in range(4)}
    slots["hist"] = SlotConfig(dim=16, embedding_summation=False, sample_fixed_size=8)
    cfg = EmbeddingConfig(slots_config=slots, feature_index_prefix_bit=8)
    worker = EmbeddingWorker(cfg, [EmbeddingStore(optimizer=Adagrad().config, seed=3)], device_pooling=True)
    rng = np.random.default_rng(0)
    b = 64
    feats = [IDTypeFeature(f"cat_{i}", [rng.integers(0, 50, 1, dtype=np.uint64) for _ in range(b)])
             for i in range(4)]
    feats.append(IDTypeFeature("hist", [rng.integers(0, 64, rng.integers(0, 8), dtype=np.uint64)
                                        for _ in range(b)]))
    batch = PersiaBatch(feats, non_id_type_features=[NonIDTypeFeature(rng.normal(size=(b, 13)).astype(np.float32))],
                        requires_grad=False)
    worker.forward_directly(batch, train=True)
    preds, sd = {}, None
    for device in (None, "cpu"):  # None: the default device, the card
        model = DLRM(13, 5, 16, (32, 16), (64, 32), device=device)
        sd = sd or state_dict_from_flax(model, seeded_flax_params_like(model, 1))
        model.load_state_dict(sd)
        engine = InferenceEngine(InferCtx(model, worker, cfg, device=device), device=device)
        before = dot_interaction.launches
        preds[device] = engine.predict_from_bytes(batch.to_bytes())
        assert dot_interaction.launches == before + (1 if device is None else 0)
    assert np.isfinite(preds[None]).all()
    np.testing.assert_allclose(preds[None], preds["cpu"], rtol=0, atol=2e-2)


@pytest.mark.parametrize(
    "dtype,rtol,atol", [(torch.float32, 1e-5, 1e-5), (torch.bfloat16, 2 ** -7, 1e-2)]
)
@pytest.mark.parametrize("b,n,d", [(4096, 27, 16), (4095, 27, 16), (33, 2, 8), (7, 32, 64), (7, 60, 48),
                                   (5, 9, 24), (9, 17, 48)])
def test_dot_interaction_bwd_kernel_matches_plain(cuda, b, n, d, dtype, rtol, atol):
    """Both sum in f32 and round once: f32 differs from the plain version
    (two products and their sum) in order only; bf16 by one rounding of two
    f32 sums of ~n terms of magnitude ~d."""
    feats = _randn((b, n, d), seed=n + d, dev=cuda, dtype=dtype)
    g = _randn((b, n * (n - 1) // 2), seed=n + d + 1, dev=cuda, dtype=dtype)
    before = dot_interaction_bwd.launches
    out = dot_interaction_bwd(feats, g)
    torch.cuda.synchronize()
    assert dot_interaction_bwd.launches == before + 1
    assert out.shape == feats.shape and out.dtype == dtype
    torch.testing.assert_close(out.float(), dot_interaction_bwd_reference(feats, g).float(),
                               rtol=rtol, atol=atol)


def test_dot_interaction_autograd_launches_the_backward_kernel(cuda):
    feats = _randn((64, 27, 16), seed=5, dev=cuda, dtype=torch.bfloat16).requires_grad_(True)
    g = _randn((64, 351), seed=6, dev=cuda, dtype=torch.bfloat16)
    before = dot_interaction.launches, dot_interaction_bwd.launches
    (dx,) = torch.autograd.grad(dot_interaction(feats), feats, g)
    torch.cuda.synchronize()
    assert (dot_interaction.launches, dot_interaction_bwd.launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(dx.float(), dot_interaction_bwd_reference(feats.detach(), g).float(),
                               rtol=2 ** -7, atol=1e-2)


def _pool_ids(rng, batch, L, d, ids):
    """Row ids (batch, L) in [0, d): "uniform"; "zipf", zipf(1.2) ranks mod
    d (the hottest row ~18 % of the positions); "one_row", all on row 0;
    "edge", rows 0 and 1 take 64 and 128 positions, so both end on an edge
    of 64-position chunks (the rest uniform over the other rows)."""
    if ids == "uniform":
        return rng.integers(0, d, (batch, L))
    if ids == "zipf":
        return (rng.zipf(1.2, (batch, L)) - 1) % d
    if ids == "one_row":
        return np.zeros((batch, L), np.int64)
    flat = np.concatenate([np.zeros(64), np.ones(128), rng.integers(2, d, batch * L - 192)])
    return rng.permutation(flat).reshape(batch, L).astype(np.int64)


def _pool_group(dev, dtype, batch, slot_specs, seed, dim=16, ids="uniform"):
    """Rows and PoolSlots of a group: slot_specs is [(distinct D, L, counts?)];
    rows are padded to one P with zero rows past D, pads index row D."""
    rng = np.random.default_rng(seed)
    p = max(d for d, _, _ in slot_specs) + 1
    rows, slots = [], []
    for d, L, with_counts in slot_specs:
        r = np.zeros((p, dim), np.float32)
        r[:d] = rng.standard_normal((d, dim))
        counts = rng.integers(0 if L > 1 else 1, L + 1, batch).astype(np.int32)
        index = np.full((batch, L), d, np.int32)
        keep = np.arange(L)[None, :] < counts[:, None]
        index[keep] = _pool_ids(rng, batch, L, d, ids)[keep]
        order, offsets = pool_csr(index, p)
        rows.append(torch.from_numpy(r).to(dev, dtype))
        slots.append(PoolSlot(
            torch.from_numpy(index).to(dev),
            torch.from_numpy(counts.reshape(-1, 1)).to(dev) if with_counts else None,
            torch.from_numpy(order).to(dev), torch.from_numpy(offsets).to(dev),
        ))
    return rows, slots


# name: (batch, [(D, L, counts?)], dim, ids)
POOL_CASES = {
    "bench": (4096, [(1500, 1, False)] * 26, 16, "uniform"),
    "counts_L4": (1000, [(300, 4, True), (50, 4, False), (700, 1, True)], 16, "uniform"),
    "pads_L2": (333, [(5, 2, True), (1, 2, False)], 16, "uniform"),
    "70_slots": (64, [(20 + s, 1 + s % 3, s % 2 == 0) for s in range(70)], 16, "uniform"),
    "zipf_bench": (4096, [(1500, 1, False)] * 26, 16, "zipf"),
    "one_row": (4096, [(1500, 1, False)] * 4, 16, "one_row"),
    "chunk_edge": (1000, [(300, 1, False)] * 3, 16, "edge"),
    "dim8": (1000, [(300, 4, True), (50, 1, False)], 8, "zipf"),
    "dim24": (777, [(200, 2, True), (30, 1, False)], 24, "zipf"),
    "dim10_scalar": (500, [(60, 1, False), (9, 3, True)], 10, "zipf"),
    "dim3_scalar": (300, [(40, 2, True), (7, 1, False)], 3, "zipf"),
    "dim128": (512, [(100, 1, False), (20, 3, True)], 128, "zipf"),  # one lane group a chunk
}


def _sum_order_bound(grad, rows, slots):
    """Per element, twice the f32 sum-order error bound of its row's n
    terms, 2 (n - 1) 2^-24 sum|x| (each sum is within (n - 1) u sum|x| of
    the exact one). The kernel and index_add_ sum a row in different orders;
    the pad row D of the L > 1 cases and the hot zipf rows hold hundreds to
    thousands of terms, beyond what a fixed atol covers."""
    abs_sums = gather_pool_bwd_reference(grad.abs(), [r.float() for r in rows], slots)
    return [2 * (s.offsets[1:] - s.offsets[:-1]).float()[:, None] * 2 ** -24 * a for s, a in zip(slots, abs_sums)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_gather_pool_kernels_match_plain(cuda, case, dtype):
    """Forward: f32 sums of the same rows (in l order on both sides).
    Backward: f32 sums, the kernel in its chunked order, index_add_ in its
    own, one rounding to the row dtype. 70 slots: two launches each way
    (the backward's two passes count as one)."""
    batch, specs, dim, ids = POOL_CASES[case]
    rows, slots = _pool_group(cuda, dtype, batch, specs, seed=len(specs), dim=dim, ids=ids)
    launches = -(-len(specs) // 64)
    before = gather_pool_fwd.launches, gather_pool_bwd.launches
    out = gather_pool_fwd(rows, slots)
    g = _randn(out.shape, seed=7, dev=cuda)
    grads = gather_pool_bwd(g, rows, slots)
    torch.cuda.synchronize()
    assert (gather_pool_fwd.launches, gather_pool_bwd.launches) == (before[0] + launches, before[1] + launches)
    assert out.shape == (batch, len(specs), dim) and out.dtype == torch.float32
    torch.testing.assert_close(out, gather_pool_fwd_reference(rows, slots), rtol=1e-6, atol=1e-6)
    rtol, atol = (1e-5, 1e-5) if dtype == torch.float32 else (2 ** -7, 1e-3)
    bounds = _sum_order_bound(g, rows, slots)
    for got, ref, extra in zip(grads, gather_pool_bwd_reference(g, rows, slots), bounds):
        assert got.dtype == dtype and got.shape == ref.shape
        err = (got.float() - ref.float()).abs()
        assert bool((err <= atol + extra + rtol * ref.float().abs()).all()), float(err.max())


@pytest.mark.parametrize(
    "case", ["zipf_bench", "one_row", "chunk_edge", "dim8", "dim24", "dim10_scalar", "dim3_scalar", "dim128",
             "bench", "counts_L4"]
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_pool_bwd_follows_its_schedule_bitwise(cuda, case, dtype):
    """The kernel's sums are exactly those of plans.pool_bwd_model, its
    order in numpy, held on the CPU to an exact sum
    (tests/test_torch_pool_schedule.py): bit for bit, each rounded once to
    the row dtype. The scaled gradient rows the model sums are formed on the
    card as the kernel forms them (rsqrt of the count, one f32 product)."""
    from persia_tpu_torch.ops import plans

    batch, specs, dim, ids = POOL_CASES[case]
    rows, slots = _pool_group(cuda, dtype, batch, specs, seed=len(specs) + 1, dim=dim, ids=ids)
    g = _randn((batch, len(specs), dim), seed=11, dev=cuda)
    grads = gather_pool_bwd(g, rows, slots)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for s, (got, slot) in enumerate(zip(grads, slots)):
        x = g[:, s]
        if slot.counts is not None:
            x = x * torch.rsqrt(torch.clamp(slot.counts.reshape(-1), min=1).float())[:, None]
        index, order = slot.index.cpu().numpy(), slot.order.cpu().numpy()
        L, p = index.shape[1], got.shape[0]
        plan = plans.pool_plan(batch, 1, dim, got.element_size(), p, L)
        want = plans.pool_bwd_model(x.cpu().numpy()[order // L], index.reshape(-1)[order], p, plan)
        assert torch.equal(got.cpu().view(bits), torch.from_numpy(want).to(dtype).view(bits))


def test_gather_pool_bwd_is_deterministic(cuda):
    """Every row is written once, in a fixed order, with no atomics: two
    calls agree bit for bit on a hot-row (zipf) index."""
    batch, rng = 4096, np.random.default_rng(3)
    rows, slots = [], []
    for _ in range(4):
        index = np.minimum(rng.zipf(1.2, (batch, 1)) - 1, 511).astype(np.int32)
        order, offsets = pool_csr(index, 513)
        rows.append(torch.zeros((513, 16), device=cuda, dtype=torch.bfloat16))
        slots.append(PoolSlot(torch.from_numpy(index).to(cuda), None,
                              torch.from_numpy(order).to(cuda), torch.from_numpy(offsets).to(cuda)))
    g = _randn((batch, 4, 16), seed=8, dev=cuda)
    a, b = gather_pool_bwd(g, rows, slots), gather_pool_bwd(g, rows, slots)
    for x, y in zip(a, b):
        assert torch.equal(x.view(torch.int16), y.view(torch.int16))


def test_embedding_pool_autograd_on_card(cuda):
    rows, slots = _pool_group(cuda, torch.bfloat16, 256, [(40, 2, True), (9, 1, False)], seed=4)
    leaves = [r.clone().requires_grad_(True) for r in rows]
    before = gather_pool_fwd.launches, gather_pool_bwd.launches
    pooled = embedding_pool(leaves, slots)
    torch.stack(pooled, 1).pow(2).sum().backward()
    torch.cuda.synchronize()
    assert (gather_pool_fwd.launches, gather_pool_bwd.launches) == (before[0] + 1, before[1] + 1)
    ref = gather_pool_bwd_reference(2 * gather_pool_fwd_reference(rows, slots), rows, slots)
    for leaf, r in zip(leaves, ref):
        torch.testing.assert_close(leaf.grad.float(), r.float(), rtol=2 ** -7, atol=1e-3)


def test_new_wrappers_reject_what_the_kernels_do_not_take(cuda):
    rows, slots = _pool_group(cuda, torch.float32, 8, [(3, 1, False)], seed=1)
    with pytest.raises(TypeError):
        gather_pool_fwd([rows[0].half()], slots)
    with pytest.raises(ValueError):
        gather_pool_bwd(torch.zeros((8, 1, 16), device=cuda), rows, [slots[0]._replace(order=None)])
    with pytest.raises(ValueError):
        gather_pool_fwd(rows, [slots[0]._replace(index=slots[0].index.long())])
    x = torch.zeros((4, 3, 8), device=cuda)
    with pytest.raises(ValueError):
        dot_interaction_bwd(x, torch.zeros((4, 2), device=cuda))


def _flagship_cfg():
    from persia_tpu_torch.config import EmbeddingConfig, SlotConfig

    slots = {f"cat_{i}": SlotConfig(dim=16) for i in range(4)}
    slots["hist"] = SlotConfig(dim=16, embedding_summation=False, sample_fixed_size=8)
    return EmbeddingConfig(slots_config=slots, feature_index_prefix_bit=8)


def _flagship_ctx(device, device_pooling=True, wire_dtype=None, backend="numpy"):
    """The flagship-shaped TrainCtx (4 single-id + 1 raw slot, 2 replicas,
    f32 compute) from seeded weights; its stores."""
    from persia_tpu_torch.ctx import TrainCtx
    from persia_tpu_torch.embedding.native_store import create_store
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.embedding.worker import EmbeddingWorker
    from persia_tpu_torch.models import DLRM
    from persia_tpu_torch.weights import seeded_flax_params_like, state_dict_from_flax

    cfg = _flagship_cfg()
    model = DLRM(13, 5, 16, (32, 16), (64, 32), compute_dtype=torch.float32, device="cpu")
    model.load_state_dict(state_dict_from_flax(model, seeded_flax_params_like(model, 2)))
    stores = [create_store(backend, capacity=1 << 16, num_internal_shards=4, seed=3) for _ in range(2)]
    worker = EmbeddingWorker(cfg, stores, device_pooling=device_pooling)
    ctx = TrainCtx(model, torch.optim.Adam(model.parameters(), lr=1e-3), Adagrad(lr=0.1), worker, cfg,
                   device=device, wire_dtype=wire_dtype).__enter__()
    return ctx, stores


def _flagship_batches(n, b=256, seed=0):
    from persia_tpu_torch.data import IDTypeFeature, Label, NonIDTypeFeature, PersiaBatch

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        feats = [IDTypeFeature(f"cat_{i}", [rng.integers(0, 300, 1, dtype=np.uint64) for _ in range(b)])
                 for i in range(4)]
        feats.append(IDTypeFeature("hist", [rng.integers(0, 64, rng.integers(0, 8), dtype=np.uint64)
                                            for _ in range(b)]))
        out.append(PersiaBatch(feats, non_id_type_features=[NonIDTypeFeature(rng.normal(size=(b, 13)).astype(np.float32))],
                               labels=[Label(rng.integers(0, 2, (b, 1)).astype(np.float32))], requires_grad=True))
    return out


def _train_pair(device_pooling, wire_dtype, steps):
    """The flagship-shaped TrainCtx on the card and on the CPU from the
    same weights and batches."""
    out = {}
    for device in (None, "cpu"):
        ctx, stores = _flagship_ctx(device, device_pooling, wire_dtype)
        losses = []
        for batch in _flagship_batches(steps):
            losses.append(ctx.train_step(batch)["loss"])
            assert ctx.worker.staleness == 0
        out[device] = (ctx, losses, stores)
    return out


@pytest.mark.parametrize("device_pooling,wire_dtype", [(True, None), (True, "bfloat16"), (False, None)])
def test_training_slice_on_card_matches_cpu(cuda, device_pooling, wire_dtype):
    """Three TrainCtx steps on the card and on the CPU: losses, dense
    parameters and every PS entry agree (f32 compute; the card's kernels
    sum in other orders, and the bf16 wire rounds their sums)."""
    before = {fn.__name__: fn.launches for fn in (dot_interaction, dot_interaction_bwd, gather_pool_fwd,
                                                   gather_pool_bwd)}
    runs = _train_pair(device_pooling, wire_dtype, steps=3)
    pooled = 3 if device_pooling else 0
    assert dot_interaction.launches - before["dot_interaction"] == 3
    assert dot_interaction_bwd.launches - before["dot_interaction_bwd"] == 3
    assert gather_pool_fwd.launches - before["gather_pool_fwd"] == pooled
    assert gather_pool_bwd.launches - before["gather_pool_bwd"] == pooled
    (card, card_losses, card_stores), (cpu, cpu_losses, cpu_stores) = runs[None], runs["cpu"]
    tol = 1e-4 if wire_dtype is None else 1e-3
    np.testing.assert_allclose(card_losses, cpu_losses, rtol=0, atol=tol)
    for k, v in cpu.model.state_dict().items():
        np.testing.assert_allclose(card.model.state_dict()[k].cpu().numpy(), v.numpy(), rtol=0, atol=tol)
    for a, b in zip(card_stores, cpu_stores):
        assert a.size() == b.size()
        for shard in b._shards:
            for sign, (_, vec) in shard.entries.items():
                np.testing.assert_allclose(a.get_embedding_entry(sign), vec, rtol=0, atol=tol)


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_dlrm_backward_on_card_reaches_the_embeddings(cuda, compute_dtype):
    """Through the interaction kernel's autograd, every embedding input gets
    a non-zero gradient on the card, equal to the CPU port's: before the
    backward kernel, the card's interaction output had no grad_fn and these
    were None. f32 compute: the kernels sum in other orders (1e-4); bf16:
    the devices round at other points in every layer of the backward, so
    each slot's gradient is held to 1e-1 of its norm (a bug in the
    interaction's backward moves it by its whole size)."""
    from persia_tpu_torch.models import DLRM
    from persia_tpu_torch.weights import seeded_flax_params_like, state_dict_from_flax

    rng = np.random.default_rng(9)
    dense = rng.standard_normal((512, 13)).astype(np.float32)
    embs = rng.standard_normal((26, 512, 16)).astype(np.float32)
    grads, sd = {}, None
    for device in ("cuda", "cpu"):
        model = DLRM(13, 26, 16, (256, 64, 16), (512, 256), compute_dtype=compute_dtype, device=device)
        sd = sd or state_dict_from_flax(model, seeded_flax_params_like(model, 4))
        model.load_state_dict(sd)
        leaves = [torch.from_numpy(e).to(device).requires_grad_(True) for e in embs]
        model([torch.from_numpy(dense).to(device)], leaves).sum().backward()
        grads[device] = [l.grad for l in leaves]
    for g_card, g_cpu in zip(grads["cuda"], grads["cpu"]):
        assert g_card is not None and bool(g_card.abs().sum() > 0)
        if compute_dtype == torch.float32:
            torch.testing.assert_close(g_card.cpu(), g_cpu, rtol=1e-4, atol=1e-5)
        else:
            assert float((g_card.cpu() - g_cpu).norm() / g_cpu.norm()) < 1e-1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal,scale", [(False, None), (True, None), (False, -0.2)])
def test_flash_attention_backward_on_card_matches_cpu(cuda, dtype, causal, scale):
    """The card's output has a grad_fn, and its q, k, v gradients (the dense
    recompute, launching no kernel) match the CPU port's at the route
    tolerance; a negative scale is differentiated as the caller gave it,
    not as the launch rewrote it."""
    shape = (2, 200, 3, 64)
    host = [_randn(shape, seed=40 + i, dev="cpu", dtype=dtype) for i in range(3)]
    w = _randn(shape, seed=50, dev="cpu")
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        leaves = [x.to(dev).requires_grad_(True) for x in host]
        before = flash_attention.launches
        out = flash_attention(*leaves, causal=causal, scale=scale)
        assert out.requires_grad and (out.grad_fn is not None)
        (out.float() * w.to(dev)).sum().backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert flash_attention.launches == before + 1
        grads[dev.type] = [l.grad for l in leaves]
    rtol, atol = route_tolerance(host[2])
    for g_card, g_cpu in zip(grads["cuda"], grads["cpu"]):
        assert g_card.dtype == dtype and bool(torch.isfinite(g_card.float()).all())
        torch.testing.assert_close(g_card.cpu().float(), g_cpu.float(), rtol=rtol, atol=atol)


def test_pipelined_loader_on_card_with_native_cores(cuda):
    """The DataLoader on the card with the native store and worker and four
    lookup threads (staging on their own streams): every loss finite,
    every kernel of the step launched once a step, the window whole after
    flush. Then reproducible with staleness 1 against ``train_step`` on the
    same batches: the same losses and PS entries within 1e-5."""
    from persia_tpu_torch.data_loader import DataLoader
    from persia_tpu_torch.embedding import native_worker
    from persia_tpu_torch.embedding.native_store import store_backend_name
    from persia_tpu_torch.embedding.worker import preprocess_batch

    assert native_worker.available()
    ctx, stores = _flagship_ctx(None, wire_dtype="bfloat16", backend="native")
    assert all(store_backend_name(s) == "native" for s in stores)
    before = dot_interaction.launches, gather_pool_bwd.launches
    loader = DataLoader(iter(_flagship_batches(12)), ctx, num_workers=4, staleness=4)
    for tb in loader:
        ctx.train_step_prepared(tb, loader, fetch_metrics=False)
    loader.flush()
    assert np.isfinite(ctx.last_prepared_metrics()["loss"])
    assert (dot_interaction.launches - before[0], gather_pool_bwd.launches - before[1]) == (12, 12)
    assert ctx.worker.staleness == 0
    assert loader.staleness_state() == {"outstanding_gradient_batches": 0, "free_permits": 4, "staleness": 4}
    loader.shutdown()

    batches = _flagship_batches(4, seed=1)
    sync, sync_stores = _flagship_ctx(None, wire_dtype="bfloat16", backend="native")
    want = [sync.train_step(b)["loss"] for b in batches]
    pipe, pipe_stores = _flagship_ctx(None, wire_dtype="bfloat16", backend="native")
    loader = DataLoader(iter(batches), pipe, num_workers=4, staleness=1, reproducible=True)
    got = [pipe.train_step_prepared(tb, loader)["loss"] for tb in loader]
    loader.flush()
    loader.shutdown()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    signs = np.unique(np.concatenate([s.keys for b in batches
                                      for s in preprocess_batch(b.id_type_features, _flagship_cfg())]))
    assert [s.size() for s in pipe_stores] == [s.size() for s in sync_stores]
    rows = 0
    for a, b in zip(pipe_stores, sync_stores):
        for sign in signs.tolist():
            ea, eb = a.get_embedding_entry(sign), b.get_embedding_entry(sign)
            assert (ea is None) == (eb is None)
            if ea is not None:
                np.testing.assert_allclose(ea, eb, rtol=0, atol=1e-5)
                rows += 1
    assert rows == sum(s.size() for s in sync_stores) > 0


# --------------------------------------------------------------- fused tier


def _bits(t):
    t = t.detach().cpu().contiguous().reshape(-1)
    return t.view(torch.uint8)


FUSED_GATHER_CASES = {
    # (dtype, dim, slot shapes, vocab, stacked); a row of dim 16 f32 or bf16
    # takes 16-byte vectors, 10 f32 8-byte, 3 f32 4-byte, 3 bf16 2-byte
    "stacked_f32": (torch.float32, 16, [(4096,)] * 5, 1000, True),
    "stacked_bf16_pooled": (torch.bfloat16, 16, [(512,), (512, 5)], 1000, True),
    "unstacked_nan": (torch.float32, 16, [(777,)], 1000, False),
    "unstacked_bf16_bag": (torch.bfloat16, 8, [(100, 3)], 300, False),
    "dim_10": (torch.float32, 10, [(300,), (50, 2)], 200, True),
    "dim_3_f32": (torch.float32, 3, [(300,), (40, 3)], 200, True),
    "dim_3_bf16": (torch.bfloat16, 3, [(300,)], 200, True),
    "one_slot": (torch.float32, 16, [(1000,)], 500, True),
    "empty_slot": (torch.float32, 16, [(300,), (0,), (0, 4), (200, 2)], 100, True),
    "129_slots": (torch.bfloat16, 16, [(64,)] * 64 + [(16, 3)] * 65, 50, True),
}


@pytest.mark.parametrize("case", sorted(FUSED_GATHER_CASES))
def test_fused_gather_kernel_matches_plain(cuda, case):
    """K4 copies rows: bit for bit its plain version, pads, clamps and NaN
    rows included, with and without the update keys; the keys bit for bit
    ``update_keys_reference`` (pads, ids at vocab - 1, vocab and far past
    it), written once a position whatever the vector width; one launch a
    call and group of 128 slots, none of ``update_keys``."""
    from persia_tpu_torch.ops import fused_gather, update_keys
    from persia_tpu_torch.ops.fused_gather import fused_gather_reference, update_keys_reference

    dtype, dim, shapes, vocab, stacked = FUSED_GATHER_CASES[case]
    rng = np.random.default_rng(len(case))
    table = _randn((vocab * len(shapes), dim), 3, cuda, dtype)
    ids = []
    for s in shapes:
        a = rng.integers(-1, vocab + 3, s).astype(np.int32)
        a.reshape(-1)[:4] = [vocab + 7, -1, vocab - 1, 1 << 30][:a.size]
        ids.append(torch.from_numpy(a).to(cuda))
    offsets = [i * vocab for i in range(len(shapes))] if stacked else [0]
    vocabs = [vocab] * len(ids)
    calls = -(-len(ids) // 128)
    before, keys_before = fused_gather.launches, update_keys.launches
    out = fused_gather(table, ids, offsets, vocabs, stacked)
    assert fused_gather.launches == before + calls
    rows, keys = fused_gather(table, ids, offsets, vocabs, stacked, keys=True)
    assert fused_gather.launches == before + 2 * calls and update_keys.launches == keys_before
    ref = fused_gather_reference(table, ids, offsets, vocabs, stacked)
    assert out.dtype == dtype and out.shape == ref.shape
    assert torch.equal(_bits(out), _bits(ref)) and torch.equal(_bits(rows), _bits(ref))
    assert bool(out.isnan().any()) != stacked
    want = update_keys_reference([i.cpu() for i in ids], offsets, vocabs)
    assert keys.dtype == torch.int32 and torch.equal(keys.cpu(), want)


def _k5_inputs(kind, cfg, vocab, n, dim, dtype, seed):
    from persia_tpu_torch.ops.sparse_update import init_sparse_state

    rng = np.random.default_rng(seed)
    if kind == "uniform":
        ids = rng.integers(0, vocab, n)
    elif kind == "zipf":
        ids = (rng.zipf(1.2, n) - 1) % vocab
    else:
        ids = np.full(n, 5)
    ids = ids.astype(np.int32)
    ids[rng.random(n) < 0.1] = -1
    ids[:2] = vocab + 1
    table = (torch.from_numpy(rng.standard_normal((vocab, dim)).astype(np.float32)) * 0.05).to(dtype)
    state = init_sparse_state(cfg, vocab, dim)
    for v in state.values():
        v.copy_(torch.from_numpy(rng.uniform(0.01, 1.0, v.shape).astype(np.float32)))
    grads = torch.from_numpy(rng.standard_normal((n, dim)).astype(np.float32))
    return torch.from_numpy(ids), table, state, grads


@pytest.mark.parametrize("kind", ["uniform", "zipf", "one_row"])
@pytest.mark.parametrize("opt", ["sgd_wd", "adagrad_wd", "adagrad_vw", "adam", "adagrad_bf16"])
def test_sparse_update_kernel_matches_cpu_plain_bitwise(cuda, opt, kind):
    """K5 sums each row's gradients in sorted order and rounds each
    operation once, as the plain version does on the CPU: bit for bit."""
    from persia_tpu_torch.embedding.optim import SGD, Adagrad, Adam
    from persia_tpu_torch.ops import sparse_update

    cfg = {"sgd_wd": SGD(lr=0.1, weight_decay=0.01), "adagrad_wd": Adagrad(lr=0.05, g_square_momentum=0.95,
                                                                           weight_decay=0.01),
           "adagrad_vw": Adagrad(lr=0.05, vectorwise_shared=True, weight_decay=0.01),
           "adam": Adam(lr=0.01, weight_decay=0.1), "adagrad_bf16": Adagrad(lr=0.05)}[opt].config
    dtype = torch.bfloat16 if opt.endswith("bf16") else torch.float32
    ids, table, state, grads = _k5_inputs(kind, cfg, 5000, 20000, 16, dtype, seed=len(opt + kind))
    bs = torch.tensor([cfg.beta1 ** 2, cfg.beta2 ** 2])
    mask = ids >= 0
    card_t, card_s = table.to(cuda), {k: v.to(cuda) for k, v in state.items()}
    before = sparse_update.launches
    sparse_update(cfg, card_t, card_s, ids.to(cuda), grads.to(cuda), bs.to(cuda), mask=mask.to(cuda))
    sparse_update(cfg, table, state, ids, grads, bs, mask=mask)
    assert sparse_update.launches == before + 1
    assert torch.equal(_bits(card_t), _bits(table))
    for k in state:
        assert torch.equal(_bits(card_s[k]), _bits(state[k])), k


K5_STREAMS = ["uniform", "zipf", "one_row", "length_t_minus_1", "length_t", "length_t_plus_1", "tile_edge",
              "empty", "all_padding"]


def _k5_stream(kind, dim, vocab, seed):
    """(ids, mask, grads) on the CPU: the CPU schedule tests' streams
    (tests/test_torch_sparse_schedule.py), one row's segment at the long
    threshold - 1, at it and + 1, or ending on a staged tile's edge."""
    from persia_tpu_torch.ops import plans

    rng = np.random.default_rng(seed)
    t, rows, n = plans.K5_LONG_MIN, plans.sparse_update_plan(1, dim).tile_rows, 4000
    if kind == "uniform":
        ids = rng.integers(0, vocab, n)
    elif kind == "zipf":
        ids = (rng.zipf(1.2, n) - 1) % vocab
    elif kind == "one_row":
        ids = np.full(n, 7)
    elif kind.startswith("length_"):
        k = {"length_t_minus_1": t - 1, "length_t": t, "length_t_plus_1": t + 1}[kind]
        ids = np.r_[np.full(k, 11), 12 + np.arange(n - k) % (vocab - 12)][rng.permutation(n)]
    elif kind == "tile_edge":
        ids = np.r_[np.full(2 * rows, 3), np.full(rows, 150), np.full(rows + 1, 60), rng.integers(0, vocab, 500)]
        ids = ids[rng.permutation(ids.size)]
        n = ids.size
    elif kind == "empty":
        ids, n = np.zeros(0), 0
    else:
        ids = rng.integers(0, vocab, n)
    ids = ids.astype(np.int32)
    mask = rng.random(n) >= 0.1
    if kind in ("one_row", "tile_edge"):
        mask[:] = True
    if kind == "all_padding":
        mask[:] = False
    if kind.startswith("length_"):
        mask[ids == 11] = True
    if kind in ("uniform", "zipf"):
        ids[:2] = [vocab + 4, -3]
        mask[:2] = True
    grads = rng.standard_normal((n, dim)).astype(np.float32)
    return torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(grads)


def _k5_case(cuda, cfg, ids, mask, grads, dim, vocab, dtype, seed, unaligned=False):
    """K5 on the card and its plain version on the CPU from one state:
    tables and optimizer state bit for bit, one launch counted."""
    from persia_tpu_torch.ops import sparse_update
    from persia_tpu_torch.ops.sparse_update import init_sparse_state

    rng = np.random.default_rng(seed)
    table = (torch.from_numpy(rng.standard_normal((vocab, dim)).astype(np.float32)) * 0.05).to(dtype)
    state = init_sparse_state(cfg, vocab, dim)
    for v in state.values():
        v.copy_(torch.from_numpy(rng.uniform(0.01, 1.0, v.shape).astype(np.float32)))
    bs = torch.tensor([cfg.beta1 ** 3, cfg.beta2 ** 3])
    card_t, card_s = table.to(cuda), {k: v.to(cuda) for k, v in state.items()}
    card_g = grads.to(cuda)
    if unaligned:  # the same gradients 4 bytes off a 16-byte boundary: the scalar path
        card_g = torch.empty(grads.numel() + 1, device=cuda)[1:].view(grads.shape).copy_(card_g)
    before = sparse_update.launches
    sparse_update(cfg, card_t, card_s, ids.to(cuda), card_g, bs.to(cuda), mask=mask.to(cuda))
    sparse_update(cfg, table, state, ids, grads, bs, mask=mask)
    torch.cuda.synchronize()
    assert sparse_update.launches == before + (1 if ids.numel() else 0)
    assert torch.equal(_bits(card_t), _bits(table))
    for k in state:
        assert torch.equal(_bits(card_s[k]), _bits(state[k])), k


@pytest.mark.parametrize("dim", [8, 10, 16, 24, 64, 128])
@pytest.mark.parametrize("kind", K5_STREAMS)
def test_sparse_update_kernel_schedule_cases_bitwise(cuda, kind, dim):
    """K5 bit for bit its plain version on every stream of the CPU schedule
    tests, for SGD, Adagrad, vectorwise Adagrad and Adam, all with weight
    decay, at dims 8 to 128 (10: the scalar path), and a bf16 table."""
    from persia_tpu_torch.embedding.optim import SGD, Adagrad, Adam

    opts = [SGD(lr=0.1, weight_decay=0.01), Adagrad(lr=0.05, g_square_momentum=0.95, weight_decay=0.01),
            Adagrad(lr=0.05, vectorwise_shared=True, weight_decay=0.02), Adam(lr=0.01, weight_decay=0.1)]
    ids, mask, grads = _k5_stream(kind, dim, 300, seed=len(kind) + dim)
    for i, opt in enumerate(opts):
        _k5_case(cuda, opt.config, ids, mask, grads, dim, 300, torch.float32, seed=i)
    _k5_case(cuda, Adagrad(lr=0.05).config, ids, mask, grads, dim, 300, torch.bfloat16, seed=9)


@pytest.mark.parametrize("opt", ["adagrad_wd", "adagrad_vw", "adam"])
def test_sparse_update_kernel_unaligned_gradients_bitwise(cuda, opt):
    """Gradients off a 16-byte boundary take the scalar path: the same bits."""
    from persia_tpu_torch.embedding.optim import Adagrad, Adam

    cfg = {"adagrad_wd": Adagrad(lr=0.05, weight_decay=0.01), "adagrad_vw": Adagrad(lr=0.05, vectorwise_shared=True),
           "adam": Adam(lr=0.01)}[opt].config
    ids, mask, grads = _k5_stream("zipf", 16, 300, seed=5)
    _k5_case(cuda, cfg, ids, mask, grads, 16, 300, torch.float32, seed=1, unaligned=True)


@pytest.mark.parametrize("opt", ["adagrad", "adagrad_vw", "adam"])
def test_sparse_update_kernel_one_row_at_bench_size_bitwise(cuda, opt):
    """106,496 positions (26 slots of B=4096) on one row: one long segment
    of 832 staged tiles, bit for bit."""
    from persia_tpu_torch.embedding.optim import Adagrad, Adam

    cfg = {"adagrad": Adagrad(lr=0.05), "adagrad_vw": Adagrad(lr=0.05, vectorwise_shared=True),
           "adam": Adam(lr=0.01)}[opt].config
    n = 26 * 4096
    rng = np.random.default_rng(2)
    ids = torch.full((n,), 1234, dtype=torch.int32)
    grads = torch.from_numpy(rng.standard_normal((n, 16)).astype(np.float32))
    _k5_case(cuda, cfg, ids, torch.ones(n, dtype=torch.bool), grads, 16, 5000, torch.float32, seed=3)


def test_sparse_update_graphs_on_two_streams_bitwise(cuda):
    """Two updates of one shape captured in two CUDA graphs and replayed at
    once on two streams, 5 times each: each graph owns its scratch, so
    both tables and accumulators stay bit for bit the plain version's."""
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.ops import sparse_update
    from persia_tpu_torch.ops.sparse_update import init_sparse_state

    cfg = Adagrad(lr=0.05, vectorwise_shared=True).config
    bs = torch.ones(2)
    cases, graphs = [], []
    for seed in (7, 8):
        ids, mask, grads = _k5_stream("zipf", 16, 300, seed=seed)
        table = torch.from_numpy((np.random.default_rng(seed).standard_normal((300, 16)) * 0.05).astype(np.float32))
        state = init_sparse_state(cfg, 300, 16)
        cases.append((ids, mask, grads, table, state))
        args = (ids.to(cuda), grads.to(cuda), bs.to(cuda), mask.to(cuda))
        warm_t, warm_s = table.to(cuda), {k: v.to(cuda) for k, v in state.items()}
        sparse_update(cfg, warm_t, warm_s, args[0], args[1], args[2], mask=args[3])  # builds and loads K5
        card_t, card_s = table.to(cuda), {k: v.to(cuda) for k, v in state.items()}
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            sparse_update(cfg, card_t, card_s, args[0], args[1], args[2], mask=args[3])
        graphs.append((g, card_t, card_s, args))
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    for _ in range(5):
        for (g, *_), s in zip(graphs, streams):
            with torch.cuda.stream(s):
                g.replay()
    torch.cuda.synchronize()
    for (ids, mask, grads, table, state), (_, card_t, card_s, _) in zip(cases, graphs):
        for _ in range(5):
            sparse_update(cfg, table, state, ids, grads, bs, mask=mask)
        assert torch.equal(_bits(card_t), _bits(table))
        assert torch.equal(_bits(card_s["acc"]), _bits(state["acc"]))


@pytest.mark.parametrize("slots", [1, 26, 130])
def test_update_keys_kernel_matches_plain_bitwise(cuda, slots):
    """The routing kernel: pads, ids >= vocab and < -1, (B,) and (B, L)
    slots, offsets up to 2**31 - 101; one launch a group of 128 slots."""
    from persia_tpu_torch.ops import update_keys
    from persia_tpu_torch.ops.sparse_update import update_keys_reference

    rng = np.random.default_rng(slots)
    ids, offsets, vocabs = [], [], []
    for s in range(slots):
        vocab = int(rng.integers(1, 300))
        offset = 2 ** 31 - 401 if s == slots - 1 else int(rng.integers(0, 1 << 26))
        shape = (4096,) if s % 2 == 0 else (100, 3)
        a = rng.integers(-5, vocab + 5, shape).astype(np.int32)
        ids.append(torch.from_numpy(a).to(cuda))
        offsets.append(offset)
        vocabs.append(vocab)
    before = update_keys.launches
    got = update_keys(ids, offsets, vocabs)
    want = update_keys_reference([i.cpu() for i in ids], offsets, vocabs)
    assert update_keys.launches == before + -(-slots // 128)
    assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)


def _fused_setup(dev, seed=0, compute=torch.bfloat16):
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.models import DLRM
    from persia_tpu_torch.parallel.fused_step import FusedSlotSpec, init_fused_state

    specs = {f"s{i}": FusedSlotSpec(vocab=1000, dim=16) for i in range(4)}
    specs["bag"] = FusedSlotSpec(vocab=500, dim=16, sqrt_scaling=True)
    model = DLRM(13, 5, 16, (64, 16), (64, 32), compute_dtype=compute, device=dev,
                 generator=torch.Generator().manual_seed(seed))
    state = init_fused_state(model, torch.optim.Adam(model.parameters(), lr=1e-3), torch.Generator().manual_seed(1),
                             specs, Adagrad(lr=0.05).config, stack=True, device=dev)
    return specs, Adagrad(lr=0.05).config, state


def _fused_batches(dev, n, seed=0, b=256):
    out = []
    for i in range(n):
        rng = np.random.default_rng(seed + i)
        ids = {f"s{s}": rng.integers(-1, 1000, b).astype(np.int32) for s in range(4)}
        ids["bag"] = rng.integers(-1, 500, (b, 3)).astype(np.int32)
        out.append({"dense": [torch.from_numpy(rng.standard_normal((b, 13)).astype(np.float32)).to(dev)],
                    "labels": [torch.from_numpy(rng.integers(0, 2, (b, 1)).astype(np.float32)).to(dev)],
                    "ids": {k: torch.from_numpy(v).to(dev) for k, v in ids.items()}})
    return out


def _state_bits(state):
    from persia_tpu_torch.weights import fused_state_to_flax

    return [np.ascontiguousarray(a).view(np.uint8) for a in fused_state_to_flax(state)[1]]


def _traced_kernels(fn, names):
    """How many times each kernel in ``names`` ran on the card during
    ``fn()``, from torch.profiler's device trace."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = dict.fromkeys(names, 0)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for n in names:
                counts[n] += bool(re.search(rf"\b{n}\b", e.name))
    return counts


def test_fused_graph_step_equals_eager_step(cuda):
    """The CUDA-graph step (jit=True) and the eager step give the same bits
    over 5 steps, and the K-step graph the same bits as K single steps.
    The eager step calls the wrappers of K4 (which routes the update ids)
    and K5 once a step and ``update_keys`` never; the graph step calls K4's
    and K5's only at its first call (the capture's warm-up and the
    capture) and ``update_keys`` once there (the warm-up routes the ids to
    find the rows it restores), and each replay runs K4 and K5's three
    kernels once on the card and the routing kernel never (device
    trace)."""
    from persia_tpu_torch.ops import fused_gather, sparse_update, update_keys
    from persia_tpu_torch.parallel.fused_step import build_fused_multi_step, build_fused_train_step

    batches = _fused_batches(cuda, 5)
    results = []
    counted = (fused_gather, update_keys, sparse_update)
    for jit in (False, True):
        specs, cfg, state = _fused_setup(cuda)
        step = build_fused_train_step(cfg, specs, stack=True, jit=jit)
        losses = []
        for i, b in enumerate(batches):
            before = [fn.launches for fn in counted]
            state, (loss, _) = step(state, b)
            per_call = ((2, 1, 2) if i == 0 else (0, 0, 0)) if jit else (1, 0, 1)
            assert tuple(fn.launches - b0 for fn, b0 in zip(counted, before)) == per_call
            losses.append(loss)
        results.append((torch.stack(losses).cpu(), _state_bits(state)))
    assert torch.equal(results[0][0], results[1][0])
    assert all(np.array_equal(a, b) for a, b in zip(results[0][1], results[1][1]))
    names = ("fused_gather_kernel", "update_keys_kernel", "sparse_update_segments_kernel",
             "sparse_update_long_kernel", "sparse_update_short_kernel")
    traced = _traced_kernels(lambda: [step(state, b) for b in batches[:3]], names)
    assert traced == {**dict.fromkeys(names, 3), "update_keys_kernel": 0}
    specs, cfg, state = _fused_setup(cuda)
    multi = build_fused_multi_step(cfg, specs, 5, stack=True)
    state, (losses, _) = multi(state, tuple(batches))
    assert torch.equal(losses.cpu(), results[0][0])
    assert all(np.array_equal(a, b) for a, b in zip(_state_bits(state), results[0][1]))


def test_fused_card_step_matches_cpu_step(cuda):
    """Three f32 steps on the card against the same steps on the CPU (K4
    and K5 against their plain versions, cuBLAS against the CPU's
    matmuls): losses to rtol 1e-4, tables to 1e-5."""
    from persia_tpu_torch.models import DLRM
    from persia_tpu_torch.parallel.fused_step import build_fused_train_step
    from persia_tpu_torch.weights import fused_state_from_flax, fused_state_to_flax

    specs, cfg, state = _fused_setup(cuda, compute=torch.float32)
    manifest, arrays = fused_state_to_flax(state)
    model = DLRM(13, 5, 16, (64, 16), (64, 32), compute_dtype=torch.float32, device="cpu")
    cpu_state = fused_state_from_flax(manifest, arrays, model, torch.optim.Adam(model.parameters(), lr=1e-3),
                                      device="cpu")
    step, cpu_step = build_fused_train_step(cfg, specs, stack=True), build_fused_train_step(cfg, specs, stack=True)
    for b in _fused_batches(cuda, 3, seed=7):
        cb = {"dense": [x.cpu() for x in b["dense"]], "labels": [x.cpu() for x in b["labels"]],
              "ids": {k: v.cpu() for k, v in b["ids"].items()}}
        state, (loss, _) = step(state, b)
        cpu_state, (cpu_loss, _) = cpu_step(cpu_state, cb)
        np.testing.assert_allclose(float(loss), float(cpu_loss), rtol=1e-4)
    for name, t in state.tables.items():
        np.testing.assert_allclose(t.cpu().numpy(), cpu_state.tables[name].numpy(), rtol=0, atol=1e-5)


def test_fused_ctx_pipelined_on_card_equals_step_loop(cuda):
    """``FusedTrainCtx.train_pipelined`` on the card (a feed thread staging
    on its own stream) lands on the ``train_step`` loop's bits."""
    from persia_tpu_torch.data import IDTypeFeatureWithSingleID, Label, NonIDTypeFeature, PersiaBatch
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.models import DLRM
    from persia_tpu_torch.parallel.fused_ctx import FusedTrainCtx
    from persia_tpu_torch.parallel.fused_step import FusedSlotSpec

    def batch(seed):
        rng = np.random.default_rng(seed)
        ids = [IDTypeFeatureWithSingleID(n, rng.integers(0, 500, 256).astype(np.uint64)) for n in ("a", "b")]
        return PersiaBatch(ids, non_id_type_features=[NonIDTypeFeature(rng.standard_normal((256, 13)).astype(
            np.float32))], labels=[Label(rng.integers(0, 2, (256, 1)).astype(np.float32))], requires_grad=True)

    def ctx():
        m = DLRM(13, 2, 16, (32, 16), (32,), device=cuda, generator=torch.Generator().manual_seed(0))
        return FusedTrainCtx(m, torch.optim.Adam(m.parameters(), lr=1e-3), Adagrad(lr=0.05),
                             {n: FusedSlotSpec(vocab=500, dim=16) for n in ("a", "b")}, device=cuda)

    batches = [batch(i) for i in range(10)]
    seq = ctx()
    for b in batches:
        seq.train_step(b, fetch_metrics=False)
    pipe = ctx()
    m = pipe.train_pipelined(batches[:4], pipeline_depth=2)
    m = pipe.train_pipelined(batches[4:], pipeline_depth=2)
    assert len(m["losses"]) == 6
    assert all(np.array_equal(a, b) for a, b in zip(_state_bits(seq.state), _state_bits(pipe.state)))


def test_fused_ctx_checkpoint_loads_in_place_on_card(cuda, tmp_path):
    """``load_checkpoint`` writes the host arrays into the live tensors: the
    captured graph step stays valid, and training on from the checkpoint
    lands on the same bits as the first time through."""
    from persia_tpu_torch.data import IDTypeFeatureWithSingleID, Label, NonIDTypeFeature, PersiaBatch
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.models import DLRM
    from persia_tpu_torch.parallel.fused_ctx import FusedTrainCtx
    from persia_tpu_torch.parallel.fused_step import FusedSlotSpec

    def batch(seed):
        rng = np.random.default_rng(seed)
        ids = [IDTypeFeatureWithSingleID(n, rng.integers(0, 500, 256).astype(np.uint64)) for n in ("a", "b")]
        return PersiaBatch(ids, non_id_type_features=[NonIDTypeFeature(rng.standard_normal((256, 13)).astype(
            np.float32))], labels=[Label(rng.integers(0, 2, (256, 1)).astype(np.float32))], requires_grad=True)

    m = DLRM(13, 2, 16, (32, 16), (32,), device=cuda, generator=torch.Generator().manual_seed(0))
    ctx = FusedTrainCtx(m, torch.optim.Adam(m.parameters(), lr=1e-3), Adagrad(lr=0.05),
                        {n: FusedSlotSpec(vocab=500, dim=16) for n in ("a", "b")}, device=cuda)
    batches = [batch(i) for i in range(4)]
    for b in batches[:2]:
        ctx.train_step(b, fetch_metrics=False)
    ctx.dump_checkpoint(str(tmp_path))
    for b in batches[2:]:
        ctx.train_step(b, fetch_metrics=False)
    first = _state_bits(ctx.state)
    ptrs = [t.data_ptr() for t in ctx.state.tables.values()]
    ctx.load_checkpoint(str(tmp_path))
    assert [t.data_ptr() for t in ctx.state.tables.values()] == ptrs
    for b in batches[2:]:
        ctx.train_step(b, fetch_metrics=False)
    assert all(np.array_equal(a, b) for a, b in zip(first, _state_bits(ctx.state)))


# --- the raw-slot gather (K6, K7) and DIN's attention pool (K8, K9) -------

def _raw_group(dev, dtype, b, l, dim, case, seed, slots=2):
    """Rows (P, dim) of ``dtype`` (rows past d zero) and RawSlots with CSR
    on ``dev``: random ids with pads at P - 1 and an all-padding row, every
    position on one row, or all padding."""
    from persia_tpu_torch.ops import RawSlot, raw_csr

    rng = np.random.default_rng(seed)
    rows, raw = [], []
    for s in range(slots):
        d = 37 + 500 * s
        p = 1 << int(np.ceil(np.log2(d + 1)))
        r = np.zeros((p, dim), np.float32)
        r[:d] = rng.standard_normal((d, dim))
        if case == "random":
            index = np.where(rng.random((b, l)) < 0.5, rng.integers(0, d, (b, l)), p - 1)
            index[0] = p - 1
        elif case == "one_row":
            index = np.full((b, l), 3)
        else:
            index = np.full((b, l), p - 1)
        index = index.astype(np.int32)
        rows.append(torch.from_numpy(r).to(dev, dtype))
        raw.append(RawSlot(*(torch.from_numpy(a).to(dev) for a in (index, *raw_csr(index, p)))))
    return rows, raw


def _raw_schedule_bits(grad, raw, dtype):
    """``plans.raw_bwd_model`` (K7's order, in numpy) of each slot, rounded
    to ``dtype``, as bits."""
    from persia_tpu_torch.ops import plans

    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    return [torch.from_numpy(plans.raw_bwd_model(g.reshape(-1, g.shape[-1]).float().cpu().numpy(),
                                                 s.order.cpu().numpy(), s.offsets.cpu().numpy())).to(dtype).view(bits)
            for g, s in zip(grad, raw)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case,b,l,dim", [("random", 1024, 50, 16), ("one_row", 1024, 50, 16),
                                          ("all_masked", 64, 50, 16), ("random", 77, 9, 10),
                                          ("random", 33, 5, 24), ("random", 40, 3, 128)])
def test_raw_gather_kernels_match_plain(cuda, case, b, l, dim, dtype):
    """K6 copies rows: bit for bit. K7 bit for bit its schedule
    (``plans.raw_bwd_model``: a row's terms in f32 in stream order, a long
    row's chunk by chunk) and, where it differs from index_add_'s stream
    order (the one-row case's long row), within twice the f32 sum-order
    bound of the row, then one rounding (1e-6 relative in f32, one bf16 ulp
    in bf16) of the plain version; the pad row zero; two calls agree bit
    for bit."""
    from persia_tpu_torch.ops import raw_gather_bwd, raw_gather_fwd
    from persia_tpu_torch.ops.raw_gather import raw_gather_bwd_reference, raw_gather_fwd_reference

    rows, raw = _raw_group(cuda, dtype, b, l, dim, case, seed=dim)
    before = raw_gather_fwd.launches, raw_gather_bwd.launches
    out = raw_gather_fwd(rows, raw)
    g = _randn(out.shape, seed=5, dev=cuda, dtype=dtype)
    grads = raw_gather_bwd(g, rows, raw)
    again = raw_gather_bwd(g, rows, raw)
    torch.cuda.synchronize()
    assert (raw_gather_fwd.launches, raw_gather_bwd.launches) == (before[0] + 1, before[1] + 2)
    assert out.shape == (len(rows), b, l, dim) and out.dtype == dtype
    assert torch.equal(out, raw_gather_fwd_reference(rows, raw))
    abs_sums = raw_gather_bwd_reference(g.abs().float(), [r.float() for r in rows], raw)
    rtol = 1e-6 if dtype == torch.float32 else 2 ** -8
    for got, ref, a, s, rep in zip(grads, raw_gather_bwd_reference(g, rows, raw), abs_sums, raw, again):
        n = (s.offsets[1:] - s.offsets[:-1]).float()[:, None]
        err = (got.float() - ref.float()).abs()
        assert bool((err <= 2 * n * 2 ** -24 * a + rtol * ref.float().abs() + 1e-30).all()), float(err.max())
        assert torch.equal(got, rep) and not got[-1].any()
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for got, want in zip(grads, _raw_schedule_bits(g, raw, dtype)):
        assert torch.equal(got.cpu().view(bits), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dim", [16, 10])
def test_raw_gather_bwd_long_rows_match_their_schedule(cuda, dim, dtype):
    """K7's long rows: rows of K7_LONG_MIN - 1, K7_LONG_MIN and + 1
    positions, of one chunk and one position past it, of several chunks,
    and every position of a slot on one row, each bit for bit
    ``plans.raw_bwd_model`` (the chunk sums in chunk order, whichever
    block finishes last) and run to run; the short rows beside them and
    the pad row as always. One launch a call."""
    from persia_tpu_torch.ops import RawSlot, plans, raw_csr, raw_gather_bwd

    t, c = plans.K7_LONG_MIN, plans.K7_CHUNK
    rng = np.random.default_rng(dim)
    b, l, p = 64, 160, 4096
    lengths = [t - 1, t, t + 1, c, c + 1, 3 * c + 5]
    flat = np.concatenate([np.full(n, r) for r, n in enumerate(lengths)])
    rest = b * l - flat.size
    flat = np.concatenate([flat, rng.integers(len(lengths), p - 1, rest // 2), np.full(rest - rest // 2, p - 1)])
    cases = [rng.permutation(flat).reshape(b, l), np.full((b, l), 5)]
    rows = [torch.zeros((p, dim), device=cuda, dtype=dtype) for _ in cases]
    raw = [RawSlot(*(torch.from_numpy(a).to(cuda) for a in (i.astype(np.int32), *raw_csr(i.astype(np.int32), p))))
           for i in cases]
    assert [s.long_chunks.shape[0] for s in raw] == [1 + 1 + 1 + 2 + 4, -(-b * l // c)]
    g = _randn((len(cases), b, l, dim), seed=dim + 1, dev=cuda, dtype=dtype)
    before = raw_gather_bwd.launches
    grads = raw_gather_bwd(g, rows, raw)
    again = raw_gather_bwd(g, rows, raw)
    torch.cuda.synchronize()
    assert raw_gather_bwd.launches == before + 2
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for got, rep, want in zip(grads, again, _raw_schedule_bits(g, raw, dtype)):
        assert torch.equal(got.cpu().view(bits), want) and torch.equal(got, rep)
        assert not got[-1].any()


_OUT_OF_RANGE = """
import sys
import torch
from persia_tpu_torch.ops import RawSlot, raw_csr, raw_gather_bwd, raw_gather_fwd
rows = torch.randn(8, 16, device="cuda")
index = torch.tensor([[0, 8, -1, 7]], dtype=torch.int32)
if sys.argv[1] == "fwd":
    raw_gather_fwd([rows], [RawSlot(index.cuda())])
else:  # a CSR whose order lists position 4 of the 4 positions
    order, offsets, long_chunks = (torch.from_numpy(a).cuda() for a in raw_csr(index.clamp(0, 7).numpy(), 8))
    order[0] = 4
    raw_gather_bwd(torch.randn(1, 1, 4, 16, device="cuda"), [rows], [RawSlot(index.cuda(), order, offsets,
                                                                             long_chunks)])
torch.cuda.synchronize()
print("no fault")
"""


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_raw_gather_never_reads_out_of_range(cuda, direction):
    """An index outside [0, P) stops K6 with a device-side assert, as
    index_select does on the card (the host raises before staging one);
    K7 reads no index, and a CSR entry outside the slot's positions stops
    it the same way; in a process of its own, since the fault ends its
    CUDA context."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root, os.environ.get("PYTHONPATH", "")]))
    run = subprocess.run([sys.executable, "-c", _OUT_OF_RANGE, direction], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode != 0 and "no fault" not in run.stdout, run.stdout + run.stderr
    assert "assert" in run.stderr.lower(), run.stderr[-2000:]


def test_raw_gather_autograd_on_card(cuda):
    from persia_tpu_torch.ops import raw_gather, raw_gather_bwd, raw_gather_fwd
    from persia_tpu_torch.ops.raw_gather import raw_gather_bwd_reference

    rows, raw = _raw_group(cuda, torch.bfloat16, 256, 10, 16, "random", seed=2)
    leaves = [r.clone().requires_grad_(True) for r in rows]
    before = raw_gather_fwd.launches, raw_gather_bwd.launches
    out = raw_gather(leaves, raw)
    torch.stack(out).float().pow(2).sum().backward()
    torch.cuda.synchronize()
    assert (raw_gather_fwd.launches, raw_gather_bwd.launches) == (before[0] + 1, before[1] + 1)
    ref = raw_gather_bwd_reference(2 * torch.stack(out).detach(), rows, raw)
    for leaf, r in zip(leaves, ref):
        torch.testing.assert_close(leaf.grad.float(), r.float(), rtol=2 ** -7, atol=1e-3)


def _pool_inputs(dev, dtype, b, l, dim, seed):
    rng = np.random.default_rng(seed)
    logits = torch.from_numpy((2 * rng.standard_normal((b, l))).astype(np.float32)).to(dev)
    mask = rng.random((b, l)) < 0.5
    mask[0] = False
    mask[1] = True
    hist = rng.standard_normal((b, l, dim)).astype(np.float32)
    hist[~mask] = 0.0
    d_out = _randn((b, dim), seed=seed + 1, dev=dev, dtype=dtype)
    return logits, torch.from_numpy(mask).to(dev), torch.from_numpy(hist).to(dev, dtype), d_out


# the DIN shape and earlier cases, then the kernels' edges: a lane's
# positions (L <= 32, 64, 256 and 1536 take 1, 2, 8 and 48 a lane; past 256
# the backward's g goes through shared memory), a lane group walking more
# than kAhead (8) positions (L = 200 at dim 16: 13), the scalar path
# (dim 10) with several vectors a lane
ATT_POOL_CASES = [(1024, 50, 16), (33, 7, 10), (5, 100, 64), (9, 1, 8), (3, 600, 16)] + [
    (37, l, 16) for l in (32, 33, 64, 65, 200, 256, 257, 1536)] + [(37, 200, 10)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l,dim", ATT_POOL_CASES)
def test_attention_pool_kernels_match_plain(cuda, b, l, dim, dtype):
    """K8's weights to 1e-6 relative (exp and the sums in another order),
    its pooled rows inside their f64 envelope (an f32 sum in any order,
    then one rounding), the plain version's too; K9's d_hist bit for bit,
    d_logits inside its envelope; masked positions and all-masked rows
    exactly zero."""
    from persia_tpu_torch.ops import attention_pool_bwd, attention_pool_fwd
    from persia_tpu_torch.ops.attention_pool import attention_pool_bwd_reference, attention_pool_fwd_reference
    from persia_tpu_torch.testing.envelopes import attention_pool_bwd_envelope, attention_pool_fwd_envelope, outside

    logits, mask, hist, d_out = _pool_inputs(cuda, dtype, b, l, dim, seed=dim)
    before = attention_pool_fwd.launches, attention_pool_bwd.launches
    out, w = attention_pool_fwd(logits, mask, hist)
    d_logits, d_hist = attention_pool_bwd(d_out, mask, hist, w)
    torch.cuda.synchronize()
    assert (attention_pool_fwd.launches, attention_pool_bwd.launches) == (before[0] + 1, before[1] + 1)
    ref_out, ref_w = attention_pool_fwd_reference(logits, mask, hist)
    ref_dl, ref_dh = attention_pool_bwd_reference(d_out, mask, hist, w)
    torch.testing.assert_close(w, ref_w, rtol=1e-6, atol=1e-12)
    assert outside(out, attention_pool_fwd_envelope(w, hist)) == 0
    assert outside(ref_out, attention_pool_fwd_envelope(ref_w, hist)) == 0
    assert not out[0].any() and not d_logits[0].any() and not d_logits[~mask].any()
    assert bool(torch.isfinite(d_logits).all()) and bool(torch.isfinite(d_hist.float()).all())
    torch.testing.assert_close(d_hist.float(), ref_dh.float(), rtol=0, atol=0)
    env = attention_pool_bwd_envelope(d_out, mask, hist, w)
    assert outside(d_logits, env) == 0 and outside(ref_dl, env) == 0, float((d_logits - ref_dl).abs().max())


def _din_cfg(hist=12):
    from persia_tpu_torch.config import EmbeddingConfig, SlotConfig

    return EmbeddingConfig(
        slots_config={
            "item": SlotConfig(dim=16), "cate": SlotConfig(dim=16),
            "hist_item": SlotConfig(dim=16, embedding_summation=False, sample_fixed_size=hist),
            "hist_cate": SlotConfig(dim=16, embedding_summation=False, sample_fixed_size=hist),
        },
        feature_index_prefix_bit=8,
        feature_groups={"items": ["item", "hist_item"], "cates": ["cate", "hist_cate"]},
    )


@pytest.mark.parametrize("wire_dtype", [None, "bfloat16"])
def test_din_training_on_card_matches_cpu(cuda, wire_dtype):
    """Three DIN TrainCtx steps on Taobao-shaped batches, on the card and on
    the CPU from the same weights (f32 compute): losses, dense parameters
    and every PS entry agree; K6-K9 ran once a step each (K8, K9 once a raw
    slot)."""
    from persia_tpu_torch import ops
    from persia_tpu_torch.ctx import TrainCtx
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.embedding.store import EmbeddingStore
    from persia_tpu_torch.embedding.worker import EmbeddingWorker
    from persia_tpu_torch.models import DIN
    from persia_tpu_torch.testing import TaobaoSynthetic

    batches = list(TaobaoSynthetic(num_samples=3 * 128, item_vocab=3000, max_hist=12, seed=1).batches(128))
    out = {}
    for device in (cuda, "cpu"):
        model = DIN(1, 2, 2, 16, (36,), (64, 32), compute_dtype=torch.float32, device="cpu",
                    generator=torch.Generator().manual_seed(0))
        stores = [EmbeddingStore(capacity=1 << 16, num_internal_shards=4, optimizer=Adagrad(lr=0.05).config,
                                 seed=13 + r) for r in range(2)]
        ctx = TrainCtx(model, torch.optim.Adam(model.parameters(), lr=1e-3), Adagrad(lr=0.05),
                       EmbeddingWorker(_din_cfg(), stores), _din_cfg(), device=device,
                       wire_dtype=wire_dtype).__enter__()
        before = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}
        losses = [ctx.train_step(b)["loss"] for b in batches]
        after = {fn.__name__: fn.launches - before[fn.__name__] for fn in ops.KERNEL_WRAPPERS}
        out[str(device)] = (ctx, losses, stores, after)
    (card, card_losses, card_stores, launches), (cpu, cpu_losses, cpu_stores, _) = out[str(cuda)], out["cpu"]
    assert (launches["raw_gather_fwd"], launches["raw_gather_bwd"]) == (3, 3)
    assert (launches["attention_pool_fwd"], launches["attention_pool_bwd"]) == (6, 6)
    tol = 1e-4 if wire_dtype is None else 1e-3
    np.testing.assert_allclose(card_losses, cpu_losses, rtol=0, atol=tol)
    for k, v in cpu.model.state_dict().items():
        np.testing.assert_allclose(card.model.state_dict()[k].cpu().numpy(), v.numpy(), rtol=0, atol=tol)
    for a, b in zip(card_stores, cpu_stores):
        assert a.size() == b.size()
        for shard in b._shards:
            for sign, (_, vec) in shard.entries.items():
                np.testing.assert_allclose(a.get_embedding_entry(sign), vec, rtol=0, atol=tol)


# the DNN paths' shapes, one row, C not a multiple of 8, and rows split
# over a cluster into spans of unequal length (2049 and 4100 rows)
BN_CASES = [(4096, 128), (4096, 32), (256, 128), (256, 32), (128, 64), (128, 16), (1, 10), (37, 10), (300, 12),
            (2049, 128), (4100, 10)]


def _bn_inputs(b, c, seed, dev, dtype):
    """x with per-column offsets and spreads (a mean a few stds off zero, as
    a Dense layer's output), dy, scale, bias and running statistics."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, c)) * rng.uniform(0.5, 3.0, c) + rng.uniform(-2, 2, c)
    t = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a, np.float32)).to(dev, dt)  # noqa: E731
    return dict(x=t(x, dtype), dy=t(rng.standard_normal((b, c)), dtype), scale=t(1 + 0.2 * rng.standard_normal(c)),
                bias=t(0.1 * rng.standard_normal(c)), mean=t(0.3 * rng.standard_normal(c)),
                var=t(rng.uniform(0.5, 2.0, c)))


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,c", BN_CASES)
def test_batch_norm_kernels_match_their_schedule_bitwise(cuda, b, c, dtype, train):
    """K10 and K11 bit for bit their schedules (the plain versions with the
    column sums in the kernels' order, ``batch_norm_*_schedule``, run on
    the CPU): y, saved, the running statistics, dx, dscale and dbias; two
    runs give the same bits; one launch each, counted by mode."""
    from persia_tpu_torch.ops import batch_norm_bwd, batch_norm_fwd
    from persia_tpu_torch.ops.batch_norm import batch_norm_bwd_schedule, batch_norm_fwd_schedule

    inp = _bn_inputs(b, c, 100 * b + c, cuda, dtype)
    cpu = {k: v.cpu() for k, v in inp.items()}
    rm, rv = inp["mean"].clone(), inp["var"].clone()
    before = batch_norm_fwd.launches, dict(batch_norm_fwd.launches_by_route), batch_norm_bwd.launches
    y, saved = batch_norm_fwd(inp["x"], inp["scale"], inp["bias"], rm, rv, train)
    dx, dscale, dbias = batch_norm_bwd(inp["dy"], inp["x"], inp["scale"], saved, train)
    torch.cuda.synchronize()
    mode = "train" if train else "eval"
    assert batch_norm_fwd.launches == before[0] + 1 and batch_norm_bwd.launches == before[2] + 1
    assert batch_norm_fwd.launches_by_route[mode] == before[1][mode] + 1
    wy, wsaved, wrm, wrv = batch_norm_fwd_schedule(cpu["x"], cpu["scale"], cpu["bias"], cpu["mean"], cpu["var"], train)
    wdx, wds, wdb = batch_norm_bwd_schedule(cpu["dy"], cpu["x"], cpu["scale"], wsaved, train)
    for got, want, what in ((y, wy, "y"), (saved, wsaved, "saved"), (rm, wrm, "running mean"),
                            (rv, wrv, "running var"), (dx, wdx, "dx"), (dscale, wds, "dscale"), (dbias, wdb, "dbias")):
        assert torch.equal(got.cpu(), want), (what, float((got.cpu().float() - want.float()).abs().max()))
    rm2, rv2 = inp["mean"].clone(), inp["var"].clone()
    y2, saved2 = batch_norm_fwd(inp["x"], inp["scale"], inp["bias"], rm2, rv2, train)
    dx2 = batch_norm_bwd(inp["dy"], inp["x"], inp["scale"], saved2, train)[0]
    assert torch.equal(y2, y) and torch.equal(saved2, saved) and torch.equal(dx2, dx) and torch.equal(rv2, rv)
    if not train:
        assert torch.equal(rm, inp["mean"]) and torch.equal(rv, inp["var"])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,c", [(4096, 128), (128, 16), (1, 10), (37, 10)])
def test_batch_norm_kernels_match_plain(cuda, b, c, dtype):
    """The kernels against the plain versions on the card: y and dx within
    one ulp of the dtype (2^-7 bf16, 1e-5 f32) plus 1e-5 of the column's
    scale (the sums in another order move the mean, and where x is several
    stds off zero that moves y), the statistics within 1e-5, the
    parameters' gradients within 1e-5 of their terms' sum of magnitudes
    (an f32 sum in another order)."""
    from persia_tpu_torch.ops import batch_norm_bwd, batch_norm_fwd
    from persia_tpu_torch.ops.batch_norm import batch_norm_bwd_reference, batch_norm_fwd_reference

    inp = _bn_inputs(b, c, 7 * b + c, cuda, dtype)
    rel = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    for train in (True, False):
        rm, rv, prm, prv = (inp[k].clone() for k in ("mean", "var", "mean", "var"))
        y, saved = batch_norm_fwd(inp["x"], inp["scale"], inp["bias"], rm, rv, train)
        py, psaved = batch_norm_fwd_reference(inp["x"], inp["scale"], inp["bias"], prm, prv, train)
        dx, ds, db = batch_norm_bwd(inp["dy"], inp["x"], inp["scale"], saved, train)
        pdx, pds, pdb = batch_norm_bwd_reference(inp["dy"], inp["x"], inp["scale"], psaved, train)
        scale = inp["x"].float().abs().amax(0) + 1.0
        m = (psaved[1] * inp["scale"]).abs()
        torch.testing.assert_close(y.float(), py.float(), rtol=rel, atol=float((1e-5 * scale * m).max()))
        torch.testing.assert_close(saved, psaved, rtol=1e-5, atol=1e-5 * float(scale.max()))
        torch.testing.assert_close(rv, prv, rtol=1e-5, atol=1e-5 * float(scale.max() ** 2))
        torch.testing.assert_close(rm, prm, rtol=1e-5, atol=1e-6 * float(scale.max()))
        g = float(inp["dy"].float().abs().max() * m.max())
        torch.testing.assert_close(dx.float(), pdx.float(), rtol=rel, atol=1e-5 * g)
        dsum = float(inp["dy"].float().abs().sum(0).max())
        terms = float((inp["dy"].float() * (inp["x"].float() - psaved[0]) * psaved[1]).abs().sum(0).max())
        torch.testing.assert_close(ds, pds, rtol=1e-5, atol=1e-5 * terms)
        torch.testing.assert_close(db, pdb, rtol=1e-5, atol=1e-5 * dsum)
    if b == 1:  # flax's variance 0: x - mean is 0, y = bias, no gradient into x
        y, _ = batch_norm_fwd(inp["x"], inp["scale"], inp["bias"], inp["mean"].clone(), inp["var"].clone(), True)
        assert torch.equal(y, inp["bias"].to(dtype)[None])


def test_batch_norm_autograd_on_card(cuda):
    """``ops.batch_norm`` on a CUDA tensor goes through K10 and K11 (one
    launch each, the running statistics moved once), and its gradients
    equal the kernels' outputs called directly."""
    from persia_tpu_torch.ops import batch_norm, batch_norm_bwd, batch_norm_fwd

    inp = _bn_inputs(512, 64, 3, cuda, torch.bfloat16)
    x = inp["x"].clone().requires_grad_(True)
    scale, bias = inp["scale"].clone().requires_grad_(True), inp["bias"].clone().requires_grad_(True)
    rm, rv = inp["mean"].clone(), inp["var"].clone()
    before = batch_norm_fwd.launches, batch_norm_bwd.launches
    y = batch_norm(x, scale, bias, rm, rv, True)
    moved = rv.clone()
    y.backward(inp["dy"])
    assert (batch_norm_fwd.launches, batch_norm_bwd.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(rv, moved) and not torch.equal(rv, inp["var"])
    wy, saved = batch_norm_fwd(inp["x"], inp["scale"], inp["bias"], inp["mean"].clone(), inp["var"].clone(), True)
    wdx, wds, wdb = batch_norm_bwd(inp["dy"], inp["x"], inp["scale"], saved, True)
    assert torch.equal(y.detach(), wy) and torch.equal(x.grad, wdx)
    assert torch.equal(scale.grad, wds) and torch.equal(bias.grad, wdb)


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_dnn_backward_on_card_reaches_the_embeddings(cuda, compute_dtype):
    """DNN in train mode on the card: every embedding input gets a non-zero
    gradient through K11's autograd, equal to the CPU port's, and the
    batch statistics move as the CPU's. f32 compute: the kernels sum in
    other orders (1e-4), the tight check of K11's backward. bf16: the
    devices round at other points in every layer, so each slot's gradient
    is held to 1e-1 of its norm; a backward without its mean term (k1) or
    its variance term (k2) moves every slot's by more than 0.15 of it
    (``tests/test_torch_batch_norm.py::test_a_dropped_backward_term_breaks_the_card_bound``)."""
    from persia_tpu_torch.models import DNN
    from persia_tpu_torch.ops import batch_norm_bwd, batch_norm_fwd
    from persia_tpu_torch.weights import batch_stats_to_flax, seeded_flax_params_like, state_dict_from_flax

    rng = np.random.default_rng(9)
    dense = rng.standard_normal((512, 8)).astype(np.float32)
    embs = (0.3 * rng.standard_normal((8, 512, 16))).astype(np.float32)
    grads, stats, sd = {}, {}, None
    for device in ("cuda", "cpu"):
        model = DNN(8, [16] * 8, 32, 128, (128, 64), compute_dtype=compute_dtype, device=device)
        sd = sd or state_dict_from_flax(model, seeded_flax_params_like(model, 4))
        model.load_state_dict(sd)
        leaves = [torch.from_numpy(e).to(device).requires_grad_(True) for e in embs]
        before = batch_norm_fwd.launches, batch_norm_bwd.launches
        model.train()
        model([torch.from_numpy(dense).to(device)], leaves).sum().backward()
        if device == "cuda":
            assert (batch_norm_fwd.launches - before[0], batch_norm_bwd.launches - before[1]) == (2, 2)
        grads[device] = [l.grad for l in leaves]
        stats[device] = batch_stats_to_flax(model)
    for g_card, g_cpu in zip(grads["cuda"], grads["cpu"]):
        assert g_card is not None and bool(g_card.abs().sum() > 0)
        if compute_dtype == torch.float32:
            torch.testing.assert_close(g_card.cpu(), g_cpu, rtol=1e-4, atol=1e-5)
        else:
            assert float((g_card.cpu() - g_cpu).norm() / g_cpu.norm()) < 1e-1
    for name in stats["cpu"]:
        for k in ("mean", "var"):
            np.testing.assert_allclose(stats["cuda"][name][k], stats["cpu"][name][k], rtol=1e-2 if compute_dtype ==
                                       torch.bfloat16 else 1e-5, atol=1e-5)
