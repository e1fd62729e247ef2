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


# ------------------------------------------- the cache tier: K12 and K13


def _cache_aux_both(case, wb_bf16, ring_pos=None):
    """K12 on the card and its plain version on the CPU, from one case's
    copies: (payload, table, state, ring) of each; with ``ring_pos`` a
    seeded ring of the payload's rows + 24 takes the payload too."""
    from persia_tpu_torch.ops.cache_aux import cache_aux, cache_aux_reference, cache_aux_ring_reference

    cpu = {k: (v.cpu().clone() if torch.is_tensor(v) else
               {kk: vv.cpu().clone() for kk, vv in v.items()} if isinstance(v, dict) else v) for k, v in case.items()}
    ring = rring = None
    if ring_pos is not None:
        width = case["table"].shape[1] + sum(s.shape[1] for s in case["state"].values())
        rring = torch.randn((case["ev_rows"].shape[0] + 24, width), generator=torch.Generator().manual_seed(5)).to(
            torch.bfloat16 if wb_bf16 else torch.float32)
        ring = rring.to(case["table"].device)
    before = cache_aux.launches
    pay = cache_aux(**case, wb_bf16=wb_bf16, ring=ring, ring_pos=ring_pos or 0)
    rows = case["m_rows"].numel() + case["c_rows"].numel() + case["ev_free"].numel()
    assert cache_aux.launches == before + (rows > 0)
    if ring is None:
        ref = cache_aux_reference(**cpu, wb_bf16=wb_bf16)
    else:
        ref = cache_aux_ring_reference(ring=rring, ring_pos=ring_pos, **cpu, wb_bf16=wb_bf16)
    return (pay, case["table"], case["state"], ring), (ref, cpu["table"], cpu["state"], rring)


def _assert_aux_bits(got, want):
    (pay, table, state, ring), (rpay, rtable, rstate, rring) = got, want
    assert torch.equal(_bits(pay), _bits(rpay))
    assert torch.equal(table.cpu(), rtable)
    for k in state:
        assert torch.equal(state[k].cpu(), rstate[k]), k
    if ring is not None:
        assert torch.equal(_bits(ring), _bits(rring))


@pytest.mark.parametrize("reuse", [False, True, "partial"])
@pytest.mark.parametrize("wires", [(False, False), (True, True), (True, False)])
@pytest.mark.parametrize("kind", ["sgd", "adagrad", "adagrad_vw", "adam"])
def test_cache_aux_kernel_matches_plain_bitwise(cuda, kind, wires, reuse):
    """K12 (one kernel) bit for bit its plain version: the payload (f32, or
    bf16 ties to even), the table and every state column after; with
    ``reuse`` every miss takes a row evicted this step, so each such row
    must be read before its write (in the thread that writes it); with
    "partial" half the misses do and some evictions no write claims."""
    from persia_tpu_torch.testing.cache_cases import aux_case

    aux_bf16, wb_bf16 = wires
    share = 0.5 if reuse == "partial" else reuse
    case = aux_case(kind, 4096, 16, 1500, 900 if reuse else 700, 600 if reuse else 500, share, aux_bf16, cuda,
                    seed=len(kind) + 3 * (reuse == "partial"))
    _assert_aux_bits(*_cache_aux_both(case, wb_bf16))


@pytest.mark.parametrize("ring_pos", [0, 7, 10_000, -3])
@pytest.mark.parametrize("wires", [(False, False), (True, True)])
@pytest.mark.parametrize("kind", ["adagrad", "adagrad_vw", "adam"])
def test_cache_aux_kernel_ring_matches_plain(cuda, kind, wires, ring_pos):
    """K12 with the ring: the payload stored a second time from
    ``ring_start`` (a position that fits, one the clamp moves, a negative
    one counted from the end), bit for bit the plain ring version, the rest
    of the ring untouched."""
    from persia_tpu_torch.testing.cache_cases import aux_case

    aux_bf16, wb_bf16 = wires
    case = aux_case(kind, 4096, 16, 1500, 700, 600, 0.5, aux_bf16, cuda, seed=ring_pos % 97)
    _assert_aux_bits(*_cache_aux_both(case, wb_bf16, ring_pos=ring_pos))


def test_cache_aux_kernel_all_pads_and_empty_pieces(cuda):
    """Pieces whose rows are all pads (C for the payload: the zero row;
    C+1 for the writes: dropped) and pieces with no rows: no launch."""
    from persia_tpu_torch.testing.cache_cases import all_pads, aux_case

    case = all_pads(aux_case("adagrad", 256, 16, 5, 3, 2, False, False, cuda, seed=3), 256)
    _assert_aux_bits(*_cache_aux_both(case, False))
    _assert_aux_bits(*_cache_aux_both(all_pads(aux_case("adam", 256, 16, 5, 3, 2, False, True, cuda, seed=4), 256),
                                      True, ring_pos=2))
    empty = aux_case("adam", 64, 16, 0, 0, 0, False, True, cuda, seed=4)
    got, want = _cache_aux_both(empty, True)
    assert got[0].shape == (0, 48)
    _assert_aux_bits(got, want)
    only_writes = aux_case("adagrad", 256, 16, 0, 3, 2, False, True, cuda, seed=5)
    _assert_aux_bits(*_cache_aux_both(only_writes, True))


_ONE_K12_CALL = """
import json
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from persia_tpu_torch.ops.cache_aux import cache_aux
from persia_tpu_torch.testing.cache_cases import aux_case

case = aux_case("adagrad", 1 << 18, 16, 7820, 500, 7320, 1, True, "cuda", seed=6)
ring = torch.empty((2 * case["ev_rows"].shape[0], 32), dtype=torch.bfloat16, device="cuda")
cache_aux(**case, wb_bf16=True, ring=ring, ring_pos=5)  # the library's load and first launch, untraced
torch.cuda.synchronize()
before = cache_aux.launches
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    cache_aux(**case, wb_bf16=True, ring=ring, ring_pos=5)
    torch.cuda.synchronize()
print(json.dumps({"launches": cache_aux.launches - before,
                  "device": [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
                             and not getattr(e, "is_user_annotation", False)]}))
"""


def test_cache_aux_call_is_one_kernel(cuda):
    """One K12 call at a saturated step's pieces runs exactly one kernel on
    the card (torch.profiler's device trace): the payload, the ring and the
    writes in one launch. In a process of its own: after other profiles in
    one process a trace can come back without its device records."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root, os.environ.get("PYTHONPATH", "")]))
    run = subprocess.run([sys.executable, "-c", _ONE_K12_CALL], cwd=root, env=env, capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-2000:]
    traced = json.loads(run.stdout.strip().splitlines()[-1])
    assert traced["launches"] == 1
    assert len(traced["device"]) == 1 and "cache_aux_kernel" in traced["device"][0], traced


@pytest.mark.parametrize("kind", ["sgd", "adagrad", "adagrad_vw", "adam"])
def test_gather_entry_rows_kernel_matches_plain(cuda, kind):
    """The flush's read (16-byte where the widths allow) bit for bit its
    plain version, rows out of range clamped; one launch a call, none for
    no rows."""
    from persia_tpu_torch.ops.cache_aux import gather_entry_rows, gather_entry_rows_reference
    from persia_tpu_torch.testing.cache_cases import aux_case

    case = aux_case(kind, 4096, 16, 1, 0, 0, False, False, cuda, seed=7)
    rows = torch.randperm(4097, generator=torch.Generator().manual_seed(2))[:3000].int()
    rows[:3] = torch.tensor([-4, 4096, 1 << 20], dtype=torch.int32)
    before = gather_entry_rows.launches
    got = gather_entry_rows(case["table"], case["state"], rows.to(cuda))
    none = gather_entry_rows(case["table"], case["state"], rows[:0].to(cuda))
    assert gather_entry_rows.launches == before + 1 and none.shape[0] == 0
    ref = gather_entry_rows_reference(case["table"].cpu(), {k: v.cpu() for k, v in case["state"].items()}, rows)
    assert torch.equal(got.cpu(), ref)


def _sum_tolerance(case, L):
    """An f32 sum of L terms in another order: (L - 1) * 2^-23 * sum |x|,
    times the scale."""
    from persia_tpu_torch.ops.cached_gather import cached_gather_reference

    absum = cached_gather_reference(case["table"].abs().cpu(), case["rows"].cpu(), True,
                                    case["scale"].abs().cpu() if "scale" in case else None,
                                    miss_table=case["miss_table"].abs().cpu() if "miss_table" in case else None)
    return (L - 1) * 2.0 ** -23 * absum


@pytest.mark.parametrize("L,scale,miss,zipf", [(1, False, 0, True), (1, True, 0, False), (1, False, 37, False),
                                               (3, False, 0, False), (8, True, 0, True), (5, True, 29, False)])
def test_cached_gather_kernel_matches_plain(cuda, L, scale, miss, zipf):
    """K13 pooled against its plain version on the CPU: bit for bit at L=1,
    within the f32 sum-order bound beyond; the keys and, for a raw slot,
    rows and mask bit for bit; eval rows > C from the miss table."""
    from persia_tpu_torch.ops.cached_gather import cached_gather, cached_gather_reference
    from persia_tpu_torch.testing.cache_cases import gather_case

    case = gather_case(26, 512, L, 3000, 16, cuda, seed=L, scale=scale, miss=miss, zipf=zipf)
    sc, mt = case.get("scale"), case.get("miss_table")
    keys = miss == 0
    got = cached_gather(case["table"], case["rows"], True, sc, keys=keys, miss_table=mt)
    ref = cached_gather_reference(case["table"].cpu(), case["rows"].cpu(), True,
                                  sc.cpu() if sc is not None else None, keys=keys,
                                  miss_table=mt.cpu() if mt is not None else None)
    pooled, rpooled = (got[0], ref[0]) if keys else (got, ref)
    if L == 1:
        assert torch.equal(pooled.cpu(), rpooled)
    else:
        assert bool(((pooled.cpu() - rpooled).abs() <= _sum_tolerance(case, L)).all())
    if keys:
        assert torch.equal(got[1].cpu(), ref[1])
    raw = cached_gather(case["table"], case["rows"][0].contiguous(), False, keys=keys, miss_table=mt)
    rraw = cached_gather_reference(case["table"].cpu(), case["rows"][0].cpu(), False, keys=keys,
                                   miss_table=mt.cpu() if mt is not None else None)
    for a, b in zip(raw, rraw):
        assert torch.equal(a.cpu(), b)


def test_cached_ctx_on_card_matches_cpu(cuda):
    """The cache tier on the card against the same ctx on the CPU over 6
    steps with evictions and bf16 wires: the directories' lists bit for
    bit (the same host code), losses within 1e-4 (f32 compute), the
    server's entries after flush within 1e-3; K12 and K13 launched."""
    from persia_tpu_torch.config import EmbeddingConfig, SlotConfig
    from persia_tpu_torch.data import IDTypeFeatureWithSingleID, Label, NonIDTypeFeature, PersiaBatch
    from persia_tpu_torch.embedding.hbm_cache import CachedTrainCtx
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.embedding.store import EmbeddingStore
    from persia_tpu_torch.embedding.worker import EmbeddingWorker
    from persia_tpu_torch.models import DLRM
    from persia_tpu_torch.ops import cache_aux, cached_gather

    cfg = EmbeddingConfig(slots_config={f"c{i}": SlotConfig(dim=16) for i in range(4)}, feature_index_prefix_bit=8)

    def make(device):
        store = EmbeddingStore(capacity=1 << 16, num_internal_shards=4, optimizer=Adagrad(lr=0.05).config, seed=1)
        torch.manual_seed(0)
        model = DLRM(13, 4, 16, (32, 16), (64,), compute_dtype=torch.float32, device="cpu")
        ctx = CachedTrainCtx(model, torch.optim.Adam(model.parameters(), lr=1e-3), Adagrad(lr=0.05),
                             EmbeddingWorker(cfg, [store]), cfg, cache_rows=640, device=device,
                             wb_wire_dtype="bfloat16", aux_wire_dtype="bfloat16", admit_touches=2).__enter__()
        return ctx, store

    rng = np.random.default_rng(0)
    batches = []
    for _ in range(6):
        feats = [IDTypeFeatureWithSingleID(f"c{i}", (rng.zipf(1.2, 256) % 5000).astype(np.uint64)) for i in range(4)]
        batches.append(PersiaBatch(feats, non_id_type_features=[NonIDTypeFeature(rng.normal(size=(256, 13))
                                                                                 .astype(np.float32))],
                                   labels=[Label(rng.integers(0, 2, (256, 1)).astype(np.float32))],
                                   requires_grad=True))
    (card, cstore), (cpu, pstore) = make(cuda), make("cpu")
    k12, k13 = cache_aux.launches, cached_gather.launches
    for b in batches:
        a, c = card.train_step(b), cpu.train_step(b)
        assert abs(a["loss"] - c["loss"]) <= 1e-4
    assert cache_aux.launches > k12 and cached_gather.launches == k13 + 6
    assert card.tier.counts() == cpu.tier.counts() and card.tier.evictions > 0
    card.flush()
    cpu.flush()
    assert cstore.size() == pstore.size()
    for shard in pstore._shards:
        for sign, (_, vec) in shard.entries.items():
            np.testing.assert_allclose(cstore.get_embedding_entry(sign), vec, rtol=0, atol=1e-3)


# ------------------------------------------- the cache tier: K14 and the stream


def _restores_both(case, wb_bf16, store):
    """K12 with restores on the card and its plain version on the CPU, from
    one case's copies (``aux_case`` with ``n_restore``): (payload, table,
    state, ring) of each; ``store``: the payload also into the ring."""
    from persia_tpu_torch.ops.cache_aux import cache_aux, cache_aux_reference, cache_aux_ring_reference

    cpu = {k: (v.cpu().clone() if torch.is_tensor(v) else
               {kk: vv.cpu().clone() for kk, vv in v.items()} if isinstance(v, dict) else
               tuple(t.cpu().clone() for t in v) if k == "restores" else v) for k, v in case.items()}
    ring_pos = case.pop("ring_pos")
    cpu.pop("ring_pos")
    before = cache_aux.launches
    pay = cache_aux(**case, wb_bf16=wb_bf16, ring_pos=ring_pos if store else None)
    assert cache_aux.launches == before + 1
    rring = cpu.pop("ring")
    if store:
        ref = cache_aux_ring_reference(ring=rring, ring_pos=ring_pos, **cpu, wb_bf16=wb_bf16)
    else:
        ref = cache_aux_reference(**cpu, ring=rring, wb_bf16=wb_bf16)
    return (pay, case["table"], case["state"], case["ring"]), (ref, cpu["table"], cpu["state"], rring)


@pytest.mark.parametrize("store", [True, False])
@pytest.mark.parametrize("wires", [(False, False), (True, True), (True, False), (False, True)])
@pytest.mark.parametrize("kind", ["sgd", "adagrad", "adagrad_vw", "adam"])
def test_cache_aux_kernel_restores_match_plain(cuda, kind, wires, store):
    """K12 with restores (the in-flight restores folded into its one
    launch) bit for bit its plain version: the payload, the ring, the table
    and every state column, for every optimizer and each pairing of the
    aux wire (warm entries) and the write-back wire (the ring the restores
    read); half the misses, restored ones too, on rows evicted this step;
    with and without the payload's store into the ring."""
    from persia_tpu_torch.testing.cache_cases import aux_case

    aux_bf16, wb_bf16 = wires
    case = aux_case(kind, 4096, 16, 1500, 500, 400, 0.5, aux_bf16, cuda, seed=len(kind) + 5 * store,
                    n_restore=300, ring_rows=3000, wb_bf16=wb_bf16, ring_pos=700)
    _assert_aux_bits(*_restores_both(case, wb_bf16, store))


def test_cache_aux_kernel_restores_pads_and_alone(cuda):
    """Restores whose rows are all pads (dropped, their sources unread),
    restores alone (no eviction, warm or cold row: a group whose every miss
    was restored) and no restore at all (a 0-row restore list)."""
    from persia_tpu_torch.testing.cache_cases import aux_case, all_pads

    case = all_pads(aux_case("adagrad", 512, 16, 40, 10, 10, 0.5, True, cuda, seed=3, n_restore=10,
                             ring_rows=200, wb_bf16=True, ring_pos=4), 512)
    _assert_aux_bits(*_restores_both(case, True, True))
    alone = aux_case("adam", 512, 16, 0, 0, 0, 0, False, cuda, seed=4, n_restore=60, ring_rows=200,
                     wb_bf16=False, ring_pos=0)
    got, want = _restores_both(alone, False, False)
    assert got[0].shape == (0, 48)
    _assert_aux_bits(got, want)
    none = aux_case("adagrad", 512, 16, 40, 10, 10, 0.5, True, cuda, seed=5, ring_rows=200, wb_bf16=True)
    assert none["restores"][0].shape == (0,)
    _assert_aux_bits(*_restores_both(none, True, True))


def test_cache_aux_restores_from_an_earlier_calls_span(cuda):
    """Two K12 calls on one stream: the first stores its payload into the
    ring's span from 100; the second restores from that span onto rows the
    first wrote and onto rows it evicts itself (its own span elsewhere):
    bit for bit the plain versions in that order."""
    from persia_tpu_torch.ops.cache_aux import cache_aux, cache_aux_ring_reference
    from persia_tpu_torch.testing.cache_cases import aux_case

    first = aux_case("adam", 4096, 16, 1500, 700, 600, 0.5, True, cuda, seed=9)
    cpu = {k: (v.cpu().clone() if torch.is_tensor(v) else
               {kk: vv.cpu().clone() for kk, vv in v.items()} if isinstance(v, dict) else v) for k, v in first.items()}
    ring = torch.zeros((4096, 48), dtype=torch.bfloat16, device=cuda)
    rring = ring.cpu().clone()
    cache_aux(**first, wb_bf16=True, ring=ring, ring_pos=100)
    cache_aux_ring_reference(ring=rring, ring_pos=100, **cpu, wb_bf16=True)
    second = aux_case("adam", 4096, 16, 400, 0, 0, 0.5, True, cuda, seed=10, n_restore=300, ring_rows=4096,
                      wb_bf16=True, ring_pos=2500)
    src = torch.zeros(512, dtype=torch.int32)
    src[:300] = 100 + torch.randperm(1500, generator=torch.Generator().manual_seed(1))[:300].int()
    dst, slot = second["restores"][1].cpu().clone(), second["restores"][2].cpu().clone()
    assert int((slot >= 0).sum()) == 150  # half the restores land on rows this call evicts
    # restores onto rows the first call wrote (none this call evicts or restores otherwise)
    taken = set(second["ev_rows"].cpu().tolist()) | set(dst.tolist())
    written = [r for r in cpu["m_rows"][:700].tolist() if r not in taken][:100]
    on_written = (slot[:300] < 0).nonzero().flatten()[:len(written)]
    dst[on_written] = torch.tensor(written, dtype=torch.int32)
    kw = dict(ev_rows=second["ev_rows"], m_rows=second["m_rows"], m_entries=second["m_entries"],
              c_rows=second["c_rows"], c_emb=second["c_emb"], state_consts=second["state_consts"],
              m_slot=second["m_slot"], c_slot=second["c_slot"], ev_free=second["ev_free"])
    cache_aux(first["table"], first["state"], **kw, wb_bf16=True, ring=ring, ring_pos=2500,
              restores=(src.to(cuda), dst.to(cuda), slot.to(cuda)))
    cache_aux_ring_reference(cpu["table"], cpu["state"], rring, 2500, **{k: (v.cpu() if torch.is_tensor(v) else v)
                                                                         for k, v in kw.items()},
                             wb_bf16=True, restores=(src, dst, slot))
    assert torch.equal(first["table"].cpu(), cpu["table"])
    for k in cpu["state"]:
        assert torch.equal(first["state"][k].cpu(), cpu["state"][k]), k
    assert torch.equal(_bits(ring), _bits(rring))


def test_cached_stream_on_card_matches_cpu(cuda):
    """The stream on the card (saturated: evictions and restores every few
    steps, bf16 wires, the bench's knobs) against the same stream on the
    CPU: the directories' decisions bit for bit (the same host code), the
    last loss within 1e-4, the servers' entries after flush within 1e-3;
    K12 (with the restores) and K13 launched on the card."""
    from persia_tpu_torch.config import EmbeddingConfig, SlotConfig
    from persia_tpu_torch.data import IDTypeFeatureWithSingleID, Label, NonIDTypeFeature, PersiaBatch
    from persia_tpu_torch.embedding.hbm_cache import CachedTrainCtx
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.embedding.store import EmbeddingStore
    from persia_tpu_torch.embedding.worker import EmbeddingWorker
    from persia_tpu_torch.models import DLRM
    from persia_tpu_torch.ops import cache_aux, cached_gather
    from persia_tpu_torch.testing.watchdog import run_with_watchdog

    cfg = EmbeddingConfig(slots_config={f"c{i}": SlotConfig(dim=16) for i in range(4)}, feature_index_prefix_bit=8)

    def make(device):
        store = EmbeddingStore(capacity=1 << 16, num_internal_shards=4, optimizer=Adagrad(lr=0.05).config, seed=1)
        torch.manual_seed(0)
        model = DLRM(13, 4, 16, (32, 16), (64,), compute_dtype=torch.float32, device="cpu")
        ctx = CachedTrainCtx(model, torch.optim.Adam(model.parameters(), lr=1e-3), Adagrad(lr=0.05),
                             EmbeddingWorker(cfg, [store]), cfg, cache_rows=640, device=device,
                             wb_wire_dtype="bfloat16", aux_wire_dtype="bfloat16").__enter__()
        steps = []
        inner = ctx.tier.prepare_batch

        def wrapped(batch, **kw):
            out = inner(batch, **kw)
            inputs, _l, miss, cold, restore, ev, meta = out
            back = [np.asarray(miss[g][0]) for g in miss] + [np.asarray(restore[g][1]) for g in restore]
            live = np.sort(np.concatenate(back)) if back else np.empty(0)
            steps.append((inputs["stacked_rows"]["cache_d16"].copy(), live[live < 641],
                          {g: (np.asarray(m[0][:m[1]]).copy(), m[2]) for g, m in meta.items()}))
            return out

        ctx.tier.prepare_batch = wrapped
        return ctx, store, steps

    rng = np.random.default_rng(0)
    batches = []
    for _ in range(12):
        feats = [IDTypeFeatureWithSingleID(f"c{i}", (rng.zipf(1.2, 256) % 3000).astype(np.uint64)) for i in range(4)]
        batches.append(PersiaBatch(feats, non_id_type_features=[NonIDTypeFeature(rng.normal(size=(256, 13))
                                                                                 .astype(np.float32))],
                                   labels=[Label(rng.integers(0, 2, (256, 1)).astype(np.float32))],
                                   requires_grad=True))
    (card, cstore, csteps), (cpu, pstore, psteps) = make(cuda), make("cpu")
    k12, k13 = cache_aux.launches, cached_gather.launches
    knobs = dict(dispatch_k=8, pipeline_depth=1, fetch_final=False, prefetch=3, wb_flush_steps=8)
    run_with_watchdog(lambda: card.train_stream(batches, **knobs), timeout=60.0)
    run_with_watchdog(lambda: cpu.train_stream(batches, **knobs), timeout=60.0)
    assert abs(card.last_metrics()["loss"] - cpu.last_metrics()["loss"]) <= 1e-4
    assert card.stream_stats()["restore_steps"] > 0, card.stream_stats()
    assert cache_aux.launches > k12 and cached_gather.launches == k13 + 12
    for (a_rows, a_back, a_meta), (b_rows, b_back, b_meta) in zip(csteps, psteps):
        assert np.array_equal(a_rows, b_rows) and np.array_equal(a_back, b_back)
        assert a_meta.keys() == b_meta.keys()
        for g in a_meta:
            assert np.array_equal(a_meta[g][0], b_meta[g][0]) and a_meta[g][1] == b_meta[g][1]
    card.flush()
    cpu.flush()
    assert cstore.size() == pstore.size()
    for shard in pstore._shards:
        for sign, (_, vec) in shard.entries.items():
            np.testing.assert_allclose(cstore.get_embedding_entry(sign), vec, rtol=0, atol=1e-3)


def test_pipelined_stream_on_card_matches_in_order(cuda):
    """The stage-pipelined stream on the card (depth 4, packs of 4, bf16
    wires, a cache small enough to evict and restore) against the in-order
    stream on the card over the same batches: the directories' decisions
    and the servers' entries after flush bit for bit, the last loss
    equal; feeds hoisted (K12 enqueued by the stager on the dispatch's
    stream) and restoring steps in order."""
    from persia_tpu_torch.config import EmbeddingConfig, SlotConfig
    from persia_tpu_torch.data import IDTypeFeatureWithSingleID, Label, NonIDTypeFeature, PersiaBatch
    from persia_tpu_torch.embedding.hbm_cache import CachedTrainCtx
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.embedding.store import EmbeddingStore
    from persia_tpu_torch.embedding.worker import EmbeddingWorker
    from persia_tpu_torch.models import DLRM
    from persia_tpu_torch.testing.watchdog import run_with_watchdog

    cfg = EmbeddingConfig(slots_config={f"c{i}": SlotConfig(dim=16) for i in range(4)}, feature_index_prefix_bit=8)
    rng = np.random.default_rng(1)
    batches = []
    for _ in range(24):
        feats = [IDTypeFeatureWithSingleID(f"c{i}", (rng.zipf(1.2, 256) % 3000).astype(np.uint64)) for i in range(4)]
        batches.append(PersiaBatch(feats, non_id_type_features=[NonIDTypeFeature(rng.normal(size=(256, 13))
                                                                                 .astype(np.float32))],
                                   labels=[Label(rng.integers(0, 2, (256, 1)).astype(np.float32))],
                                   requires_grad=True))

    def run(depth):
        store = EmbeddingStore(capacity=1 << 16, num_internal_shards=4, optimizer=Adagrad(lr=0.05).config, seed=1)
        torch.manual_seed(0)
        model = DLRM(13, 4, 16, (32, 16), (64,), compute_dtype=torch.float32, device="cpu")
        ctx = CachedTrainCtx(model, torch.optim.Adam(model.parameters(), lr=1e-3), Adagrad(lr=0.05),
                             EmbeddingWorker(cfg, [store]), cfg, cache_rows=640, device=cuda,
                             wb_wire_dtype="bfloat16", aux_wire_dtype="bfloat16").__enter__()
        rows = []
        inner = ctx.tier.prepare_batch

        def wrapped(batch, **kw):
            out = inner(batch, **kw)
            rows.append(out[0]["stacked_rows"]["cache_d16"].copy())
            return out

        ctx.tier.prepare_batch = wrapped
        run_with_watchdog(lambda: ctx.train_stream(batches, dispatch_k=4, pipeline_depth=depth, fetch_final=False),
                          timeout=60.0)
        loss = ctx.last_metrics()["loss"]
        st = ctx.stream_stats()
        ctx.flush()
        return loss, rows, store, st

    l1, r1, s1, st1 = run(1)
    l4, r4, s4, st4 = run(4)
    assert st4["pipelined_feeds"] > 0 and st4["pipeline_depth"] == 4 and st1["pipelined_feeds"] == 0, st4
    assert l1 == l4
    assert all(np.array_equal(a, b) for a, b in zip(r1, r4)) and len(r1) == len(r4) == 24
    assert s1.size() == s4.size()
    for shard in s1._shards:
        for sign, (_, vec) in shard.entries.items():
            np.testing.assert_array_equal(s4.get_embedding_entry(sign), vec, err_msg=str(sign))


# ------------------------------------------- the mixed tier: K15 and its path


def _quant_case(lengths, dtype, seed, dev):
    g = torch.Generator().manual_seed(seed)
    n = sum(lengths)
    scales = torch.tensor([10.0 ** (i % 5 - 3) for i, ln in enumerate(lengths) for _ in range(ln)])
    grads = (torch.randn(n, generator=g) * scales).to(dtype)
    res = torch.randn(n, generator=g) * scales * 1e-2
    offsets = [0]
    for ln in lengths:
        offsets.append(offsets[-1] + ln)
    return grads.to(dev), res.to(dev), offsets


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lengths", [[1, 511, 512, 513, 1000, 3], [24576] * 26, [0, 7, 0, 4096 * 16 + 5],
                                     [16 * 4096, 1536 * 16, 33], [5, 2043, 4099, 771, 8], [300_003],
                                     [(i * 37) % 251 for i in range(512)], [24576] * 13])
def test_quantize_int8_kernel_matches_plain_bitwise(cuda, lengths, dtype):
    """K15 against its plain version on the card, segment lengths that are
    not multiples of 512 or of the 8-element unit, empty ones, the
    ps-stream path's 26 segments of 24,576 and the mixed leg's 13,
    host-pooled (B, D) beside device-pooled (P, D), starts off 8 elements
    before a vector body, one segment past a cluster's registers (300,003)
    and 512 segments: codes, scales and the residual bit for bit, over
    three steps with the residual carried in place; one launch a call."""
    from persia_tpu_torch.ops.quantize_int8 import quantize_int8_ef, quantize_int8_ef_reference

    g, res, offsets = _quant_case(lengths, dtype, 7, cuda)
    plain_res = res.clone()
    for step in range(3):
        before = quantize_int8_ef.launches
        q, s, new = quantize_int8_ef(g, res, offsets)
        assert quantize_int8_ef.launches == before + 1 and new.data_ptr() == res.data_ptr()
        q2, s2, plain_res = quantize_int8_ef_reference(g, plain_res, offsets)
        torch.cuda.synchronize()
        assert torch.equal(q, q2) and torch.equal(s, s2)
        assert torch.equal(new.view(torch.int32), plain_res.view(torch.int32))
        g = (g.float() * -0.5 + 1e-3).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_int8_kernel_nan_segment(cuda, dtype):
    """A NaN inside one segment: its scale is the card's canonical NaN
    (0x7fffffff: the card's arithmetic returns it whatever NaN went in),
    its codes 0 and its residual NaN, as the plain version gives them on
    the card; the other segments are untouched by it. Bit for bit over
    three steps, in place, one launch a call."""
    from persia_tpu_torch.ops.quantize_int8 import quantize_int8_ef, quantize_int8_ef_reference

    lengths = [24576, 24576, 1000, 24576]
    g, res, offsets = _quant_case(lengths, dtype, 11, cuda)
    g[24576 + 777] = float("nan")
    clean_g, clean_res = g.clone(), res.clone()
    clean_g[24576:2 * 24576] = 0
    plain_res = res.clone()
    for step in range(3):
        before = quantize_int8_ef.launches
        q, s, new = quantize_int8_ef(g, res, offsets)
        assert quantize_int8_ef.launches == before + 1 and new.data_ptr() == res.data_ptr()
        q2, s2, plain_res = quantize_int8_ef_reference(g, plain_res, offsets)
        qc, sc, clean_res = quantize_int8_ef_reference(clean_g, clean_res, offsets)
        torch.cuda.synchronize()
        assert torch.equal(q, q2) and torch.equal(s.view(torch.int32), s2.view(torch.int32))
        assert torch.equal(new.view(torch.int32), plain_res.view(torch.int32))
        assert s.view(torch.int32)[1].item() == 0x7FFFFFFF
        assert not q[24576:2 * 24576].any() and new[24576:2 * 24576].isnan().all()
        for a, b in ((0, 24576), (2 * 24576, sum(lengths))):
            assert torch.equal(q[a:b], qc[a:b]) and torch.equal(new[a:b].view(torch.int32),
                                                                  clean_res[a:b].view(torch.int32))
        assert torch.equal(s[[0, 2, 3]], sc[[0, 2, 3]])
        g = (g.float() * -0.5 + 1e-3).to(dtype)
        clean_g = (clean_g.float() * -0.5 + 1e-3).to(dtype)
        clean_g[24576:2 * 24576] = 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lengths", [[5, 2043, 4099, 771, 8], [300_003]])
def test_quantize_int8_kernel_off_16_bytes(cuda, lengths, dtype):
    """Gradients and a residual that start off 16 bytes (views into larger
    tensors) take K15's scalar units: bit for bit the plain version over
    three steps, in place, one launch a call."""
    from persia_tpu_torch.ops import plans
    from persia_tpu_torch.ops.quantize_int8 import quantize_int8_ef, quantize_int8_ef_reference

    g0, res0, offsets = _quant_case(lengths, dtype, 13, cuda)
    n = g0.numel()
    g_big = torch.zeros(n + 3, dtype=dtype, device=cuda)
    r_big = torch.zeros(n + 1, dtype=torch.float32, device=cuda)
    g, res = g_big[3:], r_big[1:]
    g.copy_(g0)
    res.copy_(res0)
    assert g.data_ptr() % 16 and res.data_ptr() % 16
    assert plans.quantize_int8_plan(len(lengths), max(lengths), g.element_size(), False).vec == 1
    plain_res = res0.clone()
    for step in range(3):
        before = quantize_int8_ef.launches
        q, s, new = quantize_int8_ef(g, res, offsets)
        assert quantize_int8_ef.launches == before + 1 and new.data_ptr() == res.data_ptr()
        q2, s2, plain_res = quantize_int8_ef_reference(g, plain_res, offsets)
        torch.cuda.synchronize()
        assert torch.equal(q, q2) and torch.equal(s, s2)
        assert torch.equal(new.view(torch.int32), plain_res.view(torch.int32))
        g.copy_((g.float() * -0.5 + 1e-3).to(dtype))


def _quant_extremes(dtype, dev):
    """Segments at the edges of K15's division: maxima under 1e-30 (the
    scale clamps), scales under 2^-90 and from 2^126 up (IEEE division),
    just inside both (Markstein's), subnormal gradients, v at the codes'
    rounding midpoints, signed zeros, an infinity."""
    rng = np.random.default_rng(5)
    segs = [rng.standard_normal(4099) * 1e-31, rng.standard_normal(4101) * 1e-29,
            np.where(rng.random(4096) < 0.25, 1e-40, rng.standard_normal(4096) * 1e-26),
            rng.standard_normal(4103) * 1e37, rng.standard_normal(4096) * 4e37,
            np.concatenate([[1.37], (np.arange(-127, 127) + 0.5) / 127 * 1.37, -(np.arange(-127, 127) + 0.5) / 127]),
            np.array([0.0, -0.0, -0.0, 0.0, 1e-3, -0.0, 2e-3, -5e-4] * 64), np.array([1.0, np.inf, -2.0, 0.5] * 9)]
    g = torch.from_numpy(np.concatenate(segs).astype(np.float32)).to(dtype)
    res = torch.zeros(g.shape, dtype=torch.float32)
    zeros = torch.from_numpy(np.concatenate([np.zeros(sum(len(x) for x in segs[:6])), np.array([-0.0] * 512),
                                             np.zeros(len(segs[7]))]).astype(np.float32))
    res = torch.where(zeros.signbit(), zeros, res)
    offsets = [0] + np.cumsum([len(x) for x in segs]).tolist()
    return g.to(dev), res.to(dev), offsets


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_int8_kernel_extreme_scales_bitwise(cuda, dtype):
    """K15 at the edges of its division (``_quant_extremes``) against its
    plain version on the card: codes, scales and the residual bit for bit
    over three steps, in place."""
    from persia_tpu_torch.ops.quantize_int8 import quantize_int8_ef, quantize_int8_ef_reference

    g, res, offsets = _quant_extremes(dtype, cuda)
    plain_res = res.clone()
    for step in range(3):
        q, s, new = quantize_int8_ef(g, res, offsets)
        q2, s2, plain_res = quantize_int8_ef_reference(g, plain_res, offsets)
        torch.cuda.synchronize()
        assert torch.equal(q, q2) and torch.equal(s.view(torch.int32), s2.view(torch.int32)), step
        assert torch.equal(new.view(torch.int32), plain_res.view(torch.int32)), step
        g = (g.float() * -0.5).to(dtype)


def test_quantize_int8_kernel_zeros_and_refusals(cuda):
    """All-zero segments give code 0, scale 1e-30 and an unchanged
    residual; offsets that do not end at n raise before a launch."""
    from persia_tpu_torch.ops.quantize_int8 import quantize_int8_ef

    g = torch.zeros(1000, device=cuda)
    res = torch.zeros(1000, device=cuda)
    q, s, new = quantize_int8_ef(g, res, [0, 300, 1000])
    torch.cuda.synchronize()
    assert not q.any() and torch.equal(s.cpu(), torch.full((2,), 1e-30)) and not new.any()
    with pytest.raises(ValueError):
        quantize_int8_ef(g, res, [0, 300, 999])


def test_all_ps_int8_ctx_on_card_matches_cpu(cuda):
    """Every slot on the PS, the int8 wire, device pooling: the card's
    ``train_step`` (K1/K2 on the PS slots' rows, K15 once a step) against
    the same ctx on the CPU over 4 steps: losses within 1e-4 (f32
    compute), the servers' entries within 1e-3 (a code flip moves one
    entry's gradient by scale / 127); no cache kernel launched; then a
    stream of 4 steps: every ref released, K15 once a step."""
    from persia_tpu_torch.config import EmbeddingConfig, SlotConfig
    from persia_tpu_torch.data import IDTypeFeatureWithSingleID, Label, NonIDTypeFeature, PersiaBatch
    from persia_tpu_torch.embedding.hbm_cache import CachedTrainCtx
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.embedding.store import EmbeddingStore
    from persia_tpu_torch.embedding.worker import EmbeddingWorker
    from persia_tpu_torch.models import DLRM
    from persia_tpu_torch.ops import cache_aux, cached_gather, quantize_int8_ef, sparse_update
    from persia_tpu_torch.testing.watchdog import run_with_watchdog

    names = [f"c{i}" for i in range(4)]
    cfg = EmbeddingConfig(slots_config={n: SlotConfig(dim=16) for n in names}, feature_index_prefix_bit=8)

    def make(device):
        store = EmbeddingStore(capacity=1 << 16, num_internal_shards=4, optimizer=Adagrad(lr=0.05).config, seed=1)
        torch.manual_seed(0)
        model = DLRM(13, 4, 16, (32, 16), (64,), compute_dtype=torch.float32, device="cpu")
        ctx = CachedTrainCtx(model, torch.optim.Adam(model.parameters(), lr=1e-3), Adagrad(lr=0.05),
                             EmbeddingWorker(cfg, [store], device_pooling=True), cfg, cache_rows=8, device=device,
                             ps_slots=names, ps_wire_dtype="int8").__enter__()
        return ctx, store

    rng = np.random.default_rng(0)
    batches = []
    for _ in range(8):
        feats = [IDTypeFeatureWithSingleID(n, (rng.zipf(1.2, 256) % 5000).astype(np.uint64)) for n in names]
        batches.append(PersiaBatch(feats, non_id_type_features=[NonIDTypeFeature(rng.normal(size=(256, 13))
                                                                                 .astype(np.float32))],
                                   labels=[Label(rng.integers(0, 2, (256, 1)).astype(np.float32))],
                                   requires_grad=True))
    (card, cstore), (cpu, pstore) = make(cuda), make("cpu")
    counts = [f.launches for f in (cache_aux, cached_gather, sparse_update, quantize_int8_ef)]
    for b in batches[:4]:
        a, c = card.train_step(b), cpu.train_step(b)
        assert abs(a["loss"] - c["loss"]) <= 1e-4
    assert [f.launches for f in (cache_aux, cached_gather, sparse_update)] == counts[:3]
    assert quantize_int8_ef.launches == counts[3] + 4
    assert cstore.size() == pstore.size()
    for shard in pstore._shards:
        for sign, (_, vec) in shard.entries.items():
            np.testing.assert_allclose(cstore.get_embedding_entry(sign), vec, rtol=0, atol=1e-3)
    m = run_with_watchdog(lambda: card.train_stream(batches[4:], prefetch=4, psgrad_batch=2), timeout=60.0)
    assert np.isfinite(m["loss"]) and card.worker.staleness == 0 and card.stream_stats()["psgrad_steps"] == 4
    assert quantize_int8_ef.launches == counts[3] + 8


# ------------------------- bf16 pools (K12, its read, K13) and K15's loss-scale gate


@pytest.mark.parametrize("wires", [(False, False), (True, True), (False, True)])
@pytest.mark.parametrize("kind", ["sgd", "adagrad", "adagrad_vw", "adam"])
def test_cache_aux_kernel_bf16_pool_matches_plain_bitwise(cuda, kind, wires):
    """K12 on a bf16 pool bit for bit its plain version: each evicted row
    widened into the payload (f32, or back to bf16: its own bits), the warm
    entries and cold seeds rounded to bf16 (to nearest, ties to even), the
    f32 state as on an f32 pool; half the misses on rows evicted this
    step."""
    from persia_tpu_torch.testing.cache_cases import aux_case

    aux_bf16, wb_bf16 = wires
    case = aux_case(kind, 4096, 16, 1500, 900, 600, 0.5, aux_bf16, cuda, seed=11 + len(kind),
                    table_dtype=torch.bfloat16)
    got, want = _cache_aux_both(case, wb_bf16)
    assert got[1].dtype == torch.bfloat16
    _assert_aux_bits(got, want)


@pytest.mark.parametrize("store", [True, False])
@pytest.mark.parametrize("wires", [(False, False), (True, True), (False, True)])
@pytest.mark.parametrize("kind", ["adagrad", "adam"])
def test_cache_aux_kernel_bf16_pool_restores_match_plain(cuda, kind, wires, store):
    """K12 with ring restores on a bf16 pool: the restored entries rounded
    to bf16, the payload (and the ring) bit for bit the plain version."""
    from persia_tpu_torch.testing.cache_cases import aux_case

    aux_bf16, wb_bf16 = wires
    case = aux_case(kind, 4096, 16, 1500, 500, 400, 0.5, aux_bf16, cuda, seed=3 + len(kind) + 5 * store,
                    n_restore=300, ring_rows=3000, wb_bf16=wb_bf16, ring_pos=700, table_dtype=torch.bfloat16)
    _assert_aux_bits(*_restores_both(case, wb_bf16, store))


@pytest.mark.parametrize("kind", ["sgd", "adagrad", "adagrad_vw", "adam"])
def test_gather_entry_rows_kernel_bf16_pool_matches_plain(cuda, kind):
    """The flush's read of a bf16 pool: the rows widened beside the f32
    state, bit for bit its plain version; a bf16 row round-trips to its
    bits."""
    from persia_tpu_torch.ops.cache_aux import gather_entry_rows, gather_entry_rows_reference
    from persia_tpu_torch.testing.cache_cases import aux_case

    case = aux_case(kind, 4096, 16, 1, 0, 0, False, False, cuda, seed=9, table_dtype=torch.bfloat16)
    rows = torch.randperm(4097, generator=torch.Generator().manual_seed(3))[:3000].int()
    rows[:3] = torch.tensor([-4, 4096, 1 << 20], dtype=torch.int32)
    got = gather_entry_rows(case["table"], case["state"], rows.to(cuda))
    ref = gather_entry_rows_reference(case["table"].cpu(), {k: v.cpu() for k, v in case["state"].items()}, rows)
    assert got.dtype == torch.float32 and torch.equal(got.cpu(), ref)
    live = rows[3:].long()
    assert torch.equal(got[3:, :16].cpu().to(torch.bfloat16), case["table"].cpu()[live])


@pytest.mark.parametrize("L,scale,miss,zipf", [(1, False, 0, True), (1, True, 0, False), (1, False, 37, False),
                                               (3, False, 0, False), (8, True, 0, True), (5, True, 29, False)])
def test_cached_gather_kernel_bf16_pool_matches_plain(cuda, L, scale, miss, zipf):
    """K13 on a bf16 pool (4 columns a thread) against its plain version on
    the CPU, pooled in f32: bit for bit at L=1, within the f32 sum-order
    bound beyond; eval's miss rows rounded to bf16; keys, raw rows and mask
    bit for bit."""
    from persia_tpu_torch.ops.cached_gather import cached_gather, cached_gather_reference
    from persia_tpu_torch.testing.cache_cases import gather_case

    case = gather_case(26, 512, L, 3000, 16, cuda, seed=40 + L, scale=scale, miss=miss, zipf=zipf,
                       table_dtype=torch.bfloat16)
    sc, mt = case.get("scale"), case.get("miss_table")
    keys = miss == 0
    got = cached_gather(case["table"], case["rows"], True, sc, keys=keys, miss_table=mt)
    ref = cached_gather_reference(case["table"].cpu(), case["rows"].cpu(), True,
                                  sc.cpu() if sc is not None else None, keys=keys,
                                  miss_table=mt.cpu() if mt is not None else None)
    pooled, rpooled = (got[0], ref[0]) if keys else (got, ref)
    assert pooled.dtype == torch.float32
    if L == 1:
        assert torch.equal(pooled.cpu(), rpooled)
    else:
        wide = dict(case, table=case["table"].float())
        assert bool(((pooled.cpu() - rpooled).abs() <= _sum_tolerance(wide, L)).all())
    if keys:
        assert torch.equal(got[1].cpu(), ref[1])
    raw = cached_gather(case["table"], case["rows"][0].contiguous(), False, keys=keys, miss_table=mt)
    rraw = cached_gather_reference(case["table"].cpu(), case["rows"][0].cpu(), False, keys=keys,
                                   miss_table=mt.cpu() if mt is not None else None)
    for a, b in zip(raw, rraw):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("finite", [True, False], ids=["finite", "overflow"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lengths", [[24576] * 26, [1, 511, 512, 513, 1000, 3], [0, 7, 0, 4096 * 16 + 5],
                                     [300_003]])
def test_quantize_int8_kernel_loss_scale_gate_matches_plain(cuda, lengths, dtype, finite):
    """K15 reading ``inv`` and ``finite`` from the card's memory, against
    its plain version on the card over three steps with the residual
    carried: on a finite step codes, scales (their tail 1) and the residual
    bit for bit; on an overflow (an inf in the gradients, inv 0) zero
    codes, zero scales with the tail 0, the residual left as it was; one
    launch a call; without the gate the call is the old one."""
    from persia_tpu_torch.ops.quantize_int8 import quantize_int8_ef, quantize_int8_ef_reference

    g, res, offsets = _quant_case(lengths, dtype, 17, cuda)
    g = (g.float() * 1024.0).to(dtype)
    if not finite:
        g[offsets[-1] // 2] = float("inf")
    inv = torch.tensor(1.0 / 1024.0 if finite else 0.0, device=cuda)
    fin = torch.tensor(1.0 if finite else 0.0, device=cuda)
    plain_res = res.clone()
    for step in range(3):
        kept = res.clone()
        before = quantize_int8_ef.launches
        q, s, new = quantize_int8_ef(g, res, offsets, inv, fin)
        assert quantize_int8_ef.launches == before + 1 and new.data_ptr() == res.data_ptr()
        q2, s2, plain_res = quantize_int8_ef_reference(g, plain_res, offsets, inv, fin)
        torch.cuda.synchronize()
        assert s.shape == (len(offsets),) and float(s[-1]) == float(finite)
        assert torch.equal(q, q2) and torch.equal(s, s2)
        assert torch.equal(new.view(torch.int32), plain_res.view(torch.int32))
        if not finite:
            assert not q.any() and not s.any() and torch.equal(new, kept)
        g = (g.float() * -0.5 + 1e-3).to(dtype)
    g2, r2, _ = _quant_case(lengths, dtype, 18, cuda)
    a = quantize_int8_ef(g2, r2.clone(), offsets)
    b = quantize_int8_ef(g2, r2.clone(), offsets, torch.tensor(1.0, device=cuda), torch.tensor(1.0, device=cuda))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1][:-1]) and torch.equal(a[2], b[2])


# ------------------------------------- DeepFM, DCN-v2 and DNN on the fused tier


@pytest.mark.parametrize("name", ["deepfm", "dcnv2", "dnn"])
def test_fused_graph_step_equals_eager_step_any_model(cuda, name):
    """The fused tier's CUDA-graph step against its eager step for DeepFM,
    DCN-v2 and DNN (bf16 compute, 5 single-id slots of dim 16), 4 steps:
    losses and every state leaf bit for bit, DNN's batch statistics
    included (K10 and K11 and their running-statistic writes captured in
    the graph); the eval step after it moves no statistic."""
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.models import DNN, DCNv2, DeepFM
    from persia_tpu_torch.ops import batch_norm_bwd, batch_norm_fwd
    from persia_tpu_torch.parallel.fused_step import (
        FusedSlotSpec, build_fused_eval_step, build_fused_train_step, init_fused_state,
    )

    specs = {f"s{i}": FusedSlotSpec(vocab=1000, dim=16) for i in range(4)}
    specs["bag"] = FusedSlotSpec(vocab=500, dim=16, sqrt_scaling=True)
    batches = _fused_batches(cuda, 4)
    results = []
    for jit in (False, True):
        gen = torch.Generator().manual_seed(3)
        model = {"deepfm": lambda: DeepFM(13, 5, 16, (64, 32), device=cuda, generator=gen),
                 "dcnv2": lambda: DCNv2(13, 5, 16, 2, None, (64, 32), device=cuda, generator=gen),
                 "dnn": lambda: DNN(13, [16] * 5, 16, 64, (64, 32), device=cuda, generator=gen)}[name]()
        state = init_fused_state(model, torch.optim.Adam(model.parameters(), lr=1e-3),
                                 torch.Generator().manual_seed(1), specs, Adagrad(lr=0.05).config, stack=True,
                                 device=cuda)
        step = build_fused_train_step(Adagrad(lr=0.05).config, specs, stack=True, jit=jit)
        bn = (batch_norm_fwd.launches, batch_norm_bwd.launches)
        losses = [step(state, b)[1][0] for b in batches]
        if name == "dnn" and not jit:
            assert (batch_norm_fwd.launches - bn[0], batch_norm_bwd.launches - bn[1]) == (8, 8)
        results.append((torch.stack(losses).cpu(), _state_bits(state)))
        before = _state_bits(state)
        build_fused_eval_step(specs, stack=True)(state, batches[0])
        assert all(np.array_equal(a, b) for a, b in zip(before, _state_bits(state)))
    assert torch.equal(results[0][0], results[1][0])
    assert all(np.array_equal(a, b) for a, b in zip(results[0][1], results[1][1]))


# ------------------------------- the dense sync's kernels (K16, K17, K15 shared)


def _blocks_vector(n, bs, seed, dev):
    rng = np.random.default_rng(seed)
    mags = 10.0 ** rng.integers(-20, 6, n // bs)
    v = (rng.normal(size=n) * np.repeat(mags, bs)).astype(np.float32)
    v[:bs] = 0.0  # an all-zero block
    return torch.from_numpy(v).to(dev)


@pytest.mark.parametrize("feedback", [False, True])
@pytest.mark.parametrize("n,bs", [(341248, 256), (1000, 100), (4096, 2048), (96, 1), (256, 256)])
def test_block_quantize_kernel_matches_plain_bitwise(cuda, n, bs, feedback):
    """K16: codes, scales and errors bit for bit the plain version, one
    launch a call, the error written into the caller's row."""
    from persia_tpu_torch.ops.block_int8 import block_quantize_int8, block_quantize_int8_reference

    v = _blocks_vector(n, bs, n + bs, cuda)
    ef = _blocks_vector(n, bs, n + bs + 1, cuda) * 1e-3 if feedback else None
    err = torch.empty_like(v)
    before = block_quantize_int8.launches
    q, s, e = block_quantize_int8(v, bs, ef=ef, err=err)
    assert block_quantize_int8.launches == before + 1 and e.data_ptr() == err.data_ptr()
    q2, s2, e2 = block_quantize_int8_reference(v, bs, ef)
    assert torch.equal(q, q2) and torch.equal(s, s2) and torch.equal(e, e2)


@pytest.mark.parametrize("n_rows,roll,with_base,with_ef", [
    (1, 0, False, False), (1, 0, True, False), (1, 0, True, True), (4, 1, False, False), (2, 1, False, False)])
def test_block_dequantize_kernel_matches_plain_bitwise(cuda, n_rows, roll, with_base, with_ef):
    """K17: the hop's accumulate (in place) and the all-gather's rolled rows
    bit for bit the plain version, one launch a call."""
    from persia_tpu_torch.ops.block_int8 import (
        block_dequantize_int8,
        block_dequantize_int8_reference,
        block_quantize_int8,
    )

    bs, chunk = 256, 85504
    v = _blocks_vector(n_rows * chunk, bs, 7 + n_rows, cuda)
    q, s, _ = block_quantize_int8(v, bs)
    base = _blocks_vector(n_rows * chunk, bs, 9, cuda) if with_base else None
    ef = base * 1e-3 if with_ef else None
    want = block_dequantize_int8_reference(q, s, bs, n_rows, roll, base, ef)
    before = block_dequantize_int8.launches
    got = block_dequantize_int8(q, s, bs, n=n_rows, roll=roll, base=base, ef=ef, out=base)
    assert block_dequantize_int8.launches == before + 1
    assert torch.equal(got, want)


def _f32_bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("feedback", [False, True])
@pytest.mark.parametrize("bs", [16, 48, 100, 128, 384, 512, 640])
def test_block_int8_both_plans_match_plain_bitwise(cuda, bs, feedback):
    """K16 on the warp plan (128, 384, 512) and the block plan (16, 48,
    100, 640); K17 on the vector plan (block sizes a multiple of 16) and
    the scalar plan (100): bit for bit their plain versions, K17 as the
    all-gather's 4 rolled rows and as a hop's accumulate in place."""
    from persia_tpu_torch.ops import plans
    from persia_tpu_torch.ops.block_int8 import (
        block_dequantize_int8,
        block_dequantize_int8_reference,
        block_quantize_int8,
        block_quantize_int8_reference,
    )

    chunk = 24 * bs
    v = _blocks_vector(4 * chunk, bs, bs + 17, cuda)
    ef = _blocks_vector(4 * chunk, bs, bs + 18, cuda) * 1e-3 if feedback else None
    assert (plans.block_int8_plan(bs, 1).vec > 0) == (bs in (128, 384, 512))
    assert (plans.block_dequant_plan(bs, chunk).vec > 0) == (bs % 16 == 0)
    q, s, e = block_quantize_int8(v, bs, ef=ef)
    q2, s2, e2 = block_quantize_int8_reference(v, bs, ef)
    assert torch.equal(q, q2) and torch.equal(s, s2) and torch.equal(_f32_bits(e), _f32_bits(e2))
    rows = block_dequantize_int8(q, s, bs, n=4, roll=1)
    assert torch.equal(_f32_bits(rows), _f32_bits(block_dequantize_int8_reference(q, s, bs, 4, 1)))
    base = _blocks_vector(chunk, bs, bs + 19, cuda)
    hop_ef = base * 1e-3 if feedback else None
    want = block_dequantize_int8_reference(q[:chunk], s[:chunk // bs], bs, 1, 0, base, hop_ef)
    got = block_dequantize_int8(q[:chunk], s[:chunk // bs], bs, base=base, ef=hop_ef, out=base)
    assert got is base and torch.equal(_f32_bits(got), _f32_bits(want))


@pytest.mark.parametrize("write_acc", [False, True])
@pytest.mark.parametrize("feedback", [False, True])
@pytest.mark.parametrize("n,bs", [(85504, 256), (341248, 256), (4096, 128), (4608, 384), (4096, 512), (1000, 100),
                                  (1536, 16)])
def test_block_requantize_kernel_matches_plain_bitwise(cuda, n, bs, feedback, write_acc):
    """The fused hop on both plans: codes, scales and errors (and with
    ``write_acc`` the sum in ``base``) bit for bit K17's plain version then
    K16's; one launch of its own a call, none of K16's or K17's."""
    from persia_tpu_torch.ops.block_int8 import (
        block_dequantize_int8,
        block_quantize_int8,
        block_requantize_int8,
        block_requantize_int8_reference,
    )

    q_in, sc_in, _ = block_quantize_int8(_blocks_vector(n, bs, n + 3, cuda), bs)
    base = _blocks_vector(n, bs, n + 4, cuda)
    ef = _blocks_vector(n, bs, n + 5, cuda) * 1e-3 if feedback else None
    before = base.clone()
    q2, s2, e2, x = block_requantize_int8_reference(q_in, sc_in, before, ef, bs)
    counts = lambda: (block_quantize_int8.launches, block_dequantize_int8.launches,  # noqa: E731
                      block_requantize_int8.launches)
    c0 = counts()
    q, s, e = block_requantize_int8(q_in, sc_in, base, ef, bs, write_acc=write_acc)
    assert tuple(b - a for a, b in zip(c0, counts())) == (0, 0, 1)
    assert torch.equal(q, q2) and torch.equal(s, s2) and torch.equal(_f32_bits(e), _f32_bits(e2))
    assert torch.equal(_f32_bits(base), _f32_bits(x if write_acc else before))


def test_block_int8_vector_plans_refuse_misaligned_tensors(cuda):
    """The warp and vector plans' 16-byte accesses: a tensor that starts
    off a 16-byte boundary raises; the block and scalar plans take it."""
    from persia_tpu_torch.ops.block_int8 import block_dequantize_int8, block_quantize_int8, block_requantize_int8

    buf = torch.randn(4 * 256 + 4, device=cuda)
    off = buf[1:1 + 4 * 256]
    with pytest.raises(ValueError, match="boundary"):
        block_quantize_int8(off, 256)
    q, s, _ = block_quantize_int8(buf[:4 * 256].contiguous(), 256)
    with pytest.raises(ValueError, match="boundary"):
        block_requantize_int8(q, s, off, None, 256)
    with pytest.raises(ValueError, match="boundary"):
        block_dequantize_int8(q, s, 256, base=off, out=off)
    block_quantize_int8(buf[1:1 + 4 * 100], 100)  # the block plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_int8_shared_scale_kernel_matches_plain_bitwise(cuda, dtype):
    """K15's scales-only mode and its codes at a shared scale: the scales,
    codes and residual bit for bit the plain versions, one launch each, the
    residual in place; the DLRM tower's leaf sizes (1 to 187,904)."""
    from persia_tpu_torch.ops.quantize_int8 import (
        quantize_int8_ef_reference,
        quantize_int8_ef_shared,
        segment_absmax,
        segment_absmax_reference,
    )

    sizes = [1, 16, 256, 3, 4096, 187904, 131072, 256, 512, 1, 64]
    offsets = np.concatenate([[0], np.cumsum(sizes)]).tolist()
    g = _randn(offsets[-1], 11, cuda, dtype)
    res = _randn(offsets[-1], 12, cuda) * 1e-3
    before = segment_absmax.launches
    scale = segment_absmax(g, res, offsets)
    assert segment_absmax.launches == before + 1
    assert torch.equal(scale, segment_absmax_reference(g, res, offsets))
    shared = scale * 1.25
    plain = res.clone()
    before = quantize_int8_ef_shared.launches
    q, s, new = quantize_int8_ef_shared(g, res, offsets, shared)
    assert quantize_int8_ef_shared.launches == before + 1 and new.data_ptr() == res.data_ptr()
    q2, s2, r2 = quantize_int8_ef_reference(g, plain, offsets, scale=shared)
    assert torch.equal(q, q2) and torch.equal(s, s2) and torch.equal(new, r2)



# K15's dense-sync modes as flat passes: phase 3h's cases. The bench DLRM
# tower's leaves in the flat vector's order (each bias before its kernel)
# and by layer; 512 segments; empty and 1-element segments; boundaries
# inside a unit (and 13 in one unit, empty segments); boundaries on a CTA's span boundary (the tower's plan
# spans 2,584 elements at both unit sizes); a leaf of zeros (the floor), a
# NaN, +-inf
TOWER_LEAVES = [256, 3328, 64, 16384, 16, 1024, 512, 187904, 256, 131072, 1, 256]
FLAT_CASES = {
    "tower": TOWER_LEAVES,
    "tower_by_layer": [3328, 256, 16384, 64, 1024, 16, 187904, 512, 131072, 256, 256, 1],
    "segments_512": [(i * 37) % 251 for i in range(512)],
    "empty_and_ones": [0, 1, 0, 1, 1, 5000, 0, 1, 3],
    "inside_units": [3, 5, 13, 2, 9, 4100, 1, 1, 6],
    "many_in_a_unit": [3] + [0] * 10 + [1] * 3 + [5000],
    "span_boundary": [2584, 7752, 1, 2583, sum(TOWER_LEAVES) - 12920],
    "specials": [4096, 1000, 1000, 513],
}


def flat_case(case, dev, dtype, off16=False, seed=21):
    """(g, residual, offsets) of ``FLAT_CASES[case]``: normal g of mixed
    magnitudes, a residual ~1e-4; "specials": leaf 0 all zeros (g and
    residual), a NaN in leaf 1, +inf and -inf in leaf 2. ``off16``: g and
    the residual start one element past a 16-byte boundary."""
    lengths = FLAT_CASES[case]
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(int).tolist()
    n = offsets[-1]
    rng = np.random.default_rng(seed)
    g = (rng.normal(size=n) * 10.0 ** rng.integers(-3, 2, n)).astype(np.float32)
    r = (rng.normal(size=n) * 1e-4).astype(np.float32)
    if case == "specials":
        g[:4096] = 0
        r[:4096] = 0
        g[4096 + 17] = np.nan
        g[5096 + 3], g[5096 + 900] = np.inf, -np.inf
    lead = int(off16)
    gbuf = torch.zeros(n + lead, dtype=dtype, device=dev)
    rbuf = torch.zeros(n + lead, dtype=torch.float32, device=dev)
    gbuf[lead:] = torch.from_numpy(g).to(dev, dtype)
    rbuf[lead:] = torch.from_numpy(r).to(dev)
    return gbuf[lead:], rbuf[lead:], offsets


def _f32_bits_equal(a, b):
    return a.dtype == b.dtype and torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("off16", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(FLAT_CASES))
def test_flat_dense_sync_modes_match_plain_bitwise(cuda, case, dtype, off16):
    """``segment_absmax`` and ``quantize_int8_ef_shared``, one launch
    each, bit for bit their plain versions at every case, f32 and bf16 g,
    on 16 bytes (8-element units) and off them (the scalar plan); the int32
    codes the plain version's int8 codes widened; the residual in place."""
    from persia_tpu_torch.ops import plans
    from persia_tpu_torch.ops.quantize_int8 import (
        quantize_int8_ef_reference,
        quantize_int8_ef_shared,
        segment_absmax,
        segment_absmax_reference,
    )

    g, res, offsets = flat_case(case, cuda, dtype, off16)
    assert plans.flat_quant_plan(g.numel(), not off16).vec == (1 if off16 else 8)
    if case == "span_boundary":
        assert plans.flat_quant_plan(g.numel(), not off16).span * (1 if off16 else 8) == 2584
    before = segment_absmax.launches
    scale = segment_absmax(g, res, offsets)
    assert segment_absmax.launches == before + 1
    assert _f32_bits_equal(scale, segment_absmax_reference(g, res, offsets))
    if case == "specials":
        assert scale[0].item() == np.float32(1e-30) and np.isnan(scale[1].item()) and scale[2].item() == np.inf
    shared = scale * 1.25
    plain = res.clone()
    before = quantize_int8_ef_shared.launches
    q, s, new = quantize_int8_ef_shared(g, res, offsets, shared)
    assert quantize_int8_ef_shared.launches == before + 1 and new.data_ptr() == res.data_ptr()
    q2, s2, r2 = quantize_int8_ef_reference(g, plain, offsets, scale=shared)
    assert q.dtype == torch.int32 and torch.equal(q, q2.to(torch.int32))
    assert _f32_bits_equal(s, s2) and _f32_bits_equal(new, r2)


def test_segment_absmax_scratch_resets_itself(cuda):
    """Two calls in a row, a call on another stream (its own scratch), and
    a call captured in a CUDA graph and replayed 3 times (an eager call of
    other inputs between replays) give the plain version's scales: the
    last CTA sets the scratch and its ticket back to zero."""
    from persia_tpu_torch.ops import quantize_int8
    from persia_tpu_torch.ops.quantize_int8 import segment_absmax, segment_absmax_reference

    g, res, offsets = flat_case("tower", cuda, torch.float32)
    g2, res2, _ = flat_case("tower", cuda, torch.float32, seed=22)
    want, want2 = segment_absmax_reference(g, res, offsets), segment_absmax_reference(g2, res2, offsets)
    assert torch.equal(segment_absmax(g, res, offsets), want)
    assert torch.equal(segment_absmax(g2, res2, offsets), want2)
    assert torch.equal(segment_absmax(g, res, offsets), want)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        on_side = segment_absmax(g2, res2, offsets)
        keys = set(quantize_int8._scratch)
    torch.cuda.current_stream().wait_stream(side)
    assert torch.equal(on_side, want2) and len(keys) >= 2
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = segment_absmax(g, res, offsets)
    before = segment_absmax.launches
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)
        assert torch.equal(segment_absmax(g2, res2, offsets), want2)
    assert segment_absmax.launches == before + 3  # the replays pass no wrapper


def test_segment_absmax_graphs_replayed_at_once_keep_their_own_scratch(cuda):
    """Two CUDA graphs, each capturing ``segment_absmax`` of other inputs on
    ``torch.cuda.graph``'s shared capture stream, replayed at once on two
    streams (the second first), 10 times: every replay gives the plain
    version's scales, since each capture makes its own scratch (its key
    holds the capture's id) and zeroes it in its graph."""
    from persia_tpu_torch.ops import quantize_int8
    from persia_tpu_torch.ops.quantize_int8 import segment_absmax, segment_absmax_reference

    inputs = [flat_case("tower", cuda, torch.float32, seed=30 + i) for i in range(2)]
    wants = [segment_absmax_reference(g, r, offsets) for g, r, offsets in inputs]
    torch.cuda.synchronize()
    graphs, outs, keys = [], [], []
    for g, r, offsets in inputs:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs.append(segment_absmax(g, r, offsets))
            keys.append([k for k in quantize_int8._scratch if k[2] is not None])
        graphs.append(graph)
    assert len(keys[0]) == len(keys[1]) == 1 and keys[0][0][2] != keys[1][0][2]
    streams = [torch.cuda.Stream() for _ in graphs]
    for _ in range(10):
        for out in outs:
            out.zero_()
        torch.cuda.synchronize()
        for graph, stream in zip(graphs[::-1], streams[::-1]):
            with torch.cuda.stream(stream):
                graph.replay()
        torch.cuda.synchronize()
        for out, want in zip(outs, wants):
            assert _f32_bits_equal(out, want)

@pytest.mark.parametrize("mode", ["f32", "bf16", "bytegrad", "block-int8-ring", "f32-sharded",
                                  "block-int8-ring-sharded"])
def test_dense_sync_ctx_on_card_matches_cpu(cuda, mode):
    """``TrainCtx(mesh=data_parallel_mesh(), dense_sync=mode)`` at one rank
    on the card against the same on the CPU (plain versions), 3 steps:
    losses within 1e-5 relative, parameters within 1e-5; the ring launches
    K16 and K17 once a step each, bytegrad K15's two modes once each."""
    from persia_tpu_torch.ops import block_int8, quantize_int8
    from persia_tpu_torch.parallel.mesh import data_parallel_mesh
    from persia_tpu_torch.testing import dense_sync as tds

    outs = []
    for dev in (cuda, torch.device("cpu")):
        counts = (block_int8.block_quantize_int8.launches, block_int8.block_dequantize_int8.launches,
                  quantize_int8.segment_absmax.launches, quantize_int8.quantize_int8_ef_shared.launches)
        res = tds.run_case(data_parallel_mesh(), dict(mode=mode, steps=3, seed=9), tds.SPEC, dev)
        after = (block_int8.block_quantize_int8.launches, block_int8.block_dequantize_int8.launches,
                 quantize_int8.segment_absmax.launches, quantize_int8.quantize_int8_ef_shared.launches)
        if dev.type == "cuda":
            ring = mode == "block-int8-ring"
            want = (3 * ring, 3 * ring, 3 * (mode == "bytegrad"), 3 * (mode == "bytegrad"))
            assert tuple(a - b for a, b in zip(after, counts)) == want
        outs.append(res)
    np.testing.assert_allclose(outs[0]["losses"], outs[1]["losses"], rtol=1e-5)
    np.testing.assert_allclose(outs[0]["params"], outs[1]["params"], rtol=0, atol=1e-5)


def _lp_mix_lengths(case):
    from persia_tpu_torch.parallel import grad_sync
    from persia_tpu_torch.testing import dense_sync as tds

    if case == "tower":  # the bench DLRM tower's 12 leaves, in the flat vector's order
        from persia_tpu_torch.models import DLRM

        model = DLRM(13, 26, 16, (256, 64, 16), (512, 256), compute_dtype=torch.float32, device="cpu")
        return [p.numel() for _path, p, _tr in grad_sync.dense_leaves(model)]
    return tds.LP_MIX_CASES[case]


@pytest.mark.parametrize("specials", [False, True])
@pytest.mark.parametrize("off16", [False, True])
@pytest.mark.parametrize("case", ["tower", "segments_512", "empty_and_ones", "inside_units", "many_in_a_unit"])
def test_lp_ring_mix_kernel_matches_plain_bitwise(cuda, case, off16, specials):
    """K18 against its plain version on the card, bit for bit: x and the
    three shadows rewritten in place, one launch; codes of -127, 127 and 0,
    a scale of 1e-30, NaN and infinities in x, tensors off 16 bytes (the
    scalar plan)."""
    from persia_tpu_torch.ops import plans
    from persia_tpu_torch.ops.lp_ring import lp_ring_mix, lp_ring_mix_reference
    from persia_tpu_torch.testing import dense_sync as tds

    args, offsets = tds.lp_mix_inputs(_lp_mix_lengths(case), cuda, 70, off16, specials)
    want = lp_ring_mix_reference(*args, offsets)
    ins = [a.clone() if i < 4 else a for i, a in enumerate(args)]
    if off16:  # clones start on 16 bytes: keep the four rewritten tensors off them
        for i in range(4):
            buf = torch.empty(ins[i].numel() + 1, dtype=torch.float32, device=cuda)[1:]
            buf.copy_(args[i])
            ins[i] = buf
    assert plans.lp_ring_mix_plan(offsets[-1], not off16).vec == (1 if off16 else 4)
    before = lp_ring_mix.launches
    out = lp_ring_mix(*ins, offsets)
    assert lp_ring_mix.launches == before + 1
    for o, i, w in zip(out, ins, want):
        assert o is i and _f32_bits_equal(o, w)


def test_lp_ring_mix_kernel_refusals(cuda):
    from persia_tpu_torch.ops.lp_ring import lp_ring_mix
    from persia_tpu_torch.testing import dense_sync as tds

    args, offsets = tds.lp_mix_inputs([600] * 513, cuda, 71)
    with pytest.raises(ValueError, match="segments"):
        lp_ring_mix(*args, offsets)
    args, offsets = tds.lp_mix_inputs([10, 20], cuda, 72)
    with pytest.raises(ValueError, match="int8"):
        lp_ring_mix(*args[:4], args[4].int(), *args[5:], offsets)


@pytest.mark.parametrize("name,kwargs,want", [
    ("decentralized", {}, {}),
    ("local_sgd", {"period": 2}, {}),
    ("qadam", {"lr": 3e-3, "warmup_steps": 1}, {"segment_absmax": 1, "quantize_int8_ef_shared": 1}),
    ("lp", {}, {"quantize_int8_ef": 1, "lp_ring_mix": 1}),
])
def test_divergent_algorithms_on_card_match_cpu(cuda, name, kwargs, want):
    """``build_sync_train_step`` with each divergent-replica algorithm at
    one rank on the card against the same on the CPU (plain versions), 3
    steps: losses within 1e-5 relative, parameters within 1e-5 (QAdam's
    after its warmup 1e-3 relative: its frozen v scales a rounding up);
    a step's sync kernels: LowPrecisionDecentralized 1 K15 and 1 K18,
    QAdam after its warmup 1 ``segment_absmax`` and 1 shared quantize (none
    in it), the others none."""
    from persia_tpu_torch.parallel.mesh import data_parallel_mesh
    from persia_tpu_torch.testing import dense_sync as tds

    case = dict(algorithm=name, kwargs=kwargs, steps=3, seed=9)
    card = tds.divergent_case(data_parallel_mesh(), case, tds.SPEC, cuda)
    cpu = tds.divergent_case(data_parallel_mesh(), case, tds.SPEC, torch.device("cpu"))
    for s, launches in enumerate(card["launches"]):
        expect = {} if name == "qadam" and s == 0 else want
        assert {k: v for k, v in launches.items() if v} == expect, s
    np.testing.assert_allclose(card["losses"], cpu["losses"], rtol=1e-5)
    rtol = 1e-3 if name == "qadam" else 0
    np.testing.assert_allclose(card["params"][-1], cpu["params"][-1], rtol=rtol, atol=1e-5)
