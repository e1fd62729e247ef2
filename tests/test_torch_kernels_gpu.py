"""The port's CUDA kernels on a card, each held to its plain version, and the
serving slice on the card held to the same engine on the CPU.

Every test needs a card and skips without one. This file imports no JAX,
so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -q -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from persia_tpu_torch.ops import dot_interaction, flash_attention, tf32_split_planes
from persia_tpu_torch.ops.dot_interaction import dot_interaction_reference
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
    from persia_tpu_torch.weights import dlrm_state_dict_from_flax, seeded_flax_params_like

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
        sd = sd or dlrm_state_dict_from_flax(seeded_flax_params_like(model, 1))
        model.load_state_dict(sd)
        engine = InferenceEngine(InferCtx(model, worker, cfg, device=device), device=device)
        before = dot_interaction.launches
        preds[device] = engine.predict_from_bytes(batch.to_bytes())
        assert dot_interaction.launches == before + (1 if device is None else 0)
    assert np.isfinite(preds[None]).all()
    np.testing.assert_allclose(preds[None], preds["cpu"], rtol=0, atol=2e-2)
