"""The port's host-side bf16 wire (``persia_tpu_torch/wire.py``) against
``ml_dtypes``' rounding, which the reference's bf16 staging uses (through
``jax.numpy``): bit for bit, ties, subnormals, ±inf and NaN included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from persia_tpu_torch.wire import BF16Host, bf16_bits_to_f32, f32_to_bf16_bits, tensor_to_host_f32


def _ml_dtypes_bits(x: np.ndarray) -> np.ndarray:
    return np.asarray(jnp.asarray(x, dtype=jnp.bfloat16)).view(np.uint16)


def _special_bits():
    bits = [
        0x00000000, 0x80000000,  # ±0
        0x7F800000, 0xFF800000,  # ±inf
        0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF800001, 0x7FBFFFFF, 0x7FFFFFFF,  # NaNs
        0x00000001, 0x80000001, 0x00007FFF, 0x00008000, 0x00018000, 0x007FFFFF,  # subnormals
        0x00800000, 0x3F808000, 0x3F818000, 0x3F807FFF, 0x3F808001,  # ties and neighbours
        0x7F7FFFFF, 0xFF7FFFFF, 0x7F7F7FFF, 0x7F7F8000,  # near the largest finite
    ]
    return np.array(bits, dtype=np.uint32)


@pytest.mark.parametrize("kind", ["random_bits", "normals", "special", "ties"])
def test_rounding_matches_ml_dtypes_bitwise(kind):
    rng = np.random.default_rng(0)
    if kind == "random_bits":
        u = rng.integers(0, 2 ** 32, 200_000, dtype=np.uint64).astype(np.uint32)
    elif kind == "normals":
        u = (rng.standard_normal(200_000) * 10.0 ** rng.integers(-40, 38, 200_000)).astype(np.float32).view(np.uint32)
    elif kind == "special":
        u = _special_bits()
    else:  # exactly halfway between two bf16 values, both parities of the kept bit
        hi = rng.integers(0, 2 ** 16, 50_000, dtype=np.uint64).astype(np.uint32)
        u = (hi << np.uint32(16)) | np.uint32(0x8000)
    x = u.view(np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        np.testing.assert_array_equal(f32_to_bf16_bits(x), _ml_dtypes_bits(x))


def test_widening_is_exact_and_inverts_rounding():
    bits = np.arange(2 ** 16, dtype=np.uint32).astype(np.uint16)
    wide = bf16_bits_to_f32(bits)
    np.testing.assert_array_equal(wide.view(np.uint32), bits.astype(np.uint32) << np.uint32(16))
    finite = np.isfinite(wide)
    np.testing.assert_array_equal(f32_to_bf16_bits(wide[finite]), bits[finite])
    np.testing.assert_array_equal(bf16_bits_to_f32(bits.view(np.int16)), wide)


def test_host_array_reaches_torch_as_bf16():
    """``BF16Host.to`` gives the tensor torch's own f32 → bf16 conversion
    gives (also round to nearest even), and the way back is exact."""
    x = np.random.default_rng(1).standard_normal((37, 16)).astype(np.float32)
    host = BF16Host.from_f32(x)
    assert host.shape == (37, 16)
    t = host.to(torch.device("cpu"))
    assert t.dtype == torch.bfloat16 and t.shape == (37, 16)
    assert torch.equal(t, torch.from_numpy(x).to(torch.bfloat16))
    np.testing.assert_array_equal(tensor_to_host_f32(t), t.float().numpy())
    np.testing.assert_array_equal(tensor_to_host_f32(torch.from_numpy(x)), x)
