"""K7's sum order (``plans.raw_bwd_model``), its long-row list
(``ops.raw_csr``) and its launch geometry (``plans.raw_gather_bwd_plan``),
on the CPU. The card tests (``tests/test_torch_kernels_gpu.py``) hold the
kernel to the model bit for bit; here the model is held to the plain
version and to a sequential loop:

- a row of fewer than ``K7_LONG_MIN`` positions sums them in f32 in stream
  order from 0, so the model equals ``raw_gather_bwd_reference`` (a
  sequential ``index_add_`` on the CPU) bit for bit, in f32 and in bf16
  (one rounding of the f32 sum);
- a long row sums each chunk of ``K7_CHUNK`` positions so, then the chunk
  sums in chunk order from 0.
"""

import numpy as np
import pytest
import torch

from persia_tpu_torch.ops import RawSlot, plans, raw_csr
from persia_tpu_torch.ops.raw_gather import raw_gather_bwd_reference

T, C = plans.K7_LONG_MIN, plans.K7_CHUNK
BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def _taobao_index(rng, b, l, d):
    """A (B, L) index of Taobao-length histories over d distinct rows
    (1..L valid positions, sample 0 empty, sample 1 full; pads at P - 1)."""
    p = 1 << int(np.ceil(np.log2(d + 1)))
    lengths = rng.integers(1, l + 1, b)
    lengths[0], lengths[1] = 0, l
    ids = rng.integers(0, d, (b, l))
    return np.where(np.arange(l)[None, :] < lengths[:, None], ids, p - 1).astype(np.int32), p


def _model_bits(grad, order, offsets, dtype):
    m = plans.raw_bwd_model(grad.reshape(-1, grad.shape[-1]).float().numpy(), order, offsets)
    return torch.from_numpy(m).to(dtype).view(BITS[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l,d,dim", [(1024, 50, 26_000, 16), (1024, 50, 9_000, 16), (64, 9, 40, 10)])
def test_model_equals_the_plain_version_bitwise_on_taobao_histories(b, l, d, dim, dtype):
    rng = np.random.default_rng(d + dim)
    index, p = _taobao_index(rng, b, l, d)
    order, offsets, long_chunks = raw_csr(index, p)
    assert np.diff(offsets).max() < T and long_chunks.shape == (0, 2)  # no row is long here
    grad = torch.from_numpy(rng.standard_normal((1, b, l, dim)).astype(np.float32)).to(dtype)
    slot = RawSlot(torch.from_numpy(index), *map(torch.from_numpy, (order, offsets, long_chunks)))
    ref = raw_gather_bwd_reference(grad, [torch.zeros((p, dim), dtype=dtype)], [slot])[0]
    assert torch.equal(_model_bits(grad[0], order, offsets, dtype), ref.view(BITS[dtype]))
    assert not ref[-1].any()


def _sequential(x):
    acc = np.zeros(x.shape[1], np.float32)
    for row in x:
        acc = acc + row  # f32 + f32: one rounding an add
    return acc


def _row_sum(x):
    """A row's sum as K7 takes it: below K7_LONG_MIN terms in stream order,
    else each chunk of K7_CHUNK so and then the chunk sums in order."""
    if x.shape[0] < T:
        return _sequential(x)
    return _sequential(np.stack([_sequential(x[k:k + C]) for k in range(0, x.shape[0], C)]))


@pytest.mark.parametrize("n", [T - 1, T, T + 1, C, C + 1, 3 * C + 7])
def test_model_sums_a_long_row_chunk_by_chunk(n):
    """Row 1 holds n positions scattered among others (rows 2-5): below
    K7_LONG_MIN a row is one stream-order sum, from it on each chunk of
    K7_CHUNK positions is, then the chunk sums in chunk order; the long
    list names the rows of K7_LONG_MIN positions or more."""
    rng = np.random.default_rng(n)
    index = rng.integers(2, 6, 4 * n).astype(np.int32)
    index[rng.choice(4 * n, n, replace=False)] = 1
    index = index.reshape(4, n)
    order, offsets, long_chunks = raw_csr(index, 8)
    x = (rng.standard_normal((4 * n, 5)) * 10.0 ** rng.integers(-3, 4, (4 * n, 1))).astype(np.float32)
    got = plans.raw_bwd_model(x, order, offsets)
    assert offsets[2] - offsets[1] == n
    for r in range(1, 6):
        span = order[offsets[r]:offsets[r + 1]]
        assert (np.diff(span) > 0).all()
        np.testing.assert_array_equal(got[r], _row_sum(x[span]))
    if n > C + 1:  # a second chunk of two or more: another sum than the stream order's
        assert not np.array_equal(got[1], _sequential(x[order[offsets[1]:offsets[2]]]))
    assert not got[0].any() and not got[6:].any()
    listed = {int(r) for r in long_chunks[:, 0]}
    assert listed == {r for r in range(7) if offsets[r + 1] - offsets[r] >= T}


@pytest.mark.parametrize("lengths", [[T - 1, T, T + 1], [1, 600, 0, 2 * C, 5, 2 * C + 1], [C - 1, 40, 0]])
def test_raw_csr_lists_exactly_the_long_rows_chunks(lengths):
    """``raw_csr``'s long list: for every row of K7_LONG_MIN positions or
    more, rows ascending, (row, chunk) for its ceil(n / K7_CHUNK) chunks
    in order; no short row and never the pad row, however long."""
    rng = np.random.default_rng(len(lengths))
    rows = len(lengths) + 2  # the last is the pad row
    flat = np.concatenate([np.full(n, r) for r, n in enumerate(lengths)] + [np.full(3 * T, rows - 1)])
    index = rng.permutation(flat).astype(np.int32).reshape(1, -1)
    _, _, long_chunks = raw_csr(index, rows)
    assert long_chunks.dtype == np.int32 and long_chunks.shape[1] == 2
    want = [(r, c) for r, n in enumerate(lengths) if n >= T for c in range(-(-n // C))]
    assert [tuple(e) for e in long_chunks.tolist()] == want


@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("slots,dim,max_rows,long_blocks,aligned", [
    (2, 16, 32_768, 0, True), (2, 16, 32_768, 400, True), (1, 10, 37, 3, True), (3, 24, 513, 1, True),
    (1, 128, 9, 0, True), (64, 16, 4, 2, False), (1, 1024, 5, 1, True), (5, 7, 1, 0, True),
])
def test_raw_gather_bwd_plan_covers_every_row_and_chunk_once(slots, dim, max_rows, long_blocks, aligned, elem):
    """The kernel's mapping (csrc/raw_gather.cu): block x < short_blocks,
    thread t takes row x * threads / lanes + t / lanes (columns t % lanes,
    vec each, dim / vec / lanes times); block short_blocks + j the listed
    chunk j; grid (short_blocks + long_blocks, slots)."""
    p = plans.raw_gather_bwd_plan(slots, dim, elem, max_rows, long_blocks, aligned)
    wide = 16 // elem
    assert p.vec == (wide if aligned and dim % wide == 0 else 1)
    units = dim // p.vec
    assert p.lanes & (p.lanes - 1) == 0 and p.lanes <= 32 and units % p.lanes == 0 and units <= p.threads
    assert p.threads == plans.K7_THREADS
    per_block = p.threads // p.lanes
    rows = [b * per_block + t // p.lanes for b in range(p.short_blocks) for t in range(0, p.threads, p.lanes)]
    assert len(rows) == len(set(rows)) and set(range(max_rows)) <= set(rows)
    assert len(rows) - max_rows < per_block  # the fewest short blocks
    assert [b - p.short_blocks for b in range(p.short_blocks, p.short_blocks + p.long_blocks)] == \
        list(range(long_blocks))
    if long_blocks:
        assert p.tile_rows == min(C, plans.K7_STAGE_FLOATS // dim) >= 1
        assert p.smem_bytes == 4 * (p.tile_rows * dim + C) + 16 <= plans.SMEM_STATIC
        n = slots * long_blocks
        assert p.scratch_ints == -(-n // 4) * 4 + n * dim
    else:
        assert p.smem_bytes == 0 and p.scratch_ints == 0


@pytest.mark.parametrize("args", [
    (0, 16, 4, 4, 1), (plans.POOL_MAX_SLOTS + 1, 16, 4, 4, 1), (1, 16, 8, 4, 1), (1, 16, 4, 0, 1),
    (1, 0, 4, 4, 1), (1, 16, 4, 4, -1), (1, 257, 4, 4, 0), (1, 2056, 2, 4, 0),
])
def test_raw_gather_bwd_plan_refuses_what_the_kernel_takes_not(args):
    """Group sizes without a launch, another element size, no rows, a
    negative chunk count, and rows of more column units than a block has
    threads (the entry point's checks)."""
    with pytest.raises(ValueError):
        plans.raw_gather_bwd_plan(*args)


def test_k7_constants_match_their_cuda_twins():
    """K7's thresholds and sizes are constants on both sides: plans.py and
    csrc/raw_gather.cu."""
    import re
    from pathlib import Path

    src = (Path(plans.__file__).resolve().parent.parent / "csrc" / "raw_gather.cu").read_text()
    twins = {"kLongMin": plans.K7_LONG_MIN, "kChunk": plans.K7_CHUNK, "kBwdThreads": plans.K7_THREADS,
             "kStageFloats": plans.K7_STAGE_FLOATS}
    for name, value in twins.items():
        assert int(re.search(rf"constexpr int {name} = (\d+);", src).group(1)) == value, name
