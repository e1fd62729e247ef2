"""The schedule of the grouped gather-pool backward kernel
(csrc/embedding_pool.cu), checked on the CPU: the host CSR it reads, the
chunks and lane groups that cover a slot's sorted positions, the rows pass
2 combines, and ``plans.pool_bwd_model`` — the kernel's f32 sums in its own
order — held to an exact f64 scatter-add. On a card the kernel is held to
that model bit for bit (tests/test_torch_kernels_gpu.py)."""

import numpy as np
import pytest

from persia_tpu_torch.ops import plans
from persia_tpu_torch.ops.embedding_pool import pool_csr


def _index(case: str):
    """(index (B, L) int32, rows P, dim) of a named case; pads (L > 1)
    point at row D = P - 1."""
    rng = np.random.default_rng(CASES.index(case))
    if case == "empty_rows":  # rows 0, 2, 4, ... only, and nothing past 50
        return (2 * rng.integers(0, 25, (300, 1))).astype(np.int32), 80, 16
    if case == "all_on_one_row":
        return np.full((4096, 1), 7, np.int32), 16, 16
    if case == "chunk_edge":  # row 0 ends on the first chunk edge (C = 64), row 1 on the third
        index = np.concatenate([np.zeros(64), np.ones(128), np.full(100, 2)])
        return rng.permutation(index).astype(np.int32)[:, None], 4, 16
    if case == "three_chunks":  # row 3 spans positions 10..309: five chunks of 64
        index = np.concatenate([np.arange(10) % 3, np.full(300, 3), 4 + np.arange(90) % 5])
        return rng.permutation(index).astype(np.int32)[:, None], 10, 16
    if case == "L4_pads":
        counts = rng.integers(0, 5, 500)
        index = np.full((500, 4), 40, np.int32)
        for b, c in enumerate(counts):
            index[b, :c] = rng.integers(0, 40, c)
        return index, 41, 16
    if case == "zipf":
        return ((rng.zipf(1.2, (4096, 1)) - 1) % 1500).astype(np.int32), 1537, 16
    raise KeyError(case)


CASES = ["empty_rows", "all_on_one_row", "chunk_edge", "three_chunks", "L4_pads", "zipf"]


def _direct_csr(index: np.ndarray, rows: int):
    """Row r's positions b * L + l in ascending order, by a plain walk."""
    flat = index.reshape(-1).tolist()
    per_row = [[] for _ in range(rows)]
    for pos, r in enumerate(flat):
        per_row[r].append(pos)
    order = [pos for positions in per_row for pos in positions]
    offsets = [0]
    for positions in per_row:
        offsets.append(offsets[-1] + len(positions))
    return np.array(order, np.int32), np.array(offsets, np.int32)


@pytest.mark.parametrize("case", CASES)
def test_pool_csr_matches_direct_construction(case):
    index, rows, _ = _index(case)
    order, offsets = pool_csr(index, rows)
    want_order, want_offsets = _direct_csr(index, rows)
    assert order.dtype == offsets.dtype == np.int32
    np.testing.assert_array_equal(order, want_order)
    np.testing.assert_array_equal(offsets, want_offsets)


def test_pool_csr_matches_direct_construction_70_slots():
    """A group of 70 slots (two launches): every slot's CSR exact."""
    rng = np.random.default_rng(70)
    for s in range(70):
        L, d = 1 + s % 3, 20 + s
        index = np.where(rng.random((64, L)) < 0.2, d, rng.integers(0, d, (64, L))).astype(np.int32)
        order, offsets = pool_csr(index, d + 1)
        want_order, want_offsets = _direct_csr(index, d + 1)
        np.testing.assert_array_equal(order, want_order)
        np.testing.assert_array_equal(offsets, want_offsets)


def _plan(index, rows, dim, slots=1, elem_bytes=2):
    return plans.pool_plan(index.shape[0], slots, dim, elem_bytes, rows, index.shape[1])


@pytest.mark.parametrize("case", CASES)
def test_pool_chunks_cover_every_position_once(case):
    index, rows, dim = _index(case)
    plan = _plan(index, rows, dim)
    n = index.size
    seen = [k for c in range(plan.chunks(n)) for g in range(plan.groups)
            for k in plan.group_positions(c, g)]
    assert len(seen) == plan.chunks(n) * plan.chunk == len(set(seen))
    assert [k for k in seen if k < n] == list(range(n))  # in order, each once
    assert max(seen) < n + plan.chunk  # past the end only in the last chunk
    assert plan.chunks(n) <= plan.max_chunks


@pytest.mark.parametrize("case", CASES)
def test_pool_rows_written_once(case):
    """Pass 1 stores the rows inside one chunk and pass 2 every other row
    (empty ones as zeros), each once: ``pool_bwd_model`` raises otherwise.
    Pass 2's partials of a row run from its first chunk's last half to its
    last chunk's first half, one a chunk."""
    index, rows, dim = _index(case)
    plan = _plan(index, rows, dim)
    order, offsets = pool_csr(index, rows)
    flat = index.reshape(-1)
    values = np.ones((index.size, dim), np.float32)
    plans.pool_bwd_model(values, flat[order], rows, plan)
    for r in range(rows):
        start, end = int(offsets[r]), int(offsets[r + 1])
        parts = plan.row_partials(start, end)
        if start == end:
            assert parts is None
        elif start // plan.chunk == (end - 1) // plan.chunk:
            assert parts == []
        else:
            chunks = [c for c, _ in parts]
            assert chunks == list(range(start // plan.chunk, (end - 1) // plan.chunk + 1))
            assert [h for _, h in parts] == [1] + [0] * (len(parts) - 1)
    if case == "three_chunks":
        assert len(plan.row_partials(int(offsets[3]), int(offsets[4]))) >= 3
    if case == "chunk_edge":  # row 0 ends exactly on the edge: one chunk, no partials
        assert (offsets[1], plan.row_partials(int(offsets[0]), int(offsets[1]))) == (plan.chunk, [])


@pytest.mark.parametrize(
    "batch,slots,dim,elem,max_rows,max_ids",
    [(4096, 26, 16, 2, 1536, 1), (1000, 3, 16, 4, 701, 4), (64, 64, 8, 2, 90, 3), (333, 6, 24, 4, 17, 2),
     (77, 2, 10, 4, 5, 1), (5, 1, 128, 2, 9, 1), (4096, 1, 256, 4, 3, 1)],
)
def test_pool_scratch_matches_chunks(batch, slots, dim, elem, max_rows, max_ids):
    """The partials hold two rows of dim for each chunk of the slot with the
    most positions, and the launch grids cover the chunks and the rows."""
    p = plans.pool_plan(batch, slots, dim, elem, max_rows, max_ids)
    assert p.max_chunks == -(-batch * max_ids // p.chunk)
    assert p.scratch_shape == (slots, p.max_chunks, 2, dim)
    bx, by = p.chunk_grid
    assert (bx - 1) * plans.POOL_CHUNK_WARPS < p.max_chunks <= bx * plans.POOL_CHUNK_WARPS and by == slots
    rx, ry = p.row_block
    assert rx * ry <= plans.POOL_THREADS and rx == min(dim // p.bwd_vec, plans.POOL_THREADS)
    assert (p.row_grid[0] - 1) * ry < max_rows <= p.row_grid[0] * ry and p.row_grid[1] == slots
    items = batch * slots * dim // p.fwd_vec
    assert (p.fwd_grid - 1) * p.fwd_threads < items <= p.fwd_grid * p.fwd_threads


@pytest.mark.parametrize(
    "dim,elem,aligned,fwd_vec,bwd_vec,lanes,tiles,chunk",
    [
        (16, 2, True, 8, 4, 4, 1, 64),  # the bench shape: 8 position groups of 4 lanes
        (16, 4, True, 4, 4, 4, 1, 64),
        (8, 4, True, 4, 4, 2, 1, 128),
        (24, 4, True, 4, 4, 2, 3, 128),  # 6 float4 columns: 2 lanes, 3 tiles
        (24, 2, True, 8, 4, 2, 3, 128),
        (128, 2, True, 8, 4, 32, 1, 8),
        (256, 4, True, 4, 4, 32, 2, 8),
        (10, 4, True, 1, 1, 8, 2, 32),  # the scalar path, a ragged last tile
        (3, 2, True, 1, 1, 4, 1, 64),
        (16, 2, False, 1, 1, 8, 2, 32),  # unaligned pointers: the scalar path
    ],
)
def test_pool_plan_paths(dim, elem, aligned, fwd_vec, bwd_vec, lanes, tiles, chunk):
    p = plans.pool_plan(64, 1, dim, elem, 10, 1, aligned)
    assert (p.fwd_vec, p.bwd_vec, p.lanes_per_pos, p.col_tiles, p.chunk) == (fwd_vec, bwd_vec, lanes, tiles, chunk)
    assert p.groups * p.lanes_per_pos == 32 and p.chunk == p.groups * plans.POOL_GROUP_POSITIONS
    # the lanes' column tiles cover the row; the float4 path exactly
    width = p.lanes_per_pos * p.bwd_vec
    assert (p.col_tiles - 1) * width < dim <= p.col_tiles * width
    if p.bwd_vec == 4:
        assert dim == p.col_tiles * width


def _model_case(dim, batch, L, rows, counts, seed):
    rng = np.random.default_rng(seed)
    d = rows - 1  # row D, the pads' row
    n_ids = rng.integers(0 if L > 1 else 1, L + 1, batch)
    index = np.full((batch, L), d, np.int32)
    keep = np.arange(L)[None, :] < n_ids[:, None]
    index[keep] = ((rng.zipf(1.2, (batch, L)) - 1) % d)[keep]
    grad = rng.standard_normal((batch, dim)).astype(np.float32)
    scale = (1 / np.sqrt(np.maximum(n_ids, 1))).astype(np.float32) if counts else np.ones(batch, np.float32)
    return index, grad, scale


@pytest.mark.parametrize(
    "dim,batch,L,rows,counts",
    [(16, 4096, 1, 1537, False), (16, 4096, 1, 257, True), (8, 1000, 4, 301, True), (24, 777, 2, 101, False),
     (10, 500, 1, 65, False), (16, 4096, 1, 3, False)],
)
def test_two_pass_model_matches_exact_sums(dim, batch, L, rows, counts):
    """The kernel's order (per position x = g[b] * scale[b] in f32, then
    pass 1's group sums and scan and pass 2's partials, all f32) against
    np.add.at in f64 on zipf(1.2) rows: each f32 sum of n terms is within
    (n - 1) 2^-24 sum|x| of the exact one; held to twice that, the bound
    the card's check uses against index_add_."""
    index, grad, scale = _model_case(dim, batch, L, rows, counts, seed=dim + L + rows)
    plan = plans.pool_plan(batch, 1, dim, 4, rows, L)
    order, offsets = pool_csr(index, rows)
    flat = index.reshape(-1)
    b = order // L
    values = grad[b] * scale[b][:, None]  # f32, one rounding each, as the kernel's __fmul_rn
    got = plans.pool_bwd_model(values, flat[order], rows, plan)
    exact = np.zeros((rows, dim))
    np.add.at(exact, flat[order], values.astype(np.float64))
    abs_sum = np.zeros((rows, dim))
    np.add.at(abs_sum, flat[order], np.abs(values.astype(np.float64)))
    n = np.diff(offsets)[:, None]
    bound = 2 * np.maximum(n - 1, 0) * 2.0 ** -24 * abs_sum
    assert got.dtype == np.float32
    assert (np.abs(got - exact) <= bound).all()
    # the hot rows really do cross chunks here (but for the 3-row case,
    # where one row holds most positions)
    assert max(len(plan.row_partials(int(offsets[r]), int(offsets[r + 1])) or []) for r in range(rows)) >= 3
