"""The launch geometry of the port's CUDA kernels (persia_tpu_torch/ops/
plans.py), checked on the CPU: the kernels take these numbers as given."""

import itertools

import numpy as np
import pytest

from persia_tpu_torch.ops import plans

FLASH_SHAPES = [
    (4, 1024, 8, 64), (2, 1000, 4, 16), (2, 37, 3, 32), (1, 8, 1, 128), (8, 2048, 16, 64),
    (3, 65, 2, 128), (2, 300, 3, 16),
]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flash_plan_covers_every_tile_once(shape, causal):
    b, l, h, d = shape
    p = plans.flash_plan(b, l, h, d, causal)
    seen = [p.block_tile(block) for block in range(p.grid)]
    assert len(seen) == len(set(seen)) == b * h * p.q_tiles
    assert set(seen) == set(itertools.product(range(b), range(h), range(p.q_tiles)))
    # the tiles cover every query row, and no tile starts past L
    assert (p.q_tiles - 1) * p.block_q < l <= p.q_tiles * p.block_q


@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flash_plan_launches_longest_first(shape):
    b, l, h, d = shape
    p = plans.flash_plan(b, l, h, d, causal=True)
    work = [p.key_tiles(p.block_tile(block)[2]) for block in range(p.grid)]
    assert work == sorted(work, reverse=True)
    # causal visits the key tiles up to the diagonal; non-causal all of them
    full = plans.flash_plan(b, l, h, d, causal=False)
    for qt in range(p.q_tiles):
        assert p.key_tiles(qt) == -(-min(l, (qt + 1) * p.block_q) // p.block_k)
        assert full.key_tiles(qt) == -(-l // full.block_k)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_flash_plan_box_swizzle_and_shared_memory(d):
    p = plans.flash_plan(4, 1024, 8, d, causal=False)
    # a TMA box row is exactly the swizzle width the wgmma descriptors name
    assert p.box_cols * 2 == p.swizzle_bytes
    assert p.swizzle_bytes == {16: 32, 32: 64, 64: 128, 128: 128}[d]
    assert p.boxes * p.box_cols == d
    # tiles keep the 1024-byte alignment of the 128-byte swizzle
    assert p.tile_bytes_q % plans.SMEM_ALIGN == 0 and p.tile_bytes_kv % plans.SMEM_ALIGN == 0
    assert p.stages >= 2
    used = p.tile_bytes_q + 2 * p.stages * p.tile_bytes_kv + 8 * (1 + 2 * p.stages)
    assert p.smem_bytes == used + plans.SMEM_ALIGN
    assert p.smem_bytes <= plans.SMEM_MAX
    # blocks that fit one SM's 228 KB, each with its 1 KB system share: four
    # up to D=64 (registers allow four), two at D=128
    per_sm = 233_472 // (p.smem_bytes + 1024)
    assert per_sm >= (4 if d <= 64 else 2)


@pytest.mark.parametrize("d", [8, 24, 48, 200])
def test_flash_plan_rejects_head_dims_without_a_kernel(d):
    with pytest.raises(ValueError):
        plans.flash_plan(1, 64, 1, d, causal=False)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_tf32_plan_covers_every_tile_once_longest_first(shape, causal):
    b, l, h, d = shape
    p = plans.tf32_plan(b, l, h, d, causal)
    seen = [p.block_tile(block) for block in range(p.grid)]
    assert len(seen) == len(set(seen)) == b * h * p.q_tiles
    assert set(seen) == set(itertools.product(range(b), range(h), range(p.q_tiles)))
    assert (p.q_tiles - 1) * p.block_q < l <= p.q_tiles * p.block_q
    work = [p.key_tiles(tile[2]) for tile in seen]
    assert work == sorted(work, reverse=True)
    for qt in range(p.q_tiles):
        keys = min(l, (qt + 1) * p.block_q) if causal else l
        assert p.key_tiles(qt) == -(-keys // p.block_k)
    # the planes hold whole q tiles, so no TMA box of Q, K or V^T leaves them
    assert p.seq_pad % p.block_q == 0 and p.seq_pad % p.block_k == 0
    assert l <= p.seq_pad < l + plans.TF32_SEQ_ALIGN
    assert p.plane_shapes == ((4, b * h, p.seq_pad, d), (2, b * h, d, p.seq_pad))


@pytest.mark.parametrize("d,blocks", [(16, 2), (32, 2), (64, 2), (128, 1)])
def test_tf32_plan_shared_memory_and_blocks_per_sm(d, blocks):
    p = plans.tf32_plan(4, 1024, 8, d, causal=False)
    # a Q/K box row is the swizzle width: 64 bytes at D=16, else 128
    assert p.box_cols * 4 == p.swizzle_bytes == (64 if d == 16 else 128)
    assert p.boxes * p.box_cols == d
    # every tile keeps the 1024-byte alignment of the 128-byte swizzle
    for tile in (p.tile_bytes_q, p.tile_bytes_k, p.tile_bytes_vt, p.stage_bytes):
        assert tile % plans.SMEM_ALIGN == 0
    assert p.tile_bytes_q == 64 * d * 4 and p.tile_bytes_k == p.tile_bytes_vt == 32 * d * 4
    assert p.stages >= 2
    used = 2 * p.tile_bytes_q + p.stages * p.stage_bytes + 8 * (1 + 2 * p.stages)
    assert p.smem_bytes == used + plans.SMEM_ALIGN <= plans.SMEM_MAX
    # blocks that fit one SM's 228 KB, each with its 1 KB system share: the
    # kernel's __launch_bounds__ target (two up to D=64, one at D=128); at
    # the main shape's D=64 exactly two (2 x 97 KB)
    per_sm = 233_472 // (p.smem_bytes + 1024)
    assert per_sm >= blocks
    if d == 64:
        assert per_sm == 2


@pytest.mark.parametrize("d", [8, 24, 48, 200])
def test_tf32_plan_rejects_head_dims_without_a_kernel(d):
    with pytest.raises(ValueError):
        plans.tf32_plan(1, 64, 1, d, causal=False)


def test_tf32_key_order_is_a_permutation_within_each_group_of_8():
    """Position p of a V^T group holds key TF32_KEY_ORDER[p]; the A fragment
    reads positions t and t+4 from the accumulator's keys 2t and 2t+1."""
    order = plans.TF32_KEY_ORDER
    assert sorted(order) == list(range(8))
    for t in range(4):
        assert (order[t], order[t + 4]) == (2 * t, 2 * t + 1)


DOT_SHAPES = [(4096, 27, 16), (4095, 27, 16), (33, 2, 8), (7, 60, 48), (5, 9, 24), (3, 100, 64)]


@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("shape", DOT_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_dot_plan_rows_fit(shape, elem):
    b, n, d = shape
    p = plans.dot_plan(b, n, d, elem)
    assert 1 <= p.rows_per_block <= plans.DOT_MAX_ROWS
    assert p.threads == 32 * p.rows_per_block  # one warp per batch row
    assert p.grid * p.rows_per_block >= b > (p.grid - 1) * p.rows_per_block
    smem = plans.dot_smem_bytes(p.rows_per_block, n, d, elem, p.mma)
    assert p.smem_bytes == smem <= plans.SMEM_STATIC
    # the most rows that fit: one more would not (or the cap is reached)
    if p.rows_per_block < plans.DOT_MAX_ROWS:
        assert plans.dot_smem_bytes(p.rows_per_block + 1, n, d, elem, p.mma) > plans.SMEM_STATIC


def test_dot_plan_serving_shape():
    p = plans.dot_plan(4096, 27, 16, 2)  # bf16: the tensor-core path
    assert p.mma and (p.rows_per_block, p.threads, p.grid, p.feat_stride) == (8, 256, 512, 24)
    p = plans.dot_plan(4096, 27, 16, 4)  # f32: the FMA walk
    assert not p.mma and (p.rows_per_block, p.threads, p.grid, p.feat_stride) == (8, 256, 512, 20)


@pytest.mark.parametrize(
    "n,d,elem,mma",
    [(27, 16, 2, True), (32, 64, 2, True), (33, 16, 2, False), (27, 16, 4, False),
     (27, 8, 2, False), (27, 24, 2, False), (2, 48, 2, True)],
)
def test_dot_plan_takes_the_tensor_cores_where_they_fit(n, d, elem, mma):
    assert plans.dot_plan(64, n, d, elem).mma is mma


def test_dot_plan_refuses_a_row_that_does_not_fit():
    assert plans.dot_plan(4, 200, 64, 4).rows_per_block == 0


@pytest.mark.parametrize("d", [16, 32, 48, 64])
def test_dot_mma_feature_stride_is_conflict_free(d):
    """One ldmatrix phase reads 8 rows of 16 bytes: the 8 rows start on
    distinct 16-byte bank groups."""
    stride_bytes = plans.dot_feat_stride(d, mma=True) * 2
    assert stride_bytes % 16 == 0  # ldmatrix rows are 16-byte aligned
    assert len({(row * stride_bytes // 16) % 8 for row in range(8)}) == 8


@pytest.mark.parametrize("d", [8, 16, 32, 48, 64, 5, 7, 24, 30])
def test_dot_feature_stride_is_conflict_free(d):
    """Reading one feature row per lane: the served widths read 16 bytes per
    lane (8 lanes per shared-memory wavefront), other widths 4 bytes (32
    lanes); either way every lane of a wavefront lands on its own banks."""
    stride = plans.dot_feat_stride(d)
    assert stride >= d
    if d in plans.DOT_SPECIALISED_DIMS:
        banks = [(lane * stride + w) % 32 for lane in range(8) for w in range(4)]
    else:
        banks = [(lane * stride) % 32 for lane in range(32)]
    assert len(set(banks)) == len(banks)


@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("shape", [(4096, 27, 16), (4095, 27, 16), (33, 2, 8), (7, 32, 64), (7, 60, 48),
                                   (5, 9, 24), (9, 17, 48)])
def test_dot_bwd_plan_rows_fit(shape, elem):
    """The backward's rows fit the static shared memory, cover the batch,
    and the tensor-core path runs a warp per row."""
    b, n, d = shape
    p = plans.dot_bwd_plan(b, n, d, elem)
    assert 1 <= p.rows_per_block <= plans.DOT_MAX_ROWS
    assert p.smem_bytes == plans.dot_bwd_smem_bytes(p.rows_per_block, n, d, p.mma) <= plans.SMEM_STATIC
    assert (p.grid - 1) * p.rows_per_block < b <= p.grid * p.rows_per_block
    assert p.mma == plans.dot_uses_mma(n, d, elem)
    assert p.threads == (32 * p.rows_per_block if p.mma else plans.DOT_BWD_THREADS)


def test_dot_bwd_plan_bench_shape():
    """(4096, 27, 16) bf16: 8 rows a block on the tensor cores; per row a
    32 x 40 bf16 symmetric tile and 32 feature rows of 24 bf16, plus the
    block's 351-entry pair table (rounded to 16 bytes)."""
    p = plans.dot_bwd_plan(4096, 27, 16, 2)
    assert (p.mma, p.rows_per_block, p.threads, p.grid) == (True, 8, 256, 512)
    assert p.smem_bytes == 8 * (32 * 40 * 2 + 32 * 24 * 2) + 704


def test_dot_bwd_gsym_stride_is_conflict_free():
    """ldmatrix reads 8 rows of 16 bytes of the symmetric tile at once: the
    rows' 16-byte bank groups must differ."""
    stride_bytes = plans.DOT_BWD_GSYM_STRIDE * 2
    assert stride_bytes % 16 == 0
    assert len({(r * stride_bytes // 16) % 8 for r in range(8)}) == 8


def test_dot_bwd_plan_refuses_a_row_that_does_not_fit():
    assert plans.dot_bwd_plan(4, 200, 64, 4).rows_per_block == 0


@pytest.mark.parametrize("batch,slots,dim,rows", [(4096, 26, 16, 2560), (1, 1, 1, 1), (333, 64, 8, 17)])
def test_pool_plan_covers_every_element(batch, slots, dim, rows):
    """Forward: a thread for every (sample, slot, vector of columns);
    backward: the chunks cover every position (L = 1) and pass 2 every row
    and column."""
    for elem in (2, 4):
        p = plans.pool_plan(batch, slots, dim, elem, rows)
        items = batch * slots * dim // p.fwd_vec
        assert dim % p.fwd_vec == 0 and p.fwd_threads % 32 == 0
        assert (p.fwd_grid - 1) * p.fwd_threads < items <= p.fwd_grid * p.fwd_threads
        assert (p.max_chunks - 1) * p.chunk < batch <= p.max_chunks * p.chunk
        assert p.chunk_grid[0] * plans.POOL_CHUNK_WARPS >= p.max_chunks and p.chunk_grid[1] == slots
        rx, ry = p.row_block
        assert (p.row_grid[0] - 1) * ry < rows <= p.row_grid[0] * ry and p.row_grid[1] == slots
        assert (p.col_tiles - 1) * p.lanes_per_pos * p.bwd_vec < dim <= p.col_tiles * p.lanes_per_pos * p.bwd_vec


@pytest.mark.parametrize("slots", [0, plans.POOL_MAX_SLOTS + 1])
def test_pool_plan_refuses_group_sizes_without_a_launch(slots):
    with pytest.raises(ValueError):
        plans.pool_plan(16, slots, 16, 2, 8)


@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("positions,slots,dim,aligned", [
    (51200, 2, 16, True), (45, 3, 10, True), (7, 1, 128, True), (100, 2, 16, False), (33, 64, 4, True),
])
def test_raw_gather_plan_covers_every_unit(positions, slots, dim, elem, aligned):
    p = plans.raw_gather_plan(positions, slots, dim, elem, aligned)
    row_bytes = dim * elem
    assert p.unit_bytes * p.row_units == row_bytes
    assert p.unit_bytes == (16 if aligned and row_bytes % 16 == 0 else elem)
    items = positions * p.row_units
    assert (p.grid[0] - 1) * p.threads < items <= p.grid[0] * p.threads and p.grid[1] == slots


def test_raw_gather_plan_refuses_group_sizes_without_a_launch():
    for slots in (0, plans.POOL_MAX_SLOTS + 1):
        with pytest.raises(ValueError):
            plans.raw_gather_plan(10, slots, 16, 2)
    with pytest.raises(ValueError):
        plans.raw_gather_plan(10, 1, 16, 8)


@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("batch,seq,dim,aligned", [
    (1024, 50, 16, True), (33, 7, 10, True), (5, 100, 64, True), (9, 1, 8, False), (3, 600, 128, True),
])
def test_attention_pool_plan_lane_groups_divide_the_row(batch, seq, dim, elem, aligned):
    p = plans.attention_pool_plan(batch, seq, dim, elem, aligned)
    wide = 16 // elem
    assert p.vec == (wide if aligned and dim % wide == 0 else 1)
    units = dim // p.vec
    assert units % p.lanes == 0 and p.lanes & (p.lanes - 1) == 0 and p.lanes <= 32
    assert (p.grid - 1) * p.warps < batch <= p.grid * p.warps
    # the forward needs no shared memory, the backward only past the register path
    in_smem = seq > 32 * plans.ATT_POOL_MID_PER_LANE
    assert p.bwd_smem == (p.warps * seq * 4 if in_smem else 0) <= plans.SMEM_STATIC


def test_attention_pool_plan_refuses_rows_past_the_registers():
    """A lane holds its positions' weights in registers, kMaxPerLane of
    them (csrc/attention_pool.cu), which bounds a row in both directions;
    the backward's g goes to shared memory past kMidPerLane a lane, and
    fits it at the longest row."""
    import re
    from pathlib import Path

    src = (Path(plans.__file__).resolve().parent.parent / "csrc" / "attention_pool.cu").read_text()
    assert int(re.search(r"constexpr int kMaxPerLane = (\d+);", src).group(1)) == plans.ATT_POOL_MAX_PER_LANE
    assert int(re.search(r"constexpr int kMidPerLane = (\d+);", src).group(1)) == plans.ATT_POOL_MID_PER_LANE
    longest = 32 * plans.ATT_POOL_MAX_PER_LANE
    assert longest == 1536
    smem = plans.attention_pool_plan(4, longest, 16, 2).bwd_smem
    assert smem == plans.ATT_POOL_WARPS * longest * 4 <= plans.SMEM_STATIC
    mid = 32 * plans.ATT_POOL_MID_PER_LANE
    assert (plans.attention_pool_plan(4, mid, 16, 2).bwd_smem, plans.attention_pool_plan(4, mid + 1, 16, 2).bwd_smem) \
        == (0, plans.ATT_POOL_WARPS * (mid + 1) * 4)
    with pytest.raises(ValueError):
        plans.attention_pool_plan(4, longest + 1, 16, 2)
    with pytest.raises(ValueError):
        plans.attention_pool_plan(4, 10, 16, 1)


@pytest.mark.parametrize("widths,wide,aligned,vec", [
    ((16, 16), True, True, 8),  # the bench: dim 16, Adagrad's acc, bf16 wires: 16 bytes of bf16
    ((16, 16), False, True, 4),  # f32 throughout: a float4
    ((16,), True, True, 8),  # SGD
    ((16, 16, 16), True, True, 8),  # Adam
    ((16, 1), True, True, 1),  # Adagrad's vector-wise acc: scalar columns
    ((16, 1), False, True, 1),
    ((12, 12), True, True, 4),  # a multiple of 4 but not of 8
    ((8, 4), True, True, 4),
    ((16, 16), True, False, 1),  # an array off 16 bytes
    ((6,), False, True, 1),
])
def test_cache_entry_vec(widths, wide, aligned, vec):
    """K12's and its read's vector: the widest of 8 (where bf16 is
    involved) and 4 that divides every array's width, on 16-byte arrays;
    else scalar columns."""
    assert plans.cache_entry_vec(widths, wide, aligned) == vec
    assert all(w % vec == 0 for w in widths)


def test_cache_entry_vec_refuses_an_entry_without_a_table():
    for widths in ((), (0, 16), (16, -1)):
        with pytest.raises(ValueError):
            plans.cache_entry_vec(widths, True)


# K15 (csrc/quantize_int8.cu): the ps-stream step's 26 device-pooled slots
# of P = 1,536 rows x 16, the mixed leg's 13, chip_smoke's edge cases
# (K15_CASES: host-pooled (4096, 16) beside device-pooled), misaligned
# starts before a vector body, one segment past a cluster's registers, 512
# segments
QUANT_CASES = {
    "ps_stream": [1536 * 16] * 26,
    "mixed": [1536 * 16] * 13,
    "edges": [1, 511, 512, 513, 1000, 3],
    "empty": [0, 7, 0, 16 * 4096 + 5],
    "host_pooled": [4096 * 16, 1536 * 16, 33],
    "misaligned": [5, 2043, 4099, 771, 8],
    "long": [300_003],
    "segments_512": [(i * 37) % 251 for i in range(512)],
}


def _quant_offsets(lengths):
    return [0] + list(itertools.accumulate(lengths))


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("case", sorted(QUANT_CASES))
def test_quantize_int8_plan_covers_every_element_once(case, elem, aligned):
    """Each element is written exactly once, by the kernel's own index
    arithmetic (quantize_int8_cover): the held units, the loop past them,
    block 0's head and tail; it is read once unless its block's span
    outruns the registers."""
    lengths = QUANT_CASES[case]
    p = plans.quantize_int8_plan(len(lengths), max(lengths), elem, aligned)
    assert p.vec == (8 if aligned else 1)
    assert 1 <= p.cluster <= plans.QUANT_MAX_CLUSTER and 1 <= p.units <= plans.QUANT_MAX_UNITS[p.vec]
    assert 32 <= p.threads <= plans.QUANT_MAX_THREADS and p.threads % 32 == 0
    writes, reads = plans.quantize_int8_cover(_quant_offsets(lengths), p)
    assert writes.shape == (sum(lengths),) and (writes == 1).all()
    if max(lengths) <= p.held:
        assert (reads == 1).all()
    assert set(reads.tolist()) <= {1, 2}


def test_quantize_int8_plan_at_the_ps_stream_shape():
    """26 segments of 24,576 bf16: clusters of 8 blocks of 192 threads,
    16 elements a thread, 208 blocks; every element held in registers, so
    the whole input (g 2 B and r 4 B an element, 3.8 MB) is in flight at
    once; the mixed leg's 13 segments take the same clusters."""
    p = plans.quantize_int8_plan(26, 24576, 2)
    assert (p.vec, p.cluster, p.threads, p.units, p.elems_a_thread, p.blocks) == (8, 8, 192, 2, 16, 208)
    assert p.held == 24576
    assert 26 * 24576 * (2 + 4) == 3_833_856
    assert plans.quantize_int8_plan(13, 24576, 2) == plans.QuantInt8Plan(13, 24576, 8, 8, 192, 2)
    assert plans.quantize_int8_plan(26, 24576, 4).blocks == 208


def test_quantize_int8_plan_past_the_registers():
    """A segment longer than a cluster's registers hold (8 blocks x 512
    threads x 32 elements) holds what fits and reads the rest twice; a
    512-segment call is one block of a warp a segment."""
    p = plans.quantize_int8_plan(1, 300_003, 2)
    assert (p.cluster, p.threads, p.units) == (8, 512, 4) and p.held == 131_072 < 300_003
    _, reads = plans.quantize_int8_cover([0, 300_003], p)
    assert (reads == 2).sum() == 300_003 - 131_072 - 3
    many = QUANT_CASES["segments_512"]
    q = plans.quantize_int8_plan(512, max(many), 2)
    assert (q.cluster, q.threads, q.blocks) == (1, 32, 512) and q.held >= max(many)


def test_quantize_int8_plan_misaligned_starts_take_scalar_edges():
    """Starts off 8 elements: a head of up to 7 scalar elements before the
    vector body, a tail of up to 7 after it, in block 0's threads 0-6 and
    8-14; a segment shorter than its head is all head."""
    p = plans.quantize_int8_plan(3, 20, 2)
    offsets = [0, 3, 6, 26]  # starts 3 and 6 are off the unit; 6 + 2 = 8 starts the body
    writes, reads = plans.quantize_int8_cover(offsets, p)
    assert (writes == 1).all() and (reads == 1).all()
    assert plans.QUANT_EDGE_THREAD + 7 <= 32 <= p.threads


def test_quantize_int8_plan_constants_match_the_kernel():
    import re
    from pathlib import Path

    src = (Path(plans.__file__).resolve().parent.parent / "csrc" / "quantize_int8.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kMaxQuantSegments") == plans.QUANT_MAX_SEGMENTS
    assert const("kMaxQuantThreads") == plans.QUANT_MAX_THREADS
    assert const("kMaxQuantCluster") == plans.QUANT_MAX_CLUSTER
    assert const("kEdgeThread") == plans.QUANT_EDGE_THREAD
    assert (const("kMaxUnitsWide"), const("kMaxUnitsScalar")) == (plans.QUANT_MAX_UNITS[8], plans.QUANT_MAX_UNITS[1])


@pytest.mark.parametrize("args", [(0, 10, 2), (513, 10, 2), (4, 10, 1), (4, 10, 8), (4, -1, 2)])
def test_quantize_int8_plan_refuses_what_it_has_no_kernel_for(args):
    with pytest.raises(ValueError):
        plans.quantize_int8_plan(*args)



# K15's two dense-sync modes, flat (segment_absmax_kernel,
# quantize_int8_shared_kernel): the bench DLRM tower's 12 leaves in the flat
# vector's order (flax's sorted paths, each bias before its kernel; 341,073
# f32) and by layer, 512 segments, empty and 1-element segments,
# boundaries inside units and on a CTA's span boundary (the tower's plan:
# 323 units a CTA, 2,584 elements), a vector of fewer elements than a unit
TOWER_LEAVES = [256, 3328, 64, 16384, 16, 1024, 512, 187904, 256, 131072, 1, 256]
FLAT_CASES = {
    "tower": TOWER_LEAVES,
    "tower_by_layer": [3328, 256, 16384, 64, 1024, 16, 187904, 512, 131072, 256, 256, 1],
    "segments_512": [(i * 37) % 251 for i in range(512)],
    "empty": [0, 7, 0, 0, 16 * 4096 + 5, 0],
    "ones": [1] * 40 + [100_000] + [1] * 9,
    "inside_units": [3, 5, 13, 2, 9, 4100, 1, 1, 6],
    "many_in_a_unit": [3] + [0] * 10 + [1] * 3 + [5000],
    "span_boundary": [2584, 2584 * 3, 1, 2583, 300_000],
    "short": [2, 0, 3],
}


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("case", sorted(FLAT_CASES))
def test_flat_quant_plan_covers_every_element_once(case, aligned):
    """By the kernels' own index arithmetic (flat_quant_cover): the
    quantize writes every element exactly once and both kernels read it
    once; segment_absmax reduces each segment in exactly the CTAs whose
    spans hold one of its elements, and a CTA in one segment in that one."""
    lengths = FLAT_CASES[case]
    offsets = _quant_offsets(lengths)
    p = plans.flat_quant_plan(offsets[-1], aligned)
    assert p.vec == (8 if aligned else 1)
    assert 32 <= p.threads <= plans.FLAT_QUANT_MAX_THREADS and p.threads % 32 == 0
    assert 1 <= p.units <= plans.QUANT_MAX_UNITS[p.vec] and 1 <= p.span <= p.threads * p.units
    assert p.tail < p.vec and p.tail <= p.threads
    hits, touched = plans.flat_quant_cover(offsets, p)
    assert hits.shape == (offsets[-1],) and (hits == 1).all()
    assert len(touched) == p.grid
    for b, segs in enumerate(touched):
        _u0, _held, e0, e1 = p.span_of(b)
        want = {s for s, (a, z) in enumerate(zip(offsets[:-1], offsets[1:])) if a < z and a < e1 and e0 < z}
        assert segs == want
    for s, (a, z) in enumerate(zip(offsets[:-1], offsets[1:])):
        ctas = {b for b, segs in enumerate(touched) if s in segs}
        assert ctas == {b for b in range(p.grid) if a < z and a < p.span_of(b)[3] and p.span_of(b)[2] < z}


def test_flat_quant_plan_fills_one_wave_at_the_tower():
    """The tower's 341,073 elements: 132 CTAs of 192 threads, 323 units a
    CTA (2 a thread), the one element past the last unit in the last CTA;
    the scalar plan also 132 CTAs. All but 6 CTAs lie inside one leaf; the
    93.5 % of the bytes in the two large leaves spread over 124 of the 132
    SMs."""
    n = sum(TOWER_LEAVES)
    p = plans.flat_quant_plan(n)
    assert (p.vec, p.span, p.threads, p.units, p.grid, p.tail) == (8, 323, 192, 2, 132, 1)
    q = plans.flat_quant_plan(n, aligned=False)
    assert (q.vec, q.grid) == (1, 132) and q.span <= q.threads * q.units
    _, touched = plans.flat_quant_cover(_quant_offsets(TOWER_LEAVES), p)
    assert sum(len(t) == 1 for t in touched) == 126
    assert sum(bool(t & {7, 9}) for t in touched) == 124
    assert (187_904 + 131_072) / n > 0.935


def test_flat_quant_plan_by_size():
    """The plan depends on n and the alignment only; a short vector takes
    one CTA; past 132 spans of 2,048 units the grid takes more waves; n
    must fit 32-bit indexing."""
    assert plans.flat_quant_plan(0) == plans.FlatQuantPlan(0, 8, 64, 32, 2, 1)
    assert plans.flat_quant_plan(5).grid == 1 and plans.flat_quant_plan(5).tail == 5
    big = plans.flat_quant_plan(100_000_000)
    assert (big.span, big.threads, big.units) == (2048, 512, 4) and big.grid == 6104
    for n in (1, 4095, 4096, 4097, 541_000, 2_162_688, 2_162_689):
        p = plans.flat_quant_plan(n)
        assert p.grid == max(1, -(-p.whole // p.span)) and p.span <= p.threads * p.units
        assert p.grid <= 132 or p.span == plans.FLAT_QUANT_MAX_THREADS * plans.QUANT_MAX_UNITS[8]
    with pytest.raises(ValueError, match="32 bits"):
        plans.flat_quant_plan(1 << 31)
    with pytest.raises(ValueError, match="offsets end"):
        plans.flat_quant_cover([0, 10], plans.flat_quant_plan(11))


def test_flat_quant_plan_constants_match_the_kernel():
    import re
    from pathlib import Path

    src = (Path(plans.__file__).resolve().parent.parent / "csrc" / "quantize_int8.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kFlatMaxThreads") == plans.FLAT_QUANT_MAX_THREADS
    assert const("kMaxQuantSegments") == plans.QUANT_MAX_SEGMENTS
    assert (const("kMaxUnitsWide"), const("kMaxUnitsScalar")) == (plans.QUANT_MAX_UNITS[8], plans.QUANT_MAX_UNITS[1])
    assert "__global__ void __launch_bounds__(kFlatMaxThreads, 1)\n    segment_absmax_kernel" in src
    assert "__global__ void __launch_bounds__(kFlatMaxThreads, 1)\n    quantize_int8_shared_kernel" in src

# the Criteo-1TB fused table: 26 stacked slots of 183,873,726 rows x 16 f32
# (2,941,979,616 elements), where the rows past 2^27 have element offsets
# past 2^31 - 1; K4's and K5's plans, argument records, routing and plain
# versions at its sizes (meta tensors stand in for the 11.8 GB table)
CRITEO_1TB_VOCABS = (
    45_833_188, 36_746, 17_245, 7_413, 20_243, 4, 7_114, 1_441, 63,
    29_275_261, 1_572_176, 345_138, 11, 2_209, 11_267, 128, 5, 975, 15,
    48_937_457, 17_246_239, 40_094_537, 452_104, 12_606, 105, 36,
)
TB_ROWS, TB_DIM, TB_BATCH = 183_873_726, 16, 4096


def _tb_group():
    from persia_tpu_torch.parallel.fused_step import FusedSlotSpec, group_stacked_specs

    specs = {f"cat_{i}": FusedSlotSpec(vocab=v, dim=TB_DIM) for i, v in enumerate(CRITEO_1TB_VOCABS)}
    (group,) = group_stacked_specs(specs, sorted(specs))
    return group


def test_1tb_stack_is_one_group_past_2_31_elements():
    g = _tb_group()
    assert g.vocab == sum(CRITEO_1TB_VOCABS) == TB_ROWS < 2 ** 31 - 1
    assert g.vocab * TB_DIM == 2_941_979_616 > 2 ** 31
    ends = [o + v for o, v in zip(g.offsets, (CRITEO_1TB_VOCABS[int(n[4:])] for n in g.slots))]
    assert ends[-1] == TB_ROWS and list(g.offsets) == [0] + ends[:-1]
    # in the stack's (sorted) slot order, the slots with rows whose element
    # offset (row * 16) leaves int32: cat_21 from its row 20,214,929 on, and
    # the 11 after it whole
    past = [n for n, e in zip(g.slots, ends) if (e - 1) * TB_DIM > 2 ** 31 - 1]
    whole = [n for n, o in zip(g.slots, g.offsets) if o * TB_DIM > 2 ** 31 - 1]
    assert past[0] == "cat_21" and past[1:] == whole and len(whole) == 11 and whole[-1] == "cat_9"


def test_sparse_update_plan_at_the_1tb_step():
    """K5's plan depends on the positions and the dim, not the table's rows."""
    n = TB_BATCH * len(CRITEO_1TB_VOCABS)
    p = plans.sparse_update_plan(n, TB_DIM)
    assert (p.vec, p.units, p.tile_rows) == (4, 4, plans.K5_TILE_ROWS_MAX)
    assert p.scratch_ints == 4 + 2 * n + 2 * (n // plans.K5_LONG_MIN) < 2 ** 31 - 1


def test_k5_segments_at_the_top_rows_of_the_1tb_table():
    import numpy as np

    top = np.array([TB_ROWS - 3] * 40 + [TB_ROWS - 2] + [TB_ROWS - 1] * 2 + [2 ** 31 - 1] * 5, np.int32)
    short, long_ = plans.k5_segments(top, TB_ROWS)
    assert long_ == [(0, 40)] and short == [(40, 1), (41, 2)]
    assert plans.k5_segments(top, TB_ROWS - 1)[0] == [(40, 1)]


def test_k4_and_k5_accept_the_1tb_table():
    """The wrappers' checks and parameter records take the whole table, its
    update keys included (every row < INT32_MAX); the routing and the plain
    gather rows at its last slots are exact in int64."""
    import importlib

    import numpy as np
    import torch

    from persia_tpu_torch.embedding.optim import Adagrad

    k4 = importlib.import_module("persia_tpu_torch.ops.fused_gather")
    k5 = importlib.import_module("persia_tpu_torch.ops.sparse_update")

    g = _tb_group()
    vocabs = [CRITEO_1TB_VOCABS[int(n[4:])] for n in g.slots]
    meta = torch.empty((TB_ROWS, TB_DIM), device="meta")
    ids = [torch.empty(TB_BATCH, dtype=torch.int32, device="meta") for _ in g.slots]
    assert k4._check(meta, ids, list(g.offsets), vocabs, keys=True) == TB_BATCH * len(g.slots)
    params = np.zeros(1, k4._PARAMS)
    params["offset"][0, :len(g.slots)] = g.offsets
    params["vocab"][0, :len(g.slots)] = vocabs
    assert (params["offset"][0, :len(g.slots)] + params["vocab"][0, :len(g.slots)]).max() == TB_ROWS
    n = TB_BATCH * len(g.slots)
    cfg = Adagrad(lr=0.05).config
    k5._check(cfg, meta, {"acc": torch.empty((TB_ROWS, TB_DIM), device="meta")},
              torch.empty(n, dtype=torch.int32, device="meta"), torch.empty(n, dtype=torch.int64, device="meta"),
              torch.empty((n, TB_DIM), device="meta"), torch.empty(2, device="meta"))
    # the last slot's top ids: keys and plain gather rows past 2^27
    last = [torch.tensor([v - 1, v - 2, 0, -1, v], dtype=torch.int32) for v in vocabs]
    keys = k4.update_keys_reference(last, list(g.offsets), vocabs)
    want = np.concatenate([[o + v - 1, o + v - 2, o, 2 ** 31 - 1, 2 ** 31 - 1] for o, v in zip(g.offsets, vocabs)])
    np.testing.assert_array_equal(keys.numpy(), want)
    rows = torch.cat([k4.gather_rows(i, o, v, True) for i, o, v in zip(last, g.offsets, vocabs)])
    assert rows.dtype == torch.int64 and int(rows.max()) == TB_ROWS - 1
    assert int(rows.max()) * TB_DIM > 2 ** 31


# the dense ring's block int8 wire (csrc/block_int8.cu)
@pytest.mark.parametrize("bs,vec,threads", [(1, 0, 32), (16, 0, 32), (100, 0, 128), (128, 1, None), (256, 2, None),
                                            (384, 3, None), (512, 4, None), (640, 0, 256), (2048, 0, 256)])
def test_block_int8_plan_chooses_by_block_size(bs, vec, threads):
    """K16 and the fused hop: the warp plan where the block size is 128 V
    (V up to 4), the block plan (a thread block a quantization block, up to
    8 elements a thread) otherwise."""
    p = plans.block_int8_plan(bs, 334)
    assert p.vec == vec
    if vec == 0:
        assert (p.grid, p.threads) == (334, threads) and bs <= p.threads * plans.BLOCK_INT8_MAX_PER
    else:
        assert p.grid * p.threads // 32 >= 334 and p.threads % 32 == 0


@pytest.mark.parametrize("blocks,warps,grid", [(1333, 11, 122), (334, 3, 112), (132, 1, 132), (1, 1, 1), (0, 1, 0),
                                               (100_000, 16, 6250)])
def test_block_int8_warp_plan_fills_the_sms_in_one_wave(blocks, warps, grid):
    """A warp a block, the fewest warps a CTA that keep the grid within one
    CTA an SM: the bench tower's vector (1,333 blocks of 256) and a hop's
    chunk at n = 4 (334) each in one wave over the 132 SMs."""
    p = plans.block_int8_plan(256, blocks)
    assert (p.threads, p.grid) == (32 * warps, grid)
    assert p.grid * warps >= blocks and (p.grid - 1) * warps < max(blocks, 1)
    assert p.grid <= plans.H100_SMS or warps == plans.BLOCK_INT8_WARP_MAX_WARPS


@pytest.mark.parametrize("bs,elements,vec,threads,grid", [
    (256, 85_504, 1, 64, 84), (256, 4 * 85_312, 1, 192, 112), (16, 4096, 1, 32, 8), (48, 96, 1, 32, 1),
    (100, 1000, 0, 256, 4), (8, 1 << 30, 0, 256, plans.BLOCK_DEQUANT_MAX_GRID),
    (256, (1 << 31) - 256, 1, 256, plans.BLOCK_DEQUANT_VEC_MAX_GRID)])
def test_block_dequant_plan_vector_or_scalar(bs, elements, vec, threads, grid):
    """K17: a thread 16 codes where the block size is a multiple of 16 (the
    grid one CTA an SM up to 8 warps a CTA, then at most 4 CTAs an SM and
    the grid-stride loop), a thread an element otherwise."""
    p = plans.block_dequant_plan(bs, elements)
    assert (p.vec, p.threads, p.grid) == (vec, threads, grid)


def test_block_dequant_vector_plan_refuses_2_31_elements():
    """The vector plan indexes in 32 bits: n * chunk must stay below 2^31."""
    with pytest.raises(ValueError, match="2\\^31"):
        plans.block_dequant_plan(256, 1 << 31)
    assert plans.block_dequant_plan(100, 3 << 30).vec == 0  # the scalar plan indexes in 64 bits
    with pytest.raises(ValueError, match="block_size"):
        plans.block_int8_plan(4096, 1)


def test_block_int8_plan_constants_match_the_kernel():
    import re
    from pathlib import Path

    src = (Path(plans.__file__).resolve().parent.parent / "csrc" / "block_int8.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kMaxBlockThreads") == plans.BLOCK_INT8_MAX_THREADS
    assert const("kMaxPer") == plans.BLOCK_INT8_MAX_PER
    assert const("kWarpMaxVec") == plans.BLOCK_INT8_WARP_MAX_VEC
    assert const("kWarpMaxThreads") == 32 * plans.BLOCK_INT8_WARP_MAX_WARPS
    assert const("kDequantVec") == plans.BLOCK_DEQUANT_VEC
    assert const("kDequantVecMaxThreads") == 32 * plans.BLOCK_DEQUANT_VEC_MAX_WARPS


# ------------------------------------------------------------------- K18


def lp_mix_cover(offsets, plan):
    """Which K18 thread handles each element, by the kernel's own index
    arithmetic (csrc/lp_ring.cu: a unit of ``vec`` elements a thread,
    grid-stride; a unit a segment boundary crosses element by element; the
    last n % vec elements to block 0's first threads): how many times each
    element is written, and the elements a unit takes one at a time."""
    n, vec = plan.n, plan.vec
    hits = np.zeros(n, np.int32)
    scalar = []
    off = np.asarray(offsets)
    for u in range(plan.units):  # every unit is some thread's: u < units, stride grid * threads
        e = u * vec
        k = np.searchsorted(off, e, side="right") - 1
        hits[e:e + vec] += 1
        if vec > 1 and off[k + 1] < e + vec:
            scalar.extend(range(e, e + vec))
    tail = n - plan.units * vec
    assert tail < plans.LP_MIX_THREADS
    hits[n - tail:] += 1
    return hits, scalar


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("lengths", [[3328, 256, 16384, 64, 1024, 16, 187904, 512, 131072, 256, 256, 1],
                                     [0, 1, 0, 1, 1, 5000, 0, 1, 3], [3] + [0] * 10 + [1] * 3 + [5000],
                                     [(i * 37) % 251 for i in range(512)], [7]])
def test_lp_ring_mix_plan_covers_every_element_once(lengths, aligned):
    """K18's plan: every element written by exactly one thread; a unit
    that a segment boundary crosses (and only such a unit) goes element by
    element; the grid one wave at most, units past it by the grid-stride
    loop."""
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(int)
    n = int(offsets[-1])
    plan = plans.lp_ring_mix_plan(n, aligned)
    assert plan.vec == (4 if aligned else 1)
    assert 1 <= plan.grid <= plans.LP_MIX_MAX_GRID
    assert plan.grid * plans.LP_MIX_THREADS >= plan.units or plan.grid == plans.LP_MIX_MAX_GRID
    hits, scalar = lp_mix_cover(offsets, plan)
    assert (hits == 1).all()
    inner = set(offsets[1:-1].tolist())
    crossing = {e for e in range(0, plan.units * plan.vec, plan.vec)
                if any(e < b < e + plan.vec for b in inner)} if plan.vec > 1 else set()
    assert set(scalar) == {e + j for e in crossing for j in range(plan.vec)}


def test_lp_ring_mix_plan_constants_match_the_kernel():
    import re
    from pathlib import Path

    src = (Path(plans.__file__).resolve().parent.parent / "csrc" / "lp_ring.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kMaxMixSegments") == plans.LP_MIX_MAX_SEGMENTS == plans.QUANT_MAX_SEGMENTS
    assert const("kMixThreads") == plans.LP_MIX_THREADS
    assert plans.lp_ring_mix_plan(341_073).grid == min(plans.LP_MIX_MAX_GRID, -(-(341_073 // 4) // 256))
    with pytest.raises(ValueError, match="32 bits"):
        plans.lp_ring_mix_plan(1 << 31)
