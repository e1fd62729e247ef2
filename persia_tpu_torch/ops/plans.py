"""Launch geometry of the port's CUDA kernels, in plain Python.

The wrappers compute a plan here and pass its numbers to the C entry
points, which check them against what the kernel was compiled for and
launch. Keeping the geometry here keeps it testable on a machine without a
card (``tests/test_torch_kernel_plans.py``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

SMEM_MAX = 232_448  # bytes of shared memory one H100 block can use (227 KB)
SMEM_STATIC = 48 * 1024  # usable without cudaFuncSetAttribute
SMEM_ALIGN = 1024  # a 128-byte swizzle repeats every 1024 bytes

# flash attention, bf16 (csrc/flash_attention_hopper.cu): one consumer
# warpgroup owns 64 query rows; keys arrive in tiles of 64 through a TMA ring
FA_BLOCK_Q = 64
FA_BLOCK_K = 64
FA_STAGES = 2
FA_SWIZZLE_MAX = 128  # bytes: the widest TMA/wgmma swizzle


class _QTileOrder:
    """How a flash-attention kernel maps blocks to (b, h, q tile) and how
    many key tiles each visits (both kernels alike)."""

    def block_tile(self, block: int):
        """(b, h, q tile) of a block, as the kernel maps it: q tiles
        longest-first (the last tile has the most keys under ``causal``),
        every (b, h) of one q tile before the next."""
        bh_count = self.batch * self.heads
        q_tile = self.q_tiles - 1 - block // bh_count
        bh = block % bh_count
        return bh // self.heads, bh % self.heads, q_tile

    def key_tiles(self, q_tile: int) -> int:
        """Key tiles a q tile visits: all of them, or under ``causal`` those
        not wholly above its last query (the TPU kernel's ``block_live``)."""
        keys = self.seq_len
        if self.causal:
            keys = min(keys, (q_tile + 1) * self.block_q)
        return -(-keys // self.block_k)


@dataclass(frozen=True)
class FlashPlan(_QTileOrder):
    batch: int
    seq_len: int
    heads: int
    dim: int
    causal: bool
    block_q: int
    block_k: int
    stages: int
    q_tiles: int
    grid: int  # one block per (q tile, b, h)
    box_cols: int  # inner extent of one TMA box, elements
    boxes: int  # boxes per tile row: D / box_cols
    swizzle_bytes: int  # TMA swizzle == wgmma layout type
    tile_bytes_q: int
    tile_bytes_kv: int
    smem_bytes: int  # dynamic shared memory, alignment slack included


def flash_plan(batch: int, seq_len: int, heads: int, dim: int, causal: bool) -> FlashPlan:
    if dim not in (16, 32, 64, 128):
        raise ValueError(f"no wgmma plan for head dim {dim}")
    box_cols = min(dim, FA_SWIZZLE_MAX // 2)  # a box row is at most 128 bytes
    tile_q = FA_BLOCK_Q * dim * 2
    tile_kv = FA_BLOCK_K * dim * 2
    barriers = 8 * (1 + 2 * FA_STAGES)
    smem = SMEM_ALIGN + tile_q + 2 * FA_STAGES * tile_kv + barriers
    q_tiles = -(-seq_len // FA_BLOCK_Q)
    return FlashPlan(
        batch=batch, seq_len=seq_len, heads=heads, dim=dim, causal=bool(causal),
        block_q=FA_BLOCK_Q, block_k=FA_BLOCK_K, stages=FA_STAGES,
        q_tiles=q_tiles, grid=q_tiles * batch * heads,
        box_cols=box_cols, boxes=dim // box_cols, swizzle_bytes=box_cols * 2,
        tile_bytes_q=tile_q, tile_bytes_kv=tile_kv, smem_bytes=smem,
    )


# flash attention, f32 (csrc/flash_attention_tf32.cu): split TF32 planes
# written by a pre-pass, one warpgroup per 64 query rows, keys in tiles of 32
TF32_BLOCK_Q = 64
TF32_BLOCK_K = 32
TF32_STAGES = 2
TF32_SEQ_ALIGN = 64  # the planes hold whole q tiles
TF32_BOX_COLS_MAX = 32  # f32 columns in a 128-byte swizzle row
# position p of each group of 8 in a V^T row holds key TF32_KEY_ORDER[p]:
# the S accumulator gives a thread keys 2t, 2t+1 of a group and the TF32 A
# fragment wants columns t, t+4, so P enters P.V without a shuffle
TF32_KEY_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


@dataclass(frozen=True)
class Tf32Plan(_QTileOrder):
    batch: int
    seq_len: int
    heads: int
    dim: int
    causal: bool
    block_q: int
    block_k: int
    stages: int
    seq_pad: int  # rows of every plane: L rounded up to whole q tiles
    q_tiles: int
    grid: int  # main kernel: one block per (q tile, b, h)
    box_cols: int  # inner extent of one Q/K plane TMA box, f32 elements
    boxes: int  # boxes per plane row: D / box_cols
    swizzle_bytes: int  # Q/K planes and the output (the V^T planes: 128)
    tile_bytes_q: int  # one Q plane tile (hi or lo): 64 x D
    tile_bytes_k: int  # one K plane tile: 32 x D
    tile_bytes_vt: int  # one V^T plane tile: D x 32
    stage_bytes: int  # k_hi, k_lo, v_hi, v_lo
    smem_bytes: int  # dynamic shared memory, alignment slack included

    @property
    def plane_shapes(self):
        """Shapes of the pre-pass outputs: qk [4, B*H, L_pad, D] (q_hi,
        q_lo, k_hi, k_lo) and vt [2, B*H, D, L_pad] (v_hi, v_lo)."""
        bh = self.batch * self.heads
        return (4, bh, self.seq_pad, self.dim), (2, bh, self.dim, self.seq_pad)


def tf32_plan(batch: int, seq_len: int, heads: int, dim: int, causal: bool) -> Tf32Plan:
    if dim not in (16, 32, 64, 128):
        raise ValueError(f"no split-TF32 plan for head dim {dim}")
    box_cols = min(dim, TF32_BOX_COLS_MAX)
    tile_q = TF32_BLOCK_Q * dim * 4
    tile_k = TF32_BLOCK_K * dim * 4
    tile_vt = dim * TF32_BLOCK_K * 4
    stage = 2 * tile_k + 2 * tile_vt
    barriers = 8 * (1 + 2 * TF32_STAGES)
    smem = SMEM_ALIGN + 2 * tile_q + TF32_STAGES * stage + barriers
    seq_pad = -(-seq_len // TF32_SEQ_ALIGN) * TF32_SEQ_ALIGN
    q_tiles = -(-seq_len // TF32_BLOCK_Q)
    return Tf32Plan(
        batch=batch, seq_len=seq_len, heads=heads, dim=dim, causal=bool(causal),
        block_q=TF32_BLOCK_Q, block_k=TF32_BLOCK_K, stages=TF32_STAGES, seq_pad=seq_pad,
        q_tiles=q_tiles, grid=q_tiles * batch * heads,
        box_cols=box_cols, boxes=dim // box_cols, swizzle_bytes=box_cols * 4,
        tile_bytes_q=tile_q, tile_bytes_k=tile_k, tile_bytes_vt=tile_vt, stage_bytes=stage,
        smem_bytes=smem,
    )


# dot interaction (csrc/dot_interaction.cu): one warp per batch row
DOT_MAX_ROWS = 8
DOT_SPECIALISED_DIMS = (8, 16, 32, 48, 64)
DOT_MMA_DIMS = (16, 32, 48, 64)
DOT_MMA_MAX_N = 32


@dataclass(frozen=True)
class DotPlan:
    batch: int
    n: int
    d: int
    elem_bytes: int
    mma: bool  # bf16 on the tensor cores; else the f32 FMA walk
    rows_per_block: int  # 0: one row does not fit
    threads: int
    grid: int
    feat_stride: int  # elements between feature rows in shared memory
    smem_bytes: int


def dot_uses_mma(n: int, d: int, elem_bytes: int) -> bool:
    """bf16 with d a multiple of 16 up to 64 and n <= 32 (one 32 x 32 Gram
    tile per warp) takes the tensor-core kernel."""
    return elem_bytes == 2 and d in DOT_MMA_DIMS and n <= DOT_MMA_MAX_N


def dot_feat_stride(d: int, mma: bool = False) -> int:
    """Row stride of the feature copy in shared memory, chosen so that reads
    of one row per lane (or per ldmatrix row) do not conflict:
    - tensor-core path, bf16 rows: d + 8 elements. Eight rows of 16 bytes
      (one ldmatrix phase) then start on 8 distinct 16-byte bank groups;
    - served widths on the FMA walk, f32 rows: d + 4 floats. Eight lanes
      reading 16 bytes each hit 32 distinct banks;
    - other widths: an odd stride, so 32 lanes reading one float each
      conflict nowhere."""
    if mma:
        return d + 8
    if d in DOT_SPECIALISED_DIMS:
        return d + 4
    return d + 1 - d % 2


def dot_smem_bytes(rows: int, n: int, d: int, elem_bytes: int, mma: bool = False) -> int:
    stride = dot_feat_stride(d, mma)
    if mma:  # bf16 rows, plus slack so the last row's 32-row Gram tile stays inside
        feats = -(-(rows * n + 32 - n) * stride * 2 // 16) * 16
    else:
        feats = -(-rows * n * stride * 4 // 16) * 16
    staging = rows * (n * (n - 1) // 2) * elem_bytes
    return feats + staging + 16  # + the shift that aligns staging with the output


def dot_plan(batch: int, n: int, d: int, elem_bytes: int) -> DotPlan:
    mma = dot_uses_mma(n, d, elem_bytes)
    rows = 0
    for r in range(DOT_MAX_ROWS, 0, -1):
        if dot_smem_bytes(r, n, d, elem_bytes, mma) <= SMEM_STATIC:
            rows = r
            break
    grid = -(-batch // rows) if rows else 0
    return DotPlan(
        batch=batch, n=n, d=d, elem_bytes=elem_bytes, mma=mma, rows_per_block=rows,
        threads=32 * rows, grid=grid, feat_stride=dot_feat_stride(d, mma),
        smem_bytes=dot_smem_bytes(rows, n, d, elem_bytes, mma) if rows else 0,
    )


@dataclass(frozen=True)
class DotBwdPlan:
    batch: int
    n: int
    d: int
    elem_bytes: int
    mma: bool  # bf16 on the tensor cores; else the f32 FMA walk
    rows_per_block: int  # 0: one row does not fit
    threads: int
    grid: int
    smem_bytes: int


DOT_BWD_THREADS = 256  # the FMA walk's block; the tensor-core path runs a warp per row
DOT_BWD_GSYM_STRIDE = 40  # bf16 elements between rows of the 32 x 32 symmetric tile


def dot_bwd_smem_bytes(rows: int, n: int, d: int, mma: bool) -> int:
    """Tensor-core path: per row a zero-padded symmetric 32 x 32 bf16 tile
    of the pair gradients (stride 40) and 32 bf16 feature rows (stride
    d + 8), plus the block's (i, j) table of the pairs (2 bytes each). FMA
    walk: per row its features and pair gradients widened to f32."""
    pairs = n * (n - 1) // 2
    if mma:
        per_row = 32 * DOT_BWD_GSYM_STRIDE * 2 + 32 * (d + 8) * 2
        return rows * per_row + -(-pairs * 2 // 16) * 16
    return rows * 4 * (n * d + pairs)


def dot_bwd_plan(batch: int, n: int, d: int, elem_bytes: int) -> DotBwdPlan:
    """Geometry of ``dot_interaction_bwd`` (csrc/dot_interaction.cu): the
    tensor-core path takes the shapes the forward's does."""
    mma = dot_uses_mma(n, d, elem_bytes)
    rows = 0
    for r in range(DOT_MAX_ROWS, 0, -1):
        if dot_bwd_smem_bytes(r, n, d, mma) <= SMEM_STATIC:
            rows = r
            break
    return DotBwdPlan(
        batch=batch, n=n, d=d, elem_bytes=elem_bytes, mma=mma, rows_per_block=rows,
        threads=32 * rows if mma else DOT_BWD_THREADS,
        grid=-(-batch // rows) if rows else 0,
        smem_bytes=dot_bwd_smem_bytes(rows, n, d, mma) if rows else 0,
    )


# grouped gather-pool (csrc/embedding_pool.cu): one launch each way for up
# to POOL_MAX_SLOTS slots, the slot on grid y. The backward is two passes:
# chunks of the sorted positions (one warp each), then one thread group per
# row that combines the chunks' partial sums
POOL_MAX_SLOTS = 64
POOL_THREADS = 256  # forward and pass-2 blocks
POOL_CHUNK_WARPS = 4  # pass-1 warps a block, one chunk each
POOL_GROUP_POSITIONS = 8  # consecutive sorted positions one lane group walks
POOL_SCALAR_LANES = 8  # most lanes a position takes on the scalar path


def _pow2_ceil(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length()


@dataclass(frozen=True)
class PoolPlan:
    batch: int
    slots: int
    dim: int
    # forward: one thread per (sample, slot, fwd_vec columns), in that order
    fwd_vec: int  # 16-byte loads: 8 bf16 or 4 f32 columns; 1 on the general path
    fwd_threads: int
    fwd_grid: int
    # backward pass 1: a warp takes a chunk of a slot's sorted positions; a
    # lane group of lanes_per_pos lanes holds one position's columns
    # (bwd_vec each, col_tiles times), walking POOL_GROUP_POSITIONS positions
    bwd_vec: int  # 4: float4 columns; 1: scalar columns, the last tile ragged
    lanes_per_pos: int
    col_tiles: int
    chunk: int  # positions a warp takes
    max_chunks: int  # chunks of the slot with the most positions
    chunk_grid: tuple  # (chunk blocks of POOL_CHUNK_WARPS warps, slots)
    # backward pass 2: thread (x, y) of block (bx, slot) takes row
    # bx * row_block[1] + y and bwd_vec columns from x * bwd_vec
    row_block: tuple
    row_grid: tuple  # (row blocks, slots)

    @property
    def groups(self) -> int:
        """Lane groups of a warp in pass 1."""
        return 32 // self.lanes_per_pos

    @property
    def scratch_shape(self) -> tuple:
        """Pass 1's f32 partial sums: per slot and chunk, the sum of its
        first segment where that began in the chunk before ([..., 0, :]) and
        of its last where that goes on into the next ([..., 1, :])."""
        return (self.slots, self.max_chunks, 2, self.dim)

    def chunks(self, positions: int) -> int:
        """Chunks of a slot with ``positions`` sorted positions (B * L)."""
        return -(-positions // self.chunk)

    def group_positions(self, chunk: int, group: int) -> range:
        """The sorted positions lane group ``group`` of chunk ``chunk`` walks
        (some may lie past the slot's end)."""
        k = chunk * self.chunk + group * POOL_GROUP_POSITIONS
        return range(k, k + POOL_GROUP_POSITIONS)

    def row_partials(self, start: int, end: int):
        """How pass 2 writes the row whose sorted positions are
        [start, end): None, zeros (an empty row); [], pass 1 wrote it (one
        chunk); else the (chunk, half) partials it sums, in this order."""
        if end <= start:
            return None
        first, last = start // self.chunk, (end - 1) // self.chunk
        if first == last:
            return []
        return [(first, 1)] + [(c, 0) for c in range(first + 1, last + 1)]


@functools.lru_cache(maxsize=256)
def pool_plan(batch: int, slots: int, dim: int, elem_bytes: int, max_rows: int, max_ids: int = 1,
              aligned: bool = True) -> PoolPlan:
    """Geometry of ``gather_pool_fwd`` and ``gather_pool_bwd`` for a group
    of ``slots`` slots of rows of ``dim`` elements of ``elem_bytes`` bytes,
    ``max_rows`` rows and ``max_ids`` ids per sample at most. ``aligned``:
    the pointers the 16-byte paths read (the forward's rows, the backward's
    gradient) are 16-byte aligned."""
    if not 1 <= slots <= POOL_MAX_SLOTS:
        raise ValueError(f"one launch pools 1..{POOL_MAX_SLOTS} slots, got {slots}")
    if elem_bytes not in (2, 4) or min(batch, dim, max_rows, max_ids) < 1:
        raise ValueError("a pooled group needs bf16 or f32 rows and positive sizes")
    wide = 16 // elem_bytes
    fwd_vec = wide if aligned and dim % wide == 0 else 1
    fwd_items = batch * slots * (dim // fwd_vec)
    if aligned and dim % 4 == 0:
        quads = dim // 4
        bwd_vec, lanes = 4, min(quads & -quads, 32)  # the largest power of 2 dividing it
    else:
        bwd_vec, lanes = 1, min(_pow2_ceil(dim), POOL_SCALAR_LANES)
    col_tiles = -(-dim // (lanes * bwd_vec))
    chunk = 32 // lanes * POOL_GROUP_POSITIONS
    max_chunks = -(-batch * max_ids // chunk)
    rx = min(dim // bwd_vec, POOL_THREADS)
    ry = POOL_THREADS // rx
    return PoolPlan(
        batch=batch, slots=slots, dim=dim,
        fwd_vec=fwd_vec, fwd_threads=POOL_THREADS, fwd_grid=-(-fwd_items // POOL_THREADS),
        bwd_vec=bwd_vec, lanes_per_pos=lanes, col_tiles=col_tiles, chunk=chunk, max_chunks=max_chunks,
        chunk_grid=(-(-max_chunks // POOL_CHUNK_WARPS), slots),
        row_block=(rx, ry), row_grid=(-(-max_rows // ry), slots),
    )


def pool_bwd_model(values: np.ndarray, rows: np.ndarray, num_rows: int, plan: PoolPlan) -> np.ndarray:
    """The backward kernel's f32 sums for one slot, in numpy, in the
    kernel's order: ``values`` (n, dim) f32 are the scaled gradient rows of
    the slot's sorted positions, ``rows`` (n,) their rows (ascending).
    Returns (num_rows, dim) f32; raises if a row would be written other than
    once. Pass 1 per chunk: each lane group sums its segments in position
    order; a segmented inclusive scan (Hillis-Steele) carries the groups'
    last segments forward; segments that begin and end in the chunk are
    stored, the chunk's first and last otherwise go to the partials. Pass 2
    sums a multi-chunk row's partials in chunk order."""
    values = np.asarray(values, dtype=np.float32)
    rows = np.asarray(rows, dtype=np.int64)
    n, dim = values.shape
    C, G, K = plan.chunk, plan.groups, POOL_GROUP_POSITIONS
    chunks = plan.chunks(n)
    no_row = np.iinfo(np.int64).max
    r_all = np.full(chunks * C, no_row, np.int64)
    r_all[:n] = rows
    x_all = np.zeros((chunks * C, dim), np.float32)
    x_all[:n] = values
    out = np.zeros((num_rows, dim), np.float32)
    writes = np.zeros(num_rows, np.int64)
    partials = np.zeros((chunks, 2, dim), np.float32)
    for c in range(chunks):
        k0 = c * C
        r = r_all[k0:k0 + C].reshape(G, K)
        x = x_all[k0:k0 + C].reshape(G, K, dim)
        before = r_all[k0 - 1] if k0 > 0 else -1
        after = r_all[k0 + C] if k0 + C < n else -1
        continues = [g > 0 and r[g - 1, -1] == r[g, 0] for g in range(G)]
        tails = []
        for g in range(G):
            acc = x[g, 0]
            for i in range(1, K):
                acc = acc + x[g, i] if r[g, i] == r[g, i - 1] else x[g, i]
            tails.append(acc)
        scan = list(tails)
        flag = [not continues[g] or r[g, 0] != r[g, -1] for g in range(G)]
        d = 1
        while d < G:
            old, old_flag = list(scan), list(flag)
            for g in range(d, G):
                if not old_flag[g]:
                    scan[g] = old[g - d] + old[g]
                flag[g] = old_flag[g] or old_flag[g - d]
            d *= 2
        for g in range(G):
            acc = scan[g - 1] + x[g, 0] if continues[g] else x[g, 0]
            for i in range(K):
                if i > 0:
                    acc = acc + x[g, i] if r[g, i] == r[g, i - 1] else x[g, i]
                row = r[g, i]
                chunk_end = i == K - 1 and g == G - 1
                nxt = r[g, i + 1] if i < K - 1 else (r[g + 1, 0] if g < G - 1 else None)
                if row == no_row or (not chunk_end and nxt == row):
                    continue
                if row == r[0, 0] and before == row:
                    partials[c, 0] = acc
                elif chunk_end and after == row:
                    partials[c, 1] = acc
                else:
                    out[row] = acc
                    writes[row] += 1
    starts = np.searchsorted(rows, np.arange(num_rows + 1))
    for row in range(num_rows):
        parts = plan.row_partials(int(starts[row]), int(starts[row + 1]))
        if parts == []:
            continue
        acc = np.zeros(dim, np.float32)
        if parts:
            acc = partials[parts[0]].copy()
            for part in parts[1:]:
                acc = acc + partials[part]
        out[row] = acc
        writes[row] += 1
    if not (writes == 1).all():
        raise AssertionError(f"rows written other than once: {np.flatnonzero(writes != 1)[:10]}")
    return out


# raw-slot gather, K6 (csrc/raw_gather.cu): one thread per (slot on grid
# y, position, unit of the row), the units fastest
RAW_THREADS = 256


@dataclass(frozen=True)
class RawGatherPlan:
    positions: int  # B * L
    unit_bytes: int  # 16, or the element's bytes
    row_units: int
    threads: int
    grid: tuple  # (position blocks, slots)


@functools.lru_cache(maxsize=256)
def raw_gather_plan(positions: int, slots: int, dim: int, elem_bytes: int, aligned: bool = True) -> RawGatherPlan:
    """Geometry of ``raw_gather_fwd`` for a group of ``slots`` slots of
    ``positions`` positions each and rows of ``dim`` elements of
    ``elem_bytes`` bytes. ``aligned``: the rows and the output start on 16
    bytes. A row whose bytes are a multiple of 16 moves in 16-byte units,
    else element by element."""
    if not 1 <= slots <= POOL_MAX_SLOTS:
        raise ValueError(f"one launch gathers 1..{POOL_MAX_SLOTS} slots, got {slots}")
    if elem_bytes not in (2, 4) or positions < 1 or dim < 1:
        raise ValueError("a raw group needs bf16 or f32 rows and positive sizes")
    row_bytes = dim * elem_bytes
    unit = 16 if aligned and row_bytes % 16 == 0 else elem_bytes
    row_units = row_bytes // unit
    return RawGatherPlan(positions=positions, unit_bytes=unit, row_units=row_units, threads=RAW_THREADS,
                         grid=(-(-positions * row_units // RAW_THREADS), slots))


# its scatter-add, K7 (csrc/raw_gather.cu): one launch, the slot on grid y.
# A lane group takes one row and sums its positions in stream order. A row
# of K7_LONG_MIN positions or more is long: ``raw_csr`` lists its chunks of
# K7_CHUNK positions, each summed by a block of the same launch, and the
# last of the row's blocks to finish sums the chunk sums in chunk order.
K7_LONG_MIN = 32  # positions from which a row is long (kLongMin)
K7_CHUNK = 256  # positions of one chunk of a long row (kChunk)
K7_THREADS = 256
K7_STAGE_FLOATS = 4096  # f32 a long block stages at a time (kStageFloats)


@dataclass(frozen=True)
class RawBwdPlan:
    slots: int
    dim: int
    vec: int  # 16-byte access: 8 bf16 or 4 f32 columns a lane; 1 on the general path
    lanes: int  # lanes of a row's group: the largest power of 2 dividing dim / vec, at most 32
    threads: int
    short_blocks: int  # grid x from 0: threads / lanes rows a block, over the most rows a slot has
    long_blocks: int  # grid x after them: a listed long-row chunk a block, the most a slot lists
    tile_rows: int  # gradient rows (or chunk sums) a long block stages at a time
    smem_bytes: int  # dynamic shared memory: none without long rows

    @property
    def scratch_ints(self) -> int:
        """int32 scratch, zeroed: a ticket counter per listed chunk (padded
        to 16 bytes), then each chunk's f32 sum; none without long rows."""
        if not self.long_blocks:
            return 0
        n = self.slots * self.long_blocks
        return -(-n // 4) * 4 + n * self.dim


@functools.lru_cache(maxsize=256)
def raw_gather_bwd_plan(slots: int, dim: int, elem_bytes: int, max_rows: int, long_blocks: int,
                        aligned: bool = True) -> RawBwdPlan:
    """Geometry of ``raw_gather_bwd`` for a group of ``slots`` slots of
    rows of ``dim`` elements of ``elem_bytes`` bytes, at most ``max_rows``
    rows and ``long_blocks`` listed long-row chunks a slot. ``aligned``: the
    gradient and the rows start on 16 bytes."""
    if not 1 <= slots <= POOL_MAX_SLOTS:
        raise ValueError(f"one launch scatters 1..{POOL_MAX_SLOTS} slots, got {slots}")
    if elem_bytes not in (2, 4) or min(dim, max_rows) < 1 or long_blocks < 0:
        raise ValueError("a raw group needs bf16 or f32 rows and positive sizes")
    wide = 16 // elem_bytes
    vec = wide if aligned and dim % wide == 0 else 1
    units = dim // vec
    if units > K7_THREADS:
        raise ValueError(f"raw_gather_bwd takes rows of at most {K7_THREADS} column units "
                         f"({K7_THREADS * wide} columns, aligned), got {dim} columns")
    lanes = min(units & -units, 32)
    tile_rows = min(K7_CHUNK, K7_STAGE_FLOATS // dim)
    smem = 4 * (tile_rows * dim + K7_CHUNK) + 16 if long_blocks else 0
    return RawBwdPlan(slots=slots, dim=dim, vec=vec, lanes=lanes, threads=K7_THREADS,
                      short_blocks=-(-max_rows * lanes // K7_THREADS), long_blocks=long_blocks,
                      tile_rows=tile_rows, smem_bytes=smem)


def raw_bwd_model(values: np.ndarray, order: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """K7's f32 sums for one slot, in numpy, in the kernel's order:
    ``values`` (B * L, dim) f32 are the positions' gradients, ``order`` and
    ``offsets`` the slot's CSR. Returns (P, dim) f32, the pad row P - 1
    zero. A short row (fewer than K7_LONG_MIN positions) sums its positions
    in stream order from 0, as a sequential ``index_add_`` does; a long row
    sums each chunk of K7_CHUNK of its positions so, then the chunk sums in
    chunk order from 0. The order does not depend on the launch geometry."""
    values = np.asarray(values, dtype=np.float32)
    offsets = np.asarray(offsets, dtype=np.int64)
    rows, dim = offsets.shape[0] - 1, values.shape[1]
    lens = np.diff(offsets)[:-1]
    row = np.repeat(np.arange(rows - 1), lens)  # of each listed position but the pad row's
    k = np.arange(row.shape[0]) + offsets[0]
    x = values[np.asarray(order, dtype=np.int64)[k]]
    out = np.zeros((rows, dim), np.float32)
    long_ = lens[row] >= K7_LONG_MIN
    np.add.at(out, row[~long_], x[~long_])  # in order, one f32 rounding an add
    r, c = row[long_], (k[long_] - offsets[row[long_]]) // K7_CHUNK
    new = np.r_[True, (r[1:] != r[:-1]) | (c[1:] != c[:-1])] if r.size else np.zeros(0, bool)
    chunk = np.cumsum(new) - 1
    sums = np.zeros((int(new.sum()), dim), np.float32)
    np.add.at(sums, chunk, x[long_])
    np.add.at(out, r[new], sums)
    return out


# DIN's masked attention pool, K8 and K9 (csrc/attention_pool.cu): one warp
# per sample row, ATT_POOL_WARPS a block; a lane group of lanes lanes takes
# one position's row, vec columns a lane (16-byte loads). A lane holds the
# weights of positions lane + 32 i in registers, at most
# ATT_POOL_MAX_PER_LANE of them (kMaxPerLane), which bounds a row; past
# ATT_POOL_MID_PER_LANE a lane (kMidPerLane) the backward keeps g in shared
# memory, L floats a warp, and needs none below
ATT_POOL_WARPS = 4
ATT_POOL_MID_PER_LANE = 8
ATT_POOL_MAX_PER_LANE = 48


@dataclass(frozen=True)
class AttentionPoolPlan:
    batch: int
    seq_len: int
    dim: int
    vec: int  # 8 bf16 or 4 f32 columns a load; 1 on the general path
    lanes: int  # lanes of a position's group: a power of 2 dividing dim / vec
    warps: int
    grid: int
    bwd_smem: int  # bytes: g of each warp's row, on rows past 32 * ATT_POOL_MID_PER_LANE positions


@functools.lru_cache(maxsize=256)
def attention_pool_plan(batch: int, seq_len: int, dim: int, elem_bytes: int, aligned: bool = True
                        ) -> AttentionPoolPlan:
    """Geometry of ``attention_pool_fwd`` and ``attention_pool_bwd`` for
    (B, L) logits over (B, L, dim) history rows of ``elem_bytes`` bytes.
    ``aligned``: the history, its gradient and the pooled rows start on 16
    bytes."""
    if elem_bytes not in (2, 4) or min(batch, seq_len, dim) < 1:
        raise ValueError("the attention pool needs bf16 or f32 rows and positive sizes")
    wide = 16 // elem_bytes
    vec = wide if aligned and dim % wide == 0 else 1
    units = dim // vec
    lanes = min(units & -units, 32)  # the largest power of 2 dividing it
    if seq_len > 32 * ATT_POOL_MAX_PER_LANE:
        raise ValueError(f"the attention pool takes at most {32 * ATT_POOL_MAX_PER_LANE} positions a row, "
                         f"got {seq_len}")
    bwd_smem = ATT_POOL_WARPS * seq_len * 4 if seq_len > 32 * ATT_POOL_MID_PER_LANE else 0
    return AttentionPoolPlan(batch=batch, seq_len=seq_len, dim=dim, vec=vec, lanes=lanes, warps=ATT_POOL_WARPS,
                             grid=-(-batch // ATT_POOL_WARPS), bwd_smem=bwd_smem)


# fused sparse optimizer update, K5 (csrc/sparse_update.cu): a first pass
# lists the segments (runs of one row among the sorted ids), split at
# K5_LONG_MIN positions; a short segment goes to a group of lanes, a long
# one to a block that stages its rows into shared memory, tile_rows rows a
# tile. The kernel derives its lane groups and grids from N, dim and vec.
K5_LONG_MIN = 32  # positions from which a segment is long (kLongMin)
K5_TILE_ROWS_MAX = 128
K5_TILE_CHUNKS = 1024  # 16-byte (or 4-byte, scalar) pieces of one staged tile
K5_MAX_UNITS = 256  # column units (4 columns, or 1 on the scalar path) a row may have


def _pow2_floor(x: int) -> int:
    return 1 << (max(x, 1).bit_length() - 1)


@dataclass(frozen=True)
class SparseUpdatePlan:
    n: int  # sorted positions
    dim: int
    vec: int  # 4: 16-byte rows (8 for a bf16 table); 1: scalar columns
    tile_rows: int  # rows of one staged tile of a long segment

    @property
    def units(self) -> int:
        """Column units of a row: dim / vec."""
        return self.dim // self.vec

    @property
    def scratch_ints(self) -> int:
        """int32 scratch: 2 counters (padded to 16 bytes), the short list
        (start, length) x n, the long list x the most long segments n
        positions can hold."""
        return 4 + 2 * self.n + 2 * (self.n // K5_LONG_MIN)


@functools.lru_cache(maxsize=256)
def sparse_update_plan(n: int, dim: int, aligned: bool = True) -> SparseUpdatePlan:
    """Geometry of K5 for ``n`` sorted positions of rows of ``dim``
    columns. ``aligned``: the table, the gradients and the per-column state
    start on 16 bytes (8 for a bf16 table). A row takes 16-byte access where
    dim % 4 == 0 and it is aligned, else scalar columns."""
    if n < 0 or dim < 1:
        raise ValueError("K5 needs n >= 0 and dim >= 1")
    vec = 4 if aligned and dim % 4 == 0 else 1
    units = dim // vec
    if units > K5_MAX_UNITS:
        raise ValueError(f"K5 takes rows of at most {K5_MAX_UNITS * 4} columns (a multiple of 4, aligned) "
                         f"or {K5_MAX_UNITS} otherwise, got {dim}")
    return SparseUpdatePlan(n=n, dim=dim, vec=vec,
                            tile_rows=min(K5_TILE_ROWS_MAX, _pow2_floor(K5_TILE_CHUNKS // units)))


def k5_segments(sorted_ids: np.ndarray, num_rows: int):
    """K5's first pass, in numpy: the segments of ``sorted_ids`` (ascending
    int32) whose id lies in [0, num_rows), as (start, length) lists, short
    ones (length < K5_LONG_MIN) and long ones, each in position order (the
    kernel's lists are in position order within each block of positions;
    the blocks append in any order, which changes no bit)."""
    ids = np.asarray(sorted_ids, dtype=np.int64)
    n = ids.shape[0]
    heads = np.flatnonzero(np.r_[True, ids[1:] != ids[:-1]]) if n else np.zeros(0, np.int64)
    ends = np.r_[heads[1:], n] if n else heads
    short, long_ = [], []
    for s, e in zip(heads.tolist(), ends.tolist()):
        if 0 <= ids[s] < num_rows:
            (long_ if e - s >= K5_LONG_MIN else short).append((s, e - s))
    return short, long_


# flax's BatchNorm, K10 and K11 (csrc/batch_norm.cu): a cluster of slices
# blocks owns 16 bytes of a row's columns, each block one of slices equal
# spans of the rows, row_lanes lanes a block, each lane every
# row_lanes-th row of its span
BN_THREADS = 256
BN_MAX_SLICES = 8  # blocks a cluster: the portable cluster size
BN_TARGET_BLOCKS = 128  # about one block an SM of the H100's 132
BN_SLICE_ROWS = 256  # the fewest rows worth a block of their own
BN_ROWS_A_LANE = 4  # rows a lane keeps in flight (kRowsAhead)


@dataclass(frozen=True)
class BatchNormPlan:
    rows: int
    cols: int
    vec: int  # 8 bf16 or 4 f32 columns a load; 1 on the scalar path
    groups: int  # column vectors a block: groups * vec * elem_bytes == 16
    row_lanes: int  # lanes a column vector: a power of 2, threads / groups
    grid: int  # one cluster a group of groups * vec columns
    slices: int  # blocks a cluster, each a span of the rows

    @property
    def span(self) -> int:
        """Rows a block: the last block's span may be shorter."""
        return -(-self.rows // self.slices)

    @property
    def threads(self) -> int:
        return self.groups * self.row_lanes

    @property
    def cols_per_block(self) -> int:
        return self.groups * self.vec


@functools.lru_cache(maxsize=256)
def batch_norm_plan(rows: int, cols: int, elem_bytes: int, aligned: bool = True) -> BatchNormPlan:
    """Geometry of ``batch_norm_fwd`` and ``batch_norm_bwd`` over (rows,
    cols) activations of ``elem_bytes`` bytes. ``aligned``: every (B, C)
    tensor the kernel reads or writes starts on 16 bytes. A row takes
    16-byte loads where cols is a multiple of 8 (bf16) or 4 (f32) and it is
    aligned, else scalar columns; either way a block's columns span 16
    bytes of a row. The rows split into ``slices`` spans, one block each
    (a cluster), so that the grid comes near ``BN_TARGET_BLOCKS``, with no
    span under ``BN_SLICE_ROWS`` rows. The row lanes are the fewest powers
    of 2 that give each lane at most ``BN_ROWS_A_LANE`` rows of a span
    (one row where a column group's block walks every row: at the small
    batches more lanes a block hide more of a load's latency), from a
    warp's worth up to ``BN_THREADS`` threads."""
    if elem_bytes not in (2, 4) or rows < 1 or cols < 1:
        raise ValueError("batch norm needs bf16 or f32 activations and positive sizes")
    wide = 16 // elem_bytes
    vec = wide if aligned and cols % wide == 0 else 1
    groups = wide // vec
    grid = -(-cols // (groups * vec))
    slices = max(1, min(BN_MAX_SLICES, BN_TARGET_BLOCKS // grid, rows // BN_SLICE_ROWS))
    span = -(-rows // slices)
    rows_a_lane = BN_ROWS_A_LANE if slices > 1 else 1
    row_lanes = max(32 // groups, min(BN_THREADS // groups, _pow2_ceil(-(-span // rows_a_lane))))
    return BatchNormPlan(rows=rows, cols=cols, vec=vec, groups=groups, row_lanes=row_lanes, grid=grid,
                         slices=slices)


def batch_norm_sum_model(values: np.ndarray, plan: BatchNormPlan) -> np.ndarray:
    """The column sums of (rows, cols) f32 ``values`` in the order K10 and
    K11 take them, in numpy f32: in each span of ``plan.span`` rows, each
    row lane sums its rows (lane, lane + R, ...) in order, a warp's lanes
    meet in a shuffle tree (xor offsets 16 down to the column groups), and
    the warps' sums add in warp order; then the spans' sums add in order."""
    v = np.asarray(values, dtype=np.float32)
    out = None
    for s in range(plan.slices):
        part = _bn_block_sums(v[s * plan.span:(s + 1) * plan.span], plan)
        out = part if out is None else out + part
    return out


def _bn_block_sums(v: np.ndarray, plan: BatchNormPlan) -> np.ndarray:
    lanes = plan.row_lanes
    acc = np.zeros((lanes, v.shape[1]), dtype=np.float32)
    for r in range(v.shape[0]):
        acc[r % lanes] = acc[r % lanes] + v[r]
    lanes_a_warp = 32 // plan.groups  # row lanes of one warp: a warp's threads / groups
    warps = []
    for w in range(0, lanes, lanes_a_warp):
        part = acc[w:w + lanes_a_warp].copy()
        off = lanes_a_warp // 2
        while off >= 1:  # xor offset off * groups over threads is off over row lanes
            part = part + part[np.arange(lanes_a_warp) ^ off]
            off //= 2
        warps.append(part[0])
    out = np.zeros(v.shape[1], dtype=np.float32)
    for s in warps:
        out = out + s
    return out
