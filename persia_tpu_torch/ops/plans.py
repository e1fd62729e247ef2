"""Launch geometry of the port's CUDA kernels, in plain Python.

The wrappers compute a plan here and pass its numbers to the C entry
points, which check them against what the kernel was compiled for and
launch. Keeping the geometry here keeps it testable on a machine without a
card (``tests/test_torch_kernel_plans.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

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


# grouped gather-pool (csrc/embedding_pool.cu): one launch for up to
# POOL_MAX_SLOTS slots, one thread per output element
POOL_MAX_SLOTS = 64
POOL_THREADS = 256


@dataclass(frozen=True)
class PoolPlan:
    fwd_grid: int  # over batch x slots x dim
    bwd_grid: tuple  # (blocks over max rows x dim, slots)
    threads: int


def pool_plan(batch: int, slots: int, dim: int, max_rows: int) -> PoolPlan:
    if not 1 <= slots <= POOL_MAX_SLOTS:
        raise ValueError(f"one launch pools 1..{POOL_MAX_SLOTS} slots, got {slots}")
    return PoolPlan(
        fwd_grid=-(-batch * slots * dim // POOL_THREADS),
        bwd_grid=(-(-max_rows * dim // POOL_THREADS), slots),
        threads=POOL_THREADS,
    )
