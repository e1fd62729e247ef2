"""K5's schedule (``persia_tpu_torch/ops/plans.py``: ``sparse_update_plan``,
``k5_segments``) and the routing of the update ids (``ops/sparse_update.py``:
``update_keys``' plain version), on the CPU.

- The segment lists: every sorted position lies in exactly one segment,
  each segment in exactly one list, ids outside [0, V) (the padding
  sentinel among them) are never scheduled, and every touched row is
  written once.
- The update made segment by segment in the kernel's schedule (each of
  ``k5_segments``' segments summed from 0 in sorted order, then the plain
  version's optimizer on its row), bit for bit against the plain version
  ``sparse_update_reference`` for all four optimizers with weight decay,
  on uniform and zipf(1.2) streams, one row taking every position,
  segments at the long threshold - 1, at it and + 1, segments ending on a
  staged tile's edge, an empty and an all-padding stream. The card tests
  hold the kernel itself to the plain version on the same streams.
- The routing's plain version, bit for bit against the reference's
  routing (``persia_tpu/parallel/fused_step.py:389-399`` and the mask to
  the sentinel of ``persia_tpu/ops/sparse_update.py:69-71``), JAX on the
  CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import persia_tpu.embedding  # noqa: F401  (imports persia_tpu.ops in the order it needs)
from persia_tpu.ops.sparse_update import _PAD_SENTINEL
from persia_tpu_torch.embedding.optim import SGD, Adagrad, Adam
from persia_tpu_torch.ops import plans
from persia_tpu_torch.ops.sparse_update import (
    PAD_SENTINEL,
    _apply_rows,
    init_sparse_state,
    sparse_update_reference,
    update_keys,
    update_keys_reference,
)

OPTIMIZERS = {
    "sgd_wd": lambda: SGD(lr=0.1, weight_decay=0.01),
    "adagrad_wd": lambda: Adagrad(lr=0.05, g_square_momentum=0.95, weight_decay=0.01),
    "adagrad_vw_wd": lambda: Adagrad(lr=0.05, vectorwise_shared=True, weight_decay=0.02),
    "adam_wd": lambda: Adam(lr=0.01, weight_decay=0.1),  # Adam rows take no decay
}
T = plans.K5_LONG_MIN
VOCAB = 200


def _stream(kind, dim, seed):
    """(ids, mask, grads) of one stream: padding (mask False), a live id
    past the table and a live id < 0 where the stream has room for them."""
    rng = np.random.default_rng(seed)
    rows = plans.sparse_update_plan(1, dim).tile_rows
    n = 600
    if kind == "uniform":
        ids = rng.integers(0, VOCAB, n)
    elif kind == "zipf":
        ids = (rng.zipf(1.2, n) - 1) % VOCAB
    elif kind == "one_row":
        ids = np.full(n, 7)
    elif kind.startswith("length_"):  # one row with exactly that many positions, the rest at most 4
        k = {"length_t_minus_1": T - 1, "length_t": T, "length_t_plus_1": T + 1}[kind]
        ids = np.r_[np.full(k, 11), 12 + np.arange(n - k) % (VOCAB - 12)]
        ids = ids[rng.permutation(n)]
    elif kind == "tile_edge":  # long segments ending on a tile's edge, and one past it
        ids = np.r_[np.full(2 * rows, 3), np.full(rows, 150), np.full(rows + 1, 60), rng.integers(0, VOCAB, 50)]
        n = ids.size
        ids = ids[rng.permutation(n)]
    elif kind == "empty":
        n = 0
        ids = np.zeros(0)
    else:  # all padding
        ids = rng.integers(0, VOCAB, n)
    ids = ids.astype(np.int32)
    mask = rng.random(n) >= 0.1 if kind not in ("all_padding", "one_row", "tile_edge") else np.ones(n, bool)
    if kind == "all_padding":
        mask[:] = False
    if kind.startswith("length_"):
        mask[ids == 11] = True  # the row of the chosen length keeps every position
    if kind in ("uniform", "zipf"):
        ids[:2] = [VOCAB + 4, -3]  # live outside the table: dropped
        mask[:2] = True
    grads = rng.standard_normal((n, dim)).astype(np.float32)
    return torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(grads)


STREAMS = ["uniform", "zipf", "one_row", "length_t_minus_1", "length_t", "length_t_plus_1", "tile_edge",
           "empty", "all_padding"]


def _sorted(ids, mask):
    masked = torch.where(mask, ids, torch.full_like(ids, PAD_SENTINEL))
    sids, perm = torch.sort(masked, stable=True)
    return sids.numpy(), perm.numpy()


@pytest.mark.parametrize("kind", STREAMS)
def test_segments_cover_each_position_once(kind):
    ids, mask, _ = _stream(kind, 16, seed=len(kind))
    sids, _ = _sorted(ids, mask)
    short, long_ = plans.k5_segments(sids, VOCAB)
    covered = np.zeros(sids.size, np.int64)
    for (start, length), is_long in [(s, False) for s in short] + [(s, True) for s in long_]:
        assert length >= 1 and (length >= T) == is_long  # each segment in exactly one list
        covered[start:start + length] += 1
        assert (sids[start:start + length] == sids[start]).all()
        assert start == 0 or sids[start - 1] != sids[start]
        assert start + length == sids.size or sids[start + length] != sids[start]
    in_range = (sids >= 0) & (sids < VOCAB)
    np.testing.assert_array_equal(covered, in_range.astype(np.int64))  # never the sentinel or outside [0, V)
    rows = [int(sids[s]) for s, _ in short + long_]
    assert len(rows) == len(set(rows)) == np.unique(sids[in_range]).size  # every touched row once
    assert [s for s, _ in short] == sorted(s for s, _ in short)
    assert [s for s, _ in long_] == sorted(s for s, _ in long_)
    lengths = {"length_t_minus_1": (T - 1, 0), "length_t": (T, 1), "length_t_plus_1": (T + 1, 1)}
    if kind in lengths:
        k, n_long = lengths[kind]
        assert len(long_) == n_long and k in [ln for _, ln in short + long_]
    if kind in ("empty", "all_padding"):
        assert short == [] and long_ == []


def _by_segments(cfg, table, state, sids, perm, grads, batch_state):
    """The update in K5's schedule, on copies: each segment of
    ``k5_segments`` (long ones first, as the kernel launches them) summed
    from 0 in sorted order, the plain version's optimizer applied to its
    row and the deltas added to the row and its state."""
    table, state = table.clone(), {k: v.clone() for k, v in state.items()}
    short, long_ = plans.k5_segments(sids, table.shape[0])
    for start, length in long_ + short:
        row = torch.tensor([int(sids[start])])
        g = torch.zeros(1, grads.shape[1])
        for q in perm[start:start + length]:
            g = g + grads[int(q)]
        w, st = table[row], {k: v[row] for k, v in state.items()}
        new_w, new_st = _apply_rows(cfg, w, st, g, batch_state)
        table.index_add_(0, row, (new_w - w.float()).to(table.dtype))
        for k, v in state.items():
            v.index_add_(0, row, new_st[k] - st[k])
    return table, state


@pytest.mark.parametrize("dim", [16, 10])
@pytest.mark.parametrize("kind", STREAMS)
@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_schedule_model_equals_plain_version_bitwise(opt, kind, dim):
    """The update made segment by segment in the kernel's schedule lands
    on the plain version's bits: tables and optimizer state."""
    cfg = OPTIMIZERS[opt]().config
    ids, mask, grads = _stream(kind, dim, seed=len(opt + kind) + dim)
    rng = np.random.default_rng(dim)
    table = torch.from_numpy((rng.standard_normal((VOCAB, dim)) * 0.05).astype(np.float32))
    state = init_sparse_state(cfg, VOCAB, dim)
    for v in state.values():
        v.copy_(torch.from_numpy(rng.uniform(0.01, 1.0, v.shape).astype(np.float32)))
    bs = torch.tensor([cfg.beta1 ** 3, cfg.beta2 ** 3], dtype=torch.float32)
    sids, perm = _sorted(ids, mask)
    model_t, model_s = _by_segments(cfg, table, state, sids, perm, grads, bs)
    ref_t, ref_s = sparse_update_reference(cfg, table.clone(), {k: v.clone() for k, v in state.items()},
                                           ids, grads, bs, mask)
    assert torch.equal(model_t.view(torch.int32), ref_t.view(torch.int32))
    for k in state:
        assert torch.equal(model_s[k].view(torch.int32), ref_s[k].view(torch.int32)), k
    if kind in ("empty", "all_padding"):
        assert torch.equal(model_t, table)


@pytest.mark.parametrize("kind", ["zipf", "tile_edge"])
def test_schedule_model_bf16_table_equals_plain_version_bitwise(kind):
    """A bf16 table: the delta rounded to bf16, then added and rounded."""
    cfg = Adagrad(lr=0.05, weight_decay=0.01).config
    ids, mask, grads = _stream(kind, 16, seed=3)
    rng = np.random.default_rng(4)
    table = torch.from_numpy((rng.standard_normal((VOCAB, 16)) * 0.05).astype(np.float32)).to(torch.bfloat16)
    state = init_sparse_state(cfg, VOCAB, 16)
    sids, perm = _sorted(ids, mask)
    model_t, model_s = _by_segments(cfg, table, state, sids, perm, grads, torch.ones(2))
    ref_t, ref_s = sparse_update_reference(cfg, table.clone(), {k: v.clone() for k, v in state.items()},
                                           ids, grads, torch.ones(2), mask)
    assert torch.equal(model_t.view(torch.int16), ref_t.view(torch.int16))
    assert torch.equal(model_s["acc"].view(torch.int32), ref_s["acc"].view(torch.int32))
    assert not torch.equal(model_t, table)


@pytest.mark.parametrize("dim,aligned,vec,rows", [
    (16, True, 4, 128), (8, True, 4, 128), (24, True, 4, 128), (64, True, 4, 64), (128, True, 4, 32),
    (1024, True, 4, 4), (10, True, 1, 64), (16, False, 1, 64), (3, True, 1, 128), (256, False, 1, 4),
])
def test_sparse_update_plan_geometry(dim, aligned, vec, rows):
    p = plans.sparse_update_plan(106_496, dim, aligned)
    assert (p.vec, p.tile_rows, p.units) == (vec, rows, dim // vec)
    # a staged tile: at most a chunk a thread's share, so 3 stages fit 48 KB
    assert p.tile_rows * p.units <= plans.K5_TILE_CHUNKS and p.units <= plans.K5_MAX_UNITS
    assert 3 * p.tile_rows * dim * 4 <= plans.SMEM_STATIC
    assert p.scratch_ints == 4 + 2 * 106_496 + 2 * (106_496 // plans.K5_LONG_MIN)


@pytest.mark.parametrize("dim,aligned", [(1028, True), (257, False), (0, True)])
def test_sparse_update_plan_refuses_rows_without_a_kernel(dim, aligned):
    with pytest.raises(ValueError):
        plans.sparse_update_plan(10, dim, aligned)


def _reference_routing(ids, offset, vocab):
    """The reference's stacked step: ids outside the slot's [0, vocab) to
    -1, the rest + offset; its sparse_update then routes the mask (>= 0)
    to the sentinel."""
    j = jnp.asarray(ids)
    routed = jnp.where((j >= 0) & (j < vocab), j + offset, -1).reshape(-1)
    return np.asarray(jnp.where(routed >= 0, routed, _PAD_SENTINEL))


@pytest.mark.parametrize("slots", [1, 3, 26, 130])
def test_update_keys_plain_version_matches_reference_routing(slots):
    """Pads, ids >= vocab and ids < -1, (B,) and (B, L) slots, slot after
    slot, offsets up to 2**31 - 101 (their last row below the sentinel)."""
    rng = np.random.default_rng(slots)
    ids, offsets, vocabs, want = [], [], [], []
    for s in range(slots):
        vocab = int(rng.integers(1, 300))
        offset = 2 ** 31 - 101 if s == slots - 1 else int(rng.integers(0, 10_000))
        vocab = min(vocab, 100) if s == slots - 1 else vocab
        shape = (64,) if s % 2 == 0 else (16, 3)
        a = rng.integers(-5, vocab + 5, shape).astype(np.int32)
        a.reshape(-1)[:3] = [-1, vocab, vocab - 1]
        ids.append(torch.from_numpy(a))
        offsets.append(offset)
        vocabs.append(vocab)
        want.append(_reference_routing(a, offset, vocab))
    got = update_keys(ids, offsets, vocabs)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.concatenate(want))
    np.testing.assert_array_equal(update_keys_reference(ids, offsets, vocabs).numpy(), got.numpy())


def test_update_keys_refuses_mismatched_slots():
    with pytest.raises(ValueError):
        update_keys([torch.zeros(3, dtype=torch.int32)], [0, 1], [5])
    with pytest.raises(ValueError):
        update_keys([], [], [])
