"""The port's native worker core (``persia_tpu_torch/native/worker.cpp``)
against the reference's (``native/worker.cpp``) and against the port's
numpy routines: every entry point bit for bit, dedup's first-seen order
included; and the port's worker end to end with its core on and off."""

import numpy as np
import pytest

from persia_tpu.embedding import native_worker as jnw
from persia_tpu_torch.config import EmbeddingConfig, SlotConfig
from persia_tpu_torch.data import IDTypeFeature
from persia_tpu_torch.embedding import native_worker as nw
from persia_tpu_torch.embedding import worker as wk
from persia_tpu_torch.embedding.hashing import sign_to_shard
from persia_tpu_torch.embedding.optim import Adagrad
from persia_tpu_torch.embedding.store import EmbeddingStore


@pytest.fixture(autouse=True)
def both_cores():
    assert nw.available() and jnw.available()


@pytest.mark.parametrize("n", [1, 7, 1000, 65536])
def test_dedup_matches_reference_core_and_np_unique(n):
    """First-seen order, bit for bit the reference core's; the same set as
    ``np.unique``, and (distinct, inverse) rebuilds the input."""
    ids = np.random.default_rng(n).integers(0, max(n // 3, 2), n).astype(np.uint64)
    got_d, got_i = nw.dedup(ids)
    ref_d, ref_i = jnw.dedup(ids)
    np.testing.assert_array_equal(got_d, ref_d)
    np.testing.assert_array_equal(got_i, ref_i)
    assert got_d.dtype == np.uint64 and got_i.dtype == np.int64
    np.testing.assert_array_equal(np.sort(got_d), np.unique(ids))
    np.testing.assert_array_equal(got_d[got_i], ids)


def test_dedup_first_seen_order_and_extremes():
    ids = np.array([7, 2**64 - 1, 7, 2**63, 0, 2**64 - 1], dtype=np.uint64)
    got_d, got_i = nw.dedup(ids)
    np.testing.assert_array_equal(got_d, np.array([7, 2**64 - 1, 2**63, 0], dtype=np.uint64))
    np.testing.assert_array_equal(got_i, [0, 1, 0, 2, 3, 1])
    empty_d, empty_i = nw.dedup(np.zeros(0, np.uint64))
    assert len(empty_d) == len(empty_i) == 0


def _gather_case(seed, B=16, D=9, dim=8, n=100):
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(max(B, D), dim)).astype(np.float32)
    inverse = rng.integers(0, D, n).astype(np.int64)
    sample_of_id = np.sort(rng.integers(0, B, n)).astype(np.int64)
    return rows, inverse, sample_of_id


@pytest.mark.parametrize("seed", [0, 1])
def test_sum_pool_and_grad_accum_match_reference_and_np_add_at(seed):
    rows, inverse, sample_of_id = _gather_case(seed)
    got = nw.sum_pool(rows[:9], inverse, sample_of_id, 16)
    np.testing.assert_array_equal(got, jnw.sum_pool(rows[:9], inverse, sample_of_id, 16))
    ref = np.zeros((16, 8), np.float32)
    np.add.at(ref, sample_of_id, rows[:9][inverse])
    np.testing.assert_array_equal(got, ref)

    got = nw.grad_accum(rows[:16], inverse, sample_of_id, 9)
    np.testing.assert_array_equal(got, jnw.grad_accum(rows[:16], inverse, sample_of_id, 9))
    ref = np.zeros((9, 8), np.float32)
    np.add.at(ref, inverse, rows[:16][sample_of_id])
    np.testing.assert_array_equal(got, ref)


def test_gather_loops_reject_mismatched_ids():
    rows, inverse, sample_of_id = _gather_case(0)
    with pytest.raises(ValueError):
        nw.sum_pool(rows, inverse, sample_of_id[:-1], 16)
    with pytest.raises(ValueError):
        nw.raw_index(np.array([2, 2]), np.arange(3), 4, 9)


@pytest.mark.parametrize("L", [1, 3, 8])
def test_raw_index_matches_reference_and_loop(L):
    rng = np.random.default_rng(L)
    counts = rng.integers(0, 6, 20).astype(np.int64)
    inverse = rng.integers(0, 30, int(counts.sum())).astype(np.int64)
    got = nw.raw_index(counts, inverse, L, 30)
    np.testing.assert_array_equal(got, jnw.raw_index(counts, inverse, L, 30))
    ref = np.full((20, L), 30, np.int32)
    pos = 0
    for b, c in enumerate(counts.tolist()):
        take = min(c, L)
        ref[b, :take] = inverse[pos:pos + take]
        pos += c
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.int32


@pytest.mark.parametrize("shards", [1, 3, 8])
def test_shard_partition_matches_reference_and_sign_to_shard(shards):
    signs = np.random.default_rng(shards).integers(0, 2**63, 500, dtype=np.uint64)
    pos, counts = nw.shard_partition(signs, shards)
    jpos, jcounts = jnw.shard_partition(signs, shards)
    np.testing.assert_array_equal(pos, jpos)
    np.testing.assert_array_equal(counts, jcounts)
    shard = sign_to_shard(signs, shards)
    start = 0
    for r in range(shards):
        np.testing.assert_array_equal(pos[start:start + counts[r]], np.flatnonzero(shard == r))
        start += counts[r]


def test_load_lib_falls_back_when_the_build_fails(monkeypatch):
    """A core that does not build: no library, every call returns None (the
    worker then runs its numpy routines)."""

    def broken():
        raise RuntimeError("g++ failed")

    monkeypatch.setattr(nw, "_LIB", None)
    monkeypatch.setattr(nw, "_LOAD_FAILED", False)
    monkeypatch.setattr(nw, "build_native", broken)
    assert not nw.available()
    assert nw.dedup(np.arange(3, dtype=np.uint64)) is None
    assert nw.shard_partition(np.arange(3, dtype=np.uint64), 2) is None


def test_worker_end_to_end_native_vs_numpy(monkeypatch):
    """preprocess → lookup → gradient return → lookup, core on and off: the
    pooled rows and the gathered per-sample rows bit for bit (the distinct
    rows' order differs: first-seen vs sorted), the stores alike."""
    cfg = EmbeddingConfig(
        slots_config={
            "a": SlotConfig(dim=8),
            "dev": SlotConfig(dim=8, sqrt_scaling=True),
            "seq": SlotConfig(dim=8, embedding_summation=False, sample_fixed_size=4),
        },
        feature_index_prefix_bit=8,
    )
    rng = np.random.default_rng(5)
    feats = [
        IDTypeFeature(name, [rng.integers(0, 50, rng.integers(lo, 7), dtype=np.uint64) for _ in range(8)])
        for name, lo in (("a", 1), ("dev", 1), ("seq", 0))
    ]

    def run(native: bool, device_pooling: bool):
        if not native:
            monkeypatch.setattr(nw, "_load_lib", lambda: None)
        stores = [EmbeddingStore(capacity=1 << 12, num_internal_shards=2,
                                 optimizer=Adagrad(lr=0.1).config, seed=7) for _ in range(3)]
        w = wk.EmbeddingWorker(cfg, stores, device_pooling=device_pooling)
        slots = wk.preprocess_batch(feats, cfg)
        out = w._lookup_slots(slots, train=True)
        trip = []
        for s, o in zip(slots, out):
            g = np.ones_like(o.pooled if isinstance(o, wk.SumEmbeddingBatch) else o.distinct)
            trip.append((s.keys, wk.slot_gradient_to_keys(s, g, device_pooled=device_pooling), 0))
        w.lookup_router.advance_batch_state(0)
        w.lookup_router.update_groups(trip)
        monkeypatch.undo()
        return out + w._lookup_slots(slots, train=False), stores

    def gathered(o):
        rows = np.concatenate([o.distinct, np.zeros((1, o.distinct.shape[1]), np.float32)])
        return rows[o.index]

    for device_pooling in (False, True):
        native, nstores = run(True, device_pooling)
        numpy_, fstores = run(False, device_pooling)
        for a, b in zip(native, numpy_):
            assert type(a) is type(b)
            if isinstance(a, wk.SumEmbeddingBatch):
                np.testing.assert_array_equal(a.pooled, b.pooled)
            else:
                np.testing.assert_array_equal(gathered(a), gathered(b))
        for x, y in zip(nstores, fstores):
            assert x.size() == y.size() > 0
            for sh in x._shards:
                for sign, (_, vec) in sh.entries.items():
                    np.testing.assert_array_equal(y.get_embedding_entry(sign), vec)
