"""The cache tier's sharded feeder in the port
(``persia_tpu_torch/native/cache.cpp``'s ``ShardedCache`` and
``cache_feed_batch_sharded``, ``CacheDirectory(shards=, feed_threads=)``,
``CachedTrainCtx(feed_threads=, feed_shards=)``) against the reference's
(``persia_tpu/embedding/hbm_cache``, ``native/cache.cpp``) on the CPU:

- ``shard_route`` bit for bit the reference's partition, and the native
  directory's rows lying in each sign's shard's range;
- the sharded directory at S in {1, 8} shards and T in {1, 4} threads,
  with and without the touch gate: the row LUT, the misses, the
  evictions, the pending map's restores, probes, snapshots, distinct-sign
  admits and drains bit for bit the reference's ``CacheDirectory(shards=S,
  feed_threads=T)``; at S = 8 the same bits at any thread count (the pool
  resized between feeds too); at S = 1 the unsharded walk's bits; the
  touch gate's counters round trip;
- ``CachedTrainCtx(feed_threads=4, feed_shards=8)`` beside the
  reference's with the same knobs: the synchronous steps' and the
  stream's decisions bit for bit, the losses within
  ``test_cached_ctx_matches_reference``'s tolerance; the defaults of
  ``feed_threads`` / ``feed_shards`` and their environment variables;
- a fenced stream at ``feed_shards=8`` dropped and resumed from its
  manifest lands bit for bit on the uninterrupted run; a resume with
  another shard count raises.

Every stream runs under ``run_with_watchdog`` (60 s).
"""

import numpy as np
import optax
import pytest
import torch

import persia_tpu.config as jcfg
import persia_tpu.data as jdata
from persia_tpu.embedding import hbm_cache as jhbm
from persia_tpu.embedding import optim as joptim
from persia_tpu.embedding.hbm_cache.directory import CacheDirectory as JaxDirectory
from persia_tpu.embedding.hbm_cache.directory import PendingSignMap as JaxPendingSignMap
from persia_tpu.embedding.tiering.native import shard_route as jax_shard_route
import persia_tpu_torch.config as tcfg
import persia_tpu_torch.data as tdata
from persia_tpu_torch.embedding import hbm_cache as thbm
from persia_tpu_torch.embedding import optim as toptim
from persia_tpu_torch.embedding.hbm_cache.tier import CachedEmbeddingTier
from persia_tpu_torch.embedding.worker import EmbeddingWorker
from persia_tpu_torch.models import DNN
from persia_tpu_torch.embedding.hbm_cache.directory import (
    CacheDirectory,
    PendingSignMap,
    group_salt,
    shard_route,
)
from persia_tpu_torch.weights import cached_state_to_flax_bytes
from test_torch_hbm_fence import _assert_entries_equal, _batches as _fence_batches, _ctx as _fence_ctx
from test_torch_hbm_fence import _dnn, _entries, _stores, _watch
from test_torch_hbm_stream import TIGHT, _batches, _cfg, _decisions, _pair, _record

SALT = group_salt("cache_d8")


def _zipf_batches(n, b=256, mod=2000, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.zipf(1.2, b) % mod).astype(np.uint64) for _ in range(n)]


def _run_directory(d, pmap, batches):
    """Feed ``batches`` with the map fed each step's evictions (and the
    step before last's removed): each feed's 8 outputs, then the
    snapshot."""
    outs = []
    for step, signs in enumerate(batches):
        out = d.feed_batch(signs, pmap, salt=SALT)
        outs.append((out[0].copy(),) + tuple(out[1:]))
        pmap.insert_range(out[3], 31 * step, step, salt=SALT)
        if step > 1:
            pmap.remove(outs[step - 2][3], step - 2, salt=SALT)
    return outs, d.snapshot()


def _assert_runs_equal(a, b):
    (outs_a, snap_a), (outs_b, snap_b) = a, b
    assert len(outs_a) == len(outs_b)
    for i, (x, y) in enumerate(zip(outs_a, outs_b)):
        for k, (u, v) in enumerate(zip(x, y)):
            np.testing.assert_array_equal(np.asarray(u), np.asarray(v), err_msg=f"feed {i} output {k}")
    for u, v in zip(snap_a, snap_b):
        np.testing.assert_array_equal(u, v)


# ------------------------------------------------------------ the partition


@pytest.mark.parametrize("shards", [1, 3, 8, 64])
def test_shard_route_matches_reference(shards):
    """``shard_route`` (numpy, vectorised) bit for bit the reference's
    Python mirror of the native partition, and every row the native
    sharded directory hands a sign lies in its shard's range."""
    rng = np.random.default_rng(shards)
    signs = np.unique(rng.integers(0, 1 << 64, 700, dtype=np.uint64))
    got = shard_route(signs, SALT, shards)
    want = [jax_shard_route(int(s), SALT, shards) for s in signs]
    np.testing.assert_array_equal(got, want)
    d = CacheDirectory(len(signs) * 2, shards=shards, part_salt=SALT)
    rows = d.admit(signs)[0]
    per = len(signs) * 2 // d.shards
    base = np.minimum(got, d.shards) * per + np.minimum(got, (len(signs) * 2) % d.shards)
    assert ((rows >= base) & (rows < base + per + 1)).all()


# --------------------------------------------------- the sharded directory


@pytest.mark.parametrize("touches", [1, 2])
@pytest.mark.parametrize("shards,threads", [(1, 1), (1, 4), (8, 1), (8, 4)])
def test_sharded_directory_matches_reference(shards, threads, touches):
    """A 300-row directory over zipf batches that evict and re-miss:
    every feed's row LUT, misses, evictions and restores and the final
    snapshot bit for bit the reference's; then probes, a distinct-sign
    admit, the shard sizes and the drain."""
    batches = _zipf_batches(20, seed=shards * 10 + threads + touches)
    kw = dict(admit_touches=touches, shards=shards, feed_threads=threads, part_salt=SALT)
    ref, port = JaxDirectory(300, **kw), CacheDirectory(300, **kw)
    assert port.shards == ref.shards == shards and port.feed_threads == ref.feed_threads == min(threads, shards)
    want = _run_directory(ref, JaxPendingSignMap(), batches)
    got = _run_directory(port, PendingSignMap(), batches)
    _assert_runs_equal(got, want)
    assert sum(len(o[6]) for o in want[0]) > 0, "the case must restore in-flight evictions"
    probe = np.concatenate([batches[-1], np.arange(5000, 5100, dtype=np.uint64)])
    np.testing.assert_array_equal(port.probe(probe), ref.probe(probe))
    fresh = np.unique(_zipf_batches(1, b=120, seed=99)[0] + np.uint64(4000))
    for u, v in zip(port.admit(fresh), ref.admit(fresh)):
        np.testing.assert_array_equal(u, v)
    np.testing.assert_array_equal(port.shard_sizes(), ref.shard_sizes())
    assert len(port) == len(ref)
    for u, v in zip(port.drain(), ref.drain()):
        np.testing.assert_array_equal(u, v)
    assert len(port) == 0 and port.shard_sizes().sum() == 0


def test_sharded_outputs_do_not_depend_on_threads():
    """S = 8 at 1, 2, 4 and 8 threads, with the walkers pinned (compact,
    spread), with the scalar probe, and with the pool resized between
    feeds: the same bits; each shard's busy and stall ns are set."""
    batches = _zipf_batches(16, seed=3)
    runs = [_run_directory(CacheDirectory(300, shards=8, feed_threads=t, part_salt=SALT), PendingSignMap(),
                           batches) for t in (1, 2, 4, 8)]
    pinned = CacheDirectory(300, shards=8, feed_threads=4, part_salt=SALT, affinity=1, probe=0)
    assert (pinned.feed_affinity, pinned.probe_mode) == (1, 0)
    pinned.set_feed_affinity(2)
    assert pinned.feed_affinity == 2 and pinned.feed_threads == 4
    runs.append(_run_directory(pinned, PendingSignMap(), batches))
    resized = CacheDirectory(300, shards=8, feed_threads=1, part_salt=SALT)
    pmap, outs = PendingSignMap(), []
    for i, chunk in enumerate((batches[:5], batches[5:11], batches[11:])):
        resized.set_feed_threads((1, 8, 3)[i])
        assert resized.feed_threads == (1, 8, 3)[i]
        for step, signs in enumerate(chunk, start=len(outs)):
            out = resized.feed_batch(signs, pmap, salt=SALT)
            outs.append((out[0].copy(),) + tuple(out[1:]))
            pmap.insert_range(out[3], 31 * step, step, salt=SALT)
            if step > 1:
                pmap.remove(outs[step - 2][3], step - 2, salt=SALT)
    runs.append((outs, resized.snapshot()))
    for r in runs[1:]:
        _assert_runs_equal(r, runs[0])
    assert (resized.shard_busy_ns() > 0).all() and (resized.shard_stall_ns() >= 0).all()


def test_one_shard_is_the_unsharded_walk():
    """S = 1 (any thread count) bit for bit the unsharded directory, with
    the touch gate on; an unsharded directory reports one shard."""
    batches = _zipf_batches(16, seed=4)
    plain = CacheDirectory(300, admit_touches=2)
    assert plain.shards is None and plain.feed_threads == 1 and list(plain.shard_busy_ns()) == [0]
    want = _run_directory(plain, PendingSignMap(), batches)
    for threads in (1, 4):
        got = _run_directory(CacheDirectory(300, admit_touches=2, shards=1, feed_threads=threads, part_salt=SALT),
                             PendingSignMap(), batches)
        _assert_runs_equal(got, want)
    np.testing.assert_array_equal(plain.shard_sizes(), [len(plain)])


def test_sharded_touch_counts_round_trip_and_overflow():
    """The touch gate's counters of every shard round trip into a fresh
    directory, which then feeds as the first does; a wrong count raises; a
    batch past a shard's capacity raises before anything is admitted."""
    batches = _zipf_batches(12, seed=5)
    a = CacheDirectory(300, admit_touches=3, shards=8, part_salt=SALT)
    _run_directory(a, PendingSignMap(), batches[:6])
    counts = a.touch_counts()
    assert counts.size > 0 and counts.any()
    b = CacheDirectory(300, admit_touches=3, shards=8, part_salt=SALT)
    b.set_touch_counts(counts)
    a.drain()
    _assert_runs_equal(_run_directory(b, PendingSignMap(), batches[6:]),
                       _run_directory(a, PendingSignMap(), batches[6:]))
    with pytest.raises(ValueError, match="touch counters"):
        b.set_touch_counts(counts[:-1])
    small = CacheDirectory(16, shards=8, part_salt=SALT)
    with pytest.raises(RuntimeError, match="capacity"):
        small.feed_batch(np.arange(40, dtype=np.uint64), None)
    assert len(small) == 0


# ------------------------------------------------------------ the tier


def _pair_sharded(cache_rows, **feed):
    """``test_torch_hbm_stream._pair``'s reference and port ctxs (the same
    DLRM weights), both built with the feeder options ``feed``."""
    jctx, tctx, jstore, tstore = _pair(cache_rows)
    jnew = jhbm.CachedTrainCtx(jctx.model, optax.adam(1e-3), joptim.Adagrad(lr=0.1), jctx.worker,
                               _cfg(jcfg), cache_rows=cache_rows, **feed).__enter__()
    jnew.state = jctx.state
    tnew = thbm.CachedTrainCtx(tctx.model, tctx.dense_optimizer, toptim.Adagrad(lr=0.1), tctx.worker,
                               _cfg(tcfg), cache_rows=cache_rows, device="cpu", **feed).__enter__()
    tnew.state = tctx.state
    return jnew, tnew, jstore, tstore


def _assert_decisions(jrec, trec, C):
    assert len(jrec) == len(trec) > 0
    for i, (j, t) in enumerate(zip(jrec, trec)):
        jd, td = _decisions(j, C, port=False), _decisions(t, C, port=True)
        assert set(jd) == set(td), i
        for g in jd:
            if g == "rows":
                for k in jd[g]:
                    np.testing.assert_array_equal(td[g][k], jd[g][k], err_msg=f"step {i} {k}")
                continue
            for k, v in jd[g].items():
                np.testing.assert_array_equal(np.asarray(td[g][k]), np.asarray(v), err_msg=f"step {i} {g} {k}")


@pytest.mark.parametrize("path", ["sync", "stream"])
def test_sharded_ctx_matches_reference(path):
    """``feed_threads=4, feed_shards=8`` on both packages' cache tiers (a
    100-row cache, 8 shards of 12-13 rows, batches of 16): each step's decisions bit for
    bit the reference's, synchronous steps or the stream (with restores),
    and the losses within 1e-5 relative."""
    jctx, tctx, _jstore, _tstore = _pair_sharded(100, feed_threads=4, feed_shards=8)
    assert tctx.tier.feed_shards == jctx.tier.feed_shards == 8 and tctx.tier.feed_threads == 4
    jrec, trec = _record(jctx.tier), _record(tctx.tier)
    batches = _batches(jdata, 10, b=16, seed=21)  # at most 48 signs a batch: no shard of 12 rows overflows
    tb = [tdata.PersiaBatch.from_bytes(b.to_bytes()) for b in batches]
    if path == "sync":
        jl = [float(jctx.train_step(b)["loss"]) for b in batches]
        tl = [float(tctx.train_step(b)["loss"]) for b in tb]
    else:
        jl, tl = [], []
        jctx.train_stream(batches, on_metrics=lambda m: jl.append(float(m["loss"])))
        _watch(lambda: tctx.train_stream(tb, on_metrics=lambda m: tl.append(float(m["loss"]))))
        st = tctx.stream_stats()
        assert st["restore_steps"] > 0 and st["feeder"]["feed_shards"] == 8 and st["feeder"]["feed_threads"] == 4
        assert len(st["feeder"]["shards"]["cache_d8"]["busy_ns"]) == 8
    assert tctx.tier.evictions > 0
    _assert_decisions(jrec, trec, tctx.tier.groups[0].rows)
    np.testing.assert_allclose(tl, jl, **TIGHT)
    stats = tctx.tier.feeder_shard_stats()["cache_d8"]
    assert stats["sizes"] == jctx.tier.feeder_shard_stats()["cache_d8"]["sizes"] and sum(stats["sizes"]) > 0


def test_feeder_defaults_and_environment(monkeypatch):
    """Threads > 1 default the shards to 8; ``PERSIA_FEED_THREADS`` and
    ``PERSIA_FEED_SHARDS`` are read; 0 shards forces the unsharded walk;
    the shard count is clamped to the rows; ``set_feed_threads`` resizes
    every directory."""
    c = _fence_ctx(_stores(), cache_rows=40)

    def ctx(**kw):
        return CachedEmbeddingTier(c.worker, c.sparse_cfg, 40, c.embedding_config, init_seed=7, **kw)

    assert ctx().feed_shards is None and ctx().feed_threads == 1
    t = ctx(feed_threads=4)
    assert t.feed_shards == 8 and t.dirs["cache_d8"].shards == 8 and t.dirs["cache_d8"].feed_threads == 4
    assert ctx(feed_threads=4, feed_shards=0).feed_shards is None
    assert ctx(feed_shards=100).feed_shards == 40  # min(64, rows)
    monkeypatch.setenv("PERSIA_FEED_THREADS", "2")
    assert ctx().feed_shards == 8 and ctx().feed_threads == 2
    monkeypatch.setenv("PERSIA_FEED_SHARDS", "3")
    t = ctx()
    assert t.feed_shards == 3 and t.dirs["cache_d8"].feed_threads == 2
    t.set_feed_threads(3)
    assert t.dirs["cache_d8"].feed_threads == 3
    monkeypatch.setenv("PERSIA_FEED_SHARDS", "0")
    assert ctx().feed_shards is None


# ------------------------------------------------------- kill and resume


def _sharded_ctx(stores, shards=8, threads=4):
    """The fence tests' ctx (DNN, Adagrad, init seed 7) over an 80-row
    cache (10 rows a shard at S = 8: no batch puts more than 10 signs in
    one) at ``feed_shards=shards``, ``feed_threads=threads``."""
    cfg = tcfg.EmbeddingConfig(slots_config={n: tcfg.SlotConfig(dim=8) for n in ("cat_0", "cat_1")},
                               feature_index_prefix_bit=8)
    model = _dnn()
    return thbm.CachedTrainCtx(model, torch.optim.Adam(model.parameters(), lr=3e-3), toptim.Adagrad(lr=0.1),
                               EmbeddingWorker(cfg, stores), cfg, cache_rows=80, init_seed=7, device="cpu",
                               feed_threads=threads, feed_shards=shards).__enter__()


def test_sharded_fenced_kill_and_resume_keeps_shards(tmp_path):
    """Fences every 4 steps at ``feed_shards=8``: a run dropped after step
    10 and resumed (at another thread count) from its fence at 8 ends bit
    for bit the uninterrupted run (the state's bytes and every server
    entry); the manifests record the shard count and the shards' stats; a
    ctx with another shard count refuses the manifest."""
    batches = _fence_batches()
    base_stores = _stores()
    base = _sharded_ctx(base_stores)
    _watch(lambda: base.train_stream(batches, snapshot_every=4, job_state=str(tmp_path / "base")))
    assert base.stream_stats()["fences"] == 2 and base.tier.evictions > 0
    base.flush()
    stores = _stores()
    ctx1 = _sharded_ctx(stores, threads=2)
    _watch(lambda: ctx1.train_stream(batches[:10], snapshot_every=4, job_state=str(tmp_path / "js")))
    del ctx1
    with pytest.raises(ValueError, match="feed_shards"):
        _sharded_ctx(_stores(), shards=4).resume(str(tmp_path / "js"))
    ctx2 = _sharded_ctx(stores, threads=8)
    m = ctx2.resume(str(tmp_path / "js"))
    occ = m.read_json("cache.json")
    assert m.step == 8 and occ["feed_shards"] == 8 and len(occ["feeder_shards"]["cache_d8"]["sizes"]) == 8
    _watch(lambda: ctx2.train_stream(batches[8:], snapshot_every=4, job_state=str(tmp_path / "js"), start_step=8))
    ctx2.flush()
    assert cached_state_to_flax_bytes(ctx2.state) == cached_state_to_flax_bytes(base.state)
    _assert_entries_equal(_entries(base_stores), _entries(stores))


def test_ctx_takes_the_feeder_options():
    """``CachedTrainCtx(feed_threads=, feed_shards=)`` builds a sharded
    tier (the refusal keeps only the mesh and the health options) and
    ``set_feed_threads`` reaches its directories."""
    cfg = tcfg.EmbeddingConfig(slots_config={"cat_0": tcfg.SlotConfig(dim=8)}, feature_index_prefix_bit=8)
    model = DNN(5, [8], 8, 16, (32,), compute_dtype=torch.float32, device="cpu")
    mk = lambda **kw: thbm.CachedTrainCtx(model, torch.optim.Adam(model.parameters()), toptim.Adagrad(lr=0.1),  # noqa: E731
                                          EmbeddingWorker(cfg, _stores()), cfg, cache_rows=64, init_seed=7,
                                          device="cpu", **kw)
    ctx = mk(feed_threads=2, feed_shards=8)
    assert ctx.tier.feed_shards == 8 and ctx.tier.dirs["cache_d8"].feed_threads == 2
    ctx.set_feed_threads(4)
    assert ctx.tier.dirs["cache_d8"].feed_threads == 4
    with pytest.raises(NotImplementedError, match="mesh"):
        mk(mesh=object())
