"""The port's cache-tier stream (``persia_tpu_torch/embedding/hbm_cache``'s
``train_stream``, the CPU path: K12's and K14's plain versions) against the
port's own synchronous ``train_step`` and against the reference's stream
(``persia_tpu/embedding/hbm_cache``, JAX on the CPU).

- the pending map and the fused feeder call (``cache_feed_batch``) bit for
  bit the reference's natives, salts included;
- K14's plain version bit for bit the reference's ``_restore_rows`` (f32
  and bf16 rings, every optimizer, dropped pads); a repeated row raises;
- the stream's oracles from ``tests/test_hbm_cache.py`` (the stream against
  the synchronous path: flushed entries within 1e-5 relative; Adam's
  server powers; a ring too small for the in-flight window; losses bit for
  bit however late the write-backs land; packs bit for bit single steps;
  no restoring step in a pack), run over DLRM with ``torch.optim.Adam``;
- the stream against the reference's stream on the same batches: the
  directory's rows, evictions and ring positions bit for bit, losses and
  flushed entries at ``test_cached_ctx_matches_reference``'s tolerances;
- a lane that raises ends the stream within 15 s, with no lane left
  running; no wait in the stream's module is unbounded; the options of
  later slices raise.

Every stream runs under ``run_with_watchdog`` (60 s): a hang fails with
every thread's stack instead of stalling the run.
"""

import ast
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

import persia_tpu.config as jcfg
import persia_tpu.data as jdata
from persia_tpu.embedding import hbm_cache as jhbm
from persia_tpu.embedding import optim as joptim
from persia_tpu.embedding.hbm_cache import groups as jgroups
from persia_tpu.embedding.hbm_cache.directory import CacheDirectory as JaxDirectory
from persia_tpu.embedding.hbm_cache.directory import PendingSignMap as JaxPendingSignMap
from persia_tpu.embedding.store import EmbeddingStore as JaxStore
from persia_tpu.embedding.worker import EmbeddingWorker as JaxWorker
from persia_tpu.models import DLRM as JaxDLRM
import persia_tpu_torch.config as tcfg
import persia_tpu_torch.data as tdata
from persia_tpu_torch.embedding import hbm_cache as thbm
from persia_tpu_torch.embedding import optim as toptim
from persia_tpu_torch.embedding.hashing import add_index_prefix
from persia_tpu_torch.embedding.hbm_cache import stream as tstream
from persia_tpu_torch.embedding.hbm_cache.directory import CacheDirectory, PendingSignMap
from persia_tpu_torch.embedding.store import EmbeddingStore
from persia_tpu_torch.embedding.worker import EmbeddingWorker
from persia_tpu_torch.models import DLRM
from persia_tpu_torch.ops.restore_rows import restore_rows, restore_rows_reference
from persia_tpu_torch.testing.cache_cases import restore_case
from persia_tpu_torch.testing.watchdog import run_with_watchdog
from persia_tpu_torch.weights import cached_dense_from_flax, seeded_flax_params_like

TIGHT = dict(rtol=1e-5, atol=1e-6)
SYNC = dict(rtol=1e-5, atol=1e-7)  # the reference's stream-vs-sync bound
DIM, BOTTOM, TOP, DENSE = 8, (16, 8), (32, 16), 4
SLOTS = ("cat_a", "cat_b", "cat_c")
VOCABS = (64, 32, 100)


def _watch(fn, what="the stream"):
    return run_with_watchdog(fn, timeout=60.0, what=what)


# ------------------------------------------------ the pending map, natively


def test_pending_map_matches_reference():
    """Insert (later tokens win), ranges, token-conditional removes, salts
    and growth past the first table: every query bit for bit the
    reference's map."""
    rng = np.random.default_rng(0)
    maps = (JaxPendingSignMap(), PendingSignMap())
    probe = rng.integers(0, 1 << 62, 3000, dtype=np.uint64)
    ops = []
    for step in range(12):
        signs = np.concatenate([probe[rng.integers(0, 3000, 400)], rng.integers(0, 1 << 62, 200, dtype=np.uint64)])
        salt = [0, 0x9E3779B97F4A7C15, 12345][step % 3]
        ops.append(("insert_range", (np.unique(signs), int(rng.integers(0, 1 << 20)), step), {"salt": salt}))
        ops.append(("insert", (signs[:50], rng.integers(0, 999, 50).astype(np.int64), step + 100), {"salt": salt}))
        if step > 2:
            ops.append(("remove", (probe[rng.integers(0, 3000, 900)], step - 2), {"salt": salt}))
    for name, args, kw in ops:
        for m in maps:
            getattr(m, name)(*args, **kw)
        assert len(maps[0]) == len(maps[1])
        for salt in (0, 0x9E3779B97F4A7C15, 12345):
            want, got = (m.query(probe, salt=salt) for m in maps)
            assert got[0] == want[0]
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(got[2], want[2])
    assert len(maps[1]) > 4096  # grown past the first table


@pytest.mark.parametrize("salt", [0, 0xDEADBEEF12345])
@pytest.mark.parametrize("touches", [1, 2])
def test_feed_batch_matches_reference(salt, touches):
    """``CacheDirectory.feed_batch`` (admit + the pending map's probe of the
    misses under ``sign ^ salt``) bit for bit the reference's, over batches
    that evict and re-miss, with the map fed each step's evictions."""
    rng = np.random.default_rng(touches)
    jd, td = JaxDirectory(300, admit_touches=touches), CacheDirectory(300, admit_touches=touches)
    jm, tm = JaxPendingSignMap(), PendingSignMap()
    for step in range(10):
        signs = rng.integers(0, 900, 200).astype(np.uint64)
        want = jd.feed_batch(signs, jm, salt=salt)
        got = td.feed_batch(signs, tm, salt=salt)
        assert len(got) == len(want) == 8
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        for m in (jm, tm):
            m.insert_range(want[3], 17 * step, step, salt=salt)
            if step > 1:
                m.remove(want[3][::2], step - 1, salt=salt)
    assert len(want[6]) > 0, "the case must hit in-flight evictions"


# ------------------------------------------------------- K14, plain version


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("kind", ["sgd", "adagrad", "adagrad_vw", "adam"])
def test_restore_rows_plain_matches_reference(kind, bf16):
    """K14's plain version bit for bit ``_restore_rows``: the ring's
    entries (bf16 widened) into the table and each state column, the pads
    (rows C+1) dropped, the other rows untouched."""
    case = restore_case(kind, 500, DIM, 300, 77, bf16, "cpu", seed=len(kind) + bf16)
    C = case["table"].shape[0] - 1
    assert int((case["dst_rows"] == C + 1).sum()) > 0
    ring = case["ring"]
    jring = jnp.asarray(ring.view(torch.int16).numpy().view(ml_dtypes.bfloat16) if bf16 else ring.numpy())
    jt, js = jgroups._restore_rows(jnp.asarray(case["table"].numpy()),
                                   {k: jnp.asarray(v.numpy()) for k, v in case["state"].items()}, jring,
                                   jnp.asarray(case["src_idx"].numpy().astype(np.int64)),
                                   jnp.asarray(case["dst_rows"].numpy()))
    before = restore_rows.launches
    restore_rows(**case)
    assert restore_rows.launches == before  # the plain version: no launch
    np.testing.assert_array_equal(case["table"].numpy(), np.asarray(jt))
    for k, v in case["state"].items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(js[k]), err_msg=k)


def test_restore_rows_plain_raises_on_a_repeated_row():
    """Concatenated restores are the reference's function only while no
    row repeats: the plain version refuses a repeat (pads may repeat)."""
    case = restore_case("adagrad", 200, DIM, 64, 10, False, "cpu", seed=3)
    restore_rows_reference(**case)  # 6 pads (C+1) repeat: fine
    case["dst_rows"][1] = case["dst_rows"][0]
    with pytest.raises(ValueError, match="repeats"):
        restore_rows_reference(**case)
    empty = restore_case("adam", 50, DIM, 8, 0, True, "cpu", seed=4)
    table = empty["table"].clone()
    restore_rows(**empty)
    assert torch.equal(table, empty["table"])


# ------------------------------------------------------------ the stream


def _cfg(cfg, prefix_bit=8):
    return cfg.EmbeddingConfig(slots_config={n: cfg.SlotConfig(dim=DIM) for n in SLOTS},
                               feature_index_prefix_bit=prefix_bit)


def _batches(data, n, b=32, seed=0):
    """The reference's ``tests/test_hbm_cache.py`` batches: three slots of
    one id a sample over small vocabularies (a 100-row cache evicts and
    re-misses every step)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        feats = [data.IDTypeFeature(name, list(rng.integers(0, v, (b, 1), dtype=np.uint64)))
                 for name, v in zip(SLOTS, VOCABS)]
        out.append(data.PersiaBatch(
            feats, non_id_type_features=[data.NonIDTypeFeature(rng.normal(size=(b, DENSE)).astype(np.float32))],
            labels=[data.Label(rng.integers(0, 2, (b, 1)).astype(np.float32))], requires_grad=True))
    return out


def _ctx(opt, cache_rows, cfg=None, **kw):
    """The port's ctx over a fresh numpy store: DLRM (f32) from a fixed
    seed, ``torch.optim.Adam``."""
    cfg = cfg or _cfg(tcfg)
    store = EmbeddingStore(capacity=1 << 16, num_internal_shards=2, optimizer=opt.config, seed=11)
    model = DLRM(DENSE, len(cfg.slots_config), DIM, BOTTOM, TOP, compute_dtype=torch.float32, device="cpu",
                 generator=torch.Generator().manual_seed(5))
    ctx = thbm.CachedTrainCtx(model, torch.optim.Adam(model.parameters(), lr=3e-3), opt,
                              EmbeddingWorker(cfg, [store]), cfg, cache_rows=cache_rows, device="cpu", **kw)
    return ctx.__enter__(), store


def _entries(store, cfg=None, vocabs=None):
    cfg = cfg or _cfg(tcfg)
    out = {}
    for name, v in zip(sorted(cfg.slots_config), vocabs or VOCABS):
        signs = add_index_prefix(np.arange(v, dtype=np.uint64), cfg.slot(name).index_prefix, 8)
        for i, s in enumerate(signs.tolist()):
            e = store.get_embedding_entry(s)
            if e is not None:
                out[(name, i)] = e.copy()
    return out


def _sync_entries(opt, rows, batches, **kw):
    ctx, store = _ctx(opt, rows, **kw)
    for b in batches:
        ctx.train_step(b, fetch_metrics=False)
    ctx.drain()
    ctx.flush()
    return _entries(store)


def _assert_entries(got, want, tol=SYNC):
    assert set(got) == set(want) and len(want) > 50
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=str(k), **tol)


def test_train_stream_matches_sync_path():
    """The stream's lanes against the synchronous step (a 100-row cache:
    evictions and in-flight restores every step): the servers' entries
    after flush within 1e-5 relative (here: bit for bit)."""
    batches = _batches(tdata, 8, seed=21)
    want = _sync_entries(toptim.Adagrad(lr=0.1), 100, batches)
    ctx, store = _ctx(toptim.Adagrad(lr=0.1), 100)
    m = _watch(lambda: ctx.train_stream(batches))
    assert m is not None and np.isfinite(m["loss"])
    st = ctx.stream_stats()
    assert st["restore_steps"] > 0 and st["single_steps"] + st["packed_steps"] == 8, st
    ctx.flush()
    got = _entries(store)
    _assert_entries(got, want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


def test_train_stream_advances_adam_batch_state():
    """The servers' Adam powers move once a step for every cached group, as
    in the synchronous path."""
    ctx, store = _ctx(toptim.Adam(lr=0.01), 512)
    _watch(lambda: ctx.train_stream(_batches(tdata, 3, seed=2)))
    b1, b2 = store._batch_state[0]
    np.testing.assert_allclose(b1, toptim.Adam(lr=0.01).config.beta1 ** 3, rtol=1e-6)
    np.testing.assert_allclose(b2, toptim.Adam(lr=0.01).config.beta2 ** 3, rtol=1e-6)
    assert ctx.worker.lookup_router.batch_advances == {g: 3 for g in range(3)}


def test_stream_tiny_ring_backpressure_matches_sync():
    """A 256-row ring holds two steps' spans against a window of up to
    eight unflushed steps: the feeder waits on the ring and the write-back
    flushes early, and the servers end as the synchronous path's."""
    batches = _batches(tdata, 10, seed=33)
    want = _sync_entries(toptim.Adagrad(lr=0.1), 100, batches)
    ctx, store = _ctx(toptim.Adagrad(lr=0.1), 100, wb_ring_rows=256)
    assert ctx.ring_rows("cache_d8") == 256
    m = _watch(lambda: ctx.train_stream(batches, prefetch=3, wb_flush_steps=8))
    assert m is not None and np.isfinite(m["loss"])
    assert ctx.stream_stats()["ring_waits"] > 0, "the ring never filled"
    ctx.flush()
    _assert_entries(_entries(store), want)


def test_stream_under_fast_thread_switches_matches_sync():
    """The lanes' shared state (the ring's ends, the pending map, the
    queues) under a thread switch every 10 us, a ring too small for the
    window and a flush a step: the servers end bit for bit as the
    synchronous path leaves them (a lost update of the ring's ends or the
    map would restore a stale row or hang the feeder)."""
    import sys

    batches = _batches(tdata, 10, seed=5)
    want = _sync_entries(toptim.Adagrad(lr=0.1), 100, batches)
    ctx, store = _ctx(toptim.Adagrad(lr=0.1), 100, wb_ring_rows=256)
    inner = ctx._step

    def slow_step(*a):  # the feeder runs ahead: its misses meet in-flight evictions
        time.sleep(0.01)
        return inner(*a)

    ctx._step = slow_step
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        _watch(lambda: ctx.train_stream(batches, prefetch=4, wb_flush_steps=1, dispatch_k=2))
    finally:
        sys.setswitchinterval(old)
    st = ctx.stream_stats()
    assert st["restore_steps"] > 0 and st["flushes"] >= 5, st
    ctx.flush()
    got = _entries(store)
    _assert_entries(got, want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


def test_stream_deterministic_under_flush_timing():
    """Each step's loss bit for bit run to run, and with write-backs made
    100 ms slower each (a restore from the ring or a read of the server:
    the same values)."""

    def run(slow):
        ctx, _ = _ctx(toptim.Adagrad(lr=0.1), 100)
        if slow:
            inner = ctx.tier._set_embedding

            def slow_set(signs, values, dim):
                time.sleep(0.1)
                return inner(signs, values, dim)

            ctx.tier._set_embedding = slow_set
        out = []
        _watch(lambda: ctx.train_stream(_batches(tdata, 10, seed=41), on_metrics=lambda m: out.append(m["loss"])))
        return np.array(out), ctx.stream_stats()

    (a, _), (b, _), (c, st) = run(False), run(False), run(True)
    assert len(a) == 10 and st["dispatch_k"] == 1
    np.testing.assert_array_equal(a, b, err_msg="run-to-run nondeterminism")
    np.testing.assert_array_equal(a, c, err_msg="write-back timing changed the math")


def _block_batches(n, b=16, n_blocks=16, block=16, seed=5):
    """One 256-sign slot, rotating disjoint id blocks: every step evicts, but
    an evicted sign comes back only ``n_blocks`` steps later, at the edge of
    the in-flight window, so most steps restore nothing and pack."""
    cfg = tcfg.EmbeddingConfig(slots_config={"cat": tcfg.SlotConfig(dim=DIM)}, feature_index_prefix_bit=8)
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        lo = (i % n_blocks) * block
        out.append(tdata.PersiaBatch(
            [tdata.IDTypeFeature("cat", list(rng.integers(lo, lo + block, (b, 1), dtype=np.uint64)))],
            non_id_type_features=[tdata.NonIDTypeFeature(rng.normal(size=(b, DENSE)).astype(np.float32))],
            labels=[tdata.Label(rng.integers(0, 2, (b, 1)).astype(np.float32))], requires_grad=True))
    return cfg, out


def test_stream_kstep_packing_bitwise_parity():
    """Packs of 4 (forced to form by a slow step, asserted) against single
    dispatch: the last loss and every server entry bit for bit, with the
    ring written inside the packs."""

    def run(k, slow):
        cfg, batches = _block_batches(36)
        ctx, store = _ctx(toptim.Adagrad(lr=0.1), 40, cfg=cfg)
        if slow:
            inner = ctx._step

            def slow_step(*a):
                time.sleep(0.04)
                return inner(*a)

            ctx._step = slow_step
        m = _watch(lambda: ctx.train_stream(batches, dispatch_k=k, wb_flush_steps=2))
        st = ctx.stream_stats()
        ctx.flush()
        return m["loss"], _entries(store, cfg, (256,)), st

    l1, e1, s1 = run(1, slow=False)
    l4, e4, s4 = run(4, slow=True)
    assert s1["packed_steps"] == 0 and s4["packed_steps"] > 0, f"packs never formed: {s4}"
    assert s4["packs"] * 4 == s4["packed_steps"]
    assert l1 == l4, "packing changed the loss bits"
    assert set(e1) == set(e4) and len(e1) > 200
    for key in e1:
        np.testing.assert_array_equal(e1[key], e4[key], err_msg=f"sign {key}: packing changed the math")


def test_stream_packing_never_overlaps_inflight_eviction():
    """A step that restores from the ring never enters a pack: it
    dispatches alone, after the steps before it (a tiny cache and uniform
    ids restore on nearly every step, so no pack forms)."""
    ctx, _ = _ctx(toptim.Adagrad(lr=0.1), 100)
    seen = []
    inner = ctx._dispatch

    def spy(inputs, layout, miss_aux, cold_aux, restore_aux, evict_aux, evict_meta=None):
        seen.append(sum(int((dst <= 100).sum()) for _src, dst in restore_aux.values()))
        return inner(inputs, layout, miss_aux, cold_aux, restore_aux, evict_aux, evict_meta)

    ctx._dispatch = spy
    m = _watch(lambda: ctx.train_stream(_batches(tdata, 10, seed=21), dispatch_k=4))
    st = ctx.stream_stats()
    assert m is not None and np.isfinite(m["loss"])
    assert sum(seen) > 0 and sum(seen) == st["restored_rows"], "the case must restore"
    assert st["packed_steps"] == 0, f"a restoring step entered a pack: {st}"


def test_fetch_final_false_and_sync_steps_around_a_stream():
    """Synchronous steps, then a stream with ``fetch_final=False`` (None
    returned; ``last_metrics`` reads the kept header), then synchronous
    steps again: the servers end as all-synchronous steps leave them."""
    batches = _batches(tdata, 9, seed=8)
    want = _sync_entries(toptim.Adagrad(lr=0.1), 100, batches)
    ctx, store = _ctx(toptim.Adagrad(lr=0.1), 100)
    for b in batches[:3]:
        ctx.train_step(b, fetch_metrics=False)
    assert _watch(lambda: ctx.train_stream(batches[3:6], fetch_final=False, dispatch_k=8)) is None
    m = ctx.last_metrics()
    assert m is not None and np.isfinite(m["loss"]) and m["preds"].shape == (32, 1)
    for b in batches[6:]:
        ctx.train_step(b, fetch_metrics=False)
    ctx.drain()
    ctx.flush()
    _assert_entries(_entries(store), want)


# ------------------------------------------------ against the reference's


def _pair(cache_rows, wires="float32"):
    """(reference ctx, port ctx, their stores) over the same DLRM weights."""
    params = seeded_flax_params_like(DLRM(DENSE, 3, DIM, BOTTOM, TOP, compute_dtype=torch.float32, device="cpu"), 11)
    kw = dict(capacity=1 << 14, num_internal_shards=2, seed=3)
    jstore = JaxStore(optimizer=joptim.Adagrad(lr=0.1).config, **kw)
    jmodel = JaxDLRM(embedding_dim=DIM, bottom_mlp=BOTTOM, top_mlp=TOP, compute_dtype=jnp.float32)
    wire_kw = dict(wb_wire_dtype=wires, aux_wire_dtype=wires, cache_rows=cache_rows)
    jctx = jhbm.CachedTrainCtx(jmodel, optax.adam(1e-3), joptim.Adagrad(lr=0.1), JaxWorker(_cfg(jcfg), [jstore]),
                               _cfg(jcfg), **wire_kw).__enter__()
    jparams = jax.tree.map(jnp.asarray, params)
    tables, emb_state = jhbm.init_cached_tables(jctx.tier.groups, jctx.sparse_cfg)
    jctx.state = jhbm.CachedTrainState(
        params=jparams, batch_stats={}, opt_state=optax.adam(1e-3).init(jparams), tables=tables,
        emb_state=emb_state, emb_batch_state=jnp.ones((2,), jnp.float32), step=jnp.zeros((), jnp.int32))
    tstore = EmbeddingStore(optimizer=toptim.Adagrad(lr=0.1).config, **kw)
    model = DLRM(DENSE, 3, DIM, BOTTOM, TOP, compute_dtype=torch.float32, device="cpu")
    tctx = thbm.CachedTrainCtx(model, torch.optim.Adam(model.parameters(), lr=1e-3), toptim.Adagrad(lr=0.1),
                               EmbeddingWorker(_cfg(tcfg), [tstore]), _cfg(tcfg), device="cpu",
                               **wire_kw).__enter__()
    tctx.init_state()
    zeros = jax.tree.map(jnp.zeros_like, jparams)
    cached_dense_from_flax(tctx.state, params, zeros, zeros, jnp.zeros((), jnp.int32))
    return jctx, tctx, jstore, tstore


def _decisions(step, C, port):
    """The directory's decisions of one step: the row matrices, the cold
    rows, the warm and restored rows together (which of the two a re-miss
    takes depends on when its write-back lands), the evicted rows and
    signs and their ring positions."""
    inputs, _layout, miss, cold, restore, ev, meta = step
    out = {"rows": {g: np.asarray(v) for g, v in inputs["stacked_rows"].items()}}
    for g in set(miss) | set(cold) | set(restore) | set(ev):
        live = lambda r, lim: np.asarray(r)[np.asarray(r) < lim]  # noqa: E731
        warm = live(miss[g][0], C + 1) if g in miss else np.empty(0, np.int32)
        if port:
            back = live(restore[g][1], C + 1) if g in restore else np.empty(0, np.int32)
            ev_rows = ev[g][0] if g in ev else np.empty(0, np.int32)
        else:
            back = np.concatenate([live(d, C + 1) for _p, _s, d in restore.get(g, [])] or [np.empty(0, np.int32)])
            ev_rows = ev.get(g, np.empty(0, np.int32))
        out[g] = dict(cold=live(cold[g][0], C + 1) if g in cold else np.empty(0, np.int32),
                      warm_or_restored=np.sort(np.concatenate([warm, back]).astype(np.int64)),
                      evicted=np.asarray(ev_rows)[:meta[g][1]] if g in meta else np.empty(0, np.int32),
                      signs=meta[g][0][:meta[g][1]] if g in meta else np.empty(0, np.uint64),
                      ring_pos=meta[g][2] if g in meta else None)
    return out


def _record(tier):
    steps = []
    inner = tier.prepare_batch

    def wrapped(batch, **kw):
        out = inner(batch, **kw)
        steps.append(out)
        return out

    tier.prepare_batch = wrapped
    return steps


@pytest.mark.parametrize("wires", ["float32", "bfloat16"])
def test_stream_matches_reference_stream(wires):
    """The port's stream and the reference's on the same batches and
    weights (a 100-row cache): the directory's decisions and ring positions
    bit for bit at every step, each step's loss within 1e-5 relative and,
    after flush, every server entry within 1e-5 relative (f32 wires) or
    1e-3 (bf16 wires round the entries), as
    ``test_cached_ctx_matches_reference`` holds the synchronous path."""
    jctx, tctx, jstore, tstore = _pair(100, wires)
    jrec, trec = _record(jctx.tier), _record(tctx.tier)
    batches = _batches(jdata, 8, seed=21)
    jl, tl = [], []
    jctx.train_stream(batches, on_metrics=lambda m: jl.append(float(m["loss"])))
    _watch(lambda: tctx.train_stream([tdata.PersiaBatch.from_bytes(b.to_bytes()) for b in batches],
                                     on_metrics=lambda m: tl.append(float(m["loss"]))))
    assert len(jrec) == len(trec) == 8 and tctx.tier.evictions > 0
    C = tctx.tier.groups[0].rows
    for i, (j, t) in enumerate(zip(jrec, trec)):
        jd, td = _decisions(j, C, port=False), _decisions(t, C, port=True)
        assert set(jd) == set(td), i
        for g in jd:
            if g == "rows":
                for k in jd[g]:
                    np.testing.assert_array_equal(td[g][k], jd[g][k])
                continue
            for k, v in jd[g].items():
                np.testing.assert_array_equal(np.asarray(td[g][k]), np.asarray(v), err_msg=f"step {i} {g} {k}")
    assert tctx.stream_stats()["restore_steps"] > 0
    np.testing.assert_allclose(tl, jl, **TIGHT)
    jctx.flush()
    tctx.flush()
    assert jstore.size() == tstore.size() > 0
    entry_tol = TIGHT if wires == "float32" else dict(rtol=0, atol=1e-3)
    for shard in jstore._shards:
        for sign, (_, vec) in shard.entries.items():
            np.testing.assert_allclose(tstore.get_embedding_entry(sign), vec, err_msg=str(sign), **entry_tol)


# ------------------------------------------------------- faults and waits


def _lane_threads():
    return [t.name for t in threading.enumerate() if t.name.startswith("cache-") and t.is_alive()]


class _Boom(RuntimeError):
    pass


@pytest.mark.parametrize("lane", ["feeder", "stager", "dispatch", "write_back"])
def test_a_lane_that_raises_ends_the_stream(lane):
    """A lane raising on its third call (the feeder's admit, the stager's
    copy, the dispatch's step, the write-back's ``set_embedding``) makes
    ``train_stream`` raise that exception within 15 s, no lane left
    running."""
    ctx, _ = _ctx(toptim.Adagrad(lr=0.1), 100)
    owner, name = {"feeder": (ctx.tier, "prepare_batch"), "stager": (ctx, "_stage"), "dispatch": (ctx, "_dispatch"),
                   "write_back": (ctx.tier, "_set_embedding")}[lane]
    inner = getattr(owner, name)
    calls = [0]

    def third_raises(*a, **kw):
        calls[0] += 1
        if calls[0] == 3:
            raise _Boom(f"{lane} fails")
        return inner(*a, **kw)

    setattr(owner, name, third_raises)
    t0 = time.perf_counter()
    with pytest.raises(_Boom, match=f"{lane} fails"):
        _watch(lambda: ctx.train_stream(_batches(tdata, 30, seed=1), wb_flush_steps=1))
    assert time.perf_counter() - t0 < 15.0
    assert _lane_threads() == []


def test_a_lane_that_never_ends_is_named():
    """A feeder stuck in its batch iterator past the join's bound after the
    dispatch failed: the stream raises a ``RuntimeError`` naming it,
    chained to the dispatch's exception, instead of waiting on it."""
    ctx, _ = _ctx(toptim.Adagrad(lr=0.1), 100)
    release = threading.Event()
    batches = _batches(tdata, 2, seed=1)

    def stuck():
        yield batches[0]
        release.wait(60)  # the dispatch fails meanwhile; this lane cannot see it
        yield batches[1]

    def dispatch_raises(*a):
        raise _Boom("dispatch fails")

    ctx._dispatch = dispatch_raises
    old = tstream.JOIN_S
    tstream.JOIN_S = 1.0
    try:
        with pytest.raises(RuntimeError, match="cache-feeder") as got:
            _watch(lambda: ctx.train_stream(stuck()))
        assert isinstance(got.value.__cause__, _Boom)
    finally:
        tstream.JOIN_S = old
        release.set()
    deadline = time.time() + 5
    while _lane_threads() and time.time() < deadline:
        time.sleep(0.05)
    assert _lane_threads() == []


def test_no_wait_in_the_stream_is_unbounded():
    """Every queue get/put, condition or event wait and thread join in the
    stream's module passes a timeout."""
    tree = ast.parse(Path(tstream.__file__).read_text())
    waits = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
            continue
        recv, name = node.func.value, node.func.attr
        queue_op = name in ("get", "put") and isinstance(recv, ast.Name) and (recv.id == "q" or recv.id.endswith("_q"))
        other = name in ("wait", "join", "synchronize") and not isinstance(recv, ast.Constant)
        if queue_op or other:
            waits.append((name, node.lineno, {k.arg for k in node.keywords}))
    assert waits, "the check found no wait at all"
    for name, line, kws in waits:
        assert name != "synchronize", f"stream.py:{line} synchronizes; lanes order by events"
        assert "timeout" in kws, f"stream.py:{line}: {name}() without a timeout"
    assert tstream.WAIT_S <= 0.25 and tstream.JOIN_S <= 10.0


@pytest.mark.parametrize("option", [dict(pipeline_depth=2), dict(snapshot_every=4), dict(job_state=object()),
                                    dict(start_step=3), dict(sentinel=object()), dict(skip_steps={1}),
                                    dict(fence_callback=print)])
def test_unported_stream_options_raise(option):
    ctx, _ = _ctx(toptim.Adagrad(lr=0.1), 100)
    with pytest.raises(NotImplementedError, match=next(iter(option))):
        ctx.train_stream(_batches(tdata, 1), **option)
    assert _lane_threads() == []
