"""The port's cache-tier stream (``persia_tpu_torch/embedding/hbm_cache``'s
``train_stream``, the CPU path: K12's plain version, restores included)
against the port's own synchronous ``train_step`` and against the
reference's stream (``persia_tpu/embedding/hbm_cache``, JAX on the CPU).

- the pending map and the fused feeder call (``cache_feed_batch``) bit for
  bit the reference's natives, salts included;
- the restores' plain function (``groups._restore_rows``, K12's part (d))
  bit for bit the reference's ``_restore_rows`` (f32 and bf16 rings, every
  optimizer, dropped pads); a repeated row raises;
- the stream's oracles from ``tests/test_hbm_cache.py`` (the stream against
  the synchronous path: flushed entries within 1e-5 relative; Adam's
  server powers; a ring too small for the in-flight window; losses bit for
  bit however late the write-backs land; packs bit for bit single steps;
  no restoring step in a pack), run over DLRM with ``torch.optim.Adam``;
- the stream against the reference's stream on the same batches: the
  directory's rows, evictions and ring positions bit for bit, losses and
  flushed entries at ``test_cached_ctx_matches_reference``'s tolerances;
- the stage-pipelined stream (``pipeline_depth`` 4; the oracles of
  ``tests/test_stage_graph.py``): bit for bit the in-order stream, with
  hoisted feeds, with packs and with stalls forced; ``on_metrics`` forces
  depth 1; restoring steps are barriers no feed hoists across; its
  decisions and ring positions the reference's pipelined stream's;
- a lane that raises ends the stream within 15 s, with no lane left
  running; no wait in the stream's or the stage graph's module is
  unbounded; the options of later slices (the sentinel, quarantined steps)
  raise (fences have their own file, ``tests/test_torch_hbm_fence.py``).

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
from persia_tpu_torch.ops.cache_aux import check_pairing, restore_rows_reference
from persia_tpu_torch.parallel import stage_graph as tsg
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


# ------------------------------------------------- the restores, plain version


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("kind", ["sgd", "adagrad", "adagrad_vw", "adam"])
def test_restore_rows_plain_matches_reference(kind, bf16):
    """The restores' plain function (K12's part (d), ``groups._restore_rows``)
    bit for bit ``_restore_rows``: the ring's entries (bf16 widened) into
    the table and each state column, the pads (rows C+1) dropped, the other
    rows untouched."""
    case = restore_case(kind, 500, DIM, 300, 77, bf16, "cpu", seed=len(kind) + bf16)
    C = case["table"].shape[0] - 1
    assert int((case["dst_rows"] == C + 1).sum()) > 0
    ring = case["ring"]
    jring = jnp.asarray(ring.view(torch.int16).numpy().view(ml_dtypes.bfloat16) if bf16 else ring.numpy())
    jt, js = jgroups._restore_rows(jnp.asarray(case["table"].numpy()),
                                   {k: jnp.asarray(v.numpy()) for k, v in case["state"].items()}, jring,
                                   jnp.asarray(case["src_idx"].numpy().astype(np.int64)),
                                   jnp.asarray(case["dst_rows"].numpy()))
    assert thbm.groups._restore_rows is restore_rows_reference  # no kernel of its own: K12 writes restores
    thbm.groups._restore_rows(**case)
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
    restore_rows_reference(**empty)
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
        seen.append(sum(int((dst <= 100).sum()) for _src, dst, _slot in restore_aux.values()))
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
    stream's module and in the stage graph's passes a timeout."""
    for module in (tstream, tsg):
        tree = ast.parse(Path(module.__file__).read_text())
        where = Path(module.__file__).name
        waits = []
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
                continue
            recv, name = node.func.value, node.func.attr
            queue_op = name in ("get", "put") and isinstance(recv, ast.Name) and (recv.id == "q"
                                                                                  or recv.id.endswith("_q"))
            other = name in ("wait", "join", "synchronize") and not isinstance(recv, ast.Constant)
            if queue_op or other:
                waits.append((name, node.lineno, {k.arg for k in node.keywords}))
        assert waits, f"the check found no wait at all in {where}"
        for name, line, kws in waits:
            assert name != "synchronize", f"{where}:{line} synchronizes; lanes order by events"
            assert "timeout" in kws, f"{where}:{line}: {name}() without a timeout"
    assert tstream.WAIT_S <= 0.25 and tstream.JOIN_S <= 10.0


@pytest.mark.parametrize("option", [dict(sentinel=object()), dict(skip_steps={1})])
def test_unported_stream_options_raise(option):
    ctx, _ = _ctx(toptim.Adagrad(lr=0.1), 100)
    with pytest.raises(NotImplementedError, match=next(iter(option))):
        ctx.train_stream(_batches(tdata, 1), **option)
    assert _lane_threads() == []


# --------------------------------------------- the stage-pipelined stream


def _slowed(ctx, s=0.03):
    """Each step ``s`` slower (the dense stage): the stager's feeds run
    ahead into the window."""
    inner = ctx._step

    def slow_step(*a):
        time.sleep(s)
        return inner(*a)

    ctx._step = slow_step
    return ctx


def _pipe_run(depth, k=1, cache_rows=136, slow=False, n=36):
    """``tests/test_stage_graph.py``'s harness: one stream over the rotating
    blocks (every step evicts; an evicted sign comes back 16 steps later,
    past the window, so the feeds hoist): (last loss, server entries after
    flush, stats)."""
    cfg, batches = _block_batches(n)
    ctx, store = _ctx(toptim.Adagrad(lr=0.1), cache_rows, cfg=cfg)
    if slow:
        _slowed(ctx)
    m = _watch(lambda: ctx.train_stream(batches, dispatch_k=k, pipeline_depth=depth, wb_flush_steps=2))
    st = ctx.stream_stats()
    ctx.flush()
    return m["loss"], _entries(store, cfg, (256,)), st


def _assert_stream_parity(a, b):
    (la, ea, _), (lb, eb, _) = a, b
    assert la == lb, "pipelining changed the loss bits"
    assert set(ea) == set(eb) and len(ea) > 200
    for key in ea:
        np.testing.assert_array_equal(ea[key], eb[key], err_msg=f"sign {key}: pipelining changed the math")


@pytest.fixture(scope="module")
def in_order_blocks():
    return {rows: _pipe_run(1, cache_rows=rows) for rows in (136, 16)}


def test_pipelined_stream_bitwise_parity_hazard_free(in_order_blocks):
    """Depth 4 against depth 1, bit for bit (the last loss and every server
    entry), with the slow step keeping the window full so that feeds do
    hoist."""
    pipe = _pipe_run(4, slow=True)
    st = pipe[2]
    assert st["pipeline_depth"] == 4 and st["pipeline_drains"] == 1
    assert st["pipelined_feeds"] > 0 and sum(st["feed_leads"]) == st["pipelined_feeds"]
    assert sum(st["feed_leads"][1:]) > 0, f"no feed ever ran ahead of an earlier dense stage: {st}"
    assert in_order_blocks[136][2]["pipelined_feeds"] == 0 and in_order_blocks[136][2]["pipeline_depth"] == 1
    _assert_stream_parity(in_order_blocks[136], pipe)


def test_pipelined_stream_kstep_pack_parity(in_order_blocks):
    """Packs compose with the pipeline: feed-done steps pack their dense
    stages ``min(dispatch_k, depth)`` at a time, bit for bit the in-order
    stream."""
    pipe = _pipe_run(4, k=8, slow=True)
    st = pipe[2]
    assert st["packed_steps"] > 0 and st["packs"] * 4 == st["packed_steps"], f"dense packs never formed: {st}"
    assert st["pipelined_feeds"] == st["packed_steps"] + st["single_steps"] - st["restore_steps"]
    _assert_stream_parity(in_order_blocks[136], pipe)


def test_pipelined_stream_stall_parity_tiny_cache(in_order_blocks):
    """A 16-row cache (a step touches ~10 rows): most feeds evict rows the
    step before trains, so the ledger stalls them (stalls > 0), and the
    result is still bit for bit the in-order stream's (without the stalls
    the loss bits change)."""
    pipe = _pipe_run(4, cache_rows=16, slow=True)
    assert pipe[2]["pipeline_stalls"] > 0, f"the tiny cache never stalled a feed: {pipe[2]}"
    _assert_stream_parity(in_order_blocks[16], pipe)


def test_pipelined_on_metrics_forces_in_order():
    """``on_metrics`` reads every header: the stream runs at depth 1."""
    cfg, batches = _block_batches(6)
    ctx, _ = _ctx(toptim.Adagrad(lr=0.1), 136, cfg=cfg)
    seen = []
    _watch(lambda: ctx.train_stream(batches, pipeline_depth=4, on_metrics=seen.append))
    st = ctx.stream_stats()
    assert len(seen) == 6 and st["pipeline_depth"] == 1 and st["pipelined_feeds"] == 0


def test_pipeline_depth_below_one_raises():
    ctx, _ = _ctx(toptim.Adagrad(lr=0.1), 100)
    with pytest.raises(ValueError, match="pipeline_depth"):
        ctx.train_stream(_batches(tdata, 1), pipeline_depth=0)
    assert _lane_threads() == []


def test_pipelined_restoring_steps_are_barriers():
    """A 100-row cache restores from the ring in many steps. At depth 4
    with the slow step: every hoisted feed runs in the stager, a restoring
    step's feed (its restores in its K12) runs in order with its dense
    stage, no feed of a later step runs before that, no feed runs more than
    depth - 1 steps ahead of its dense stage, and the servers end bit for
    bit as the in-order stream leaves them."""
    batches = _batches(tdata, 12, seed=21)
    base, store0 = _ctx(toptim.Adagrad(lr=0.1), 100)
    _watch(lambda: base.train_stream(batches, dispatch_k=1))
    base.flush()
    ctx, store = _ctx(toptim.Adagrad(lr=0.1), 100)
    _slowed(ctx)
    rec = _record(ctx.tier)
    events = []
    feed, step = ctx._apply_feed, ctx._step

    def spy_feed(*a, **kw):
        events.append("hoisted" if threading.current_thread().name == "cache-stager" else "in_order")
        return feed(*a, **kw)

    def spy_step(*a):
        events.append("dense")
        return step(*a)

    ctx._apply_feed, ctx._step = spy_feed, spy_step
    _watch(lambda: ctx.train_stream(batches, dispatch_k=1, pipeline_depth=4))
    st = ctx.stream_stats()
    barriers = [bool(r[4]) for r in rec]
    assert 0 < sum(barriers) < len(batches) and st["restore_steps"] == sum(barriers), st
    assert st["pipelined_feeds"] == len(batches) - sum(barriers) > 0
    # each step's events: its feed (hoisted or in order) and its dense stage
    feed_at, dense_at = {}, {}
    hoisted = iter(i for i, b in enumerate(barriers) if not b)
    n_dense = 0
    for pos, e in enumerate(events):
        if e == "hoisted":
            feed_at[next(hoisted)] = pos
        elif e == "in_order":
            feed_at[n_dense] = pos
            assert barriers[n_dense], f"step {n_dense} fed in order but restores nothing"
        else:
            dense_at[n_dense] = pos
            n_dense += 1
    assert n_dense == len(batches) and len(feed_at) == len(batches)
    for t in range(len(batches)):
        assert feed_at[t] < dense_at[t]
        if t >= 4:
            assert feed_at[t] > dense_at[t - 4], f"step {t}'s feed ran more than 3 steps ahead"
        for b in range(t):
            if barriers[b]:
                assert feed_at[t] > dense_at[b], f"step {t}'s feed hoisted across the barrier {b}"
    ctx.flush()
    want, got = _entries(store0), _entries(store)
    assert set(got) == set(want) and len(want) > 50
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


def test_stream_pairing_claims_every_slot():
    """At every step of a stream that restores: each payload slot is claimed
    by exactly one warm, cold or restore write, ``e_free`` lists only the
    pads, and ``check_pairing`` passes with the restores."""
    ctx, _ = _ctx(toptim.Adagrad(lr=0.1), 100)
    rec = _record(ctx.tier)
    _watch(lambda: ctx.train_stream(_batches(tdata, 10, seed=21)))
    C = ctx.tier.groups[0].rows
    restoring_on_evicted = 0
    for _inputs, _layout, miss, cold, restore, ev, meta in rec:
        for g, (e_rows, e_free) in ev.items():
            k = meta[g][1]
            np.testing.assert_array_equal(e_free[e_free >= 0], np.arange(k, len(e_rows)))
            writes = [w for w in (miss.get(g), cold.get(g)) if w is not None]
            r_src, r_dst, r_slot = restore.get(g, (np.empty(0, np.int32),) * 3)
            claims = np.concatenate([w[2][w[2] >= 0] for w in writes] + [r_slot[r_slot >= 0]])
            np.testing.assert_array_equal(np.sort(claims), np.arange(k))
            np.testing.assert_array_equal(e_rows[r_slot[r_slot >= 0]], r_dst[r_slot >= 0])
            restoring_on_evicted += int((r_slot >= 0).sum())
            t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
            m = [t(miss[g][0]), t(miss[g][2])] if g in miss else [t(e_free[:0])] * 2
            c = [t(cold[g][0]), t(cold[g][2])] if g in cold else [t(e_free[:0])] * 2
            check_pairing(C + 1, t(e_rows), m[0], m[1], c[0], c[1], t(e_free), t(r_dst), t(r_slot))
    assert restoring_on_evicted > 0, "the case must restore misses onto rows evicted in the same step"


@pytest.mark.parametrize("lane", ["stager", "dispatch"])
def test_a_lane_that_raises_ends_the_pipelined_stream(lane):
    """At depth 4, a hoisted feed (the stager's K12) or a dense stage alone
    raising on its third call: ``train_stream`` raises it within 15 s, no
    lane left running (a stager parked in ``reserve_feed`` wakes)."""
    cfg, batches = _block_batches(30)
    ctx, _ = _ctx(toptim.Adagrad(lr=0.1), 136, cfg=cfg)
    name = {"stager": "_apply_feed", "dispatch": "_dispatch_dense"}[lane]
    inner = getattr(ctx, name)
    calls = [0]

    def third_raises(*a, **kw):
        calls[0] += 1
        if calls[0] == 3:
            raise _Boom(f"{lane} fails")
        return inner(*a, **kw)

    setattr(ctx, name, third_raises)
    _slowed(ctx)
    t0 = time.perf_counter()
    with pytest.raises(_Boom, match=f"{lane} fails"):
        _watch(lambda: ctx.train_stream(batches, dispatch_k=1, pipeline_depth=4, wb_flush_steps=1))
    assert time.perf_counter() - t0 < 15.0
    assert _lane_threads() == []


def test_pipelined_stream_matches_reference_pipelined_stream():
    """The port's depth-4 stream and the reference's on the same batches and
    weights (a 100-row cache; the port's dense stage slowed so that feeds
    hoist): the directory's decisions and ring positions bit for bit at
    every step, the last loss within 1e-5 relative and, after flush, every
    server entry within 1e-5 relative."""
    jctx, tctx, jstore, tstore = _pair(100)
    jrec, trec = _record(jctx.tier), _record(tctx.tier)
    batches = _batches(jdata, 10, seed=23)
    jm = jctx.train_stream(batches, pipeline_depth=4, dispatch_k=4)
    _slowed(tctx, 0.02)
    tm = _watch(lambda: tctx.train_stream([tdata.PersiaBatch.from_bytes(b.to_bytes()) for b in batches],
                                          pipeline_depth=4, dispatch_k=4))
    assert jctx.stream_stats()["pipeline_depth"] == tctx.stream_stats()["pipeline_depth"] == 4
    assert tctx.stream_stats()["pipelined_feeds"] > 0 and tctx.stream_stats()["restore_steps"] > 0
    C = tctx.tier.groups[0].rows
    assert len(jrec) == len(trec) == 10
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
    np.testing.assert_allclose(tm["loss"], float(jm["loss"]), **TIGHT)
    jctx.flush()
    tctx.flush()
    assert jstore.size() == tstore.size() > 0
    for shard in jstore._shards:
        for sign, (_, vec) in shard.entries.items():
            np.testing.assert_allclose(tstore.get_embedding_entry(sign), vec, err_msg=str(sign), **TIGHT)
