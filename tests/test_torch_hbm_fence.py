"""Fences, snapshot and resume of the port's cache tier
(``persia_tpu_torch/embedding/hbm_cache``: ``train_stream``'s
``snapshot_every`` / ``job_state`` / ``start_step`` / ``fence_callback``,
``CachedTrainCtx.snapshot_job`` / ``resume``, and
``weights.cached_state_to_flax_bytes``), on the CPU:

- (a) the port's twins of ``tests/test_jobstate.py``'s
  ``test_cached_stream_fence_and_resume_bit_identical`` and
  ``tests/test_stage_graph.py``'s ``test_pipelined_kill_resume_parity``:
  DNN (its batch statistics) on the cache tier, Adagrad, fences every 4
  steps, a run dropped after step 10 and resumed from its fence at 8 (in
  order, and at depth 3 against the in-order run) lands bit for bit on the
  uninterrupted fenced run: the state's bytes and every server entry;
  (b) the same with sparse Adam (the card's batch powers and the servers'
  agree after the resume) and with the touch gate on;
- (c) the state's bytes equal ``flax.serialization.to_bytes`` of the
  reference's ``CachedTrainState`` carrying the same arrays (DLRM and DNN),
  and load back;
- (d) a manifest of the reference's fenced stream resumes in the port and
  the other way round: the directory's decisions bit for bit, losses and
  entries within ``test_cached_ctx_matches_reference``'s tolerance, the
  same step count;
- (e) the synchronous ``snapshot_job`` / ``resume`` (deferred before
  ``init_state`` and not; ``restore_ps`` True and False) against the
  reference's cached ctx doing the same;
- (f) a fence whose ring or pending map is not empty raises and ends the
  stream, no lane left; (g) a callback's ``Exception`` is counted and the
  stream finishes as without it, a ``BaseException`` ends it within
  ``JOIN_S``; (h) the cadence with ``start_step``, and with a callback and
  no ``job_state``.

Every stream runs under ``run_with_watchdog`` (60 s).
"""

import time

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import persia_tpu.config as jcfg
import persia_tpu.data as jdata
from persia_tpu import jobstate as jjob
from persia_tpu.embedding import hbm_cache as jhbm
from persia_tpu.embedding import optim as joptim
from persia_tpu.embedding.hbm_cache import groups as jgroups
from persia_tpu.embedding.store import EmbeddingStore as JaxStore
from persia_tpu.embedding.worker import EmbeddingWorker as JaxWorker
from persia_tpu.models import DLRM as JaxDLRM
import persia_tpu_torch.config as tcfg
import persia_tpu_torch.data as tdata
from persia_tpu_torch import jobstate as tjob
from persia_tpu_torch.embedding import hbm_cache as thbm
from persia_tpu_torch.embedding import optim as toptim
from persia_tpu_torch.embedding.hashing import add_index_prefix
from persia_tpu_torch.embedding.hbm_cache import stream as tstream
from persia_tpu_torch.embedding.store import EmbeddingStore
from persia_tpu_torch.embedding.worker import EmbeddingWorker
from persia_tpu_torch.models import DLRM, DNN
from persia_tpu_torch.testing import SyntheticClickDataset
from persia_tpu_torch.testing.watchdog import run_with_watchdog
from persia_tpu_torch.weights import (
    batch_stats_to_flax,
    cached_dense_from_flax,
    cached_state_from_flax_bytes,
    cached_state_to_flax_bytes,
    seeded_flax_params_like,
    state_dict_to_flax,
)
from test_torch_hbm_stream import _decisions, _lane_threads, _record

TIGHT = dict(rtol=1e-5, atol=1e-6)  # test_cached_ctx_matches_reference's
VOCABS, DIM, DENSE = (64, 32), 8, 5
STEPS, EVERY, DIE_AT = 12, 4, 10


def _watch(fn, what="the stream"):
    return run_with_watchdog(fn, timeout=60.0, what=what)


def _cfg(cfg):
    return cfg.EmbeddingConfig(slots_config={"cat_0": cfg.SlotConfig(dim=DIM), "cat_1": cfg.SlotConfig(dim=DIM)},
                               feature_index_prefix_bit=8)


def _batches(n=STEPS, seed=9):
    return list(SyntheticClickDataset(num_samples=n * 32, num_dense=DENSE, vocab_sizes=VOCABS, seed=seed)
                .batches(32))[:n]


def _stores(n=2):
    return [EmbeddingStore(capacity=1 << 16, num_internal_shards=4, seed=7) for _ in range(n)]


def _sparse(kind):
    return toptim.Adagrad(lr=0.1) if kind == "adagrad" else toptim.Adam(lr=0.01)


def _dnn():
    return DNN(DENSE, [DIM, DIM], 8, 16, (32,), compute_dtype=torch.float32, device="cpu",
               generator=torch.Generator().manual_seed(5))


def _ctx(stores, sparse="adagrad", touches=1, cache_rows=256, model=None):
    """The oracles' ctx: DNN(8, 16, (32,)) in f32, Adam(3e-3), the sparse
    optimizer, a 256-row cache, init seed 7."""
    cfg = _cfg(tcfg)
    model = model or _dnn()
    return thbm.CachedTrainCtx(model, torch.optim.Adam(model.parameters(), lr=3e-3), _sparse(sparse),
                               EmbeddingWorker(cfg, stores), cfg, cache_rows=cache_rows, init_seed=7,
                               admit_touches=touches, device="cpu").__enter__()


def _entries(stores, cfg=None):
    cfg = cfg or _cfg(tcfg)
    out = {}
    for slot, vocab in zip(("cat_0", "cat_1"), VOCABS):
        signs = add_index_prefix(np.arange(vocab, dtype=np.uint64), cfg.slot(slot).index_prefix, 8)
        for i, s in enumerate(signs.tolist()):
            e = next((st.get_embedding_entry(s) for st in stores if st.get_embedding_entry(s) is not None), None)
            if e is not None:
                out[(slot, i)] = np.array(e)
    return out


def _assert_entries_equal(a, b):
    assert set(a) == set(b) and len(a) > 50
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))


def _slowed(ctx, s=0.01):
    inner = ctx._step

    def slow(*a):
        time.sleep(s)
        return inner(*a)

    ctx._step = slow
    return ctx


# ----------------------------------------- (a), (b): kill and resume, bit for bit

KILL_CASES = {
    # (sparse optimizer, touch gate, cache rows, the uninterrupted run's
    # knobs, the dropped and resumed runs'); 72 rows of 96 signs evict and
    # restore from the ring (56 rows with the touch gate: they evict)
    "adagrad_in_order": ("adagrad", 1, 256, {}, {}),
    "adagrad_depth3": ("adagrad", 1, 256, dict(dispatch_k=1), dict(pipeline_depth=3, dispatch_k=1)),
    "adagrad_evicting_depth3": ("adagrad", 1, 72, dict(dispatch_k=1), dict(pipeline_depth=3, dispatch_k=1)),
    "adam_evicting": ("adam", 1, 72, {}, {}),
    "adam_evicting_depth3_touch_gate": ("adam", 2, 56, dict(dispatch_k=1), dict(pipeline_depth=3, dispatch_k=1)),
}


@pytest.mark.parametrize("case", sorted(KILL_CASES))
def test_fenced_stream_kill_and_resume_bit_identical(tmp_path, case):
    """Fences every 4 steps drain the stream (the pending map and the rings
    empty in every manifest), flush the cache and commit; a run dropped
    after step 10 and resumed from its fence at 8 ends with the state's
    bytes (DNN's parameters and batch statistics, Adam's, the cold pools,
    the batch powers, the step) and every server entry bit for bit the
    uninterrupted fenced run's. At depth 3 the dropped and the resumed runs
    hoist feeds and are held to the in-order run."""
    sparse, touches, rows, base_kw, run_kw = KILL_CASES[case]
    batches = _batches()
    base_stores = _stores()
    base = _ctx(base_stores, sparse, touches, rows)
    _watch(lambda: base.train_stream(batches, snapshot_every=EVERY, job_state=str(tmp_path / "base"), **base_kw))
    st = base.stream_stats()
    assert st["fences"] == 2 and base._global_step == STEPS and len(st["fence_ms"]) == 2
    if rows < sum(VOCABS):
        assert base.tier.evictions > 0 and (touches > 1 or st["restore_steps"] > 0), st
    base.flush()

    stores = _stores()
    ctx1 = _ctx(stores, sparse, touches, rows)
    if run_kw:
        _slowed(ctx1)
    _watch(lambda: ctx1.train_stream(batches[:DIE_AT], snapshot_every=EVERY, job_state=str(tmp_path / "js"),
                                     **run_kw))
    if run_kw:
        assert ctx1.stream_stats()["pipelined_feeds"] > 0
    del ctx1  # dies after step 10; its fences committed at 4 and 8

    ctx2 = _ctx(stores, sparse, touches, rows)
    m = ctx2.resume(str(tmp_path / "js"))
    assert m is not None and m.step == 8 and ctx2._global_step == 8 and ctx2.state is None
    assert ctx2.last_resume_info["resumed"] and ctx2.last_resume_info["ps_entries_restored"] > 0
    if sparse == "adam":
        assert ctx2.worker.lookup_router.batch_advances == {0: 8, 1: 8}
    _watch(lambda: ctx2.train_stream(batches[m.step:], snapshot_every=EVERY, job_state=str(tmp_path / "js"),
                                     start_step=m.step, **run_kw))
    assert ctx2._global_step == STEPS and ctx2.stream_stats()["fences"] == 0
    if sparse == "adam":
        # the card's batch powers and every server's, after 12 steps
        b1, b2 = ctx2.state.emb_batch_state.tolist()
        for s in stores:
            for grp, (s1, s2) in s._batch_state.items():
                np.testing.assert_allclose((s1, s2), (b1, b2), rtol=1e-6, err_msg=f"group {grp}")
    ctx2.flush()

    assert cached_state_to_flax_bytes(ctx2.state) == cached_state_to_flax_bytes(base.state)
    _assert_entries_equal(_entries(base_stores), _entries(stores))
    occ = m.read_json("cache.json")
    assert occ["pending_ledger_entries"] == 0 and set(occ["resident_rows"]) == {"cache_d8"}
    assert all(r["head"] == r["tail"] for r in occ["ring"].values())
    assert m.read_json("loader.json") == {"consumed_batches": 8} and m.meta["kind"] == "cached_ctx"
    assert m.has("cache/cache_d8.touch") == (touches > 1)


# -------------------------------------------- (c): the reference's bytes


def _reference_state(state, groups_cfg, sparse_cfg, lr=3e-3):
    """The reference's ``CachedTrainState`` holding the port's arrays, its
    trees as the reference builds them: params, stats and moments in the
    order a jitted step returns them, optax's adam chain, the pools from
    ``init_cached_tables``."""
    same = jax.jit(lambda t: t)
    model, opt = state.model, state.optimizer
    params = same(jax.tree.map(jnp.asarray, state_dict_to_flax(model)))
    first = next(iter(model.parameters()))
    moments = [same(jax.tree.map(jnp.asarray, state_dict_to_flax(model, lambda p, k=k: opt.state[p][k])))
               for k in ("exp_avg", "exp_avg_sq")]
    adam = optax.adam(lr).init(params)
    adam = (adam[0]._replace(count=jnp.asarray(int(opt.state[first]["step"]), jnp.int32), mu=moments[0],
                             nu=moments[1]),) + tuple(adam[1:])
    groups, _ = jgroups.make_cache_groups(groups_cfg, {DIM: state.tables["cache_d8"].shape[0] - 1}, sparse_cfg)
    tables, emb_state = jhbm.init_cached_tables(groups, sparse_cfg)
    tables = {g: jnp.asarray(state.tables[g].numpy()) for g in tables}
    emb_state = {g: {k: jnp.asarray(state.emb_state[g][k].numpy()) for k in st} for g, st in emb_state.items()}
    return jgroups.CachedTrainState(
        params=params, batch_stats=same(jax.tree.map(jnp.asarray, batch_stats_to_flax(model))), opt_state=adam,
        tables=tables, emb_state=emb_state, emb_batch_state=jnp.asarray(state.emb_batch_state.numpy()),
        step=jnp.asarray(state.step.numpy()))


@pytest.mark.parametrize("model", ["dlrm", "dnn"])
@pytest.mark.parametrize("sparse", ["adagrad", "adam"])
def test_cached_state_bytes_are_the_references(model, sparse):
    """After three steps (Adam's moments, the pools, the batch powers and,
    for DNN, the batch statistics all moved): the port's bytes equal
    ``flax.serialization.to_bytes`` of the reference's state with the same
    arrays; the reference reads them back; a fresh ctx loads them in place
    and writes the same bytes."""
    def make(stores):
        m = (DLRM(DENSE, 2, DIM, (16, DIM), (32, 16), compute_dtype=torch.float32, device="cpu",
                  generator=torch.Generator().manual_seed(5)) if model == "dlrm" else _dnn())
        return _ctx(stores, sparse, model=m)

    ctx = make(_stores())
    for b in _batches(3):
        ctx.train_step(b)
    ctx.drain()
    raw = cached_state_to_flax_bytes(ctx.state)
    sparse_cfg = (joptim.Adagrad(lr=0.1) if sparse == "adagrad" else joptim.Adam(lr=0.01)).config
    ref = _reference_state(ctx.state, _cfg(jcfg), sparse_cfg)
    if model == "dnn":
        assert jax.tree.leaves(ref.batch_stats), "DNN carries batch statistics"
    assert flax.serialization.to_bytes(ref) == raw
    back = flax.serialization.from_bytes(ref, raw)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    fresh = make(_stores())
    fresh.init_state()
    assert cached_state_to_flax_bytes(fresh.state) != raw
    cached_state_from_flax_bytes(fresh.state, raw)
    assert cached_state_to_flax_bytes(fresh.state) == raw


def test_cached_state_bytes_refuse_another_layout():
    ctx = _ctx(_stores())
    ctx.init_state()
    other = _ctx(_stores(), cache_rows=128)
    other.init_state()
    with pytest.raises(ValueError, match="bytes"):
        cached_state_from_flax_bytes(other.state, cached_state_to_flax_bytes(ctx.state))


# ------------------------------- DNN's batch statistics on the cache tier


TIGHT_BN = dict(rtol=5e-5, atol=5e-6)  # test_torch_dnn.py's: f32 through a batch norm in train mode
ENTRY_F32 = (5e-5, 5e-4)  # test_torch_dnn.py's: embeddings (absolute), Adagrad's accumulator (relative)


def test_dnn_cached_steps_match_reference():
    """DNN (f32) on the cache tier, synchronous steps over a 72-row cache
    (evictions every step), against the reference's cached ctx from the
    same weights and statistics: every step's loss and predictions and the
    running variances after them (moved in train mode, once a step) to
    ``TIGHT_BN``, the running means to ``test_torch_dnn.py``'s noise bound,
    after flush every server entry to ``test_torch_dnn.py``'s f32 entry
    tolerance; then, the reference's state loaded from its bytes, an eval
    batch's predictions (the running statistics, left as they were) to
    ``TIGHT_BN``."""
    from persia_tpu.models import DNN as JaxDNN

    tstores = _stores()
    tctx = _ctx(tstores, cache_rows=72)
    tctx.init_state()
    cfg = _cfg(jcfg)
    jstores = _jax_stores()
    jctx = jhbm.CachedTrainCtx(JaxDNN(dense_mlp_size=8, sparse_mlp_size=16, hidden_sizes=(32,),
                                      compute_dtype=jnp.float32), optax.adam(3e-3), joptim.Adagrad(lr=0.1),
                               JaxWorker(cfg, jstores), cfg, cache_rows=72, init_seed=7).__enter__()
    params = jax.tree.map(jnp.asarray, state_dict_to_flax(tctx.model))
    tables, emb_state = jhbm.init_cached_tables(jctx.tier.groups, jctx.sparse_cfg)
    jctx.state = jhbm.CachedTrainState(
        params=params, batch_stats=jax.tree.map(jnp.asarray, batch_stats_to_flax(tctx.model)),
        opt_state=optax.adam(3e-3).init(params), tables=tables, emb_state=emb_state,
        emb_batch_state=jnp.ones((2,), jnp.float32), step=jnp.zeros((), jnp.int32))
    batches = _batches(6, seed=17)
    for b in batches[:5]:
        a, t = jctx.train_step(jdata.PersiaBatch.from_bytes(b.to_bytes())), tctx.train_step(b)
        np.testing.assert_allclose(t["loss"], float(a["loss"]), **TIGHT_BN)
        np.testing.assert_allclose(t["preds"], np.asarray(a["preds"]), **TIGHT_BN)
    assert tctx.tier.evictions > 0
    want = jax.tree.map(np.asarray, jctx.state.batch_stats)
    got = batch_stats_to_flax(tctx.model)
    assert sorted(got) == sorted(want) == ["BatchNorm_0", "BatchNorm_1"]
    # the running means follow the biases feeding each norm, whose true
    # gradient is 0: test_torch_dnn.py's NOISE_MEANS bound, 0.01 * lr * T * (T + 1)
    noise_means = dict(rtol=0, atol=0.01 * 3e-3 * 5 * 6)
    for name in want:
        for k in ("mean", "var"):
            assert not np.array_equal(got[name][k], np.zeros_like(got[name][k]) if k == "mean" else 1.0), "moved"
            np.testing.assert_allclose(got[name][k], want[name][k], err_msg=f"{name}/{k}",
                                       **(noise_means if k == "mean" else TIGHT_BN))
    jctx.flush()
    tctx.flush()
    emb_atol, state_rtol = ENTRY_F32
    for js, ts in zip(jstores, tstores):
        assert js.size() == ts.size() > 0
        for shard in js._shards:
            for sign, (_, vec) in shard.entries.items():
                got = ts.get_embedding_entry(sign)
                np.testing.assert_allclose(got[:DIM], vec[:DIM], rtol=0, atol=emb_atol, err_msg=str(sign))
                np.testing.assert_allclose(got[DIM:], vec[DIM:], rtol=state_rtol, atol=0, err_msg=str(sign))
    # eval normalises with the running statistics, where the noise biases
    # do not cancel: the port takes the reference's state (its bytes) first
    cached_state_from_flax_bytes(tctx.state, flax.serialization.to_bytes(jctx.state))
    stats = batch_stats_to_flax(tctx.model)
    eval_b = batches[5]
    np.testing.assert_allclose(tctx.eval_batch(eval_b),
                               np.asarray(jctx.eval_batch(jdata.PersiaBatch.from_bytes(eval_b.to_bytes()))),
                               **TIGHT_BN)
    after = batch_stats_to_flax(tctx.model)
    for name in stats:
        for k in ("mean", "var"):
            np.testing.assert_array_equal(after[name][k], stats[name][k])


# --------------------------------- (d), (e): against the reference's cached ctx


def _pair_weights():
    model = DLRM(DENSE, 2, DIM, (16, DIM), (32, 16), compute_dtype=torch.float32, device="cpu")
    return seeded_flax_params_like(model, 11)


def _jax_ctx(stores, params=None, cache_rows=64):
    """The reference's ctx (DLRM in f32, Adam(1e-3), Adagrad(0.1)); its
    state set from ``params`` where given (else left to ``init_state``)."""
    cfg = _cfg(jcfg)
    ctx = jhbm.CachedTrainCtx(JaxDLRM(embedding_dim=DIM, bottom_mlp=(16, DIM), top_mlp=(32, 16),
                                      compute_dtype=jnp.float32), optax.adam(1e-3), joptim.Adagrad(lr=0.1),
                              JaxWorker(cfg, stores), cfg, cache_rows=cache_rows).__enter__()
    if params is not None:
        p = jax.tree.map(jnp.asarray, params)
        tables, emb_state = jhbm.init_cached_tables(ctx.tier.groups, ctx.sparse_cfg)
        ctx.state = jhbm.CachedTrainState(params=p, batch_stats={}, opt_state=optax.adam(1e-3).init(p), tables=tables,
                                          emb_state=emb_state, emb_batch_state=jnp.ones((2,), jnp.float32),
                                          step=jnp.zeros((), jnp.int32))
    return ctx


def _port_ctx(stores, params=None, cache_rows=64):
    cfg = _cfg(tcfg)
    model = DLRM(DENSE, 2, DIM, (16, DIM), (32, 16), compute_dtype=torch.float32, device="cpu")
    ctx = thbm.CachedTrainCtx(model, torch.optim.Adam(model.parameters(), lr=1e-3), toptim.Adagrad(lr=0.1),
                              EmbeddingWorker(cfg, stores), cfg, cache_rows=cache_rows, device="cpu").__enter__()
    if params is not None:
        ctx.init_state()
        zeros = jax.tree.map(np.zeros_like, params)
        cached_dense_from_flax(ctx.state, params, zeros, zeros, np.zeros((), np.int32))
    return ctx


def _jax_stores():
    return [JaxStore(capacity=1 << 16, num_internal_shards=4, seed=7) for _ in range(2)]


def _pair_batches():
    jb = [jdata.PersiaBatch.from_bytes(b.to_bytes()) for b in _batches(8, seed=13)]
    return jb, [tdata.PersiaBatch.from_bytes(b.to_bytes()) for b in jb]


def _assert_decisions(jrec, trec, C):
    assert len(jrec) == len(trec) > 0
    for i, (j, t) in enumerate(zip(jrec, trec)):
        jd, td = _decisions(j, C, port=False), _decisions(t, C, port=True)
        assert set(jd) == set(td), i
        for g in jd:
            for k, v in jd[g].items():
                np.testing.assert_array_equal(np.asarray(td[g][k]), np.asarray(v), err_msg=f"step {i} {g} {k}")


def _assert_stores_close(jstores, tstores):
    for js, ts in zip(jstores, tstores):
        assert js.size() == ts.size() > 0
        for shard in js._shards:
            for sign, (_, vec) in shard.entries.items():
                np.testing.assert_allclose(ts.get_embedding_entry(sign), vec, err_msg=str(sign), **TIGHT)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_cross_package_stream_resume(tmp_path, direction):
    """One package's fenced stream (a 64-row cache: evictions and
    restores) commits a fence at step 4 and dies after step 6; each package
    resumes from that manifest over fresh stores and streams steps 4-7
    (``start_step=4``, a fence at 4 is not repeated): the directory's
    decisions bit for bit, every step's loss and, after flush, every server
    entry within 1e-5 relative, the step count 8 in both. The port reads
    the reference's dense bytes and writes them back unchanged."""
    jb, tb = _pair_batches()
    params = _pair_weights()
    root = str(tmp_path / "js")
    if direction == "jax_to_port":
        writer = _jax_ctx(_jax_stores(), params)
        writer.train_stream(jb[:6], snapshot_every=4, job_state=root)
    else:
        writer = _port_ctx(_stores(), params)
        _watch(lambda: writer.train_stream(tb[:6], snapshot_every=4, job_state=root))
    assert writer.stream_stats()["fences"] == 1 and writer._global_step == 6
    del writer
    m = tjob.JobStateManager(root).latest()
    assert m.step == 4 and m.read_json("cache.json")["pending_ledger_entries"] == 0

    jstores, tstores = _jax_stores(), _stores()
    jctx, tctx = _jax_ctx(jstores), _port_ctx(tstores)
    assert jctx.resume(jjob.JobStateManager(root)).step == 4
    assert tctx.resume(root).step == 4 and tctx.state is None  # deferred to init_state
    tctx.init_state()
    assert cached_state_to_flax_bytes(tctx.state) == m.read_blob("dense.state")
    jrec, trec = _record(jctx.tier), _record(tctx.tier)
    jl, tl = [], []
    jctx.train_stream(jb[4:], on_metrics=lambda r: jl.append(float(r["loss"])), start_step=4)
    _watch(lambda: tctx.train_stream(tb[4:], on_metrics=lambda r: tl.append(r["loss"]), start_step=4))
    assert jctx._global_step == tctx._global_step == 8
    _assert_decisions(jrec, trec, tctx.tier.groups[0].rows)
    assert tctx.tier.evictions > 0
    np.testing.assert_allclose(tl, jl, **TIGHT)
    jctx.flush()
    tctx.flush()
    _assert_stores_close(jstores, tstores)


@pytest.mark.parametrize("restore_ps", [True, False])
def test_sync_snapshot_and_resume_match_reference(tmp_path, restore_ps):
    """The synchronous path: 4 steps, ``snapshot_job``, 2 more steps (the
    crash), then a fresh ctx over the surviving servers ``resume``s
    (``restore_ps`` rewinds them, or keeps what the crash wrote) and trains
    steps 4-7. The reference's cached ctx does the same; the port does it
    twice, resuming before ``init_state`` (deferred) and after it: the two
    port runs bit for bit, each against the reference's losses and entries
    within 1e-5 relative; the step count 8."""
    jb, tb = _pair_batches()
    params = _pair_weights()

    def port_run(deferred):
        stores = _stores()
        root = str(tmp_path / f"port_{deferred}")
        ctx = _port_ctx(stores, params)
        assert ctx.resume(root) is None and ctx._job_epoch == 0
        for b in tb[:4]:
            ctx.train_step(b)
        m = ctx.snapshot_job(root)
        assert m.step == 4 and m.read_json("cache.json")["pending_ledger_entries"] == 0
        for b in tb[4:6]:
            ctx.train_step(b)
        ctx.drain()
        del ctx
        ctx = _port_ctx(stores)
        if not deferred:
            ctx.init_state()
        assert ctx.resume(root, restore_ps=restore_ps).step == 4
        assert (ctx.state is None) == deferred
        losses = [ctx.train_step(b)["loss"] for b in tb[4:]]
        assert ctx._global_step == 8
        ctx.flush()
        return losses, stores, cached_state_to_flax_bytes(ctx.state)

    (l0, s0, b0), (l1, s1, b1) = port_run(True), port_run(False)
    assert l0 == l1 and b0 == b1
    _assert_entries_equal(_entries(s0), _entries(s1))

    jstores = _jax_stores()
    jroot = jjob.JobStateManager(str(tmp_path / "jax"))
    jctx = _jax_ctx(jstores, params)
    jctx.resume(jroot)
    for b in jb[:4]:
        jctx.train_step(b)
    jctx.snapshot_job(jroot)
    for b in jb[4:6]:
        jctx.train_step(b)
    jctx.drain()
    jctx = _jax_ctx(jstores)
    assert jctx.resume(jroot, restore_ps=restore_ps).step == 4
    jl = [float(jctx.train_step(b)["loss"]) for b in jb[4:]]
    assert jctx._global_step == 8
    jctx.flush()
    np.testing.assert_allclose(l0, jl, **TIGHT)
    _assert_stores_close(jstores, s0)


# ------------------------------------------- (f), (g), (h): the fence's rules


@pytest.mark.parametrize("leak", ["ring", "pending_map"])
def test_fence_with_work_in_flight_raises(tmp_path, leak):
    """A ring span that is never freed, or a pending-map entry that is never
    removed: the fence at step 4 raises a ``RuntimeError`` naming what is
    left, the stream ends within ``JOIN_S`` and no lane is left running;
    nothing is committed."""
    ctx = _ctx(_stores())
    inner = ctx.tier.prepare_batch
    done = []

    def leaky(batch, **kw):
        out = inner(batch, **kw)
        if not done:
            done.append(1)
            if leak == "ring":
                kw["ring_alloc"]("cache_d8", 8)
            else:
                kw["pending_map"].insert_range(np.array([(1 << 60) + 1], np.uint64), 0, 999, salt=1)
        return out

    ctx.tier.prepare_batch = leaky
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="fence at step 4.*" + ("cache_d8" if leak == "ring" else "1 entries")):
        _watch(lambda: ctx.train_stream(_batches(8), snapshot_every=EVERY, job_state=str(tmp_path / "js")))
    assert time.perf_counter() - t0 < tstream.JOIN_S
    assert _lane_threads() == []
    assert tjob.JobStateManager(str(tmp_path / "js")).latest() is None


def test_fence_callback_exception_is_counted_and_the_stream_goes_on():
    """A callback raising ``Exception`` at every fence: each is counted, the
    stream finishes, and its result is bit for bit a run without fences
    (a fence without ``job_state`` changes nothing)."""
    def run(callback):
        stores = _stores()
        ctx = _ctx(stores)
        _watch(lambda: ctx.train_stream(_batches(), snapshot_every=3, fence_callback=callback))
        st = ctx.stream_stats()
        ctx.flush()
        return st, cached_state_to_flax_bytes(ctx.state), _entries(stores)

    seen = []

    def failing(step):
        seen.append(step)
        raise ValueError(f"control plane down at {step}")

    st, raw, entries = run(failing)
    st0, raw0, entries0 = run(None)
    assert seen == [3, 6, 9] and st["fences"] == 3 and st["fence_callback_errors"] == 3
    assert st0["fences"] == 0 and raw == raw0
    _assert_entries_equal(entries, entries0)


class _Crash(BaseException):
    pass


def test_fence_callback_base_exception_ends_the_stream():
    ctx = _ctx(_stores())

    def crash(step):
        raise _Crash(f"killed at the fence at {step}")

    t0 = time.perf_counter()
    with pytest.raises(_Crash, match="at 4"):
        _watch(lambda: ctx.train_stream(_batches(), snapshot_every=EVERY, fence_callback=crash))
    assert time.perf_counter() - t0 < tstream.JOIN_S
    assert _lane_threads() == []
    assert ctx._global_step == 4


@pytest.mark.parametrize("depth", [1, 3])
def test_fence_cadence_with_start_step(tmp_path, depth):
    """``start_step`` 5, ``snapshot_every`` 3, 10 batches: fences before
    global steps 6, 9 and 12 (never before the first batch), with a
    callback and no ``job_state`` (nothing committed) and with
    ``job_state`` (a manifest each, at those steps); the step count ends at
    15."""
    seen = []
    ctx = _ctx(_stores())
    _watch(lambda: ctx.train_stream(_batches(10), snapshot_every=3, start_step=5, fence_callback=seen.append,
                                    pipeline_depth=depth))
    assert seen == [6, 9, 12] and ctx._global_step == 15 and ctx.stream_stats()["fences"] == 3
    assert ctx._job_epoch is None

    ctx = _ctx(_stores())
    root = str(tmp_path / "js")
    _watch(lambda: ctx.train_stream(_batches(10), snapshot_every=3, start_step=5, job_state=root,
                                    pipeline_depth=depth))
    st = ctx.stream_stats()
    assert st["fences"] == 3 and st["pipeline_drains"] == 4 and ctx._global_step == 15
    parts = ("drain", "wb_drain", "flush", "ps_capture", "dense_bytes", "commit", "total")
    assert all(set(f) == set(parts) and min(f.values()) >= 0 for f in st["fence_ms"])
    m = tjob.JobStateManager(root).latest()
    assert m.step == 12 and m.job_epoch == 3 and ctx._job_epoch == 3
    # a snapshot-only cadence of 0 fences nothing
    ctx = _ctx(_stores())
    _watch(lambda: ctx.train_stream(_batches(4), snapshot_every=0, job_state=str(tmp_path / "none")))
    assert ctx.stream_stats()["fences"] == 0
