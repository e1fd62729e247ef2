"""The port's router (``persia_tpu_torch.embedding.worker.ShardedLookup``)
fans every call out across its parameter-server replicas at once through
its thread pool, as the reference's ``_concurrent`` does
(``persia_tpu/embedding/worker.py``):

- every fanned-out call (``lookup_groups``, ``update_groups`` with and
  without the apply-journal, ``lookup``, ``checkout_entries``,
  ``probe_entries`` with and without its out buffers, ``set_embedding``,
  ``advance_batch_state``) at 2, 3 and 128 replicas, on numpy and native
  stores: its results and every entry after it bit for bit those of the
  same router with the calls run inline, one replica after another, and
  of the reference's router over the reference's stores; the journal
  and batch-state counts the same;
- ``journal_skips`` and ``batch_advances`` exact under 4 threads calling
  at once;
- the pool: created with the router when it has more than one replica,
  sized ``min(32, 8 x replicas)``, shut down for good by ``close`` and by
  the ctx's exit (later calls run inline), and a process that never
  closes it exits without waiting; a call from the thread that made the
  router's last ``FANOUT_SOLE_CALLS`` calls fans out, its caller running
  the first part and taking back a part no pool thread has started; a
  call from a router that another thread (another lane, a pool thread)
  called among them runs inline; every one returns the same rows.

Every call that starts threads runs under ``run_with_watchdog`` (60 s).
"""

import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from persia_tpu.embedding import native_store as jns
from persia_tpu.embedding import optim as joptim
from persia_tpu.embedding.store import EmbeddingStore as JaxStore
from persia_tpu.embedding.worker import ShardedLookup as JaxLookup
import persia_tpu_torch.config as tcfg
from persia_tpu_torch.ctx import TrainCtx
from persia_tpu_torch.embedding import native_store as ns
from persia_tpu_torch.embedding import optim as toptim
from persia_tpu_torch.embedding.hashing import sign_to_shard
from persia_tpu_torch.embedding.store import EmbeddingStore
from persia_tpu_torch.embedding.worker import FANOUT_SOLE_CALLS, EmbeddingWorker, ShardedLookup
from persia_tpu_torch.jobstate import make_journal_id
from persia_tpu_torch.models import DLRM
from persia_tpu_torch.testing.watchdog import run_with_watchdog

STORES = {"numpy": (EmbeddingStore, JaxStore), "native": (ns.NativeEmbeddingStore, jns.NativeEmbeddingStore)}
OPTS = {"adagrad": lambda m: m.Adagrad(lr=0.1), "adam": lambda m: m.Adam(lr=0.01)}


class InlineLookup(ShardedLookup):
    """The router with its calls run inline, one replica after another:
    the serial loop the fan-out replaces."""

    def _concurrent(self, thunks):
        return [t() for t in thunks]


def _watch(fn, what="the router's calls"):
    return run_with_watchdog(fn, timeout=60.0, what=what)


def _replicas(backend, side, n, opt="adagrad"):
    cls = STORES[backend][0 if side == "port" else 1]
    mod = toptim if side == "port" else joptim
    return [cls(capacity=1 << 12, num_internal_shards=4, seed=5 + r, optimizer=OPTS[opt](mod).config)
            for r in range(n)]


def _keys(rng, n, space=1 << 40):
    return np.unique(rng.integers(1, space, n, dtype=np.uint64))


def _script(router, seed, journal=True):
    """A fixed sequence of every fanned-out call; returns what each returned."""
    rng = np.random.default_rng(seed)
    outs = []
    k8, k16 = _keys(rng, 300), _keys(rng, 200)
    outs += router.lookup_groups([(k8, 8), (k16, 16)], train=True)
    outs += router.lookup_groups([(k8[:0], 8), (k16[:5], 16)], train=True)
    router.advance_batch_state(0)
    router.update_groups([(k8, rng.normal(size=(len(k8), 8)).astype(np.float32), 0),
                          (k16, rng.normal(size=(len(k16), 16)).astype(np.float32), 0)])
    outs.append(router.lookup(k8[::3], 8, True))
    outs.append(router.lookup(_keys(rng, 50), 8, False))
    fresh = _keys(rng, 120)
    outs.append(router.checkout_entries(np.concatenate([k8[:60], fresh]), 8))
    outs.append(router.checkout_entries(k8[:0], 8))
    probe = np.concatenate([k8[60:140], _keys(rng, 70)])
    warm, vals = router.probe_entries(probe, 8)
    outs += [warm, vals[warm]]
    vbuf, wbuf = np.full((len(probe) + 3, vals.shape[1]), -1, np.float32), np.zeros(len(probe) + 3, np.uint8)
    warm2, vals2 = router.probe_entries(probe, 8, vals_out=vbuf, warm_out=wbuf)
    outs += [warm2.copy(), vals2[:len(probe)][warm2].copy()]
    put = _keys(rng, 90)
    router.set_embedding(put, rng.normal(size=(len(put), vals.shape[1])).astype(np.float32), 8)
    outs.append(router.lookup(put, 8, True))
    if journal:
        g = [(k8[:100], rng.normal(size=(100, 8)).astype(np.float32), 0)]
        for step in (1, 2, 1):  # the third replays step 1: every replica skips it
            router.advance_batch_state(0)
            router.update_groups(g, journal_id=make_journal_id(0, step))
    outs.append(router.lookup(np.concatenate([k8, k16[:0]]), 8, True))
    return outs, np.concatenate([k8, fresh, probe, put]), k16


def _entries(replicas, signs):
    return [[r.get_embedding_entry(int(s)) for s in signs] for r in replicas]


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, list):
            _same(x, y)
        elif x is None or y is None:
            assert x is None and y is None
        else:
            x, y = np.asarray(x), np.asarray(y)
            assert x.shape == y.shape and x.dtype == y.dtype
            assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("backend", ["numpy", "native"])
@pytest.mark.parametrize("n", [2, 3, 128])
def test_fanout_is_the_serial_loop_and_the_references(backend, n):
    opt = "adam" if n == 3 else "adagrad"
    runs = {}
    for name, make in (("fan", lambda: ShardedLookup(_replicas(backend, "port", n, opt))),
                       ("inline", lambda: InlineLookup(_replicas(backend, "port", n, opt))),
                       ("ref", lambda: JaxLookup(_replicas(backend, "ref", n, opt)))):
        router = make()
        outs, signs, k16 = _watch(lambda: _script(router, seed=n))
        runs[name] = (router, outs, _entries(router.replicas, signs) + _entries(router.replicas, k16))
        if name != "ref":
            router.close()
    fan, inline, ref = runs["fan"], runs["inline"], runs["ref"]
    assert fan[0]._fan_pool is None and inline[0]._fan_pool is None  # closed
    for other in (inline, ref):
        _same(fan[1], other[1])
        _same(fan[2], other[2])
        assert fan[0].journal_skips == other[0].journal_skips
        assert fan[0].batch_advances == other[0].batch_advances
    # the replayed step skips on every replica that owns one of its keys
    replayed = np.random.default_rng(n)
    assert fan[0].journal_skips == len(set(sign_to_shard(_keys(replayed, 300)[:100], n).tolist()))
    assert fan[0].batch_advances == {0: 4}


def test_single_replica_runs_inline():
    router = ShardedLookup(_replicas("numpy", "port", 1))
    assert router._fan_pool is None
    outs, _, _ = _script(router, seed=1)
    assert not router._callers  # no call reached the fan-out
    assert router.journal_skips == 1 and router.batch_advances == {0: 4}
    _same(outs, _script(JaxLookup(_replicas("numpy", "ref", 1)), seed=1)[0])


def test_pool_size_and_close():
    for n, size in ((2, 16), (3, 24), (4, 32), (128, 32)):
        router = ShardedLookup(_replicas("numpy", "port", n))
        pool = router._fan_pool
        assert pool._max_workers == size
        keys = _keys(np.random.default_rng(n), 500)
        _watch(lambda: [router.lookup(keys, 8, True) for _ in range(FANOUT_SOLE_CALLS + 1)])  # the last fans out
        threads = set(pool._threads)
        assert threads
        router.close()
        assert router._fan_pool is None and not any(t.is_alive() for t in threads)
        got = _watch(lambda: [router.lookup(keys, 8, True) for _ in range(FANOUT_SOLE_CALLS + 1)])[-1]  # inline: no pool
        assert router._fan_pool is None
        np.testing.assert_array_equal(got, InlineLookup(router.replicas).lookup(keys, 8, True))
        router.close()


def test_ctx_exit_closes_the_pool():
    slots = {f"s{i}": tcfg.SlotConfig(dim=8) for i in range(2)}
    cfg = tcfg.EmbeddingConfig(slots_config=slots, feature_index_prefix_bit=8)
    worker = EmbeddingWorker(cfg, _replicas("numpy", "port", 3))
    model = DLRM(2, 2, 8, (8,), (8,), device="cpu")
    with TrainCtx(model, torch.optim.Adam(model.parameters()), toptim.Adagrad(lr=0.1), worker, cfg, device="cpu"):
        assert worker.lookup_router._fan_pool is not None
    assert worker.lookup_router._fan_pool is None


@pytest.mark.parametrize("backend", ["numpy", "native"])
def test_counts_exact_under_concurrent_callers(backend):
    """4 threads, each 6 journaled gradient batches applied twice (the
    second skipped on every replica it reaches) and 6 advances: the counts
    are exactly the serial sums, and every entry is the serial run's."""
    n, threads, rounds = 3, 4, 6
    rng = np.random.default_rng(7)
    work = [[(k, rng.normal(size=(len(k), 8)).astype(np.float32)) for k in (_keys(rng, 64) for _ in range(rounds))]
            for _ in range(threads)]

    def caller(router, t, barrier):
        barrier.wait(timeout=30)
        for i, (k, g) in enumerate(work[t]):
            jid = make_journal_id(0, 1 + t * rounds + i)
            router.update_groups([(k, g, 0)], journal_id=jid)
            router.update_groups([(k, g, 0)], journal_id=jid)
            router.advance_batch_state(t % 2)

    def run(router, concurrent):
        if not concurrent:
            for t in range(threads):
                caller(router, t, threading.Barrier(1))
            return
        barrier = threading.Barrier(threads)
        ts = [threading.Thread(target=caller, args=(router, t, barrier)) for t in range(threads)]
        for th in ts:
            th.start()
        for th in ts:
            th.join(timeout=50)
        assert not any(th.is_alive() for th in ts)

    fan = ShardedLookup(_replicas(backend, "port", n))
    serial = InlineLookup(_replicas(backend, "port", n))
    _watch(lambda: run(fan, True), "4 concurrent callers")
    run(serial, False)
    fan.close()
    expected_skips = sum(len(set(sign_to_shard(k, n).tolist())) for t in range(threads) for k, _ in work[t])
    assert fan.journal_skips == serial.journal_skips == expected_skips
    assert fan.batch_advances == serial.batch_advances == {0: 2 * rounds, 1: 2 * rounds}
    signs = np.concatenate([k for t in range(threads) for k, _ in work[t]])
    _same(_entries(fan.replicas, signs), _entries(serial.replicas, signs))


def test_unclosed_pool_does_not_hold_the_process_at_exit():
    code = ("import numpy as np\n"
            "from persia_tpu_torch.embedding.store import EmbeddingStore\n"
            "from persia_tpu_torch.embedding.worker import ShardedLookup\n"
            "r = ShardedLookup([EmbeddingStore(capacity=1 << 10, num_internal_shards=2, seed=i) for i in range(128)])\n"
            "r.lookup(np.arange(1, 5000, dtype=np.uint64), 8, True)\n"
            "print('done', flush=True)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=50,
                         cwd=pathlib.Path(__file__).resolve().parent.parent)
    assert out.returncode == 0 and out.stdout.strip() == "done", out.stderr


def _gated_pair():
    """A router over 2 numpy replicas, keys on both, their rows admitted,
    and a log of (replica, thread) for every later ``lookup``."""
    stores = _replicas("numpy", "port", 2)
    router = ShardedLookup(stores)
    keys = _keys(np.random.default_rng(3), 400)
    assert len(set(sign_to_shard(keys, 2).tolist())) == 2
    warm = router.lookup(keys, 8, True)
    seen = []
    for r, st in enumerate(stores):
        def logged(keys_, dim, train, r=r, original=st.lookup):
            seen.append((r, threading.current_thread()))
            return original(keys_, dim, train)

        st.lookup = logged
    return router, stores, keys, warm, seen


def _wait_for(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.001)
    return True


def test_caller_takes_back_a_part_no_pool_thread_started():
    """With every pool thread held, a fanned-out call runs its parts on
    the calling thread and returns: it never waits on a hand-off."""
    router, _, keys, warm, seen = _gated_pair()
    release = threading.Event()

    def body():
        for _ in range(FANOUT_SOLE_CALLS):  # this thread makes the router's last calls
            router.lookup(keys, 8, False)
        holds = [router._fan_pool.submit(release.wait, 30) for _ in range(router._fan_pool._max_workers)]
        try:
            got = router.lookup(keys, 8, False)
        finally:
            release.set()
        np.testing.assert_array_equal(got, warm)
        assert [r for r, _ in seen] == [0, 1] * (FANOUT_SOLE_CALLS + 1)
        assert all(t is threading.current_thread() for _, t in seen)
        assert all(h.result(timeout=30) for h in holds)

    _watch(body, "a call with its pool held")
    router.close()


def test_concurrent_callers_and_a_nested_call():
    """A thread's call after its ``FANOUT_SOLE_CALLS`` calls fans out, its
    other part on a pool thread; while its own part waits, a call from
    another thread runs inline beside it; a call from a pool thread runs
    inline; all return the same rows."""
    router, stores, keys, warm, seen = _gated_pair()
    hold, started, release = threading.Event(), threading.Event(), threading.Event()
    logged = stores[0].lookup

    def gated(keys_, dim, train):
        if hold.is_set() and not started.is_set():  # the fanned-out call's own part waits
            started.set()
            release.wait(30)
        return logged(keys_, dim, train)

    stores[0].lookup = gated

    def first_caller(out):
        # inline: another thread made the router's earlier calls
        out["warm-up"] = [router.lookup(keys, 8, False) for _ in range(FANOUT_SOLE_CALLS)]
        seen.clear()
        hold.set()
        out["first"] = router.lookup(keys, 8, False)

    def body():
        out = {}
        first = threading.Thread(target=first_caller, args=(out,))
        first.start()
        assert started.wait(30)
        assert _wait_for(lambda: len(seen) == 1)  # its other part, on a pool thread
        got = router.lookup(keys, 8, False)  # beside the first call, from another thread
        release.set()
        first.join(30)
        assert not first.is_alive()
        for rows in (got, out["first"], *out["warm-up"]):
            np.testing.assert_array_equal(rows, warm)
        me = threading.current_thread()
        assert seen[0][0] == 1 and seen[0][1] not in (me, first)
        assert seen[1:] == [(0, me), (1, me), (0, first)]
        nested = router._fan_pool.submit(router.lookup, keys, 8, False).result(timeout=30)
        np.testing.assert_array_equal(nested, warm)
        (r0, t0), (r1, t1) = seen[4:]  # inline, both parts on the pool thread that called
        assert (r0, r1) == (0, 1) and t0 is t1 and t0 not in (me, first)

    _watch(body, "two callers of one router")
    router.close()
