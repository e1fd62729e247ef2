"""The port's stage graph (``persia_tpu_torch/parallel/stage_graph.py``: the
window ``FusedPipeline`` uses, and the hazard ledger the cache tier's
pipelined stream uses) run through the same scenarios as the reference's
(``persia_tpu/parallel/stage_graph.py``, ``tests/test_stage_graph.py``'s
unit cases), each case on both; and the port's ``FusedPipeline`` against
its step loop and against the reference's pipelined drive. The cache
tier's pipelined stream is held in ``tests/test_torch_hbm_stream.py``."""

import threading
import time

import numpy as np
import pytest
import torch

import persia_tpu.embedding  # noqa: F401  (imports persia_tpu.ops in the order it needs)
from persia_tpu.parallel import stage_graph as jsg
from persia_tpu_torch.parallel import stage_graph as tsg

MODULES = pytest.mark.parametrize("sg", [jsg, tsg], ids=["reference", "port"])


def reserve(g, seq, **kw):
    """``reserve_feed`` with empty hazard row sets."""
    return g.reserve_feed(seq, {}, {}, **kw)


def test_port_defaults_are_no_rows():
    """``FusedPipeline``'s call, no row sets, enters a feed that is no
    barrier: a second feed follows it into the window."""
    g = tsg.StageGraph(2)
    assert g.reserve_feed(0) and g.reserve_feed(1, {"g": np.array([1])}, {})
    assert g.stalls == 0


@MODULES
def test_rows_intersect_edges(sg):
    srt = np.array([3, 5, 9], dtype=np.int64)
    assert sg._rows_intersect(srt, np.array([9]))
    assert sg._rows_intersect(srt, np.array([1, 3]))
    assert sg._rows_intersect(srt, np.array([5]))
    assert not sg._rows_intersect(srt, np.array([2, 4, 10]))
    assert not sg._rows_intersect(srt, np.array([], dtype=np.int64))
    assert not sg._rows_intersect(np.array([], dtype=np.int64), np.array([1]))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_rows_intersect_matches_reference_on_random_sets(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        srt = np.sort(rng.integers(0, 200, rng.integers(0, 40)))
        probe = rng.integers(0, 200, rng.integers(0, 40))
        assert tsg._rows_intersect(srt, probe) == jsg._rows_intersect(srt, probe) == bool(np.isin(probe, srt).any())


def test_feed_hazard_info_matches_reference():
    """The reference's case (``tests/test_stage_graph.py``) and a seeded
    one, each through both: the same feed and trained sets. The port's
    ``evict_aux`` carries (rows, unclaimed slots), the reference's the rows
    alone; its miss and cold pieces carry a slot array more."""
    di = {"stacked_rows": {"g0": np.array([[4, 7], [1, 4]])}, "raw_rows": {"slot_b": np.array([9, 2])}}
    miss = {"g0": (np.array([11, 12]), None)}
    cold = {"g0": (np.array([13]), None)}
    evict = {"g0": np.array([14, 15]), "g1": np.array([], dtype=np.int64)}
    rng = np.random.default_rng(7)
    di2 = {"stacked_rows": {"g0": rng.integers(0, 90, (3, 16, 1)), "g1": rng.integers(0, 90, (2, 16, 4))},
           "raw_rows": {"r": rng.integers(0, 90, (16, 5))}}
    miss2 = {"g1": (rng.integers(0, 90, 8), None)}
    cold2 = {"g0": (rng.integers(0, 90, 16), None)}
    evict2 = {"g0": rng.integers(0, 90, 8), "g1": rng.integers(0, 90, 16)}
    for inputs, m, c, e, slot_group in ((di, miss, cold, evict, {"slot_b": "g1"}),
                                        (di2, miss2, cold2, evict2, {"r": "g1"})):
        want = jsg.feed_hazard_info(inputs, m, c, e, slot_group)
        port = {g: (v, np.full(4, -1, np.int32)) for g, v in e.items()}
        slots = lambda d: {g: (v[0], v[1], np.full(len(v[0]), -1, np.int32)) for g, v in d.items()}  # noqa: E731
        got = tsg.feed_hazard_info(inputs, slots(m), slots(c), port, slot_group)
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])
    feed, trained = tsg.feed_hazard_info(di, miss, cold, {g: (v, v[:0]) for g, v in evict.items()}, {"slot_b": "g1"})
    assert set(feed) == {"g0"} and sorted(feed["g0"].tolist()) == [11, 12, 13, 14, 15]
    assert trained["g0"].tolist() == [1, 4, 4, 7] and trained["g1"].tolist() == [2, 9]


@MODULES
def test_reserve_stalls_on_hazard_until_dense_retires(sg):
    g = sg.StageGraph(4)
    assert g.reserve_feed(0, {"g": np.array([1])}, {"g": np.array([5, 6])})
    res = []
    t = threading.Thread(target=lambda: res.append(g.reserve_feed(1, {"g": np.array([5])}, {"g": np.array([7])})))
    t.start()
    time.sleep(0.12)
    assert not res, "feed hoisted over an in-flight dense training row 5"
    g.note_dense(0)
    t.join(2.0)
    assert res == [True]
    assert g.stalls == 1  # counted once, not per wait retry
    assert g.reserve_feed(2, {"g": np.array([6]), "h": np.array([7])}, {})  # 6 retired; 7 only h's
    assert g.stalls == 1


@MODULES
def test_barrier_blocks_every_later_feed(sg):
    g = sg.StageGraph(4)
    assert g.reserve_feed(0, None, None, barrier=True)
    res = []
    t = threading.Thread(target=lambda: res.append(g.reserve_feed(1, {"g": np.array([99])}, {})))
    t.start()
    time.sleep(0.12)
    assert not res, "feed hoisted across a barrier step"
    g.note_dense(0)
    t.join(2.0)
    assert res == [True] and g.stalls == 1
    assert g.reserve_feed(2, None, None, barrier=True)  # a barrier waits only for room
    assert g.stalls == 1


def _replay_window_rules(sg):
    """A seeded sequence of feeds, barriers and retirements on one graph:
    each reservation's outcome (a blocked one gives up after one 0.05-s
    wait) and the stall count."""
    rng = np.random.default_rng(3)
    g = sg.StageGraph(3)
    log, inflight, seq = [], [], 0
    for _ in range(40):
        if inflight and (len(inflight) == 3 or rng.random() < 0.3):
            g.note_dense(inflight.pop(0))
            log.append("retire")
            continue
        barrier = rng.random() < 0.15
        feed = None if barrier else {"g": rng.integers(0, 40, 3)}
        trained = None if barrier else {"g": np.sort(rng.integers(0, 40, 4))}
        calls = iter([False])
        ok = g.reserve_feed(seq, feed, trained, should_abort=lambda: next(calls, True), barrier=barrier)
        log.append((seq, ok))
        if ok:
            inflight.append(seq)
        seq += 1
    return log, g.stalls


def test_window_rules_replay_equal():
    """The same sequence through both graphs: the same reservations go
    through, the same stall."""
    want, got = _replay_window_rules(jsg), _replay_window_rules(tsg)
    assert got == want
    assert want[1] > 0 and any(ok is False for e in want[0] if isinstance(e, tuple) for ok in e[1:])


@MODULES
def test_window_capacity_is_the_depth(sg):
    g = sg.StageGraph(2)
    assert reserve(g, 0)
    assert reserve(g, 1)
    res = []
    t = threading.Thread(target=lambda: res.append(reserve(g, 2)))
    t.start()
    time.sleep(0.12)
    assert not res, "window exceeded depth"
    g.note_dense(0)
    t.join(2.0)
    assert res == [True]
    if sg is jsg:
        assert g.stalls == 0  # capacity waits are back-pressure, not hazard stalls


@MODULES
def test_note_dense_retires_through_seq(sg):
    g = sg.StageGraph(4)
    for s in range(3):
        assert reserve(g, s)
    g.note_dense(1)  # a packed window retires its whole range at once
    with pytest.raises(RuntimeError, match="still"):
        g.drain_for_fence(1)
    g.note_dense(2)
    g.drain_for_fence(2)
    assert g.drains == 1


@MODULES
def test_drain_raises_on_inflight_feed(sg):
    g = sg.StageGraph(2)
    g.drain_for_fence(0)
    assert reserve(g, 1)
    with pytest.raises(RuntimeError, match="still"):
        g.drain_for_fence(1)
    g.note_dense(1)
    g.drain_for_fence(1, reason="end")
    assert g.drains == 2


@MODULES
def test_abort_unblocks_reserve(sg):
    g = sg.StageGraph(1)
    assert reserve(g, 0)
    res = []
    t = threading.Thread(target=lambda: res.append(reserve(g, 1)))
    t.start()
    g.abort()
    t.join(2.0)
    assert res == [False]
    assert reserve(g, 2, should_abort=lambda: True) is False


@MODULES
def test_lane_overlap_stats(sg):
    now = [0.0]
    g = sg.StageGraph(2, clock=lambda: now[0])

    def spend(stage, dt):
        with g.lane(stage):
            now[0] += dt

    spend("feed", 2.0)
    spend("dense", 6.0)
    st = g.stats(wall_s=6.0)  # 2 s of feed hidden under 6 s of dense
    want = {
        "pipeline_depth": 2, "pipeline_drains": 0, "pipeline_stalls": 0,
        "stage_wall_s": {"feed": 2.0, "dense": 6.0, "psgrad": 0.0},
        "stage_overlap_frac": pytest.approx(0.25),
    }
    assert st == want
    assert sg.StageGraph(1, clock=lambda: now[0]).stats(wall_s=0.0)["stage_overlap_frac"] == 0.0


def test_fused_pipeline_window_bounds_staged_batches():
    """The stage graph's window is the pipeline's one bound: with depth 2
    the feed thread stages at most two batches ahead of the dense stage."""
    from persia_tpu_torch.parallel.fused_step import FusedPipeline

    staged, ahead = [], []

    class Counting(FusedPipeline):
        def _stage(self, b, stream):
            staged.append(b)
            return super()._stage(b, stream)

    def step(state, batch):
        time.sleep(0.02)  # a slow dense stage: the feed runs ahead until the window is full
        ahead.append(len(staged) - len(ahead))
        return state, (torch.zeros(()), None)

    batch = {"dense": [np.zeros((2, 1), np.float32)], "labels": [np.zeros((2, 1), np.float32)],
             "ids": {"a": np.zeros(2, np.int32)}}
    pipe = Counting(step, depth=2, device="cpu")
    _, losses = pipe.run(None, [batch] * 8)
    assert len(losses) == 8
    assert max(ahead) == 2, ahead  # the dense batch itself and one staged behind it
    assert pipe.stats()["pipeline_drains"] == 1


@pytest.mark.parametrize("depth,k", [(2, 1), (3, 2)])
def test_fused_pipeline_matches_reference_and_step_loop(depth, k):
    """The port's pipeline (host arrays staged by its feed thread) against
    the reference's pipeline on the same batches (losses to rtol 1e-5,
    state to rtol 1e-5, atol 1e-6), and against the port's own step loop
    (bit for bit)."""
    import optax
    from test_torch_fused_step import OPTIMIZERS, TIGHT, _assert_states_close, _host_batch, _jb, _pair, _tb

    from persia_tpu.embedding import optim as jopt
    from persia_tpu.parallel import fused_step as jfs
    from persia_tpu_torch.embedding import optim as topt
    from persia_tpu_torch.parallel import fused_step as tfs
    from persia_tpu_torch.weights import fused_state_to_flax

    (jstate, _, jmodel, specs_j), (tstate, _, specs_t) = _pair("adagrad", True, raw=False)
    jpipe = jfs.build_fused_pipeline(jmodel, optax.adam(1e-3), OPTIMIZERS["adagrad"](jopt).config, specs_j,
                                     stack=True, depth=depth, k=k)
    tpipe = tfs.build_fused_pipeline(OPTIMIZERS["adagrad"](topt).config, specs_t, stack=True, depth=depth, k=k,
                                     device="cpu")
    hosts = [_host_batch(30 + i, raw=False) for i in range(6)]
    jstate, jlosses = jpipe.run(jstate, [_jb(h) for h in hosts])
    tstate, tlosses = tpipe.run(tstate, iter(hosts))
    np.testing.assert_allclose(torch.stack(tlosses).numpy(), np.array([float(x) for x in jlosses]), rtol=1e-5)
    _assert_states_close(jstate, tstate, **TIGHT)
    assert tpipe.stats()["pipeline_drains"] == 1

    _, (loop_state, step, _) = _pair("adagrad", True, raw=False)
    for h in hosts:
        step(loop_state, _tb(h))
    for a, b in zip(fused_state_to_flax(loop_state)[1], fused_state_to_flax(tstate)[1]):
        np.testing.assert_array_equal(a, b)
