"""The port's stage graph (``persia_tpu_torch/parallel/stage_graph.py``, the
window ``FusedPipeline`` uses) run through the same scenarios as the
reference's (``persia_tpu/parallel/stage_graph.py``), each case on both;
and the port's ``FusedPipeline`` against its step loop and against the
reference's pipelined drive."""

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
    """``reserve_feed`` with no hazard rows: the reference takes empty row
    sets, the port (which has no hazard ledger) takes none."""
    if isinstance(g, jsg.StageGraph):
        return g.reserve_feed(seq, {}, {}, **kw)
    return g.reserve_feed(seq, **kw)


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
        "pipeline_depth": 2, "pipeline_drains": 0,
        "stage_wall_s": {"feed": 2.0, "dense": 6.0},
        "stage_overlap_frac": pytest.approx(0.25),
    }
    if sg is jsg:  # the hazard ledger's stalls and the PS gradient lane
        want.update(pipeline_stalls=0, stage_wall_s={**want["stage_wall_s"], "psgrad": 0.0})
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
