"""The divergent-replica dense algorithms in the port
(``persia_tpu_torch/parallel/grad_sync.py``: ``Decentralized``,
``LocalSGD``, ``QAdam``, ``LowPrecisionDecentralized`` on
``build_sync_train_step``, with ``replicate_for_local``,
``collapse_local``, ``init_sync_opt_state``'s algorithm state and K18's
plain version ``lp_ring_mix_reference``) against the reference's
``build_sync_train_step`` on a CPU mesh of the same size (the conftest's
virtual CPU devices), at n in {1, 2, 4} ranks.

The port runs as n gloo ranks (``testing.dense_sync.divergent_rank``
through ``run_function``: one spawn a world size for every case, a
timeout on each); both sides train DLRM (and one DNN case) from the same
seeded weights (the port's ranks but 0 from other weights, until
``replicate_for_local`` hands them rank 0's) over the same host batches
(32 rows, a host-pooled and a raw slot), Adam(3e-3) (QAdam its own).
Checked:

- each step's loss and each rank's flat parameters after each step
  against the reference's (its row i for the local algorithms), and the
  last step's predictions and embedding gradients;
- QAdam's m, v and this rank's residual, LowPrecisionDecentralized's
  three shadows and residual against the reference's trees (row i);
- LowPrecisionDecentralized's ``shadow_left`` on rank i bit for bit
  ``shadow_self`` on rank i - 1; LocalSGD's ranks the same bits right
  after a sync step and not between syncs; Decentralized at period 2
  alternating by the sync's ordinal;
- QAdam within its warmup equal to "f32" with Adam, and ``warmup_steps=0``
  refused; ``collapse_local`` bit for bit the reference's on the same
  rows; DNN (Decentralized, n = 2): each rank's batch statistics against
  the reference's rows;
- ``lp_ring_mix_reference`` against ``lp_ring_sync``'s arithmetic in JAX.

Tolerances, at 3-6x the readings on the CPU (the readings in
brackets). Losses 1e-6 relative [2.4e-7]; parameters 3e-6 absolute
[7.5e-7: the gradients' sums and Adam's arithmetic in another order];
the last header and the embedding gradients 5e-6 [1.3e-6]. Where K15's
int8 codes enter, a code can flip at a rounding midpoint between the two
packages (their inputs differ by ulps; XLA multiplies by a rounded 1/127
and contracts into FMAs), which moves a value by a whole quantization
step of its leaf: LowPrecisionDecentralized's parameters 1e-4 [2.7e-5],
shadows and residual 2e-4 [6.0e-5]; QAdam after its warmup (v frozen at
one step's squared gradient, so an element whose gradient was 0 then moves
by ``lr * m / eps``, to |p| ~ 2.5e3 here) its parameters 2e-2 relative
[6.2e-3], the losses 5e-6 [1.2e-6], the header and the gradients 6e-5
[2.0e-5], m 6e-4 [1.8e-4], v 3e-3 relative [9.3e-4] and the residual
5e-4 [1.2e-4]. DNN's biases that feed a batch norm get no gradient but
rounding noise, which Adam turns into up to lr a step: held to 2 lr a
step ([3.0e-3] after 3 steps of lr 3e-3, as ``test_torch_fused_models``'s
``BN_FED``); its batch statistics 1e-4 [2.7e-5]. QAdam within its warmup
against Adam 1e-6 [1.8e-7: Adam's ``lr / bc1`` and ``sqrt(v) /
sqrt(bc2)`` against QAdam's quotients]. K18's plain version against JAX's
arithmetic within an ulp of the shadows (XLA may multiply by a rounded
1/127) and 2 ulps of x.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

from persia_tpu.models import DLRM as JaxDLRM
from persia_tpu.models import DNN as JaxDNN
from persia_tpu.parallel import data_parallel_mesh as jax_mesh
from persia_tpu.parallel import grad_sync as jgs
from persia_tpu.parallel.train_step import TrainState as JaxTrainState
from persia_tpu.parallel.train_step import replicate_state, shard_device_batch
from persia_tpu_torch.ops.lp_ring import lp_ring_mix, lp_ring_mix_reference
from persia_tpu_torch.parallel import grad_sync as tgs
from persia_tpu_torch.testing import dense_sync as tds

SPEC = tds.SPEC
WORLDS = (1, 2, 4)
STEPS, SEED = 3, 21
ULP = 2.0 ** -23
LOSS_TOL = dict(rtol=1e-6, atol=0)
PARAM_ATOL = 3e-6
OUT_TOL = dict(rtol=0, atol=5e-6)
WARMUP_ATOL = 1e-6
# where K15's codes enter (the module's docstring)
LP_PARAM_ATOL, LP_STATE_ATOL = 1e-4, 2e-4
QADAM_PARAM_RTOL, QADAM_LOSS_TOL, QADAM_OUT_TOL = 2e-2, dict(rtol=5e-6, atol=0), dict(rtol=0, atol=6e-5)
QADAM_STATE_TOL = {"m": dict(rtol=0, atol=6e-4), "v": dict(rtol=3e-3, atol=0), "residual": dict(rtol=0, atol=5e-4)}
DNN_STATS_ATOL = 1e-4
BN_FED = (("Dense_0", "bias"), ("Dense_1", "bias"))  # DNN's biases that feed a batch norm

# (name, algorithm kwargs) of the cases every world size runs
CASES = {
    "decentralized": ("decentralized", {}),
    "local_sgd": ("local_sgd", {"period": 2}),
    "qadam": ("qadam", {"lr": SPEC["lr"], "warmup_steps": 1}),
    "lp": ("lp", {}),
}
# n = 4 only: Decentralized syncing every second step (its direction by the
# sync's ordinal), over 5 steps
DEC2 = ("decentralized", {"period": 2})
DEC2_STEPS = 5
# n = 2 only: DNN, and QAdam within its warmup beside "f32" with Adam
DNN_N = 2
WARMUP_N = 2


def _jax_algorithm(name, kw):
    return {"decentralized": jgs.Decentralized, "local_sgd": jgs.LocalSGD, "qadam": jgs.QAdam,
            "lp": jgs.LowPrecisionDecentralized}[name](**kw)


def _rows(tree, n, local):
    """Each replica's flat row of a reference tree ((n, ...) leaves where
    ``local``, else the one replicated tree)."""
    if not local:
        flat = np.asarray(ravel_pytree(tree)[0])
        return [flat] * n
    return [np.asarray(ravel_pytree(jax.tree.map(lambda x, i=i: x[i], tree))[0]) for i in range(n)]


def _jax_run(n, name, kw, steps=STEPS, model="dlrm"):
    """The reference's ``build_sync_train_step`` on n CPU devices from the
    port's rank-0 weights, over ``tds.host_batches``: each step's loss and
    each replica's flat parameters, the last header and packed gradients,
    the algorithm state's rows, the batch statistics."""
    mesh = jax_mesh(n)
    if model == "dnn":
        _m, params, stats = tds.dnn_model(SPEC)
        jmodel = JaxDNN(dense_mlp_size=16, sparse_mlp_size=32, hidden_sizes=(32, 16), compute_dtype=jnp.float32)
    else:
        _m, params = tds.model_and_params(SPEC)
        stats = {}
        jmodel = JaxDLRM(embedding_dim=SPEC["dim"], bottom_mlp=SPEC["bottom"], top_mlp=SPEC["top"],
                         compute_dtype=jnp.float32)
    algo = _jax_algorithm(name, kw)
    qadam = name == "qadam"
    opt = None if qadam else optax.adam(SPEC["lr"])
    jparams = jax.tree.map(jnp.asarray, params)
    state = JaxTrainState(params=jparams, batch_stats=jax.tree.map(jnp.asarray, stats),
                          opt_state=(optax.sgd(0.0) if qadam else opt).init(jparams), step=jnp.zeros((), jnp.int32),
                          loss_scale=None)
    local = not qadam
    algo_state = None
    if qadam:
        state = replicate_state(state, mesh)
        algo_state = jgs.init_qadam_state(state.params, mesh)
    else:
        state = jgs.replicate_for_local(state, mesh)
        if name == "lp":
            algo_state = jgs.init_lp_decentralized_state(state, mesh)
    step = jgs.build_sync_train_step(jmodel, opt, mesh, algo)
    losses, params_by_step = [], []
    for hb in tds.host_batches(SPEC, steps, SEED):
        db = shard_device_batch(hb, mesh)
        if algo_state is not None:
            state, (header, gpacked), algo_state = step(state, db, algo_state)
        else:
            state, (header, gpacked) = step(state, db)
        losses.append(float(np.asarray(header)[0]))
        params_by_step.append(_rows(state.params, n, local))
    out = {"losses": losses, "params": params_by_step, "header": np.asarray(header), "gpacked": np.asarray(gpacked),
           "batch_stats": [jax.tree.map(lambda x, i=i: np.asarray(x[i]), state.batch_stats) for i in range(n)]}
    if qadam:
        out["algo_state"] = {"m": _rows(algo_state["m"], n, False), "v": _rows(algo_state["v"], n, False),
                             "residual": _rows(algo_state["residual"], n, True)}
    elif name == "lp":
        out["algo_state"] = {k: _rows(v, n, True) for k, v in algo_state.items()}
    return out


def _port_cases(n):
    cases = [dict(algorithm=name, kwargs=kw, steps=STEPS, seed=SEED, collapse=key == "decentralized")
             for key, (name, kw) in CASES.items()]
    if n == 4:
        cases.append(dict(algorithm=DEC2[0], kwargs=DEC2[1], steps=DEC2_STEPS, seed=SEED))
    if n == DNN_N:
        cases.append(dict(algorithm="decentralized", steps=STEPS, seed=SEED, model="dnn"))
    if n == WARMUP_N:
        cases.append(dict(algorithm="qadam", kwargs={"lr": SPEC["lr"], "warmup_steps": 100}, steps=STEPS,
                          seed=SEED))
        cases.append(dict(algorithm="f32", steps=STEPS, seed=SEED))
    return cases


@pytest.fixture(scope="module")
def runs():
    """Every world size's cases on both packages: ``ref[(n, key)]``,
    ``port[(n, key)]`` (a list of the ranks' results)."""
    ref, port = {}, {}
    for n in WORLDS:
        for key, (name, kw) in CASES.items():
            ref[(n, key)] = _jax_run(n, name, kw)
        if n == 4:
            ref[(n, "dec2")] = _jax_run(n, *DEC2, steps=DEC2_STEPS)
        if n == DNN_N:
            ref[(n, "dnn")] = _jax_run(n, "decentralized", {}, model="dnn")
        cases = _port_cases(n)
        res = tds.run_function(n, tds.divergent_rank, cases, SPEC, timeout=240)
        keys = list(CASES) + (["dec2"] if n == 4 else []) + (["dnn"] if n == DNN_N else []) \
            + (["qadam_warmup", "f32"] if n == WARMUP_N else [])
        for i, key in enumerate(keys):
            port[(n, key)] = [r[i] for r in res]
    return ref, port


def _param_tol(key, step):
    """(rtol, atol) of the parameters after ``step`` (from 0)."""
    if key == "qadam" and step >= CASES["qadam"][1]["warmup_steps"]:
        return QADAM_PARAM_RTOL, PARAM_ATOL
    if key == "lp":
        return 0, LP_PARAM_ATOL
    return 0, PARAM_ATOL


@pytest.mark.parametrize("key", list(CASES))
@pytest.mark.parametrize("n", WORLDS)
def test_steps_match_reference(runs, n, key):
    """Each step's loss (the mean over the ranks, on every rank) and each
    rank's flat parameters after each step against the reference's row;
    the last step's header (every rank's predictions) and the embedding
    gradients of the global batch."""
    ref, port = runs
    want, got = ref[(n, key)], port[(n, key)]
    assert len(got) == n
    loss_tol, out_tol = (QADAM_LOSS_TOL, QADAM_OUT_TOL) if key == "qadam" else (LOSS_TOL, OUT_TOL)
    for r, res in enumerate(got):
        np.testing.assert_allclose(res["losses"], want["losses"], **loss_tol)
        for s in range(STEPS):
            rtol, atol = _param_tol(key, s)
            np.testing.assert_allclose(res["params"][s], want["params"][s][r], rtol=rtol, atol=atol,
                                       err_msg=f"rank {r} step {s}")
        np.testing.assert_allclose(res["header"], want["header"], **out_tol)
        np.testing.assert_allclose(res["gpacked"], want["gpacked"], **out_tol)
    # the local algorithms' ranks hold their own parameters (at n = 2
    # Decentralized's two ranks average with each other, to the same bits)
    if key in ("local_sgd", "lp") and n > 1 or key == "decentralized" and n > 2:
        assert not np.array_equal(got[0]["params"][0], got[1]["params"][0])
    if key == "qadam":  # replicated: every rank the same bits
        for res in got[1:]:
            np.testing.assert_array_equal(res["params"][-1], got[0]["params"][-1])


@pytest.mark.parametrize("key", ["qadam", "lp"])
@pytest.mark.parametrize("n", WORLDS)
def test_algorithm_state_matches_reference(runs, n, key):
    """QAdam's m, v (the same on every rank) and this rank's residual;
    LowPrecisionDecentralized's three shadows and residual, against the
    reference's rows; the residuals nonzero (the int8 wire lost
    something)."""
    ref, port = runs
    want, got = ref[(n, key)]["algo_state"], port[(n, key)]
    for r, res in enumerate(got):
        assert set(res["algo_state"]) == set(want)
        for k, rows in want.items():
            tol = QADAM_STATE_TOL[k] if key == "qadam" else dict(rtol=0, atol=LP_STATE_ATOL)
            np.testing.assert_allclose(res["algo_state"][k], rows[r], err_msg=f"{k} rank {r}", **tol)
        assert np.abs(res["algo_state"]["residual"]).max() > 0
    if key == "qadam":
        for res in got[1:]:
            for k in ("m", "v"):
                np.testing.assert_array_equal(res["algo_state"][k], got[0]["algo_state"][k])


@pytest.mark.parametrize("n", WORLDS)
def test_lp_left_shadow_is_the_left_neighbours_self_shadow(runs, n):
    """Rank i's ``shadow_left`` bit for bit rank i - 1's ``shadow_self``,
    and its ``shadow_right`` rank i + 1's (both advance by the same codes
    at the same scales from the same start)."""
    _ref, port = runs
    got = port[(n, "lp")]
    for r in range(n):
        st = got[r]["algo_state"]
        np.testing.assert_array_equal(st["shadow_left"].view(np.int32),
                                      got[(r - 1) % n]["algo_state"]["shadow_self"].view(np.int32))
        np.testing.assert_array_equal(st["shadow_right"].view(np.int32),
                                      got[(r + 1) % n]["algo_state"]["shadow_self"].view(np.int32))


@pytest.mark.parametrize("n", [2, 4])
def test_local_sgd_ranks_agree_right_after_a_sync(runs, n):
    """LocalSGD(period=2): the ranks' parameters the same bits after step 2
    (a sync), not after steps 1 and 3."""
    _ref, port = runs
    got = port[(n, "local_sgd")]
    same = [all(np.array_equal(res["params"][s], got[0]["params"][s]) for res in got) for s in range(STEPS)]
    assert same == [False, True, False]


def test_decentralized_period_alternates_by_sync_ordinal(runs):
    """Decentralized(period=2) over 5 steps at n = 4 against the reference
    (syncs at steps 2 and 4, ring-left then ring-right); the ranks diverge
    between syncs."""
    ref, port = runs
    want, got = ref[(4, "dec2")], port[(4, "dec2")]
    for r, res in enumerate(got):
        np.testing.assert_allclose(res["losses"], want["losses"], **LOSS_TOL)
        for s in range(DEC2_STEPS):
            np.testing.assert_allclose(res["params"][s], want["params"][s][r], rtol=0, atol=PARAM_ATOL,
                                       err_msg=f"rank {r} step {s}")


def test_dnn_batch_statistics_are_each_ranks(runs):
    """DNN under Decentralized at n = 2: losses and parameters against the
    reference; each rank's batch statistics (its own rows' moments) against
    the reference's row, the two ranks' differing."""
    ref, port = runs
    want, got = ref[(DNN_N, "dnn")], port[(DNN_N, "dnn")]
    leaves = lambda tree: jax.tree.leaves(tree)  # noqa: E731
    atol = []
    for path, p, _tr in tgs.dense_leaves(tds.dnn_model(SPEC)[0]):
        bound = 2 * SPEC["lr"] * STEPS if path in BN_FED else PARAM_ATOL
        atol.append(np.full(p.numel(), bound, np.float32))
    atol = np.concatenate(atol)
    for r, res in enumerate(got):
        np.testing.assert_allclose(res["losses"], want["losses"], **LOSS_TOL)
        np.testing.assert_array_less(np.abs(res["params"][-1] - want["params"][-1][r]), atol)
        a, b = leaves(res["batch_stats"]), leaves(want["batch_stats"][r])
        assert len(a) == len(b) == 4
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, rtol=0, atol=DNN_STATS_ATOL)
    assert not all(np.array_equal(x, y) for x, y in zip(leaves(got[0]["batch_stats"]), leaves(got[1]["batch_stats"])))


def test_qadam_within_warmup_is_f32_with_adam(runs):
    """QAdam(warmup_steps=100) over 3 steps at n = 2: the exact mean of the
    gradients and Adam's arithmetic, so the "f32" mode with Adam of the same
    hyperparameters lands on the same parameters; no kernel launched."""
    _ref, port = runs
    q, f = port[(WARMUP_N, "qadam_warmup")], port[(WARMUP_N, "f32")]
    for a, b in zip(q, f):
        np.testing.assert_allclose(a["losses"], b["losses"], **LOSS_TOL)
        for s in range(STEPS):
            np.testing.assert_allclose(a["params"][s], b["params"][s], rtol=0, atol=WARMUP_ATOL)
    with pytest.raises(ValueError, match="warmup_steps"):
        tgs.QAdam(warmup_steps=0)
    with pytest.raises(ValueError, match="warmup_steps"):
        tgs.QAdam(warmup_steps=-3)
    tgs.QAdam(warmup_steps=1)


@pytest.mark.parametrize("n", WORLDS)
def test_collapse_local_matches_reference(runs, n):
    """``collapse_local`` after Decentralized's 3 steps against the
    reference's ``collapse_local`` of a state whose leading axis holds the
    port's ranks' rows: every leaf the same bits (params, Adam's moments;
    the count rank 0's)."""
    _ref, port = runs
    got = port[(n, "decentralized")]
    mine = got[0]["collapse"]
    for res in got[1:]:
        for a, b in zip(jax.tree.leaves(res["collapse"]), jax.tree.leaves(mine)):
            np.testing.assert_array_equal(a, b)
    rows = [res["dense_tree"] for res in got]
    stacked = {k: jax.tree.map(lambda *xs: np.stack(xs), *[r[k] for r in rows])
               for k in ("params", "batch_stats", "opt_state")}
    want = jgs.collapse_local(JaxTrainState(step=np.int32(STEPS), loss_scale=None, **stacked))
    for part in ("params", "batch_stats", "opt_state"):
        a_leaves, b_leaves = jax.tree.leaves(getattr(want, part)), jax.tree.leaves(mine[part])
        assert len(a_leaves) == len(b_leaves)
        for a, b in zip(a_leaves, b_leaves):
            assert np.asarray(a).dtype == b.dtype
            np.testing.assert_array_equal(np.asarray(a), b)
    np.testing.assert_array_equal(ravel_pytree(jax.tree.map(jnp.asarray, mine["params"]))[0],
                                  np.mean(np.stack([res["params"][-1] for res in got]), axis=0, dtype=np.float32))
    assert mine["step"] == STEPS and int(np.asarray(mine["opt_state"]["0"]["count"])) == STEPS


def test_replicate_for_local_is_a_no_op_at_one_rank():
    from persia_tpu_torch.parallel.mesh import data_parallel_mesh

    model, _ = tds.model_and_params(SPEC)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tgs.replicate_for_local(model, torch.optim.Adam(model.parameters()), data_parallel_mesh())
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k])
    with pytest.raises(ValueError, match="optimizer"):
        tgs.build_sync_train_step(model, None, data_parallel_mesh(), tgs.Decentralized())


def _mix_inputs(seed, offsets):
    rng = np.random.default_rng(seed)
    n, segs = offsets[-1], len(offsets) - 1
    f = lambda scale: (rng.normal(size=n) * scale).astype(np.float32)  # noqa: E731
    codes = lambda: rng.integers(-127, 128, n).astype(np.int8)  # noqa: E731
    scales = lambda: (10.0 ** rng.uniform(-6, 1, segs)).astype(np.float32)  # noqa: E731
    return [f(1.0), f(1.0), f(1.0), f(1.0), codes(), codes(), codes(), scales(), scales(), scales()]


@pytest.mark.parametrize("offsets", [[0, 1000], [0, 3, 3, 17, 500, 501, 2000], [0, 0, 5, 9]])
def test_lp_ring_mix_plain_matches_lp_ring_sync_arithmetic(offsets):
    """K18's plain version against ``lp_ring_sync``'s arithmetic after the
    exchange, a leaf at a time in JAX: the shadows within an ulp of their
    magnitude (XLA may multiply by a rounded 1/127), x within 2 ulps; the
    wrapper on the CPU writes the plain version's bits in place."""
    args = _mix_inputs(len(offsets), offsets)
    x, ss, sl, sr, q, ql, qr, s, s_l, s_r = args
    want = {k: np.empty_like(x) for k in ("x", "ss", "sl", "sr")}
    for k, (a, b) in enumerate(zip(offsets[:-1], offsets[1:])):
        if b == a:
            continue
        seg = slice(a, b)
        jss = jnp.asarray(ss[seg]) + jnp.asarray(q[seg]).astype(jnp.float32) * (jnp.float32(s[k]) / 127.0)
        jsl = jnp.asarray(sl[seg]) + jnp.asarray(ql[seg]).astype(jnp.float32) * (jnp.float32(s_l[k]) / 127.0)
        jsr = jnp.asarray(sr[seg]) + jnp.asarray(qr[seg]).astype(jnp.float32) * (jnp.float32(s_r[k]) / 127.0)
        want["x"][seg] = np.asarray((jnp.asarray(x[seg]) + jsl + jsr) / 3.0)
        want["ss"][seg], want["sl"][seg], want["sr"][seg] = np.asarray(jss), np.asarray(jsl), np.asarray(jsr)
    t = [torch.from_numpy(a.copy()) for a in args]
    got = dict(zip(("x", "ss", "sl", "sr"), (v.numpy() for v in lp_ring_mix_reference(*t, offsets))))
    for k in ("ss", "sl", "sr"):
        np.testing.assert_array_less(np.abs(got[k] - want[k]), ULP * np.abs(want[k]) + 1e-45, err_msg=k)
    np.testing.assert_array_less(np.abs(got["x"] - want["x"]), 2 * ULP * np.abs(want["x"]) + 1e-45)
    ins = [a.clone() for a in t]
    out = lp_ring_mix(*ins, offsets)
    assert all(o is i for o, i in zip(out, ins[:4]))
    for k, o in zip(("x", "ss", "sl", "sr"), out):
        np.testing.assert_array_equal(o.numpy().view(np.int32), got[k].view(np.int32))
    with pytest.raises(ValueError, match="four tensors"):
        lp_ring_mix(ins[0], ins[0], *ins[2:], offsets)
    with pytest.raises(ValueError, match="offsets"):
        lp_ring_mix(*ins, [0, 5])
