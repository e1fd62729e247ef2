"""The hybrid tier's dense sync in the port (``persia_tpu_torch.ctx.TrainCtx(
mesh=data_parallel_mesh(), dense_sync=mode)``, ``persia_tpu_torch/parallel/
grad_sync.py``) against the reference's ``TrainCtx`` on a CPU mesh of the
same size (``persia_tpu.parallel.data_parallel_mesh(n)`` over the
conftest's virtual CPU devices), for every mode of ``DENSE_SYNC_MODES`` at
n in {1, 2, 4} ranks.

The port runs as n gloo ranks (``testing.dense_sync.run_ranks``: spawned
processes, once a world size for every case, a timeout on the group and
on each process); both sides train DLRM from the same seeded weights over
the same synthetic batches (3 steps of 32 rows), the servers two numpy
stores each. Checked:

- each step's loss and the final flat parameters against the reference's
  (tolerances below), and every rank's parameters the same bits;
- ``sync_mode`` and ``dense_wire_bytes_per_step`` equal to the
  reference's; the sharded modes' optimizer state at 1/n of the replicated
  one a rank (``per_replica_opt_state_bytes`` beside the reference's);
- the ring's error feedback: each rank's row against the reference's
  ``opt_state["ef"]`` row (tolerance below), and within the int8
  resolution of what it carries;
- the servers' entries after the steps against the reference's;
- a ring and a sharded run at n = 2 resume across the packages both ways:
  the reference's manifest (dense bytes with the ``{"opt", "ef"}``
  wrapper, servers) resumed by the port's ranks, and the port's by the
  reference, each landing where the other package's uninterrupted run
  does;
- the pipelined step at n = 2 (``train_step_prepared``: rank 0 over a
  ``DataLoader(reproducible=True, staleness=1)``, rank 1 with None) for
  "f32" and "block-int8-ring", 3 steps, against the reference's
  ``TrainCtx`` over a 2-device mesh with its ``DataLoader`` (losses,
  parameters, the servers' entries), and bit for bit the port's own
  synchronous ``train_step``.

Tolerances, at 3-6x the readings on the CPU. Every mode but bf16 at
n = 4: losses 1e-6 relative, parameters 1e-6 absolute, ``ef`` 5e-7
absolute (the readings: 1.7e-7, 1.8e-7, 1.5e-7: the sums' order differs
from XLA's, and the int8 codes came out the same). bf16 at n = 4: the
ranks' bf16 gradients are summed in bf16 in gloo's order, which rounds
other partial sums than XLA's all-reduce: an ulp of bf16 in a gradient,
which Adam turns into up to lr = 3e-3 of a step: losses 4e-6 relative,
parameters 6e-4 absolute, the servers' entries (whose gradients come
through those parameters) 1e-3 relative (the readings: 1.0e-6, 2.2e-4,
1.8e-4). The servers' entries of every other case: 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.flatten_util import ravel_pytree

import persia_tpu.config as jcfg
from persia_tpu.ctx import TrainCtx as JaxTrainCtx
from persia_tpu.data_loader import DataLoader as JaxDataLoader
from persia_tpu.embedding import optim as joptim
from persia_tpu.embedding.store import EmbeddingStore as JaxStore
from persia_tpu.embedding.worker import EmbeddingWorker as JaxWorker
from persia_tpu.models import DLRM as JaxDLRM
from persia_tpu.parallel import data_parallel_mesh as jax_mesh
from persia_tpu.parallel import grad_sync as jgs
from persia_tpu.parallel.train_step import TrainState as JaxTrainState
from persia_tpu_torch.parallel.grad_sync import DENSE_SYNC_MODES
from persia_tpu_torch.testing import dense_sync as tds

SPEC = tds.SPEC
WORLDS = (1, 2, 4)
STEPS, SEED = 3, 9
EF_TOL = 5e-7


def _tol(n, mode):
    """(loss tolerance, parameter tolerance, entry tolerance): the module's
    docstring."""
    if mode == "bf16" and n == 4:
        return dict(rtol=4e-6, atol=0), 6e-4, dict(rtol=1e-3, atol=1e-7)
    return dict(rtol=1e-6, atol=0), 1e-6, ENTRY_TOL


ENTRY_TOL = dict(rtol=1e-5, atol=1e-7)
RESUME_MODES = ("block-int8-ring", "f32-sharded")
RESUME_STEPS, RESUME_AT, RESUME_N = 4, 2, 2
LOADER_MODES, LOADER_N = ("f32", "block-int8-ring"), 2


def _jcfg():
    slots = {f"cat_{i}": jcfg.SlotConfig(dim=SPEC["dim"]) for i in range(len(SPEC["vocabs"]))}
    return jcfg.EmbeddingConfig(slots_config=slots, feature_index_prefix_bit=8)


def _jax_ctx(n, mode):
    """The reference's ctx on a mesh of n CPU devices from the port's
    seeded weights, its sync state built as its ``init_state`` builds it."""
    mesh = jax_mesh(n)
    stores = [JaxStore(capacity=1 << 16, num_internal_shards=4, seed=7, optimizer=joptim.Adagrad(lr=0.1).config)
              for _ in range(2)]
    model = JaxDLRM(embedding_dim=SPEC["dim"], bottom_mlp=SPEC["bottom"], top_mlp=SPEC["top"],
                    compute_dtype=jnp.float32)
    opt = optax.adam(SPEC["lr"])
    ctx = JaxTrainCtx(model, opt, joptim.Adagrad(lr=0.1), JaxWorker(_jcfg(), stores), _jcfg(), mesh=mesh,
                      dense_sync=mode).__enter__()
    _, params = tds.model_and_params(SPEC)
    jparams = jax.tree.map(jnp.asarray, params)
    st = JaxTrainState(params=jparams, batch_stats={}, opt_state=opt.init(jparams), step=jnp.zeros((), jnp.int32),
                       loss_scale=None)
    if ctx._sync_wrapped:
        st = st.replace(opt_state=jgs.init_sync_opt_state(jparams, opt, mesh, ctx._sync_algorithm,
                                                           ctx._sync_sharded))
    ctx.state = ctx._place_state(st)
    if mode == "bytegrad":
        ctx._sync_residual = jgs.init_residual(ctx.state.params)
    ctx._note_dense_sync(ctx.state)
    return ctx, stores


def _jax_entries(stores):
    out = {}
    from persia_tpu.embedding.hashing import add_index_prefix

    cfg = _jcfg()
    for i, vocab in enumerate(SPEC["vocabs"]):
        slot = f"cat_{i}"
        signs = add_index_prefix(np.arange(vocab, dtype=np.uint64), cfg.slot(slot).index_prefix, 8)
        for j, s in enumerate(signs.tolist()):
            e = next((st.get_embedding_entry(s) for st in stores if st.get_embedding_entry(s) is not None), None)
            if e is not None:
                out[(slot, j)] = np.array(e)
    return out


def _jax_run(n, mode, steps=STEPS, start=0, stop=None, snapshot=None, resume=None, loader=False):
    ctx, stores = _jax_ctx(n, mode)
    if resume is not None:
        m = ctx.resume(resume)
        assert m is not None and m.step == start
    data = tds.batches(SPEC, steps, SEED)
    losses = []
    if loader:  # the pipelined step over the reference's loader
        dl = JaxDataLoader(iter(data[start:stop or steps]), ctx, num_workers=2, staleness=1, reproducible=True)
        losses = [float(ctx.train_step_prepared(tb, dl)["loss"]) for tb in dl]
        dl.flush()
        dl.shutdown()
    for i in range(start, start if loader else stop or steps):
        losses.append(float(ctx.train_step(data[i])["loss"]))
        if snapshot and i + 1 == snapshot[1]:
            ctx.snapshot_job(snapshot[0])
    opt = ctx.state.opt_state
    return {
        "losses": losses, "params": np.asarray(ravel_pytree(ctx.state.params)[0]),
        "ef": np.asarray(opt["ef"]) if isinstance(opt, dict) and "ef" in opt else None,
        "opt_state_bytes": jgs.per_replica_opt_state_bytes(opt), "wire_bytes": ctx.dense_wire_bytes_per_step(),
        "sync_mode": ctx.sync_mode, "entries": _jax_entries(stores),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world size's cases on both packages; the resume cases at n =
    2: the reference's fenced run first (its manifest at step 2), then the
    port's ranks (its own fenced run, and a resume of the reference's), then
    the reference resuming the port's manifest."""
    root = tmp_path_factory.mktemp("dense_sync")
    ref = {(n, m): _jax_run(n, m) for n in WORLDS for m in DENSE_SYNC_MODES}
    for m in RESUME_MODES:
        ref[("fenced", m)] = _jax_run(RESUME_N, m, steps=RESUME_STEPS, snapshot=(str(root / f"ref_{m}"), RESUME_AT))
    for m in LOADER_MODES:
        ref[("loader", m)] = _jax_run(LOADER_N, m, loader=True)
    port = {}
    for n in WORLDS:
        cases = [dict(mode=m, steps=STEPS, seed=SEED) for m in DENSE_SYNC_MODES]
        if n == RESUME_N:
            for m in RESUME_MODES:
                cases.append(dict(mode=m, steps=RESUME_STEPS, seed=SEED, snapshot=(str(root / f"port_{m}"), RESUME_AT),
                                  state_bytes=True))
                cases.append(dict(mode=m, steps=RESUME_STEPS, seed=SEED, resume=str(root / f"ref_{m}")))
        if n == LOADER_N:
            cases += [dict(mode=m, steps=STEPS, seed=SEED, loader=True) for m in LOADER_MODES]
        res = tds.run_ranks(n, cases, timeout=240)
        for i, m in enumerate(DENSE_SYNC_MODES):
            port[(n, m)] = [r[i] for r in res]
        if n == RESUME_N:
            for k, m in enumerate(RESUME_MODES):
                port[("fenced", m)] = [r[len(DENSE_SYNC_MODES) + 2 * k] for r in res]
                port[("resumed", m)] = [r[len(DENSE_SYNC_MODES) + 2 * k + 1] for r in res]
        if n == LOADER_N:
            for k, m in enumerate(LOADER_MODES):
                port[("loader", m)] = [r[len(cases) - len(LOADER_MODES) + k] for r in res]
    for m in RESUME_MODES:
        ref[("resumed", m)] = _jax_run(RESUME_N, m, steps=RESUME_STEPS, start=RESUME_AT,
                                       resume=str(root / f"port_{m}"))
    return ref, port


def _assert_entries(got, want, tol=ENTRY_TOL):
    assert set(got) == set(want) and len(want) > 20
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=str(k), **tol)


@pytest.mark.parametrize("mode", DENSE_SYNC_MODES)
@pytest.mark.parametrize("n", WORLDS)
def test_dense_sync_steps_match_reference(runs, n, mode):
    """Three steps at n ranks: the losses (the mean over the ranks, on
    every rank) and the final parameters against the reference's; every
    rank's parameters the same bits; the servers' entries."""
    ref, port = runs
    want, got = ref[(n, mode)], port[(n, mode)]
    loss_tol, param_tol, entry_tol = _tol(n, mode)
    assert len(got) == n
    for r in got:
        np.testing.assert_allclose(r["losses"], want["losses"], **loss_tol)
        np.testing.assert_array_equal(r["params"], got[0]["params"])
    np.testing.assert_allclose(got[0]["params"], want["params"], rtol=0, atol=param_tol)
    assert not np.array_equal(got[0]["params"], np.asarray(ravel_pytree(tds.model_and_params(SPEC)[1])[0]))
    _assert_entries(got[0]["entries"], want["entries"], entry_tol)


@pytest.mark.parametrize("mode", DENSE_SYNC_MODES)
@pytest.mark.parametrize("n", WORLDS)
def test_sync_mode_wire_bytes_and_state_size_match_reference(runs, n, mode):
    """``sync_mode`` and ``dense_wire_bytes_per_step`` the reference's; the
    optimizer state a rank holds the reference's a device (the sharded
    modes 1/n of the moments)."""
    ref, port = runs
    want, got = ref[(n, mode)], port[(n, mode)]
    for r in got:
        assert r["sync_mode"] == want["sync_mode"] == mode
        assert r["wire_bytes"] == want["wire_bytes"]
        assert r["opt_state_bytes"] == want["opt_state_bytes"]
    if mode.endswith("-sharded"):
        def moments(res):  # Adam's moments and count, the ring's ef row left out
            return res["opt_state_bytes"] - (res["ef"].size * 4 if res["ef"] is not None else 0)

        full = moments(port[(n, mode.replace("-sharded", ""))][0])
        for r in got:  # the chunk is ceil(P / n), rounded up to a block for the ring
            assert moments(r) <= (full - 4) / n + 8 * 256 + 4


@pytest.mark.parametrize("mode", ["block-int8-ring", "block-int8-ring-sharded"])
@pytest.mark.parametrize("n", WORLDS)
def test_ring_error_feedback_matches_reference(runs, n, mode):
    """Each rank's ``ef`` row against the reference's (n, Ppad) ``ef``; the
    rows differ across ranks (each carries its own sends' errors) and are
    within the int8 resolution: no element past 1/254 of the largest
    gradient-sum magnitude a hop can carry."""
    ref, port = runs
    want, got = ref[(n, mode)]["ef"], port[(n, mode)]
    assert want.shape[0] == n == len(got)
    for r, res in enumerate(got):
        assert res["ef"].shape == want[r].shape
        np.testing.assert_allclose(res["ef"], want[r], rtol=0, atol=EF_TOL, err_msg=f"rank {r}")
    if mode == "block-int8-ring" or n > 1:
        assert np.abs(got[0]["ef"]).max() > 0


@pytest.mark.parametrize("mode", RESUME_MODES)
def test_resume_across_packages(runs, mode):
    """At n = 2: the port's ranks resume the reference's manifest (fence at
    step 2) and train steps 2-3 landing on the reference's uninterrupted
    run; the reference resumes the port's and lands on the port's. The
    port's manifest carries the wrapper (``ef`` (2, Ppad) for the ring,
    (2, chunk) moments for the sharded update)."""
    ref, port = runs
    tol_loss, tol_param, _ = _tol(RESUME_N, mode)
    got = port[("resumed", mode)]
    assert got[0]["start"] == RESUME_AT and len(got[0]["losses"]) == RESUME_STEPS - RESUME_AT
    np.testing.assert_allclose(got[0]["losses"], ref[("fenced", mode)]["losses"][RESUME_AT:], **tol_loss)
    np.testing.assert_allclose(got[0]["params"], ref[("fenced", mode)]["params"], rtol=0, atol=tol_param)
    np.testing.assert_array_equal(got[1]["params"], got[0]["params"])
    _assert_entries(got[0]["entries"], ref[("fenced", mode)]["entries"])
    back = ref[("resumed", mode)]
    fenced = port[("fenced", mode)]
    np.testing.assert_allclose(back["losses"], fenced[0]["losses"][RESUME_AT:], **tol_loss)
    np.testing.assert_allclose(back["params"], fenced[0]["params"], rtol=0, atol=tol_param)
    _assert_entries(back["entries"], fenced[0]["entries"])
    from persia_tpu_torch.serialization import msgpack_restore

    opt = msgpack_restore(fenced[0]["state_bytes"])["opt_state"]
    if mode == "block-int8-ring":
        assert np.asarray(opt["ef"]).shape[0] == RESUME_N
    else:
        assert np.asarray(opt["opt"]["0"]["mu"]).shape[0] == RESUME_N


@pytest.mark.parametrize("mode", LOADER_MODES)
def test_pipelined_step_over_a_mesh_matches_reference(runs, mode):
    """``train_step_prepared`` at n = 2 (rank 0 over the port's
    ``DataLoader(reproducible=True, staleness=1)``, rank 1 with None for
    the batch and the loader), 3 steps: the losses on both ranks and the
    parameters against the reference's ``TrainCtx`` over a 2-device mesh
    with its ``DataLoader``, the servers' entries; both ranks the same
    parameters, and every number the bits of the port's synchronous
    ``train_step`` over the same batches."""
    ref, port = runs
    want, got, sync = ref[("loader", mode)], port[("loader", mode)], port[(LOADER_N, mode)]
    loss_tol, param_tol, entry_tol = _tol(LOADER_N, mode)
    assert len(got) == LOADER_N
    for r, s in zip(got, sync):
        assert len(r["losses"]) == STEPS
        np.testing.assert_allclose(r["losses"], want["losses"], **loss_tol)
        assert r["losses"] == s["losses"]
        np.testing.assert_array_equal(r["params"], s["params"])
        np.testing.assert_array_equal(r["params"], got[0]["params"])
    np.testing.assert_allclose(got[0]["params"], want["params"], rtol=0, atol=param_tol)
    _assert_entries(got[0]["entries"], want["entries"], entry_tol)
    assert got[0]["entries"].keys() == sync[0]["entries"].keys()
    for k, v in sync[0]["entries"].items():
        np.testing.assert_array_equal(got[0]["entries"][k], v)
