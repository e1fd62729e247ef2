"""The port's fused tier (``persia_tpu_torch/parallel/fused_step.py``, the
CPU path: K4's and K5's plain versions) against the reference's
(``persia_tpu/parallel/fused_step.py``, jitted JAX on the CPU). State is
carried across with ``fused_state_from_flax`` (init is only statistically
equal): the gathers (stacked clamps, unstacked gives NaN), five training
steps per layout and sparse optimizer (losses to rtol 1e-5; tables, state
and parameters to rtol 1e-5, atol 1e-6, the hybrid tier's f32 training
tolerance), the eval step, the multi-step, the int32 split, the seeded
init."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import persia_tpu.embedding  # noqa: F401  (imports persia_tpu.ops in the order it needs)
from persia_tpu import config as jconfig
from persia_tpu.embedding import optim as jopt
from persia_tpu.models import DLRM as JaxDLRM
from persia_tpu.parallel import fused_step as jfs
from persia_tpu_torch import config as tconfig
from persia_tpu_torch.embedding import optim as topt
from persia_tpu_torch.models import DLRM
from persia_tpu_torch.parallel import fused_step as tfs
from persia_tpu_torch.weights import fused_state_from_flax, fused_state_to_flax

B, DIM, BOTTOM, TOP = 32, 8, (16, 8), (32,)
TIGHT = dict(rtol=1e-5, atol=1e-6)
OPTIMIZERS = {
    "sgd": lambda m: m.SGD(lr=0.1, weight_decay=0.01),
    "adagrad": lambda m: m.Adagrad(lr=0.1, weight_decay=0.01),
    "adagrad_vw": lambda m: m.Adagrad(lr=0.1, vectorwise_shared=True),
    "adam": lambda m: m.Adam(lr=0.01),
}


def _specs(module, raw=True):
    s = {
        "a": module.FusedSlotSpec(vocab=50, dim=DIM),
        "b": module.FusedSlotSpec(vocab=30, dim=DIM, sqrt_scaling=True),  # pooled (B, L) bag
        "c": module.FusedSlotSpec(vocab=40, dim=DIM),
    }
    if raw:
        s["seq"] = module.FusedSlotSpec(vocab=20, dim=DIM, pooled=False)
    return s


def _host_batch(seed, raw=True, oob=False):
    rng = np.random.default_rng(seed)
    ids = {
        "a": rng.integers(0, 50, B).astype(np.int32),
        "b": np.where(rng.random((B, 3)) < 0.3, -1, rng.integers(0, 30, (B, 3))).astype(np.int32),
        "c": rng.integers(0, 40, B).astype(np.int32),
    }
    ids["a"][::7] = -1  # single-id padding
    if oob:  # the stacked path clamps to the slot's last row and updates nothing
        ids["c"][3] = 45
        ids["b"][4, 0] = 33
    if raw:
        ids["seq"] = np.where(rng.random((B, 4)) < 0.4, -1, rng.integers(0, 20, (B, 4))).astype(np.int32)
    return {
        "dense": [rng.standard_normal((B, 4)).astype(np.float32)],
        "labels": [rng.integers(0, 2, (B, 1)).astype(np.float32)],
        "ids": ids,
    }


def _tb(h):
    return {"dense": [torch.from_numpy(x) for x in h["dense"]],
            "labels": [torch.from_numpy(x) for x in h["labels"]],
            "ids": {k: torch.from_numpy(v) for k, v in h["ids"].items()}}


def _jb(h):
    return jax.tree.map(jnp.asarray, h)


def _leaves(jstate):
    kl = jax.tree_util.tree_leaves_with_path(jstate)
    return [jax.tree_util.keystr(kp) for kp, _ in kl], [np.asarray(v) for _, v in kl]


def _pair(opt_name, stack, raw=True, seed=0, jit=True):
    """A reference fused state and the port's, carried across from it."""
    cfg_j, cfg_t = OPTIMIZERS[opt_name](jopt).config, OPTIMIZERS[opt_name](topt).config
    specs_j, specs_t = _specs(jfs, raw), _specs(tfs, raw)
    n = len(specs_j)
    jmodel = JaxDLRM(embedding_dim=DIM, bottom_mlp=BOTTOM, top_mlp=TOP, compute_dtype=jnp.float32)
    jstate = jfs.init_fused_state(jmodel, jax.random.PRNGKey(seed), specs_j, _jb(_host_batch(0, raw)),
                                  optax.adam(1e-3), cfg_j, stack=stack)
    model = DLRM(4, n, DIM, BOTTOM, TOP, compute_dtype=torch.float32, device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    tstate = fused_state_from_flax(*_leaves(jstate), model, opt, device="cpu")
    jstep = jfs.build_fused_train_step(jmodel, optax.adam(1e-3), cfg_j, specs_j, donate=False, stack=stack)
    tstep = tfs.build_fused_train_step(cfg_t, specs_t, stack=stack, jit=jit)
    return (jstate, jstep, jmodel, specs_j), (tstate, tstep, specs_t)


def _assert_states_close(jstate, tstate, **tol):
    jpaths, jarrays = _leaves(jstate)
    tpaths, tarrays = fused_state_to_flax(tstate)
    assert tpaths == jpaths
    for p, a, b in zip(jpaths, jarrays, tarrays):
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(b, a, err_msg=p)
        else:
            np.testing.assert_allclose(b, a, err_msg=p, **tol)


@pytest.mark.parametrize("opt_name,jit", [(o, True) for o in OPTIMIZERS] + [("adagrad", False)])
@pytest.mark.parametrize("stack", [True, False], ids=["stacked", "unstacked"])
def test_five_steps_match_reference(stack, opt_name, jit):
    """``jit`` True or False: both are eager on the CPU (the CUDA graph is
    the card's), and both are held to the reference."""
    (jstate, jstep, _, _), (tstate, tstep, _) = _pair(opt_name, stack, jit=jit)
    for i in range(5):
        h = _host_batch(10 + i, oob=stack)
        jstate, (jloss, jpreds) = jstep(jstate, _jb(h))
        tstate, (tloss, tpreds) = tstep(tstate, _tb(h))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(tpreds.numpy(), np.asarray(jpreds), **TIGHT)
    assert int(tstate.step) == 5
    _assert_states_close(jstate, tstate, **TIGHT)


@pytest.mark.parametrize("stack", [True, False], ids=["stacked", "unstacked"])
def test_only_touched_rows_change(stack):
    (_, _, _, _), (tstate, tstep, specs) = _pair("adagrad", stack, raw=False)
    h = _host_batch(3, raw=False)
    before = {k: v.clone() for k, v in tstate.tables.items()}
    tstep(tstate, _tb(h))
    groups = tfs.group_stacked_specs(specs, sorted(specs)) if stack else None
    for name in specs:
        view = (lambda t: tfs.stacked_slot_table(t, groups, name)) if stack else (lambda t: t[name])
        live = {int(i) for i in h["ids"][name].reshape(-1) if 0 <= i < specs[name].vocab}
        changed = set(np.nonzero((view(tstate.tables) != view(before)).any(1).numpy())[0].tolist())
        assert changed <= live and changed


@pytest.mark.parametrize("stack", [True, False], ids=["stacked", "unstacked"])
def test_gathers_match_reference(stack):
    """Pads read row 0; an id past the vocab reads the slot's last row
    (stacked) or a row of NaN (unstacked, ``take``'s fill mode)."""
    (jstate, _, _, specs_j), (tstate, _, specs_t) = _pair("sgd", stack)
    h = _host_batch(5)
    h["ids"]["c"][1] = 41
    h["ids"]["b"][2, 1] = 99
    if stack:
        jg = jfs._gather_all_stacked(jstate.tables, _jb(h)["ids"], jfs.group_stacked_specs(specs_j, sorted(specs_j)))
        tg = tfs._gather_all_stacked(tstate.tables, _tb(h)["ids"], tfs.group_stacked_specs(specs_t, sorted(specs_t)))
    else:
        jg = jfs._gather_all(jstate.tables, _jb(h)["ids"])
        tg = tfs._gather_all(tstate.tables, _tb(h)["ids"])
    assert sorted(jg) == sorted(tg)
    for k in jg:
        np.testing.assert_array_equal(tg[k].numpy(), np.asarray(jg[k]), err_msg=k)
    assert np.isnan(tg["c"][1].numpy()).all() != stack


@pytest.mark.parametrize("offset,vocab", [(0, 50), (700, 50), (2 ** 31 - 101, 100)])
def test_update_ids_match_reference_routing(offset, vocab):
    """The step's update ids: what the reference's stacked step passes its
    ``sparse_update`` (``where(in_range, id + offset, -1)`` and the mask
    ``>= 0``) after its ``dedup_gradients`` routes the mask to the sentinel."""
    from persia_tpu.ops.sparse_update import _PAD_SENTINEL
    from persia_tpu_torch.ops.fused_gather import update_ids

    ids = np.random.default_rng(offset).integers(-3, vocab + 5, (16, 3)).astype(np.int32)
    ids[0] = [-1, vocab - 1, vocab]
    j = jnp.asarray(ids)
    routed = jnp.where((j >= 0) & (j < vocab), j + offset, -1).reshape(-1)
    want = np.asarray(jnp.where(routed >= 0, routed, _PAD_SENTINEL))
    got = update_ids(torch.from_numpy(ids), offset, vocab)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("stack", [True, False], ids=["stacked", "unstacked"])
def test_step_takes_its_update_ids_from_the_gather(stack, monkeypatch):
    """The step routes its update ids inside the gather (K4's keys) and
    calls ``update_keys`` never: with it raising, five steps still match
    the reference as ``test_five_steps_match_reference`` holds them."""
    def refuse(*args, **kwargs):
        raise AssertionError("the fused step called update_keys")

    monkeypatch.setattr(tfs, "update_keys", refuse)
    (jstate, jstep, _, _), (tstate, tstep, _) = _pair("adagrad", stack)
    for i in range(5):
        h = _host_batch(10 + i, oob=stack)
        jstate, (jloss, jpreds) = jstep(jstate, _jb(h))
        tstate, (tloss, tpreds) = tstep(tstate, _tb(h))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(tpreds.numpy(), np.asarray(jpreds), **TIGHT)
    _assert_states_close(jstate, tstate, **TIGHT)


FUSED_GATHER_KEYS_CASES = {
    # (slot shapes, vocab, stacked, dim)
    "stacked_single_and_bag": ([(32,), (16, 3), (40,)], 50, True, 8),
    "unstacked_nan": ([(64,)], 30, False, 4),
    "unstacked_bag": ([(20, 5)], 30, False, 8),
    "stacked_130_slots": ([(6,)] * 65 + [(3, 2)] * 65, 7, True, 2),
    "stacked_empty_slot": ([(10,), (0,), (12,)], 9, True, 4),
}


@pytest.mark.parametrize("case", sorted(FUSED_GATHER_KEYS_CASES))
def test_fused_gather_keys_match_reference_routing(case):
    """``fused_gather(..., keys=True)`` on the CPU: the rows are the keyless
    call's, bit for bit, and the keys ``update_keys_reference``'s and the
    reference step's routing (``where(in_range, id + offset, -1)``, then
    the mask to ``_PAD_SENTINEL``): padding, ids at vocab - 1, at vocab and
    far past it, more than 128 slots (the kernel's chunk), an empty slot."""
    from persia_tpu.ops.sparse_update import _PAD_SENTINEL
    from persia_tpu_torch.ops.fused_gather import fused_gather, fused_gather_reference, update_keys_reference

    shapes, vocab, stacked, dim = FUSED_GATHER_KEYS_CASES[case]
    rng = np.random.default_rng(len(case))
    table = torch.from_numpy(rng.standard_normal((vocab * len(shapes), dim)).astype(np.float32))
    ids_np = []
    for s in shapes:
        a = rng.integers(-1, vocab + 3, s).astype(np.int32)
        a.reshape(-1)[:4] = [-1, vocab - 1, vocab, 1 << 30][:a.size]
        ids_np.append(a)
    ids = [torch.from_numpy(a) for a in ids_np]
    offsets = [i * vocab for i in range(len(shapes))] if stacked else [0]
    vocabs = [vocab] * len(shapes)
    rows, keys = fused_gather(table, ids, offsets, vocabs, stacked, keys=True)
    plain = fused_gather(table, ids, offsets, vocabs, stacked)
    assert torch.equal(rows.view(torch.int32), plain.view(torch.int32))
    assert torch.equal(rows.view(torch.int32), fused_gather_reference(table, ids, offsets, vocabs, stacked)
                       .view(torch.int32))
    assert keys.dtype == torch.int32 and keys.shape == (rows.shape[0],)
    np.testing.assert_array_equal(keys.numpy(), update_keys_reference(ids, offsets, vocabs).numpy())
    want = []
    for a, o in zip(ids_np, offsets):
        j = jnp.asarray(a)
        routed = jnp.where((j >= 0) & (j < vocab), j + o, -1).reshape(-1)
        want.append(np.asarray(jnp.where(routed >= 0, routed, _PAD_SENTINEL)))
    np.testing.assert_array_equal(keys.numpy(), np.concatenate(want))


def test_eval_step_matches_reference():
    (jstate, _, jmodel, specs_j), (tstate, _, specs_t) = _pair("adagrad", True)
    h = _host_batch(7)
    ref = jfs.build_fused_eval_step(jmodel, specs_j, stack=True)(jstate, _jb(h))
    got = tfs.build_fused_eval_step(specs_t, stack=True)(tstate, _tb(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TIGHT)


@pytest.mark.parametrize("k", [2, 3])
def test_multi_step_equals_single_steps(k):
    """K steps in one call give the single-step loop's bits (the same
    kernels, in the same order)."""
    _, (single, step, specs) = _pair("adam", True, seed=1)
    _, (packed, _, _) = _pair("adam", True, seed=1)
    multi = tfs.build_fused_multi_step(OPTIMIZERS["adam"](topt).config, specs, k, stack=True)
    batches = [_tb(_host_batch(20 + i)) for i in range(k)]
    losses = [step(single, b)[1][0] for b in batches]
    packed, (mlosses, preds) = multi(packed, tuple(batches))
    assert len(preds) == k
    np.testing.assert_array_equal(mlosses.numpy(), torch.stack(losses).numpy())
    for a, b in zip(fused_state_to_flax(single)[1], fused_state_to_flax(packed)[1]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("vocab,n", [(1 << 30, 4), (1 << 29, 9), (1000, 3)])
def test_group_stacked_specs_matches_reference(vocab, n):
    """Groups, offsets and the int32 split agree with the reference's."""
    specs_j = {f"s{i}": jfs.FusedSlotSpec(vocab=vocab, dim=8 if i % 3 else 4) for i in range(n)}
    specs_t = {k: tfs.FusedSlotSpec(vocab=v.vocab, dim=v.dim) for k, v in specs_j.items()}
    ref = jfs.group_stacked_specs(specs_j, sorted(specs_j))
    got = tfs.group_stacked_specs(specs_t, sorted(specs_t))
    assert [(g.name, g.slots, g.offsets, g.vocab, g.dim) for g in got] == \
        [(g.name, g.slots, g.offsets, g.vocab, g.dim) for g in ref]
    assert all(g.vocab <= np.iinfo(np.int32).max for g in got)


def test_seeded_init_is_layout_independent():
    """A slot's rows are the same, bit for bit, stacked or not."""
    specs = _specs(tfs)
    cfg = topt.Adagrad(lr=0.1).config
    flat, _ = tfs.create_fused_tables(torch.Generator().manual_seed(3), specs, cfg, device="cpu")
    groups = tfs.group_stacked_specs(specs, sorted(specs))
    stacked, _ = tfs.create_stacked_tables(torch.Generator().manual_seed(3), specs, groups, cfg, device="cpu")
    for name in specs:
        assert torch.equal(tfs.stacked_slot_table(stacked, groups, name), flat[name])
    other, _ = tfs.create_fused_tables(torch.Generator().manual_seed(4), specs, cfg, device="cpu")
    assert not torch.equal(other["a"], flat["a"])


@pytest.mark.parametrize("kind,p0,p1", [
    ("uniform", -0.05, 0.02), ("inverse_sqrt", 0.0, 0.0), ("normal", 0.1, 0.3),
    ("gamma", 2.0, 0.5), ("gamma", 0.5, 1.0), ("poisson", 3.0, 0.0),
])
def test_init_statistics_match_reference(kind, p0, p1):
    """Each init kind's draws have the reference's mean and spread (and
    range) over 40k values: the generators differ, the distributions not."""
    shape = (5000, 8)
    jspec = jfs.FusedSlotSpec(vocab=shape[0], dim=shape[1], init_method=jconfig.InitializationMethod(kind, p0, p1))
    tspec = tfs.FusedSlotSpec(vocab=shape[0], dim=shape[1], init_method=tconfig.InitializationMethod(kind, p0, p1))
    ref = np.asarray(jfs._sample_init(jax.random.PRNGKey(0), shape, jspec, jnp.float32))
    got = tfs._sample_init(torch.Generator().manual_seed(0), shape, tspec, torch.float32, "cpu").numpy()
    sd = ref.std()
    assert abs(got.mean() - ref.mean()) < 4 * sd / np.sqrt(ref.size) * 2 + 1e-6
    assert abs(got.std() - sd) < 0.03 * sd + 1e-6
    assert got.min() >= min(ref.min(), 0) - 6 * sd and got.max() <= ref.max() + 6 * sd
    if kind in ("uniform", "inverse_sqrt"):
        lo, hi = (p0, p1) if kind == "uniform" else (-1 / np.sqrt(8), 1 / np.sqrt(8))
        assert got.min() >= lo and got.max() <= hi
    if kind == "poisson":
        np.testing.assert_array_equal(got, np.round(got))


def test_pack_unpack_ids_round_trip():
    h = _host_batch(2)
    order = sorted(h["ids"])
    flat, shapes = tfs.pack_ids(h["ids"], order)
    ref_flat, ref_shapes = jfs.pack_ids(h["ids"], order)
    np.testing.assert_array_equal(flat, ref_flat)
    assert list(shapes) == list(ref_shapes)
    out = tfs.unpack_ids(torch.from_numpy(flat), order, shapes)
    for n in order:
        np.testing.assert_array_equal(out[n].numpy(), h["ids"][n])
