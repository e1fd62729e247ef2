"""The port's cache tier (``persia_tpu_torch/embedding/hbm_cache``, the CPU
path: K12's and K13's plain versions) against the reference's
(``persia_tpu/embedding/hbm_cache``, JAX on the CPU), on the same
numpy-seeded inputs.

- the native directory (admit, ``admit_positions``, probe, drain,
  snapshot, the touch gate, both probe layouts) and the seeded cold-row
  init of every method: bit for bit;
- K12's plain version against ``_apply_aux`` and ``_gather_entry_rows``
  (f32 and bf16 wires, SGD / Adagrad / Adam, every miss reusing an evicted
  row, some of them): bit for bit; with the ring against
  ``_apply_aux_ring`` (positions that fit, that the clamp moves, negative
  ones): bit for bit; with restores (its part (d)) against ``_apply_aux``
  or ``_apply_aux_ring`` followed by ``_restore_rows`` (every optimizer,
  f32 and bf16 rings and aux entries, pads): bit for bit; it refuses a
  pairing under which the kernel could read a row after its write, a
  repeated write row and a restore from the call's own ring span; the
  tier's pairing holds at every step of a saturated directory (both admit
  paths);
- K13's plain version against the gather + ``_model_emb_from_gathered``
  and ``_gather_ext``: bit for bit at L=1, within 1e-6 at L <= 8;
- ``CachedTrainCtx`` held to the reference's over 6 steps: every step's
  row matrices, warm, cold and eviction lists bit for bit; losses and
  predictions and, after ``flush``, every parameter-server entry at the
  hybrid tier's tolerances (``tests/test_torch_train_ctx.py``: f32 1e-5
  relative; the bf16 wires round entries, so entries to 1e-3 and dense
  parameters to 1e-4); eval changes neither the cache nor the server; the
  evict-then-re-miss hazard; the checkpoint round trip.

Both packages' worker cores are the native ones (first-seen dedup), which
order the directory's admits alike.
"""

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
from persia_tpu.embedding.hashing import init_for_signs as jinit_for_signs
from persia_tpu.embedding.hbm_cache import groups as jgroups
from persia_tpu.embedding.store import EmbeddingStore as JaxStore
from persia_tpu.embedding.worker import EmbeddingWorker as JaxWorker
from persia_tpu.models import DLRM as JaxDLRM
import persia_tpu_torch.config as tcfg
from persia_tpu_torch.embedding import hbm_cache as thbm
from persia_tpu_torch.embedding import optim as toptim
from persia_tpu_torch.embedding.hashing import init_for_signs as tinit_for_signs
from persia_tpu_torch.embedding.native_store import NativeEmbeddingStore
from persia_tpu_torch.embedding.store import EmbeddingStore
from persia_tpu_torch.embedding.worker import EmbeddingWorker
from persia_tpu_torch.models import DLRM
from persia_tpu_torch.ops.cache_aux import (
    cache_aux,
    cache_aux_reference,
    cache_aux_ring_reference,
    check_pairing,
    gather_entry_rows_reference,
    ring_start,
)
from persia_tpu_torch.testing.cache_cases import aux_case
from persia_tpu_torch.ops.cached_gather import cached_gather_reference, per_position_grads
from persia_tpu_torch.weights import cached_dense_from_flax, seeded_flax_params_like
from persia_tpu_torch.wire import bf16_bits_to_f32

TIGHT = dict(rtol=1e-5, atol=1e-6)
DIM, BOTTOM, TOP, DENSE = 8, (16, 8), (32, 16), 4


# ------------------------------------------------------------- directory


def _dir_pair(capacity, touches=1, probe=None):
    j = jhbm.CacheDirectory(capacity, admit_touches=touches)
    t = thbm.CacheDirectory(capacity, admit_touches=touches, probe=probe)
    return j, t


def _same(a, b):
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(np.asarray(y), x)
        else:
            assert x == y


@pytest.mark.parametrize("probe", [0, 1])
@pytest.mark.parametrize("touches", [1, 2, 3])
def test_directory_matches_reference(probe, touches):
    """Ten batches of zipf signs through admit (distinct) and
    admit_positions (duplicated) on a small capacity: every output, the
    probe, the snapshot and the drain, bit for bit."""
    rng = np.random.default_rng(touches)
    ja, ta = _dir_pair(48, touches, probe)
    jp, tp = _dir_pair(48, touches, probe)
    for _ in range(10):
        signs = (rng.zipf(1.3, 60) % 200).astype(np.uint64)
        uniq = np.unique(signs)[:40]
        _same(ja.admit(uniq), ta.admit(uniq))
        _same(jp.admit_positions(signs), tp.admit_positions(signs))
        probe_signs = np.arange(220, dtype=np.uint64)
        np.testing.assert_array_equal(ta.probe(probe_signs), ja.probe(probe_signs))
        _same(ja.snapshot(), ta.snapshot())
        assert len(ja) == len(ta) and len(jp) == len(tp)
    _same(ja.drain(), ta.drain())
    assert len(ta) == 0 and (ta.probe(np.arange(5, dtype=np.uint64)) == -1).all()


def test_directory_overflow_and_eviction():
    """A batch larger than the capacity raises; eviction takes the least
    recently used sign and hands its row to the miss, never a sign of the
    same batch."""
    d = thbm.CacheDirectory(4)
    with pytest.raises(RuntimeError, match="exceeds cache capacity"):
        d.admit(np.arange(5, dtype=np.uint64))
    rows, *_ = d.admit(np.array([10, 11, 12], dtype=np.uint64))
    d.admit(np.array([12, 10], dtype=np.uint64))
    rows3, miss3, ev_s, ev_r = d.admit(np.array([13, 14], dtype=np.uint64))
    assert ev_s.tolist() == [11] and ev_r[0] == rows[1]
    assert thbm.group_salt("cache_d16") == jhbm.directory.group_salt("cache_d16")


@pytest.mark.parametrize("method", [
    tcfg.InitializationMethod("uniform", -0.1, 0.2),
    tcfg.InitializationMethod("normal", 0.0, 0.05),
    tcfg.InitializationMethod("gamma", 0.7, 0.1),
    tcfg.InitializationMethod("poisson", 3.0, 0.0),
    tcfg.InitializationMethod("inverse_sqrt", 0.0, 0.0),
])
def test_native_init_rows_match_reference(method):
    signs = np.random.default_rng(3).integers(0, 2 ** 63, 50, dtype=np.uint64)
    jmethod = jcfg.InitializationMethod(method.kind, method.p0, method.p1)
    ref = jhbm.directory.native_init_rows(signs, 7, 12, jmethod)
    np.testing.assert_array_equal(thbm.native_init_rows(signs, 7, 12, method), ref)
    np.testing.assert_array_equal(tinit_for_signs(signs, 7, 12, method), jinit_for_signs(signs, 7, 12, jmethod))
    if method.kind == "uniform":
        np.testing.assert_array_equal(thbm.native_uniform_init(signs, 7, 12, -0.1, 0.2), ref)


# ------------------------------------------------------------ K12: aux


def _opt(kind):
    return {"sgd": lambda m: m.SGD(lr=0.1), "adagrad": lambda m: m.Adagrad(lr=0.1),
            "adagrad_vw": lambda m: m.Adagrad(lr=0.1, vectorwise_shared=True),
            "adam": lambda m: m.Adam(lr=0.01)}[kind]


def _aux_inputs(kind, C, reuse, seed):
    """Random pools and one step's aux pieces: evictions, warm and cold
    rows (bucket-padded as the tier pads), with every miss on an evicted
    row when ``reuse``."""
    rng = np.random.default_rng(seed)
    cfg = _opt(kind)(toptim).config
    dim = DIM
    widths = {"sgd": [], "adagrad": [("acc", dim)], "adagrad_vw": [("acc", 1)],
              "adam": [("m", dim), ("v", dim)]}[kind]
    table = rng.normal(size=(C + 1, dim)).astype(np.float32)
    table[C] = 0
    state = {k: rng.random((C + 1, w)).astype(np.float32) for k, w in widths}
    perm = rng.permutation(C)
    ev = perm[:10]
    if reuse == "partial":  # misses on ev[0, 3, 5, 7, 8]; ev[1, 2, 4, 6, 9] unclaimed
        m_rows = np.array([ev[0], ev[3], perm[10], perm[11], ev[5], perm[12]])
        c_rows = np.array([perm[13], ev[7], ev[8], perm[14]])
    elif reuse:
        m_rows, c_rows = ev[:6], ev[6:]
    else:
        m_rows, c_rows = perm[10:16], perm[16:20]
    E = dim + sum(w for _, w in widths)

    def pad(rows, to, fill):
        out = np.full(to, fill, np.int32)
        out[:len(rows)] = rows
        return out

    x = dict(
        table=table, state=state,
        ev_rows=pad(ev, 16, C), m_rows=pad(m_rows, 8, C + 1), c_rows=pad(c_rows, 8, C + 1),
        m_entries=rng.normal(size=(8, E)).astype(np.float32), c_emb=rng.normal(size=(8, dim)).astype(np.float32),
    )
    x.update(_pairing(x["ev_rows"][:len(ev)], len(x["ev_rows"]), x["m_rows"], x["c_rows"]))
    return cfg, x


def _pairing(ev, n_ev, m_rows, c_rows):
    """K12's pairing of writes that land on evicted rows: each write's slot
    in ``ev`` (the live evictions) or -1, and the slots no write claims
    (of ``n_ev``, pads included)."""
    where = {int(r): i for i, r in enumerate(ev)}
    m_slot, c_slot = ([where.get(int(r), -1) for r in rows] for rows in (m_rows, c_rows))
    claimed = {s for s in m_slot + c_slot if s >= 0}
    return dict(m_slot=np.array(m_slot, np.int32), c_slot=np.array(c_slot, np.int32),
                ev_free=np.array([s for s in range(n_ev) if s not in claimed], np.int32))


def _torch_pairing(x):
    return {k: torch.from_numpy(x[k]) for k in ("m_slot", "c_slot", "ev_free")}


@pytest.mark.parametrize("reuse", [False, True, "partial"])
@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["sgd", "adagrad", "adagrad_vw", "adam"])
def test_cache_aux_plain_matches_reference(kind, wire, reuse):
    """K12's plain version: the payload (read before the writes), the
    table and every state column after, bit for bit ``_apply_aux``; with
    ``reuse`` every miss is admitted into a row evicted this step, with
    "partial" some are and some evictions no write claims."""
    cfg, x = _aux_inputs(kind, 64, reuse, seed=len(kind) + 7 * (reuse is True) + 3 * (reuse == "partial"))
    bf16 = wire == "bfloat16"
    m_ent, c_emb = x["m_entries"], x["c_emb"]
    if bf16:  # the aux wire: the same bits on both sides
        m_ent, c_emb = m_ent.astype(ml_dtypes.bfloat16), c_emb.astype(ml_dtypes.bfloat16)
    consts = jgroups._state_init_consts(_opt(kind)(joptim).config)
    jt, js, jpay = jgroups._apply_aux(
        jnp.asarray(x["table"]), {k: jnp.asarray(v) for k, v in x["state"].items()}, jnp.asarray(x["ev_rows"]),
        jnp.asarray(x["m_rows"]), jnp.asarray(m_ent), jnp.asarray(x["c_rows"]), jnp.asarray(c_emb), consts, bf16)

    def t(a):
        return torch.from_numpy(np.asarray(a).view(np.int16)).view(torch.bfloat16) if bf16 else torch.from_numpy(a)

    table = torch.from_numpy(x["table"].copy())
    state = {k: torch.from_numpy(v.copy()) for k, v in x["state"].items()}
    tconsts = thbm.groups._state_init_consts(cfg)
    assert tconsts == consts
    pay = cache_aux_reference(table, state, torch.from_numpy(x["ev_rows"]), torch.from_numpy(x["m_rows"]), t(m_ent),
                              torch.from_numpy(x["c_rows"]), t(c_emb), tconsts, bf16, **_torch_pairing(x))
    if bf16:
        assert pay.dtype == torch.bfloat16
        np.testing.assert_array_equal(pay.view(torch.int16).numpy(), np.asarray(jpay).view(np.int16))
    else:
        np.testing.assert_array_equal(pay.numpy(), np.asarray(jpay))
    np.testing.assert_array_equal(table.numpy(), np.asarray(jt))
    for k in state:
        np.testing.assert_array_equal(state[k].numpy(), np.asarray(js[k]), err_msg=k)
    # an entry's state tail split into the state's columns
    tail = np.asarray(x["m_entries"])[:, DIM:]
    jcols = jgroups._entry_to_state_cols(js, jnp.asarray(tail))
    tcols = thbm.groups._entry_to_state_cols(state, torch.from_numpy(tail))
    assert set(tcols) == set(jcols)
    for k in jcols:
        np.testing.assert_array_equal(tcols[k].numpy(), np.asarray(jcols[k]))
    # the flush's read: (a) alone, in f32
    rows = np.array([3, 0, 64, 17], np.int32)
    ref = jgroups._gather_entry_rows(jt, js, jnp.asarray(rows))
    np.testing.assert_array_equal(gather_entry_rows_reference(table, state, torch.from_numpy(rows)).numpy(),
                                  np.asarray(ref))


def test_cache_aux_wrapper_takes_the_plain_version_on_cpu():
    """The wrapper on CPU tensors is its plain version, the empty pieces
    included, and validates its inputs."""
    cfg, x = _aux_inputs("adagrad", 32, True, seed=5)
    table = torch.from_numpy(x["table"].copy())
    state = {k: torch.from_numpy(v.copy()) for k, v in x["state"].items()}
    consts = thbm.groups._state_init_consts(cfg)
    empty = torch.empty(0, dtype=torch.int32)
    unclaimed = dict(m_slot=empty, c_slot=empty, ev_free=torch.arange(16, dtype=torch.int32))
    pay = thbm.groups._apply_aux(table, state, torch.from_numpy(x["ev_rows"]), empty,
                                 torch.empty((0, 2 * DIM)), empty, torch.empty((0, DIM)), consts, **unclaimed)
    assert pay.shape == (16, 2 * DIM)
    np.testing.assert_array_equal(table.numpy(), x["table"])
    with pytest.raises(ValueError):
        thbm.groups._apply_aux(table, state, torch.from_numpy(x["ev_rows"]).long(), empty,
                               torch.empty((0, 2 * DIM)), empty, torch.empty((0, DIM)), consts, **unclaimed)


@pytest.mark.parametrize("fault", ["wrong_row", "claimed_twice", "claimed_and_free", "unlisted", "write_on_free",
                                   "slot_past_the_payload", "dropped_row_claims"])
def test_cache_aux_plain_raises_on_a_broken_pairing(fault):
    """The plain version on CPU tensors refuses a pairing under which the
    kernel could read a row after its write (or leave a slot unread)."""
    cfg, x = _aux_inputs("adagrad", 64, "partial", seed=9)
    p = _torch_pairing(x)
    m_slot, c_slot, ev_free = (p[k].clone() for k in ("m_slot", "c_slot", "ev_free"))
    m_rows = torch.from_numpy(x["m_rows"].copy())
    claimed = int((m_slot >= 0).nonzero()[0])
    if fault == "wrong_row":  # two claims swapped: each slot's row is the other write's
        other = int((c_slot >= 0).nonzero()[0])
        m_slot[claimed], c_slot[other] = c_slot[other].clone(), m_slot[claimed].clone()
    elif fault == "claimed_twice":
        c_slot[int((c_slot >= 0).nonzero()[0])] = m_slot[claimed]
    elif fault == "claimed_and_free":
        ev_free = torch.cat([ev_free, m_slot[claimed:claimed + 1]])
    elif fault == "unlisted":
        ev_free = ev_free[1:]
    elif fault == "write_on_free":  # a write lands on an unclaimed eviction's row
        m_rows[int((m_slot < 0).nonzero()[0])] = int(x["ev_rows"][int(ev_free[0])])
    elif fault == "slot_past_the_payload":
        ev_free = torch.cat([ev_free, torch.tensor([16], dtype=torch.int32)])
    else:  # a pad write (dropped) that claims a slot
        m_rows[claimed] = 64 + 1
    table = torch.from_numpy(x["table"].copy())
    state = {k: torch.from_numpy(v.copy()) for k, v in x["state"].items()}
    consts = thbm.groups._state_init_consts(cfg)
    with pytest.raises(ValueError):
        cache_aux_reference(table, state, torch.from_numpy(x["ev_rows"]), m_rows, torch.from_numpy(x["m_entries"]),
                            torch.from_numpy(x["c_rows"]), torch.from_numpy(x["c_emb"]), consts,
                            m_slot=m_slot, c_slot=c_slot, ev_free=ev_free)
    np.testing.assert_array_equal(table.numpy(), x["table"])  # nothing written


@pytest.mark.parametrize("wb_bf16", [False, True])
@pytest.mark.parametrize("ring_pos", [3, 40, -5, -60])
def test_cache_aux_ring_plain_matches_reference(ring_pos, wb_bf16):
    """The ring's plain version bit for bit ``_apply_aux_ring``: the ring
    (48 rows; the 16-row payload lands at 3, clamped from 40 to 32; a
    negative position counts from the end: -5 to 43, clamped to 32, -60
    to -12, clamped to 0), the payload, the table and the state; the
    wrapper on CPU tensors is it."""
    cfg, x = _aux_inputs("adam", 64, "partial", seed=abs(ring_pos) + 10)
    consts = jgroups._state_init_consts(_opt("adam")(joptim).config)
    E = 3 * DIM
    ring0 = np.random.default_rng(1).normal(size=(48, E)).astype(np.float32)
    if wb_bf16:
        ring0 = ring0.astype(ml_dtypes.bfloat16)
    jt, js, jring, jpay = jgroups._apply_aux_ring(
        jnp.asarray(x["table"]), {k: jnp.asarray(v) for k, v in x["state"].items()}, jnp.asarray(ring0),
        jnp.int32(ring_pos), jnp.asarray(x["ev_rows"]), jnp.asarray(x["m_rows"]), jnp.asarray(x["m_entries"]),
        jnp.asarray(x["c_rows"]), jnp.asarray(x["c_emb"]), consts, wb_bf16)
    args = [torch.from_numpy(x[k]) for k in ("ev_rows", "m_rows", "m_entries", "c_rows", "c_emb")]

    def bits(a):
        a = np.asarray(a)
        return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a

    for fn in (lambda t, s, r: cache_aux_ring_reference(t, s, r, ring_pos, *args, consts, wb_bf16,
                                                         **_torch_pairing(x)),
               lambda t, s, r: thbm.groups._apply_aux(t, s, *args, consts, wb_bf16, ring=r, ring_pos=ring_pos,
                                                      **_torch_pairing(x))):
        table = torch.from_numpy(x["table"].copy())
        state = {k: torch.from_numpy(v.copy()) for k, v in x["state"].items()}
        ring = torch.from_numpy(bits(ring0).copy())
        if wb_bf16:
            ring = ring.view(torch.bfloat16)
        pay = fn(table, state, ring)
        as_np = (lambda t: t.view(torch.int16).numpy()) if wb_bf16 else (lambda t: t.numpy())
        np.testing.assert_array_equal(as_np(ring), bits(jring))
        np.testing.assert_array_equal(as_np(pay), bits(jpay))
        np.testing.assert_array_equal(table.numpy(), np.asarray(jt))
        for k in state:
            np.testing.assert_array_equal(state[k].numpy(), np.asarray(js[k]), err_msg=k)
    assert ring_start(48, ring_pos, 16) == {3: 3, 40: 32, -5: 32, -60: 0}[ring_pos]


def _restore_aux_case(kind, aux_bf16, wb_bf16, ring_pos, seed):
    """A step's pieces with restores (``aux_case``): 40 evictions (padded
    to 64), 12 warm, 10 cold and 14 restored misses (padded), half of the
    misses on evicted rows, from a 160-row ring."""
    return aux_case(kind, 300, DIM, 40, 12, 10, 0.5, aux_bf16, "cpu", seed, n_restore=14, ring_rows=160,
                    wb_bf16=wb_bf16, ring_pos=ring_pos)


def _jnp_bits(t):
    """A CPU tensor as JAX's array with the same bits (bf16 as ml_dtypes')."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(ml_dtypes.bfloat16))
    return jnp.asarray(t.numpy())


def _np_bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


def _t_bits(t):
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("store", [True, False])
@pytest.mark.parametrize("wb_wire", ["float32", "bfloat16"])
@pytest.mark.parametrize("aux_wire", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["sgd", "adagrad", "adagrad_vw", "adam"])
def test_cache_aux_restores_plain_matches_reference(kind, aux_wire, wb_wire, store):
    """K12 with restores, plain version and the CPU wrapper: bit for bit the
    reference's ``_apply_aux_ring`` (``store``: the payload also into the
    ring at 100, placed from 100 by the clamp to 96) or ``_apply_aux``,
    followed by ``_restore_rows`` from the ring: the payload, the ring, the
    table and every state column (pads dropped, a restored row claiming its
    evicted row's slot)."""
    wb_bf16 = wb_wire == "bfloat16"
    case = _restore_aux_case(kind, aux_wire == "bfloat16", wb_bf16, 100, seed=len(kind) + 3 * store)
    r_src, r_dst, r_slot = case["restores"]
    assert int((r_dst == 301).sum()) and int((r_slot >= 0).sum()) and int((case["m_rows"] == 301).sum())
    consts = jgroups._state_init_consts(_opt(kind)(joptim).config)
    assert consts == case["state_consts"]
    j = [_jnp_bits(case[k]) for k in ("ev_rows", "m_rows", "m_entries", "c_rows", "c_emb")]
    jt, js, jring = _jnp_bits(case["table"]), {k: _jnp_bits(v) for k, v in case["state"].items()}, \
        _jnp_bits(case["ring"])
    if store:
        jt, js, jring, jpay = jgroups._apply_aux_ring(jt, js, jring, jnp.int32(100), *j, consts, wb_bf16)
    else:
        jt, js, jpay = jgroups._apply_aux(jt, js, *j, consts, wb_bf16)
    jt, js = jgroups._restore_rows(jt, js, jring, jnp.asarray(r_src.numpy().astype(np.int64)),
                                   jnp.asarray(r_dst.numpy()))
    kw = {k: v for k, v in case.items() if k not in ("table", "state", "ring", "ring_pos")}
    for name, fn in (("plain", lambda t, s, r: (cache_aux_ring_reference(t, s, r, 100, **kw, wb_bf16=wb_bf16)
                                                if store else cache_aux_reference(t, s, **kw, wb_bf16=wb_bf16,
                                                                                  ring=r))),
                     ("wrapper", lambda t, s, r: cache_aux(t, s, **kw, wb_bf16=wb_bf16, ring=r,
                                                           ring_pos=100 if store else None))):
        table, state, ring = case["table"].clone(), {k: v.clone() for k, v in case["state"].items()}, \
            case["ring"].clone()
        before = cache_aux.launches
        pay = fn(table, state, ring)
        assert cache_aux.launches == before, name  # CPU tensors: the plain version, no launch
        np.testing.assert_array_equal(_t_bits(pay), _np_bits(jpay), err_msg=name)
        np.testing.assert_array_equal(_t_bits(ring), _np_bits(jring), err_msg=name)
        np.testing.assert_array_equal(table.numpy(), np.asarray(jt), err_msg=name)
        for k in state:
            np.testing.assert_array_equal(state[k].numpy(), np.asarray(js[k]), err_msg=f"{name} {k}")
    assert ring_start(160, 100, 64) == 96


@pytest.mark.parametrize("fault", ["slot_claimed_twice", "slot_of_another_row", "restore_on_a_warm_row",
                                   "restore_on_a_cold_row", "restore_from_the_span", "restore_from_the_span_end",
                                   "no_ring"])
def test_cache_aux_plain_refuses_a_broken_restore(fault):
    """On CPU tensors K12's plain version refuses, before writing anything,
    a restore under which the kernel could race or differ from the
    reference's order: a payload slot claimed by a warm write and a
    restore; a restore claiming a slot whose row is not its own; a restore
    row that repeats a warm or cold row; a live restore reading the ring
    span the same call stores (its first and last row); no ring at all.
    A pad restore (row C+1) may read the span."""
    case = _restore_aux_case("adagrad", True, True, 30, seed=11)
    r_src, r_dst, r_slot = (t.clone() for t in case["restores"])
    m_slot, m_rows, c_rows = case["m_slot"].clone(), case["m_rows"].clone(), case["c_rows"].clone()
    live = int((r_dst < 301).sum())
    ring = case["ring"]
    if fault == "slot_claimed_twice":
        i, j = int((m_slot >= 0).nonzero()[0]), int((r_slot >= 0).nonzero()[0])
        r_slot[j] = m_slot[i]
    elif fault == "slot_of_another_row":
        j = int((r_slot >= 0).nonzero()[0])
        free = int(case["ev_free"][0])
        r_slot[j] = free
    elif fault == "restore_on_a_warm_row":
        r_dst[int((r_slot < 0)[:live].nonzero()[0])] = m_rows[0]
    elif fault == "restore_on_a_cold_row":
        r_dst[int((r_slot < 0)[:live].nonzero()[0])] = c_rows[0]
    elif fault == "restore_from_the_span":
        r_src[0] = 30
    elif fault == "restore_from_the_span_end":
        r_src[live - 1] = 30 + 64 - 1
    else:
        ring = None
    pad = r_dst.shape[0] - 1
    assert r_dst[pad] == 301
    kw = {k: v for k, v in case.items() if k not in ("table", "state", "ring", "ring_pos", "restores", "m_slot",
                                                     "m_rows", "c_rows")}
    table = case["table"].clone()
    ok_src = r_src.clone()
    ok_src[pad] = 30  # a pad reading the span is no race: it reads nothing
    cache_aux_ring_reference(table.clone(), {k: v.clone() for k, v in case["state"].items()}, case["ring"].clone(),
                             30, m_slot=case["m_slot"], m_rows=case["m_rows"], c_rows=case["c_rows"], **kw,
                             wb_bf16=True, restores=(torch.where(torch.arange(len(r_src)) == pad, ok_src,
                                                                 case["restores"][0]), *case["restores"][1:]))
    with pytest.raises(ValueError):
        if ring is None:
            cache_aux_reference(table, case["state"], m_slot=m_slot, m_rows=m_rows, c_rows=c_rows, **kw,
                                wb_bf16=True, restores=(r_src, r_dst, r_slot))
        else:
            cache_aux_ring_reference(table, case["state"], ring.clone(), 30, m_slot=m_slot, m_rows=m_rows,
                                     c_rows=c_rows, **kw, wb_bf16=True, restores=(r_src, r_dst, r_slot))
    np.testing.assert_array_equal(table.numpy(), case["table"].numpy())  # nothing written


# ------------------------------------------------------- K13: gather-pool


def _gather_inputs(S, B, L, C, seed, miss=0):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(C + 1, DIM)).astype(np.float32)
    table[C] = 0
    rows = rng.integers(0, C + 1 + miss, (S, B, L)).astype(np.int32)
    rows[rng.random((S, B, L)) < 0.25] = C  # pads
    scale = (1.0 / np.sqrt(rng.integers(1, 5, (S, B)))).astype(np.float32)
    mt = rng.normal(size=(max(miss, 1), DIM)).astype(np.float32)
    return table, rows, scale, mt


@pytest.mark.parametrize("L", [1, 3, 8])
@pytest.mark.parametrize("with_scale", [False, True])
def test_cached_gather_plain_matches_reference_train(L, with_scale):
    """The pooled rows against ``tables[g][rows]`` +
    ``_model_emb_from_gathered`` (mask, sum over L, scale): bit for bit at
    L=1, 1e-6 beyond; the update keys are the reference's mask ``rows <
    C`` routed to the sentinel; the raw slot's rows and mask."""
    C = 50
    table, rows, scale, _ = _gather_inputs(3, 16, L, C, seed=L + 10 * with_scale)
    layout = jgroups.CacheLayout(stacked=(("g", ("a", "b", "c")),))
    batch = {"stacked_rows": {"g": jnp.asarray(rows)}, "raw_rows": {}}
    if with_scale:
        batch["stacked_scale"] = {"g": jnp.asarray(scale)}
    groups = [jgroups.CacheGroup("g", DIM, C, 0, ("a", "b", "c"), ())]
    ref = jgroups._model_emb_from_gathered(groups, batch, layout, {"g": jnp.asarray(table)[jnp.asarray(rows)]},
                                           {}, pad_row=lambda _: C)
    pooled, keys = cached_gather_reference(torch.from_numpy(table), torch.from_numpy(rows), True,
                                           torch.from_numpy(scale) if with_scale else None, keys=True)
    for i in range(3):
        if L == 1:
            np.testing.assert_array_equal(pooled[i].numpy(), np.asarray(ref[i]))
        else:
            np.testing.assert_allclose(pooled[i].numpy(), np.asarray(ref[i]), rtol=0, atol=1e-6)
    want = np.where(rows.reshape(-1) < C, rows.reshape(-1), np.iinfo(np.int32).max)
    np.testing.assert_array_equal(keys.numpy(), want)
    # the backward: the reference's cotangent of the gathered rows, masked
    # positions aside (their keys go to the sentinel)
    g = np.random.default_rng(1).normal(size=(3, 16, DIM)).astype(np.float32)

    def f(got):
        out = jgroups._model_emb_from_gathered(groups, batch, layout, {"g": got}, {}, pad_row=lambda _: C)
        return sum(jnp.sum(o * jnp.asarray(g[i])) for i, o in enumerate(out))

    jg = np.asarray(jax.grad(f)(jnp.asarray(table)[jnp.asarray(rows)])).reshape(-1, DIM)
    tg = per_position_grads(torch.from_numpy(g), L, torch.from_numpy(scale) if with_scale else None).numpy()
    live = rows.reshape(-1) < C
    np.testing.assert_array_equal(tg[live], jg[live])
    # a raw slot: (B, L) rows unmasked, the mask rows != C
    raw, mask, rkeys = cached_gather_reference(torch.from_numpy(table), torch.from_numpy(rows[0]), False, keys=True)
    np.testing.assert_array_equal(raw.numpy(), table[rows[0]])
    np.testing.assert_array_equal(mask.numpy(), rows[0] != C)
    np.testing.assert_array_equal(rkeys.numpy(), want[:16 * L])


@pytest.mark.parametrize("L", [1, 4])
def test_cached_gather_plain_matches_reference_eval(L):
    """Eval: rows > C read the miss table (``_gather_ext`` of the
    reference's eval step, restated here: it is a closure), then the same
    mask, sum and scale; bit for bit at L=1, 1e-6 beyond."""
    C, M = 40, 9
    table, rows, scale, mt = _gather_inputs(2, 12, L, C, seed=20 + L, miss=M)
    def gather_ext(tab, miss, r):
        from_cache = tab[jnp.minimum(r, C)]
        from_miss = miss[jnp.maximum(r - (C + 1), 0)]
        return jnp.where((r > C)[..., None], from_miss, from_cache)

    got = gather_ext(jnp.asarray(table), jnp.asarray(mt), jnp.asarray(rows))
    layout = jgroups.CacheLayout(stacked=(("g", ("a", "b")),))
    groups = [jgroups.CacheGroup("g", DIM, C, 0, ("a", "b"), ())]
    batch = {"stacked_rows": {"g": jnp.asarray(rows)}, "raw_rows": {}, "stacked_scale": {"g": jnp.asarray(scale)}}
    ref = jgroups._model_emb_from_gathered(groups, batch, layout, {"g": got}, {}, pad_row=lambda _: C)
    pooled = cached_gather_reference(torch.from_numpy(table), torch.from_numpy(rows), True,
                                     torch.from_numpy(scale), miss_table=torch.from_numpy(mt))
    for i in range(2):
        if L == 1:
            np.testing.assert_array_equal(pooled[i].numpy(), np.asarray(ref[i]))
        else:
            np.testing.assert_allclose(pooled[i].numpy(), np.asarray(ref[i]), rtol=0, atol=1e-6)
    raw, mask = cached_gather_reference(torch.from_numpy(table), torch.from_numpy(rows[0]), False,
                                        miss_table=torch.from_numpy(mt))
    np.testing.assert_array_equal(raw.numpy(), np.asarray(got[0]))


# ------------------------------------------------------ CachedTrainCtx


def _cfg(cfg, variable, prefix_bit=8):
    slots = {f"cat_{i}": cfg.SlotConfig(dim=DIM) for i in range(3)}
    if variable:
        slots["bag"] = cfg.SlotConfig(dim=DIM, sqrt_scaling=True)
        slots["hist"] = cfg.SlotConfig(dim=DIM, embedding_summation=False, sample_fixed_size=4)
    return cfg.EmbeddingConfig(slots_config=slots, feature_index_prefix_bit=prefix_bit)


def _batch(seed, variable, b=16, vocab=60, requires_grad=True):
    rng = np.random.default_rng(seed)
    feats = [jdata.IDTypeFeatureWithSingleID(f"cat_{i}", rng.integers(0, vocab, b, dtype=np.uint64))
             for i in range(3)]
    if variable:
        feats.append(jdata.IDTypeFeature("bag", [rng.integers(0, 30, rng.integers(0, 4), dtype=np.uint64)
                                                 for _ in range(b)]))
        feats.append(jdata.IDTypeFeature("hist", [rng.integers(0, 20, rng.integers(0, 6), dtype=np.uint64)
                                                  for _ in range(b)]))
    kw = dict(labels=[jdata.Label(rng.integers(0, 2, (b, 1)).astype(np.float32))]) if requires_grad else {}
    return jdata.PersiaBatch(
        feats, non_id_type_features=[jdata.NonIDTypeFeature(rng.normal(size=(b, DENSE)).astype(np.float32))],
        requires_grad=requires_grad, **kw)


def _tbatch(batch):
    import persia_tpu_torch.data as tdata

    return tdata.PersiaBatch.from_bytes(batch.to_bytes())


class _Recorder:
    """Wraps a tier's ``prepare_batch``, keeping each step's lists."""

    def __init__(self, tier):
        self.steps = []
        inner = tier.prepare_batch

        def wrapped(batch, **kw):
            out = inner(batch, **kw)
            self.steps.append(out)
            return out

        tier.prepare_batch = wrapped


def _host(a):
    """A staging array as f32/int host values (bf16 bits widened)."""
    if hasattr(a, "bits"):
        return bf16_bits_to_f32(a.bits)
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == ml_dtypes.bfloat16 else a


def _compare_lists(jsteps, tsteps, C, entry_tol):
    assert len(jsteps) == len(tsteps)
    for j, t in zip(jsteps, tsteps):
        jin, jlayout, jmiss, jcold, jrestore, jev, jmeta = j
        tin, tlayout, tmiss, tcold, trestore, tev, tmeta = t
        assert jrestore == {} and trestore == {}  # the synchronous path restores nothing
        assert tlayout.stacked == jlayout.stacked
        for key in ("stacked_rows", "raw_rows", "stacked_scale"):
            assert set(tin.get(key, {})) == set(jin.get(key, {}))
            for k, v in jin.get(key, {}).items():
                np.testing.assert_array_equal(tin[key][k], v, err_msg=f"{key} {k}")
        for ja, ta, warm in ((jmiss, tmiss, True), (jcold, tcold, False)):
            assert set(ta) == set(ja)
            for k in ja:
                rows = np.asarray(ja[k][0])
                np.testing.assert_array_equal(ta[k][0], rows)
                live = rows < C + 1  # pads are C+1, their values left as they were
                got, want = _host(ta[k][1])[live], _host(ja[k][1])[live]
                if warm:  # trained entries, back from the server
                    np.testing.assert_allclose(got, want, **entry_tol)
                else:  # seeded by sign
                    np.testing.assert_array_equal(got, want)
        assert set(tev) == set(jev)
        for k in jev:
            np.testing.assert_array_equal(tev[k][0], jev[k])
            js, jk, jpos = jmeta[k]
            ts, tk, tpos = tmeta[k]
            assert tk == jk and tpos == jpos == -1
            np.testing.assert_array_equal(ts, js)


def _pair(opt="adagrad", variable=False, cache_rows=256, wires="float32", touches=1, store="numpy", replicas=1):
    """(reference ctx, port ctx, their stores) on the same weights."""
    params = seeded_flax_params_like(DLRM(DENSE, 5 if variable else 3, DIM, BOTTOM, TOP,
                                          compute_dtype=torch.float32, device="cpu"), 11)
    kw = dict(capacity=1 << 14, num_internal_shards=2, seed=3)
    jstores = [JaxStore(optimizer=_opt(opt)(joptim).config, **kw) for _ in range(replicas)]
    jworker = JaxWorker(_cfg(jcfg, variable), jstores)
    jmodel = JaxDLRM(embedding_dim=DIM, bottom_mlp=BOTTOM, top_mlp=TOP, compute_dtype=jnp.float32)
    wire_kw = dict(wb_wire_dtype=wires, aux_wire_dtype=wires, admit_touches=touches, cache_rows=cache_rows)
    jctx = jhbm.CachedTrainCtx(jmodel, optax.adam(1e-3), _opt(opt)(joptim), jworker, _cfg(jcfg, variable),
                               **wire_kw).__enter__()
    jparams = jax.tree.map(jnp.asarray, params)
    tables, emb_state = jhbm.init_cached_tables(jctx.tier.groups, jctx.sparse_cfg)
    jctx.state = jhbm.CachedTrainState(
        params=jparams, batch_stats={}, opt_state=optax.adam(1e-3).init(jparams), tables=tables,
        emb_state=emb_state, emb_batch_state=jnp.ones((2,), jnp.float32), step=jnp.zeros((), jnp.int32))

    tcls = {"numpy": EmbeddingStore, "native": NativeEmbeddingStore}[store]
    tstores = [tcls(optimizer=_opt(opt)(toptim).config, **kw) for _ in range(replicas)]
    tworker = EmbeddingWorker(_cfg(tcfg, variable), tstores)
    model = DLRM(DENSE, 5 if variable else 3, DIM, BOTTOM, TOP, compute_dtype=torch.float32, device="cpu")
    opt_t = torch.optim.Adam(model.parameters(), lr=1e-3)
    tctx = thbm.CachedTrainCtx(model, opt_t, _opt(opt)(toptim), tworker, _cfg(tcfg, variable), device="cpu",
                               **wire_kw).__enter__()
    tctx.init_state()
    count = jnp.zeros((), jnp.int32)
    zeros = jax.tree.map(jnp.zeros_like, jparams)
    cached_dense_from_flax(tctx.state, params, zeros, zeros, count)
    return jctx, tctx, jstores, tstores


def _entries(jstores, tstores):
    """Every reference entry with the port's entry of its sign."""
    out = []
    for js, ts in zip(jstores, tstores):
        assert js.size() == ts.size() > 0
        for shard in js._shards:
            for sign, (_, vec) in shard.entries.items():
                out.append((sign, vec, ts.get_embedding_entry(sign)))
    return out


def _train_both(jctx, tctx, n, variable, seed0=0, vocab=60, fetch=True):
    jrec, trec = _Recorder(jctx.tier), _Recorder(tctx.tier)
    losses = []
    for s in range(n):
        batch = _batch(seed0 + s, variable, vocab=vocab)
        a = jctx.train_step(batch)
        b = tctx.train_step(_tbatch(batch))
        losses.append((a, b))
    _compare_lists(jrec.steps, trec.steps, tctx.tier.groups[0].rows,
                   TIGHT if not tctx.tier.aux_bf16 else dict(rtol=0, atol=1e-3))
    return losses


CASES = {
    # name: (optimizer, variable, cache rows, wires, touches, store, replicas)
    "adagrad_no_eviction": ("adagrad", False, 256, "float32", 1, "numpy", 1),
    "adagrad_evictions": ("adagrad", False, 64, "float32", 1, "native", 2),
    "sgd_evictions_variable": ("sgd", True, 128, "float32", 1, "numpy", 1),
    "adam_evictions": ("adam", False, 64, "float32", 1, "native", 1),
    "adagrad_bf16_wires_touch2": ("adagrad", False, 64, "bfloat16", 2, "native", 1),
    "adagrad_variable_bf16": ("adagrad", True, 128, "bfloat16", 1, "numpy", 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cached_ctx_matches_reference(case):
    opt, variable, rows, wires, touches, store, replicas = CASES[case]
    jctx, tctx, jstores, tstores = _pair(opt, variable, rows, wires, touches, store, replicas)
    steps = _train_both(jctx, tctx, 6, variable)
    for a, b in steps:
        np.testing.assert_allclose(b["loss"], a["loss"], **TIGHT)
        np.testing.assert_allclose(b["preds"], np.asarray(a["preds"]), **TIGHT)
    if rows < 100:
        assert tctx.tier.evictions > 0, "the case must evict"
    assert tctx.tier.counts()["misses"] > 0
    jctx.flush()
    tctx.flush()
    assert len(tctx.tier.dirs["cache_d8"]) == 0
    entry_tol = TIGHT if wires == "float32" else dict(rtol=0, atol=1e-3)
    for sign, ref, got in _entries(jstores, tstores):
        np.testing.assert_allclose(got, ref, err_msg=str(sign), **entry_tol)
    if opt == "adam":
        assert tctx.worker.lookup_router.batch_advances == {g: 6 for g in range(3)}


@pytest.mark.parametrize("variable", [False, True])
def test_tier_pairing_holds_on_a_saturated_directory(variable):
    """The directory hands the k rows a call evicts to its last k misses, in
    order: at every step of a saturated cache (both admit paths), each
    eviction slot is claimed by exactly one warm or cold write, the
    unclaimed list is the pads, a claimed slot's row is its writer's row,
    and ``check_pairing`` passes."""
    cfg = _cfg(tcfg, variable)
    store = EmbeddingStore(capacity=1 << 14, num_internal_shards=2, seed=3, optimizer=toptim.Adagrad(lr=0.1).config)
    model = DLRM(DENSE, 5 if variable else 3, DIM, BOTTOM, TOP, compute_dtype=torch.float32, device="cpu")
    ctx = thbm.CachedTrainCtx(model, torch.optim.Adam(model.parameters(), lr=1e-3), toptim.Adagrad(lr=0.1),
                              EmbeddingWorker(cfg, [store]), cfg, cache_rows=128 if variable else 64,
                              device="cpu").__enter__()
    rec = _Recorder(ctx.tier)
    for s in range(8):
        ctx.train_step(_tbatch(_batch(s, variable)))
    C = ctx.tier.groups[0].rows
    evicting = 0
    for _inputs, _layout, miss, cold, _restore, ev, meta in rec.steps:
        for g in set(miss) | set(cold) | set(ev):
            writes = [w for w in (miss.get(g), cold.get(g)) if w is not None]
            e_rows, e_free = ev.get(g, (np.empty(0, np.int32), np.empty(0, np.int32)))
            k = meta[g][1] if g in meta else 0
            claims = np.concatenate([slot[slot >= 0] for _, _, slot in writes])
            np.testing.assert_array_equal(np.sort(claims), np.arange(k))
            np.testing.assert_array_equal(e_free[e_free >= 0], np.arange(k, len(e_rows)))
            for rows, _, slot in writes:
                assert slot.shape == rows.shape
                np.testing.assert_array_equal(e_rows[slot[slot >= 0]], rows[slot >= 0])
            t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (e_rows, e_free)]
            m = [torch.from_numpy(a) for a in (miss[g][0], miss[g][2])] if g in miss else [t[1][:0]] * 2
            c = [torch.from_numpy(a) for a in (cold[g][0], cold[g][2])] if g in cold else [t[1][:0]] * 2
            check_pairing(C + 1, t[0], m[0], m[1], c[0], c[1], t[1])
            evicting += k > 0
    assert evicting >= 3, "the cache must saturate"


def test_cached_ctx_eval_changes_nothing():
    """Eval on seen and unseen signs: predictions as the reference's, the
    directory (length and listing) and every server entry unchanged;
    training continues after."""
    jctx, tctx, jstores, tstores = _pair("adagrad", True, 128)
    _train_both(jctx, tctx, 4, True)
    tctx.drain()
    jctx.drain()
    d = tctx.tier.dirs["cache_d8"]
    before = (len(d), d.snapshot(), {s: e.copy() for s, _, e in _entries(jstores, tstores)}, tstores[0].size())
    for seed in (2, 99):
        batch = _batch(seed, True, vocab=200, requires_grad=False)
        ref = np.asarray(jctx.eval_batch(batch))
        got = tctx.eval_batch(_tbatch(batch))
        np.testing.assert_allclose(got, ref, **TIGHT)
    assert len(d) == before[0] and tstores[0].size() == before[3]
    _same(before[1], d.snapshot())
    for sign, _, e in _entries(jstores, tstores):
        np.testing.assert_array_equal(e, before[2][sign])
    _train_both(jctx, tctx, 1, True, seed0=50)


def test_cached_ctx_hazard_evict_then_remiss():
    """A sign evicted at step N and missed again at N+1 reads its trained
    row: the deferred write-back lands first. The pipelined run's server
    entries equal a run that drains after every step, bit for bit, and the
    reference's."""
    blocks = [[0, 1, 2, 3], [4, 5, 6, 7], [0, 1, 2, 3], [4, 5, 6, 7]]

    def batch(block):
        rng = np.random.default_rng(0)
        return jdata.PersiaBatch(
            [jdata.IDTypeFeature("cat", [np.array([s], dtype=np.uint64) for s in block])],
            non_id_type_features=[jdata.NonIDTypeFeature(np.ones((len(block), DENSE), np.float32))],
            labels=[jdata.Label(rng.integers(0, 2, (len(block), 1)).astype(np.float32))], requires_grad=True)

    def run(pkg, sync):
        cfg = (tcfg if pkg == "torch" else jcfg).EmbeddingConfig(
            slots_config={"cat": (tcfg if pkg == "torch" else jcfg).SlotConfig(dim=4)}, feature_index_prefix_bit=4)
        params = seeded_flax_params_like(DLRM(DENSE, 1, 4, (8, 4), (8,), compute_dtype=torch.float32,
                                              device="cpu"), 5)
        if pkg == "torch":
            store = EmbeddingStore(capacity=1 << 12, num_internal_shards=1, optimizer=toptim.SGD(lr=0.5).config,
                                   seed=2)
            model = DLRM(DENSE, 1, 4, (8, 4), (8,), compute_dtype=torch.float32, device="cpu")
            ctx = thbm.CachedTrainCtx(model, torch.optim.Adam(model.parameters(), lr=1e-2), toptim.SGD(lr=0.5),
                                      EmbeddingWorker(cfg, [store]), cfg, cache_rows=4, device="cpu").__enter__()
            ctx.init_state()
            z = jax.tree.map(np.zeros_like, params)
            cached_dense_from_flax(ctx.state, params, z, z, 0)
        else:
            store = JaxStore(capacity=1 << 12, num_internal_shards=1, optimizer=joptim.SGD(lr=0.5).config, seed=2)
            ctx = jhbm.CachedTrainCtx(JaxDLRM(embedding_dim=4, bottom_mlp=(8, 4), top_mlp=(8,),
                                              compute_dtype=jnp.float32),
                                      optax.adam(1e-2), joptim.SGD(lr=0.5), JaxWorker(cfg, [store]), cfg,
                                      cache_rows=4).__enter__()
            p = jax.tree.map(jnp.asarray, params)
            tables, emb_state = jhbm.init_cached_tables(ctx.tier.groups, ctx.sparse_cfg)
            ctx.state = jhbm.CachedTrainState(params=p, batch_stats={}, opt_state=optax.adam(1e-2).init(p),
                                              tables=tables, emb_state=emb_state,
                                              emb_batch_state=jnp.ones((2,), jnp.float32),
                                              step=jnp.zeros((), jnp.int32))
        hazards = 0
        for blk in blocks:
            pend = set(ctx._pending_signs)
            b = batch(blk)
            ctx.train_step(_tbatch(b) if pkg == "torch" else b, fetch_metrics=False)
            if sync:
                ctx.drain()
            elif pend:
                hazards += 1
        ctx.drain()
        ctx.flush()
        from persia_tpu_torch.embedding.hashing import add_index_prefix

        signs = add_index_prefix(np.arange(8, dtype=np.uint64), cfg.slot("cat").index_prefix, 4)
        return {int(s): store.get_embedding_entry(int(s)) for s in signs}, hazards

    sync, _ = run("torch", True)
    pipe, hazards = run("torch", False)
    ref, _ = run("jax", False)
    assert hazards > 0
    for s in sync:
        np.testing.assert_array_equal(pipe[s], sync[s], err_msg=str(s))
        np.testing.assert_allclose(pipe[s], ref[s], **TIGHT)


def test_cached_ctx_checkpoint_round_trip(tmp_path):
    """``dump_checkpoint`` flushes and writes the server; a fresh ctx over
    fresh stores ``load_checkpoint``s it and holds the same entries, and
    both continue alike."""
    _, tctx, _, tstores = _pair("adagrad", False, 64, store="native", replicas=2)
    for s in range(4):
        tctx.train_step(_tbatch(_batch(s, False)))
    tctx.dump_checkpoint(str(tmp_path / "ckpt"))
    assert all(len(d) == 0 for d in tctx.tier.dirs.values())
    _, other, _, ostores = _pair("adagrad", False, 64, store="native", replicas=2)
    other.load_checkpoint(str(tmp_path / "ckpt"))
    for ts, os_ in zip(tstores, ostores):
        assert ts.size() == os_.size() > 0
    signs = [s for ts in tstores for sh in range(ts.num_internal_shards) for s in _dump_signs(ts, sh)]
    for s in signs:
        r = next(x for x in ostores if x.get_embedding_entry(s) is not None)
        np.testing.assert_array_equal(r.get_embedding_entry(s),
                                      next(x for x in tstores if x.get_embedding_entry(s) is not None)
                                      .get_embedding_entry(s))
    other.state.model.load_state_dict(tctx.state.model.state_dict())
    other.state.optimizer.load_state_dict(tctx.state.optimizer.state_dict())
    b = _batch(9, False)
    np.testing.assert_array_equal(other.train_step(_tbatch(b))["loss"], tctx.train_step(_tbatch(b))["loss"])


def _dump_signs(store, shard):
    import struct

    raw = store.dump_shard(shard)
    (n,) = struct.unpack_from("<I", raw, 0)
    off, out = 4, []
    for _ in range(n):
        sign, _dim, ln = struct.unpack_from("<QII", raw, off)
        out.append(sign)
        off += 16 + 4 * ln
    return out


def test_cached_ctx_publish_keeps_the_cache():
    """``publish`` writes every resident row to the server and evicts
    nothing: the server then holds what ``flush`` would write."""
    jctx, tctx, jstores, tstores = _pair("adagrad", False, 256)
    _train_both(jctx, tctx, 3, False)
    d = tctx.tier.dirs["cache_d8"]
    n = len(d)
    assert tctx.publish() == n == jctx.publish() and len(d) == n
    for sign, ref, got in _entries(jstores, tstores):
        np.testing.assert_allclose(got, ref, **TIGHT)


def test_unsupported_options_raise():
    cfg = _cfg(tcfg, False)
    store = EmbeddingStore(optimizer=toptim.Adagrad(lr=0.1).config)
    model = DLRM(DENSE, 3, DIM, BOTTOM, TOP, compute_dtype=torch.float32, device="cpu")
    for kw in (dict(mesh=object()), dict(health_clip_norm=1.0), dict(health_probe=True)):
        with pytest.raises(NotImplementedError):
            thbm.CachedTrainCtx(model, torch.optim.Adam(model.parameters()), toptim.Adagrad(lr=0.1),
                                EmbeddingWorker(cfg, [store]), cfg, device="cpu", **kw)
    # the sharded feeder is ported (tests/test_torch_hbm_sharded_feeder.py)
    for kw, shards in ((dict(feed_shards=2), 2), (dict(feed_threads=4), 8)):
        ctx = thbm.CachedTrainCtx(model, torch.optim.Adam(model.parameters()), toptim.Adagrad(lr=0.1),
                                  EmbeddingWorker(cfg, [store]), cfg, device="cpu", **kw)
        assert ctx.tier.feed_shards == shards
    with pytest.raises(NotImplementedError):
        thbm.build_cached_train_step(model, None, toptim.Adagrad(lr=0.1).config, [], sentinel_probe=True)
    with pytest.raises(ValueError, match="table_dtype"):
        thbm.CachedTrainCtx(model, torch.optim.Adam(model.parameters()), toptim.Adagrad(lr=0.1),
                            EmbeddingWorker(cfg, [store]), cfg, device="cpu", table_dtype=torch.float16)


# ---------------------------------------- the servers' entry reads, the worker


@pytest.mark.parametrize("backend", ["numpy", "native"])
@pytest.mark.parametrize("opt", ["adagrad", "adam", "sgd"])
def test_store_entry_reads_match_reference(backend, opt):
    """``checkout_entries`` (misses admitted with the seeded init),
    ``probe_entries`` (nothing admitted), ``get_entry_dim`` and
    ``set_embedding``: the port's stores against the reference's of the
    same backend, bit for bit, sizes included; then routed by sign over
    two replicas."""
    from persia_tpu.embedding.native_store import NativeEmbeddingStore as JaxNative

    jcls = {"numpy": JaxStore, "native": JaxNative}[backend]
    tcls = {"numpy": EmbeddingStore, "native": NativeEmbeddingStore}[backend]
    kw = dict(capacity=1 << 12, num_internal_shards=4, seed=5)
    js, ts = jcls(optimizer=_opt(opt)(joptim).config, **kw), tcls(optimizer=_opt(opt)(toptim).config, **kw)
    rng = np.random.default_rng(1)
    signs = rng.integers(0, 2 ** 62, 40, dtype=np.uint64)
    np.testing.assert_array_equal(ts.checkout_entries(signs[:25], DIM), js.checkout_entries(signs[:25], DIM))
    jw, jv = js.probe_entries(signs, DIM)
    tw, tv = ts.probe_entries(signs, DIM)
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(tv[tw], jv[jw])
    assert ts.size() == js.size() == 25
    assert ts.get_entry_dim(int(signs[0])) == DIM and ts.get_entry_dim(int(signs[30])) is None
    vals = rng.normal(size=(10, tv.shape[1])).astype(np.float32)
    js.set_embedding(signs[20:30], vals, dim=DIM)
    ts.set_embedding(signs[20:30], vals, dim=DIM)
    np.testing.assert_array_equal(ts.checkout_entries(signs, DIM), js.checkout_entries(signs, DIM))
    for s in signs.tolist():
        np.testing.assert_array_equal(ts.get_embedding_entry(s), js.get_embedding_entry(s))
    # routed: each sign's entry on the replica sign_to_shard names
    jr = JaxWorker(_cfg(jcfg, False), [jcls(optimizer=_opt(opt)(joptim).config, **kw) for _ in range(2)])
    tr = EmbeddingWorker(_cfg(tcfg, False), [tcls(optimizer=_opt(opt)(toptim).config, **kw) for _ in range(2)])
    jl, tl = jr.lookup_router, tr.lookup_router
    np.testing.assert_array_equal(tl.checkout_entries(signs[:30], DIM), jl.checkout_entries(signs[:30], DIM))
    vals_out, warm_out = np.zeros((40, tv.shape[1]), np.float32), np.zeros(40, np.uint8)
    w, v = tl.probe_entries(signs, DIM, vals_out=vals_out, warm_out=warm_out)
    jw, jv = jl.probe_entries(signs, DIM)
    np.testing.assert_array_equal(w, jw)
    np.testing.assert_array_equal(vals_out[w], jv[jw])
    tl.set_embedding(signs[30:], vals, dim=DIM, commit_incremental=True)
    jl.set_embedding(signs[30:], vals, dim=DIM, commit_incremental=True)
    np.testing.assert_array_equal(tl.lookup(signs, DIM, False), jl.lookup(signs, DIM, False))
    assert [r.size() for r in tl.replicas] == [r.size() for r in jl.replicas]


def test_sid_matrix_matches_reference():
    """The single-id path's (S, B) prefixed sign matrix: the native builder
    against the reference's and against numpy's prefixing."""
    from persia_tpu.embedding import native_worker as jnw
    from persia_tpu_torch.embedding import native_worker as tnw
    from persia_tpu_torch.embedding.hashing import add_index_prefix

    rng = np.random.default_rng(2)
    ids = [rng.integers(0, 2 ** 63, 33, dtype=np.uint64) for _ in range(5)]
    prefixes = np.array([0, 1 << 56, 2 << 56, 3 << 56, 4 << 56], dtype=np.uint64)
    a, b = np.empty((5, 33), np.uint64), np.empty((5, 33), np.uint64)
    assert tnw.build_sid_matrix(ids, prefixes, 8, a) and jnw.build_sid_matrix(ids, prefixes, 8, b)
    np.testing.assert_array_equal(a, b)
    for i in range(5):
        np.testing.assert_array_equal(a[i], add_index_prefix(ids[i], int(prefixes[i]), 8))
    with pytest.raises(ValueError):
        tnw.build_sid_matrix(ids[:4], prefixes, 8, a)
