"""The cache tier's precision options in the port (``CachedTrainCtx(...,
table_dtype=, dynamic_loss_scale=)``, the CPU path: the plain versions of
K12, K13, K5 and K15) against the reference's
(``persia_tpu/embedding/hbm_cache``, JAX on the CPU), on the same
numpy-seeded inputs and weights.

- K12's plain version on a bf16 pool against ``_apply_aux`` (and the ring
  and the restores) on a bf16 table, and the flush read against
  ``_gather_entry_rows``: bit for bit (every write rounds to bf16 as the
  reference's ``astype`` does, and a bf16 row widened to the f32 payload
  and rounded back keeps its bits);
- K13's plain version on a bf16 pool against the gather and
  ``_model_emb_from_gathered`` on the bf16 rows: bit for bit where a
  sample has one position and no scale; else the pinned departure (the
  port pools in f32, the reference sums and scales in bf16: within one
  bf16 rounding of the sum and one of the scale, 2^-7 relative); eval's
  miss rows rounded to bf16 as ``_gather_ext`` rounds them; the backward's
  per-position gradients bit for bit the reference's bf16 cotangents;
- K15's plain version with ``inv`` and ``finite`` against the reference's
  ``quantize_int8_ef(f * inv, r)`` and its select: on a finite step codes
  and scales bit for bit, the residual within the departure
  ``tests/test_torch_hbm_mixed.py`` pins; on an overflow zero codes, the
  residual as it was, the finite flag as the scales' tail;
- the twins of the cached cases of ``tests/test_loss_scale.py`` against
  the reference (an overflow skips the dense and the table updates, the
  scale grows after its interval, a scaled run equals an unscaled one,
  the stream recovers from a huge scale, the PS tier's gradients unscale
  through the stream on the f32, bf16 and int8 wires, weight decay leaks
  nothing on an overflow), with DLRM in f32 compute and dense Adam(1e-3)
  on both sides (the port's dense optimizer is Adam): losses,
  predictions, scales and flags, and every server entry after ``flush``;
- an overflow on a batch with nothing to admit changes no pool row or its
  state, no dense parameter or Adam moment, no PS-tier slot's row and no
  K15 residual, and halves the scale;
- bf16 pools against the reference's ``table_dtype=jnp.bfloat16`` over 5
  steps;
- the ``CachedTrainState`` bytes with a loss scale and bf16 pools are
  flax's, both ways.

Tolerances: f32 pools, TIGHT (rtol 1e-5, atol 1e-6) for losses,
predictions and entries, as ``tests/test_torch_hbm_cache.py``; the int8
wire's entries 2e-4 (the mixed-tier test's bound). bf16 pools of
single-id slots: losses, predictions and entries TIGHT; with bags
(sqrt-scaled) and a raw slot the pooled departure above moves losses and
predictions within 1e-3 and entries within 2e-3.
"""

import flax.serialization
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
from persia_tpu.embedding.store import EmbeddingStore as JaxStore
from persia_tpu.embedding.worker import EmbeddingWorker as JaxWorker
from persia_tpu.models import DLRM as JaxDLRM
from persia_tpu.parallel.grad_sync import quantize_int8_ef as jquantize
from persia_tpu.parallel.train_step import LossScaleState as JaxLossScale
import persia_tpu_torch.config as tcfg
import persia_tpu_torch.data as tdata
from persia_tpu_torch.embedding import hbm_cache as thbm
from persia_tpu_torch.embedding import optim as toptim
from persia_tpu_torch.embedding.store import EmbeddingStore
from persia_tpu_torch.embedding.worker import EmbeddingWorker
from persia_tpu_torch.models import DLRM
from persia_tpu_torch.ops.cache_aux import (
    cache_aux_reference,
    cache_aux_ring_reference,
    gather_entry_rows_reference,
    restore_rows_reference,
)
from persia_tpu_torch.ops.cached_gather import cached_gather, cached_gather_reference, per_position_grads
from persia_tpu_torch.ops.quantize_int8 import quantize_int8_ef, quantize_int8_ef_reference
from persia_tpu_torch.testing.watchdog import run_with_watchdog
from persia_tpu_torch.weights import (
    cached_dense_from_flax,
    cached_state_from_flax_bytes,
    cached_state_to_flax_bytes,
    seeded_flax_params_like,
    state_dict_from_flax,
)

TIGHT = dict(rtol=1e-5, atol=1e-6)
BAGS = dict(rtol=0, atol=1e-3)  # bf16 pools with bags and a raw slot: losses, predictions
BAG_ENTRIES = dict(rtol=0, atol=2e-3)
INT8_ENTRIES = dict(rtol=0, atol=2e-4)
DIM, BOTTOM, TOP, DENSE = 8, (16, 8), (32, 16), 4
HUGE = float(np.float32(3.0e38))  # tests/test_loss_scale.py's _HUGE: any gradient > ~1 overflows


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _bits(t):
    """A tensor's (or a jax array's) raw bits as numpy."""
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy().view(np.int32)
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a.view(np.int32)


# --------------------------------------------------- K12 on a bf16 pool


def _opt(kind, mod):
    return {"sgd": lambda: mod.SGD(lr=0.1), "adagrad": lambda: mod.Adagrad(lr=0.1),
            "adagrad_wd": lambda: mod.Adagrad(lr=0.1, weight_decay=0.01),
            "adagrad_vw": lambda: mod.Adagrad(lr=0.1, vectorwise_shared=True),
            "adam": lambda: mod.Adam(lr=0.01)}[kind]()


def _aux_case(kind, C, seed):
    """A bf16 pool (bf16-representable values), its f32 state, and one
    step's evictions, warm and cold rows (every miss on an evicted row but
    two), bucket-padded as the tier pads, with the kernel's pairing."""
    rng = np.random.default_rng(seed)
    widths = {"sgd": [], "adagrad": [("acc", DIM)], "adagrad_vw": [("acc", 1)],
              "adam": [("m", DIM), ("v", DIM)]}[kind]
    table = rng.normal(size=(C + 1, DIM)).astype(ml_dtypes.bfloat16)
    table[C] = 0
    state = {k: rng.random((C + 1, w)).astype(np.float32) for k, w in widths}
    perm = rng.permutation(C)
    ev = perm[:10]
    m_rows = np.array([ev[0], ev[1], ev[2], perm[10], ev[3], ev[4]])
    c_rows = np.array([ev[5], ev[6], perm[11], ev[7]])
    E = DIM + sum(w for _, w in widths)

    def pad(rows, to, fill):
        out = np.full(to, fill, np.int32)
        out[:len(rows)] = rows
        return out

    x = dict(table=table, state=state, ev_rows=pad(ev, 16, C), m_rows=pad(m_rows, 8, C + 1),
             c_rows=pad(c_rows, 8, C + 1), m_entries=rng.normal(size=(8, E)).astype(np.float32),
             c_emb=rng.normal(size=(8, DIM)).astype(np.float32))
    where = {int(r): i for i, r in enumerate(ev)}
    m_slot = [where.get(int(r), -1) for r in x["m_rows"]]
    c_slot = [where.get(int(r), -1) for r in x["c_rows"]]
    claimed = {s for s in m_slot + c_slot if s >= 0}
    x.update(m_slot=np.array(m_slot, np.int32), c_slot=np.array(c_slot, np.int32),
             ev_free=np.array([s for s in range(16) if s not in claimed], np.int32))
    return x


def _pairing(x):
    return {k: torch.from_numpy(x[k]) for k in ("m_slot", "c_slot", "ev_free")}


@pytest.mark.parametrize("aux_bf16", [False, True], ids=["aux_f32", "aux_bf16"])
@pytest.mark.parametrize("wb_bf16", [False, True], ids=["wb_f32", "wb_bf16"])
@pytest.mark.parametrize("kind", ["sgd", "adagrad", "adagrad_vw", "adam"])
def test_cache_aux_plain_on_bf16_pool_matches_reference(kind, wb_bf16, aux_bf16):
    """K12's plain version on a bf16 table: payload, table and state bit
    for bit ``_apply_aux`` on the same bf16 table (warm entries and cold
    seeds rounded to bf16, in f32 or from the bf16 aux wire); the flush
    read bit for bit ``_gather_entry_rows``. Under SGD the reference's
    payload and read stay bf16 (no f32 state to promote them); the port's
    are f32 with the same values."""
    x = _aux_case(kind, 64, seed=len(kind) + 3 * wb_bf16 + 5 * aux_bf16)
    m_ent, c_emb = x["m_entries"], x["c_emb"]
    if aux_bf16:
        m_ent, c_emb = m_ent.astype(ml_dtypes.bfloat16), c_emb.astype(ml_dtypes.bfloat16)
    consts = jgroups._state_init_consts(_opt(kind, joptim).config)
    jt, js, jpay = jgroups._apply_aux(
        jnp.asarray(x["table"]), {k: jnp.asarray(v) for k, v in x["state"].items()}, jnp.asarray(x["ev_rows"]),
        jnp.asarray(x["m_rows"]), jnp.asarray(m_ent), jnp.asarray(x["c_rows"]), jnp.asarray(c_emb), consts, wb_bf16)
    assert jt.dtype == jnp.bfloat16

    def t(a):
        return _bf16(a) if aux_bf16 else torch.from_numpy(a)

    table = _bf16(x["table"])
    state = {k: torch.from_numpy(v.copy()) for k, v in x["state"].items()}
    pay = cache_aux_reference(table, state, torch.from_numpy(x["ev_rows"]), torch.from_numpy(x["m_rows"]), t(m_ent),
                              torch.from_numpy(x["c_rows"]), t(c_emb), thbm.groups._state_init_consts(
                                  _opt(kind, toptim).config), wb_bf16, **_pairing(x))
    assert table.dtype == torch.bfloat16 and pay.dtype == (torch.bfloat16 if wb_bf16 else torch.float32)
    if kind == "sgd":  # no state to promote the reference's payload: bf16 whatever the wire, the same values
        assert jpay.dtype == jnp.bfloat16
        np.testing.assert_array_equal(pay.float().numpy(), np.asarray(jpay).astype(np.float32))
    else:
        np.testing.assert_array_equal(_bits(pay), _bits(jpay))
    np.testing.assert_array_equal(_bits(table), _bits(jt))
    for k in state:
        np.testing.assert_array_equal(state[k].numpy(), np.asarray(js[k]), err_msg=k)
    rows = np.array([3, 0, 64, 17], np.int32)
    ref = jgroups._gather_entry_rows(jt, js, jnp.asarray(rows))
    assert ref.dtype == (jnp.bfloat16 if kind == "sgd" else jnp.float32)  # the port's read is always f32
    np.testing.assert_array_equal(gather_entry_rows_reference(table, state, torch.from_numpy(rows)).numpy(),
                                  np.asarray(ref).astype(np.float32))


@pytest.mark.parametrize("wb_bf16", [False, True], ids=["wb_f32", "wb_bf16"])
def test_cache_aux_ring_and_restores_on_bf16_pool_match_reference(wb_bf16):
    """With a ring (``_apply_aux_ring``) and then restores from it
    (``_restore_rows``) on a bf16 table: the ring holds the widened
    payload, the restored rows round back to bf16, bit for bit; the
    ring's bits of a bf16 payload are the table's own bits."""
    x = _aux_case("adagrad", 64, seed=21 + wb_bf16)
    consts = jgroups._state_init_consts(_opt("adagrad", joptim).config)
    ring_dt = jnp.bfloat16 if wb_bf16 else jnp.float32
    E = DIM + DIM
    jring = jnp.zeros((64, E), ring_dt)
    jt, js, jring, jpay = jgroups._apply_aux_ring(
        jnp.asarray(x["table"]), {k: jnp.asarray(v) for k, v in x["state"].items()}, jring, jnp.int32(5),
        jnp.asarray(x["ev_rows"]), jnp.asarray(x["m_rows"]), jnp.asarray(x["m_entries"]),
        jnp.asarray(x["c_rows"]), jnp.asarray(x["c_emb"]), consts, wb_bf16)
    table = _bf16(x["table"])
    state = {k: torch.from_numpy(v.copy()) for k, v in x["state"].items()}
    ring = torch.zeros((64, E), dtype=torch.bfloat16 if wb_bf16 else torch.float32)
    pay = cache_aux_ring_reference(table, state, ring, 5, torch.from_numpy(x["ev_rows"]),
                                   torch.from_numpy(x["m_rows"]), torch.from_numpy(x["m_entries"]),
                                   torch.from_numpy(x["c_rows"]), torch.from_numpy(x["c_emb"]),
                                   thbm.groups._state_init_consts(_opt("adagrad", toptim).config), wb_bf16,
                                   **_pairing(x))
    for a, b in ((pay, jpay), (ring, jring), (table, jt)):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    if wb_bf16:  # a bf16 row through the f32 payload and back: its bits
        ev = x["ev_rows"][:10]
        np.testing.assert_array_equal(_bits(ring[5:15, :DIM]), x["table"][ev].view(np.int16))
    # restores of the evicted entries into free rows, from the ring
    src = np.arange(5, 11, dtype=np.int32)
    dst = np.array([40, 41, 42, 43, 44, 65], np.int32)  # the last a pad
    jt2, js2 = jgroups._restore_rows(jt, js, jring, jnp.asarray(src), jnp.asarray(dst))
    restore_rows_reference(table, state, ring, torch.from_numpy(src), torch.from_numpy(dst))
    np.testing.assert_array_equal(_bits(table), _bits(jt2))
    np.testing.assert_array_equal(state["acc"].numpy(), np.asarray(js2["acc"]))


# --------------------------------------------------- K13 on a bf16 pool


def _gather_case(S, B, L, C, seed, miss=0):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(C + 1, DIM)).astype(ml_dtypes.bfloat16)
    table[C] = 0
    rows = rng.integers(0, C + 1 + miss, (S, B, L)).astype(np.int32)
    rows[rng.random((S, B, L)) < 0.25] = C
    scale = (1.0 / np.sqrt(rng.integers(1, 5, (S, B)))).astype(np.float32)
    mt = rng.normal(size=(max(miss, 1), DIM)).astype(np.float32)
    return table, rows, scale, mt


def _pooled_departure(got, want):
    """The pinned departure of a bf16 pool's pooled rows: the reference's
    bf16 sum and scale against the port's f32 ones, within 2^-7 relative
    of the value (a bf16 rounding of the sum and one of the scale, 2^-9
    each, and the sum's own roundings) plus 1e-6."""
    gap = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert (gap <= 2.0 ** -7 * np.abs(got.astype(np.float64)) + 1e-6).all(), float(gap.max())


@pytest.mark.parametrize("L", [1, 3, 8])
@pytest.mark.parametrize("with_scale", [False, True])
def test_cached_gather_plain_on_bf16_pool_matches_reference(L, with_scale):
    C = 50
    table, rows, scale, _ = _gather_case(3, 16, L, C, seed=L + 10 * with_scale)
    layout = jgroups.CacheLayout(stacked=(("g", ("a", "b", "c")),))
    batch = {"stacked_rows": {"g": jnp.asarray(rows)}, "raw_rows": {}}
    if with_scale:
        batch["stacked_scale"] = {"g": jnp.asarray(scale)}
    groups = [jgroups.CacheGroup("g", DIM, C, 0, ("a", "b", "c"), ())]
    jtable = jnp.asarray(table)
    ref = jgroups._model_emb_from_gathered(groups, batch, layout, {"g": jtable[jnp.asarray(rows)]}, {},
                                           pad_row=lambda _: C)
    assert ref[0].dtype == jnp.bfloat16  # the reference pools in bf16, the port in f32
    tscale = torch.from_numpy(scale) if with_scale else None
    pooled, keys = cached_gather_reference(_bf16(table), torch.from_numpy(rows), True, tscale, keys=True)
    assert pooled.dtype == torch.float32
    for i in range(3):
        want = np.asarray(ref[i]).astype(np.float32)
        if L == 1 and not with_scale:
            np.testing.assert_array_equal(pooled[i].numpy(), want)
        else:
            _pooled_departure(pooled[i].numpy(), want)
    assert torch.equal(cached_gather(_bf16(table), torch.from_numpy(rows), True, tscale, keys=True)[0], pooled)
    g = np.random.default_rng(1).normal(size=(3, 16, DIM)).astype(np.float32)

    def f(got):
        out = jgroups._model_emb_from_gathered(groups, batch, layout, {"g": got}, {}, pad_row=lambda _: C)
        return sum(jnp.sum(o * jnp.asarray(g[i])) for i, o in enumerate(out))

    jg = jax.grad(f)(jtable[jnp.asarray(rows)])
    assert jg.dtype == jnp.bfloat16
    tg = per_position_grads(torch.from_numpy(g), L, tscale, bf16=True).numpy()
    live = rows.reshape(-1) < C
    np.testing.assert_array_equal(tg[live], np.asarray(jg).astype(np.float32).reshape(-1, DIM)[live])
    raw, mask = cached_gather_reference(_bf16(table), torch.from_numpy(rows[0]), False)
    np.testing.assert_array_equal(raw.numpy(), table[rows[0]].astype(np.float32))


def test_cached_gather_plain_eval_on_bf16_pool_rounds_the_miss_rows():
    """Eval on a bf16 pool: a miss row (f32 from the server) is rounded to
    bf16, as ``_gather_ext`` casts it to the table's dtype; one position a
    sample, no scale: bit for bit."""
    C, M = 40, 9
    table, rows, _, mt = _gather_case(2, 12, 1, C, seed=31, miss=M)
    jt = jnp.asarray(table)
    r = jnp.asarray(rows)
    got = jnp.where((r > C)[..., None], jnp.asarray(mt)[jnp.maximum(r - (C + 1), 0)].astype(jt.dtype),
                    jt[jnp.minimum(r, C)])
    layout = jgroups.CacheLayout(stacked=(("g", ("a", "b")),))
    groups = [jgroups.CacheGroup("g", DIM, C, 0, ("a", "b"), ())]
    batch = {"stacked_rows": {"g": r}, "raw_rows": {}}
    ref = jgroups._model_emb_from_gathered(groups, batch, layout, {"g": got}, {}, pad_row=lambda _: C)
    pooled = cached_gather_reference(_bf16(table), torch.from_numpy(rows), True, miss_table=torch.from_numpy(mt))
    for i in range(2):
        np.testing.assert_array_equal(pooled[i].numpy(), np.asarray(ref[i]).astype(np.float32))
    assert (rows > C).any()


# --------------------------------------------------- K15 with inv, finite


def _residual_departure(got, want, v):
    """``tests/test_torch_hbm_mixed.py``'s pinned departure of the
    residual: within 4 * 2^-23 * |v|, bar subnormals the reference
    flushed."""
    flushed = (want == 0) & (np.abs(got) < np.finfo(np.float32).tiny)
    gap = np.abs(got.astype(np.float64) - want.astype(np.float64))[~flushed]
    assert (gap <= 4 * 2.0 ** -23 * np.abs(v.astype(np.float64))[~flushed]).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("finite", [True, False], ids=["finite", "overflow"])
def test_quantize_int8_ef_with_loss_scale_matches_reference(dtype, finite):
    """The reference's int8 wire under the loss scale
    (``hbm_cache/step.py:361-415``): ``quantize_int8_ef(f * inv, r)`` a
    slot at a time, codes selected to 0 and the residual kept on an
    overflow, the scales' tail the finite flag."""
    rng = np.random.default_rng(7 + finite)
    offsets = [0, 96, 96, 353, 400]
    scale = np.float32(2.0 ** 12)
    g = (rng.standard_normal(400) * scale).astype(np.float32)
    if not finite:
        g[100] = np.inf
    res = (rng.standard_normal(400) * 1e-3).astype(np.float32)
    tg = torch.from_numpy(g)
    if dtype == "bfloat16":
        tg = tg.to(torch.bfloat16)
    gin = tg.float().numpy()
    inv = np.float32(1.0 / scale) if finite else np.float32(0.0)
    t_inv = torch.tensor(inv)
    t_fin = torch.tensor(1.0 if finite else 0.0)
    q, scales, new = quantize_int8_ef(tg, torch.from_numpy(res.copy()), offsets, t_inv, t_fin)
    q2, s2, new2 = quantize_int8_ef_reference(tg, torch.from_numpy(res.copy()), offsets, t_inv, t_fin)
    for a, b in ((q, q2), (scales, s2), (new, new2)):
        assert torch.equal(a, b)
    assert scales.shape == (5,) and float(scales[-1]) == float(finite)
    if not finite:
        assert not q.any() and not scales.any()
        np.testing.assert_array_equal(new.numpy(), res)
        return
    for s, (a, b) in enumerate(zip(offsets[:-1], offsets[1:])):
        if a == b:
            continue
        jq, js, _deq, jres = jax.jit(jquantize)(jnp.asarray(gin[a:b]) * jnp.float32(inv), jnp.asarray(res[a:b]))
        np.testing.assert_array_equal(q[a:b].numpy(), np.asarray(jq))
        assert scales[s].numpy().tobytes() == np.asarray(js, np.float32).tobytes()
        _residual_departure(new[a:b].numpy(), np.asarray(jres), (gin[a:b] * inv + res[a:b]).astype(np.float32))
    # without the loss scale the call is the old one, bit for bit
    plain = quantize_int8_ef_reference(tg, torch.from_numpy(res.copy()), offsets)
    unit = quantize_int8_ef_reference(tg, torch.from_numpy(res.copy()), offsets, torch.tensor(np.float32(1.0)),
                                      torch.tensor(1.0))
    assert torch.equal(plain[0], unit[0]) and torch.equal(plain[1], unit[1][:-1]) and torch.equal(plain[2], unit[2])


def test_quantize_int8_ef_refuses_half_a_gate():
    g, r = torch.zeros(8), torch.zeros(8)
    with pytest.raises(ValueError, match="together"):
        quantize_int8_ef(g, r, [0, 8], torch.tensor(1.0), None)
    with pytest.raises(ValueError, match="one-element"):
        quantize_int8_ef(g, r, [0, 8], torch.tensor([1.0, 1.0]), torch.tensor(1.0))


# ----------------------------------------------------- the ctx twins


def _cfg(cfg, slots=("cat_0", "cat_1", "cat_2"), variable=False):
    sc = {n: cfg.SlotConfig(dim=DIM) for n in slots}
    if variable:
        sc["bag"] = cfg.SlotConfig(dim=DIM, sqrt_scaling=True)
        sc["hist"] = cfg.SlotConfig(dim=DIM, embedding_summation=False, sample_fixed_size=4)
    return cfg.EmbeddingConfig(slots_config=sc, feature_index_prefix_bit=4)


def _batch(seed, slots=("cat_0", "cat_1", "cat_2"), scale=1.0, b=16, vocab=50, variable=False):
    rng = np.random.default_rng(seed)
    feats = [jdata.IDTypeFeature(n, list(rng.integers(0, vocab, (b, 1), dtype=np.uint64))) for n in slots]
    if variable:
        feats.append(jdata.IDTypeFeature("bag", [rng.integers(0, 30, rng.integers(0, 4), dtype=np.uint64)
                                                 for _ in range(b)]))
        feats.append(jdata.IDTypeFeature("hist", [rng.integers(0, 20, rng.integers(0, 6), dtype=np.uint64)
                                                  for _ in range(b)]))
    return jdata.PersiaBatch(
        feats, non_id_type_features=[jdata.NonIDTypeFeature((scale * rng.normal(size=(b, DENSE))).astype(np.float32))],
        labels=[jdata.Label(rng.integers(0, 2, (b, 1)).astype(np.float32))], requires_grad=True)


def _tb(batch):
    return tdata.PersiaBatch.from_bytes(batch.to_bytes())


def _n_slots(slots, variable):
    return len(slots) + 2 * variable


def _pair(opt="adagrad", slots=("cat_0", "cat_1", "cat_2"), ps=(), wire="float32", rows=64, table_bf16=False,
          variable=False, **kw):
    """(reference ctx, port ctx, reference store, port store) on the same
    seeded weights: DLRM in f32 compute, dense Adam(1e-3)."""
    n = _n_slots(slots, variable)
    params = seeded_flax_params_like(DLRM(DENSE, n, DIM, BOTTOM, TOP, compute_dtype=torch.float32, device="cpu"), 11)
    skw = dict(capacity=1 << 12, num_internal_shards=2, seed=3)
    common = dict(cache_rows=rows, ps_slots=list(ps), ps_wire_dtype=wire, **kw)
    jstore = JaxStore(optimizer=_opt(opt, joptim).config, **skw)
    jctx = jhbm.CachedTrainCtx(JaxDLRM(embedding_dim=DIM, bottom_mlp=BOTTOM, top_mlp=TOP, compute_dtype=jnp.float32),
                               optax.adam(1e-3), _opt(opt, joptim), JaxWorker(_cfg(jcfg, slots, variable), [jstore]),
                               _cfg(jcfg, slots, variable), table_dtype=jnp.bfloat16 if table_bf16 else jnp.float32,
                               **common).__enter__()
    jp = jax.tree.map(jnp.asarray, params)
    tables, emb_state = jhbm.init_cached_tables(jctx.tier.groups, jctx.sparse_cfg, dtype=jctx.table_dtype)
    ls = None
    if kw.get("dynamic_loss_scale"):
        ls = JaxLossScale(scale=jnp.asarray(kw.get("loss_scale_init", 2.0 ** 15), jnp.float32),
                          good_steps=jnp.zeros((), jnp.int32))
    jctx.state = jhbm.CachedTrainState(
        params=jp, batch_stats={}, opt_state=optax.adam(1e-3).init(jp), tables=tables, emb_state=emb_state,
        emb_batch_state=jnp.ones((2,), jnp.float32), step=jnp.zeros((), jnp.int32), loss_scale=ls)
    tstore = EmbeddingStore(optimizer=_opt(opt, toptim).config, **skw)
    tctx = _port(tstore, params, opt, slots, variable, table_bf16, **common)
    return jctx, tctx, jstore, tstore


def _port(tstore, params, opt, slots, variable, table_bf16, init=True, **kw):
    """The port's ctx over ``tstore`` with ``params`` loaded (``init``:
    its state made now; else a resume's ``init_state`` makes it)."""
    model = DLRM(DENSE, _n_slots(slots, variable), DIM, BOTTOM, TOP, compute_dtype=torch.float32, device="cpu")
    cfg = _cfg(tcfg, slots, variable)
    tctx = thbm.CachedTrainCtx(model, torch.optim.Adam(model.parameters(), lr=1e-3), _opt(opt, toptim),
                               EmbeddingWorker(cfg, [tstore]), cfg, device="cpu",
                               table_dtype=torch.bfloat16 if table_bf16 else torch.float32, **kw).__enter__()
    model.load_state_dict(state_dict_from_flax(model, params))
    if init:
        tctx.init_state()
        zeros = jax.tree.map(np.zeros_like, params)
        cached_dense_from_flax(tctx.state, params, zeros, zeros, np.zeros((), np.int32))
    return tctx


def _entries(store):
    return {int(s): np.array(v) for sh in store._shards for s, (_, v) in sh.entries.items()}


def _same_entries(jstore, tstore, tol):
    a, b = _entries(tstore), _entries(jstore)
    assert a.keys() == b.keys() and a
    for k in a:
        np.testing.assert_allclose(a[k], b[k], err_msg=str(k), **tol)


def _watch(fn, what="the stream"):
    return run_with_watchdog(fn, timeout=60.0, what=what)


def _dense_snapshot(ctx):
    out = [p.detach().clone() for p in ctx.model.parameters()]
    for st in ctx.dense_optimizer.state.values():
        out.extend(v.clone() for v in st.values() if torch.is_tensor(v))
    return out


def _pool_snapshot(ctx):
    return ({k: v.clone() for k, v in ctx.state.tables.items()},
            {(g, k): v.clone() for g, st in ctx.state.emb_state.items() for k, v in st.items()})


@pytest.mark.parametrize("table_bf16", [False, True], ids=["f32_pool", "bf16_pool"])
def test_cached_overflow_skips_dense_and_table_updates(table_bf16):
    """``test_cached_overflow_skips_dense_and_table_updates``: Adam on the
    rows (the state-decay case), a huge scale; the second overflow on the
    same batch (every sign resident) leaves the dense parameters, Adam's
    state, the pools and their state bit for bit, and both packages report
    the same flags and scales."""
    jctx, tctx, _, _ = _pair("adam", table_bf16=table_bf16, dynamic_loss_scale=True, loss_scale_init=HUGE,
                             loss_scale_max=HUGE)
    b = _batch(0, scale=100.0)
    j0, t0 = jctx.train_step(b), tctx.train_step(_tb(b))
    assert t0["grads_finite"] is j0["grads_finite"] is False and t0["loss_scale"] == j0["loss_scale"] == HUGE
    dense, (tables, states) = _dense_snapshot(tctx), _pool_snapshot(tctx)
    misses = tctx.tier.counts()["misses"]
    j1, t1 = jctx.train_step(b), tctx.train_step(_tb(b))
    assert tctx.tier.counts()["misses"] == misses  # nothing admitted
    assert t1["grads_finite"] is j1["grads_finite"] is False
    assert t1["loss_scale"] == j1["loss_scale"] == pytest.approx(HUGE / 2, rel=1e-6)
    for a, b_ in zip(dense, _dense_snapshot(tctx)):
        assert torch.equal(a, b_)
    for k, v in tables.items():
        np.testing.assert_array_equal(_bits(v), _bits(tctx.state.tables[k]))
    for key, v in states.items():
        assert torch.equal(v, tctx.state.emb_state[key[0]][key[1]])
    np.testing.assert_allclose(t1["loss"], j1["loss"], **TIGHT)


def test_cached_scale_grows_after_interval():
    jctx, tctx, _, _ = _pair(dynamic_loss_scale=True, loss_scale_init=8.0, loss_scale_growth_interval=3)
    js, ts = [], []
    for i in range(7):
        b = _batch(i)
        js.append(jctx.train_step(b)["loss_scale"])
        ts.append(tctx.train_step(_tb(b))["loss_scale"])
    assert ts == js and ts[:3] == [8.0, 8.0, 8.0] and ts[3] == 16.0 and ts[6] == 32.0


@pytest.mark.parametrize("table_bf16", [False, True], ids=["f32_pool", "bf16_pool"])
def test_cached_scaled_training_matches_unscaled(table_bf16):
    """A finite scale changes nothing: the port's scaled run equals its
    unscaled run (losses to TIGHT, entries bit for bit: the scale is a
    power of two, every unscale exact), and the reference's scaled run."""
    batches = [_batch(i) for i in range(6)]

    def run(pkg, **kw):
        jctx, tctx, jstore, tstore = _pair(table_bf16=table_bf16, **kw)
        ctx, store = (jctx, jstore) if pkg == "ref" else (tctx, tstore)
        losses = [ctx.train_step(b if pkg == "ref" else _tb(b))["loss"] for b in batches]
        ctx.flush()
        return losses, store

    l0, s0 = run("port")
    l1, s1 = run("port", dynamic_loss_scale=True, loss_scale_init=1024.0)
    lr, sr = run("ref", dynamic_loss_scale=True, loss_scale_init=1024.0)
    np.testing.assert_allclose(l1, l0, **TIGHT)
    np.testing.assert_allclose(l1, lr, **TIGHT)
    a, b = _entries(s0), _entries(s1)
    assert a.keys() == b.keys() and a
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    _same_entries(sr, s1, TIGHT)


def test_cached_stream_dynamic_scale_recovers():
    """``train_stream`` under a huge initial scale (dense features x100,
    as the reference's overflow tests scale them): the first steps
    overflow and back off, the run ends finite; the (scale, finite)
    sequence is the reference's stream's."""
    jctx, tctx, _, _ = _pair(dynamic_loss_scale=True, loss_scale_init=HUGE, loss_scale_max=HUGE)
    batches = [_batch(i, scale=100.0) for i in range(30)]
    seen, jseen = [], []
    _watch(lambda: tctx.train_stream([_tb(b) for b in batches],
                                     on_metrics=lambda m: seen.append((m["loss_scale"], m["grads_finite"]))))
    jctx.train_stream(batches, on_metrics=lambda m: jseen.append((m["loss_scale"], m["grads_finite"])))
    assert len(seen) == 30 and not seen[0][1] and seen[-1][1] and seen[-1][0] < seen[0][0]
    assert seen == jseen
    assert np.isfinite(tctx.last_metrics()["loss"])


@pytest.mark.parametrize("wire", ["float32", "bfloat16", "int8"])
def test_cached_ps_tier_grads_unscale_through_stream(wire):
    """The PS-tier slot's gradients ride the step's output scaled with a
    ``[scale | finite]`` tail (f32, bf16) or unscaled on the card (int8):
    the write-back lane divides them out, so the flushed entries equal an
    unscaled stream's (bit for bit: the scale is a power of two) and the
    reference's scaled stream's."""
    slots = ("cat", "ps")
    batches = [_batch(100 + i, slots=slots) for i in range(5)]

    def run(pkg, dyn):
        jctx, tctx, jstore, tstore = _pair(slots=slots, ps=("ps",), wire=wire, dynamic_loss_scale=dyn,
                                           loss_scale_init=256.0)
        ctx, store = (jctx, jstore) if pkg == "ref" else (tctx, tstore)
        losses = []
        go = lambda: ctx.train_stream(batches if pkg == "ref" else [_tb(b) for b in batches],  # noqa: E731
                                      on_metrics=lambda m: losses.append(m["loss"]))
        _watch(go) if pkg == "port" else go()
        assert ctx.worker.staleness == 0
        ctx.flush()
        return losses, store

    l0, s0 = run("port", False)
    l1, s1 = run("port", True)
    lr, sr = run("ref", True)
    np.testing.assert_allclose(l1, l0, **TIGHT)
    np.testing.assert_allclose(l1, lr, **TIGHT)
    a, b = _entries(s0), _entries(s1)
    assert a.keys() == b.keys() and a
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))
    _same_entries(sr, s1, TIGHT if wire != "int8" else INT8_ENTRIES)


def test_cached_overflow_noop_with_weight_decay():
    """Weight decay makes a zero gradient no no-op: an overflow must route
    every row away, so the resident rows keep their bits."""
    _, tctx, _, _ = _pair("adagrad_wd", dynamic_loss_scale=True, loss_scale_init=HUGE, loss_scale_max=HUGE)
    tctx.train_step(_tb(_batch(0, scale=100.0)))
    tables, _ = _pool_snapshot(tctx)
    m = tctx.train_step(_tb(_batch(0, scale=100.0)))
    assert m["grads_finite"] is False
    for k, v in tables.items():
        assert torch.equal(v, tctx.state.tables[k])


@pytest.mark.parametrize("wire", ["float32", "int8"])
def test_forced_overflow_with_nothing_to_admit_changes_nothing(wire):
    """A mixed ctx (cat_0, cat_1 cached; ps on the PS tier) trains three
    finite steps (the int8 wire's residual non-zero), then its scale is
    set huge and the last batch comes again (every sign resident): the
    overflow moves no pool row or its state, no dense parameter or Adam
    moment, no PS-tier row and no residual, and halves the scale; the
    next finite step trains again."""
    slots = ("cat_0", "cat_1", "ps")
    _, tctx, _, tstore = _pair(slots=slots, ps=("ps",), wire=wire, dynamic_loss_scale=True, loss_scale_init=1024.0,
                               loss_scale_max=HUGE)
    batches = [_tb(_batch(i, slots=slots, scale=100.0)) for i in range(3)]
    for b in batches:
        assert tctx.train_step(b)["grads_finite"]
    dense, (tables, states) = _dense_snapshot(tctx), _pool_snapshot(tctx)
    entries = _entries(tstore)
    residual = {k: v.clone() for k, v in tctx._ps_residual.items()}
    if wire == "int8":
        assert residual and all(v.abs().sum() > 0 for v in residual.values())
    misses = tctx.tier.counts()["misses"]
    tctx.state.loss_scale.scale.fill_(HUGE)
    m = tctx.train_step(batches[-1])
    assert m["grads_finite"] is False and m["loss_scale"] == HUGE
    assert tctx.tier.counts()["misses"] == misses
    assert float(tctx.state.loss_scale.scale) == pytest.approx(HUGE / 2, rel=1e-6)
    for a, b_ in zip(dense, _dense_snapshot(tctx)):
        assert torch.equal(a, b_)
    for k, v in tables.items():
        assert torch.equal(v, tctx.state.tables[k])
    for key, v in states.items():
        assert torch.equal(v, tctx.state.emb_state[key[0]][key[1]])
    after = _entries(tstore)
    assert after.keys() == entries.keys()
    for k in entries:
        np.testing.assert_array_equal(after[k], entries[k])
    for k, v in residual.items():
        assert torch.equal(v, tctx._ps_residual[k])
    assert tctx.worker.staleness == 0
    tctx.state.loss_scale.scale.fill_(1024.0)
    assert tctx.train_step(batches[0])["grads_finite"]


@pytest.mark.parametrize("variable", [False, True], ids=["single_id", "bags_and_raw"])
@pytest.mark.parametrize("opt", ["adagrad", "adam"])
def test_bf16_pools_match_reference(opt, variable):
    """``table_dtype=bfloat16`` on both sides over 5 steps with evictions:
    single-id slots as the reference's rounding allows (the same rows, the
    same bf16 cotangents, K5's update rounded to bf16): losses,
    predictions and every entry after ``flush`` TIGHT (an Adam moment one
    f32 ulp apart, as on f32 pools); with a sqrt-scaled bag and a raw slot the pooled departure
    moves them within BAGS / BAG_ENTRIES."""
    jctx, tctx, jstore, tstore = _pair(opt, rows=128 if variable else 48, table_bf16=True, variable=variable)
    assert tctx.state.tables["cache_d8"].dtype == torch.bfloat16
    tol = BAGS if variable else TIGHT
    for s in range(5):
        b = _batch(s, variable=variable)
        a, t = jctx.train_step(b), tctx.train_step(_tb(b))
        np.testing.assert_allclose(t["loss"], a["loss"], **tol)
        np.testing.assert_allclose(t["preds"], np.asarray(a["preds"]), **tol)
    if not variable:
        assert tctx.tier.evictions > 0
    eb = _batch(77, variable=variable)
    np.testing.assert_allclose(tctx.eval_batch(_tb(eb)), np.asarray(jctx.eval_batch(eb)), **tol)
    jctx.flush()
    tctx.flush()
    _same_entries(jstore, tstore, BAG_ENTRIES if variable else TIGHT)


def test_bf16_pool_with_loss_scale_and_int8_stream_matches_reference():
    """The two options together on the mixed tier's stream (bf16 pools, a
    scale of 2^10, the int8 PS wire): losses and flags per step, and the
    flushed entries, against the reference's stream."""
    slots = ("cat_0", "cat_1", "ps")
    batches = [_batch(40 + i, slots=slots) for i in range(6)]
    jctx, tctx, jstore, tstore = _pair(slots=slots, ps=("ps",), wire="int8", rows=48, table_bf16=True,
                                       dynamic_loss_scale=True, loss_scale_init=1024.0)
    seen, jseen = [], []
    _watch(lambda: tctx.train_stream([_tb(b) for b in batches],
                                     on_metrics=lambda m: seen.append((m["loss"], m["loss_scale"], m["grads_finite"]))))
    jctx.train_stream(batches, on_metrics=lambda m: jseen.append((m["loss"], m["loss_scale"], m["grads_finite"])))
    assert [s[1:] for s in seen] == [s[1:] for s in jseen]
    np.testing.assert_allclose([s[0] for s in seen], [s[0] for s in jseen], **TIGHT)
    jctx.flush()
    tctx.flush()
    _same_entries(jstore, tstore, INT8_ENTRIES)


# ------------------------------------- the streams under the loss scale

LS = dict(dynamic_loss_scale=True, loss_scale_init=HUGE, loss_scale_max=HUGE, cache_rows=48)
STREAM_KNOBS = {"in_order_k1": dict(dispatch_k=1), "in_order_k4": dict(dispatch_k=4),
                "pipelined_depth3": dict(pipeline_depth=3, dispatch_k=1)}


def _ls_batches(n=14):
    """Dense features x100 under a huge initial scale: the first steps
    overflow and back off inside the stream; 150 signs over 48 rows
    evict (and, in a stream, restore from the rings)."""
    return [_tb(_batch(200 + i, scale=100.0)) for i in range(n)]


def _params():
    return seeded_flax_params_like(DLRM(DENSE, 3, DIM, BOTTOM, TOP, compute_dtype=torch.float32, device="cpu"), 11)


@pytest.mark.parametrize("knobs", sorted(STREAM_KNOBS))
@pytest.mark.parametrize("table_bf16", [False, True], ids=["f32_pool", "bf16_pool"])
def test_streams_under_loss_scale_equal_the_sync_steps(table_bf16, knobs):
    """The synchronous steps, the in-order stream (one step or four a
    dispatch) and the stage-pipelined stream at depth 3 under the loss
    scale, with overflows and evictions: each step's (loss, scale, flag),
    the state's bytes (pools, dense state, the scale) and every server
    entry after ``flush``, bit for bit."""
    batches = _ls_batches()
    params = _params()
    sync = _port(EmbeddingStore(optimizer=toptim.Adagrad(lr=0.1).config, capacity=1 << 12, num_internal_shards=2,
                                seed=3), params, "adagrad", ("cat_0", "cat_1", "cat_2"), False, table_bf16, **LS)
    want = [sync.train_step(b) for b in batches]
    assert not want[0]["grads_finite"] and want[-1]["grads_finite"] and sync.tier.evictions > 0
    sync.flush()
    store = EmbeddingStore(optimizer=toptim.Adagrad(lr=0.1).config, capacity=1 << 12, num_internal_shards=2, seed=3)
    ctx = _port(store, params, "adagrad", ("cat_0", "cat_1", "cat_2"), False, table_bf16, **LS)
    got = []
    _watch(lambda: ctx.train_stream(batches, on_metrics=got.append, **STREAM_KNOBS[knobs]))
    ctx.flush()
    assert [(m["loss"], m["loss_scale"], m["grads_finite"]) for m in got] == \
        [(m["loss"], m["loss_scale"], m["grads_finite"]) for m in want]
    assert cached_state_to_flax_bytes(ctx.state) == cached_state_to_flax_bytes(sync.state)
    a, b = _entries(store), _entries(sync.worker.lookup_router.replicas[0])
    assert a.keys() == b.keys() and a
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))


def test_fenced_stream_resume_under_loss_scale(tmp_path):
    """Fences every 4 steps under the loss scale on bf16 pools: a run
    dropped after step 10 and resumed from its fence at 8 ends with the
    state's bytes (the scale and its count included) and every entry bit
    for bit the uninterrupted fenced run's."""
    batches = _ls_batches(12)
    params = _params()

    def store():
        return EmbeddingStore(optimizer=toptim.Adagrad(lr=0.1).config, capacity=1 << 12, num_internal_shards=2,
                              seed=3)

    def ctx_over(st, init=True):
        return _port(st, params, "adagrad", ("cat_0", "cat_1", "cat_2"), False, True, init=init, **LS)

    base_store = store()
    base = ctx_over(base_store)
    _watch(lambda: base.train_stream(batches, snapshot_every=4, job_state=str(tmp_path / "base")))
    base.flush()
    st = store()
    ctx1 = ctx_over(st)
    _watch(lambda: ctx1.train_stream(batches[:10], snapshot_every=4, job_state=str(tmp_path / "js")))
    del ctx1
    ctx2 = ctx_over(st, init=False)
    m = ctx2.resume(str(tmp_path / "js"))
    assert m.step == 8 and ctx2.state is None
    _watch(lambda: ctx2.train_stream(batches[8:], snapshot_every=4, job_state=str(tmp_path / "js"), start_step=8))
    ctx2.flush()
    assert ctx2.state.loss_scale is not None and ctx2.state.tables["cache_d8"].dtype == torch.bfloat16
    assert cached_state_to_flax_bytes(ctx2.state) == cached_state_to_flax_bytes(base.state)
    a, b = _entries(st), _entries(base_store)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))


# --------------------------------------------------- the state's bytes


def test_cached_state_bytes_with_loss_scale_and_bf16_pools_are_flax():
    """Two steps on each side, then the state's bytes: the port's are the
    bytes flax writes for the reference's state holding the port's arrays
    (bf16 pools and a loss scale included), and the reference's bytes load
    into the port's state bit for bit; a state without a loss scale
    refuses them."""
    jctx, tctx, _, _ = _pair(table_bf16=True, dynamic_loss_scale=True, loss_scale_init=64.0,
                             loss_scale_growth_interval=1)
    for i in range(2):
        b = _batch(i)
        jctx.train_step(b)
        tctx.train_step(_tb(b))
    raw = cached_state_to_flax_bytes(tctx.state)
    restored = flax.serialization.from_bytes(jctx.state, raw)
    assert restored.loss_scale is not None and float(restored.loss_scale.scale) == float(tctx.state.loss_scale.scale)
    assert int(restored.loss_scale.good_steps) == int(tctx.state.loss_scale.good_steps)
    assert restored.tables["cache_d8"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(_bits(restored.tables["cache_d8"]), _bits(tctx.state.tables["cache_d8"]))
    assert flax.serialization.to_bytes(restored) == raw
    jraw = flax.serialization.to_bytes(jctx.state)
    cached_state_from_flax_bytes(tctx.state, jraw)
    np.testing.assert_array_equal(_bits(tctx.state.tables["cache_d8"]), _bits(jctx.state.tables["cache_d8"]))
    assert float(tctx.state.loss_scale.scale) == float(jctx.state.loss_scale.scale) == 256.0
    _, plain, _, _ = _pair(table_bf16=True)
    with pytest.raises(ValueError, match="loss scale"):
        cached_state_from_flax_bytes(plain.state, jraw)
