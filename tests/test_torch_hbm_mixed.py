"""The port's mixed tier (``persia_tpu_torch/embedding/hbm_cache`` with
``ps_slots``, hash-stacked slots and ``ps_wire_dtype``; the CPU path: the
plain versions of K12, K13, K5 and K15) against the reference's
(``persia_tpu/embedding/hbm_cache``, JAX on the CPU) and against the
port's hybrid ``TrainCtx``, on the same numpy-seeded inputs and weights:

- ``quantize_int8_ef`` (K15's plain version) against the reference's
  function a segment at a time, over segments of unequal length with
  zeros, empty segments and a reset residual: codes and scales bit for
  bit; the residual within the departure pinned below (the reference's
  XLA CPU code multiplies by a rounded 1/127 and contracts ``v - q * s``
  into an FMA; the port rounds each operation as written); its host
  inverse bit for bit;
- routing (``make_cache_groups``' hash-stacked and excluded slots, the
  sorted slot order of the model's inputs) and the tier's refusals (a
  feature group on both tiers; PS slots beside cache groups under prefix
  bit 0);
- ``CachedTrainCtx.train_step`` / ``eval_batch`` with PS slots (all of
  them, or beside cached ones; f32, bf16 and int8 wires; host and device
  pooling; SGD, Adagrad, Adam, evictions) held to the reference's over 5
  steps: losses, predictions and every server entry after ``flush``;
  with zero cache groups no directory exists and no cache kernel runs;
- the reference's oracles (``tests/test_hbm_cache.py``), the port's twins:
  the mixed tier against the hybrid ``TrainCtx`` (losses, eval, the
  hash-stack table's keys; the stream's drift from it under bounded
  staleness), Adam's server powers once a step, the all-PS stream (refs
  released, every step applied once by its journal id, the accumulators
  moved), a dispatch failure releasing the in-hand ref, device against
  host pooling, cached Adam against the hybrid tier's, int8 against f32;
- a fenced all-PS stream whose manifest holds exactly the steps applied
  before each fence, resumed with the same PS slot set; another set
  raises; the all-PS state's bytes are flax's.

Stream tests hold invariants and stated tolerances; the PS slots train
there under the staleness window ``prefetch + psgrad_batch``. Every
stream runs under ``run_with_watchdog`` (60 s).
"""

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import persia_tpu.config as jcfg
import persia_tpu.data as jdata
from persia_tpu.embedding import hbm_cache as jhbm
from persia_tpu.embedding import optim as joptim
from persia_tpu.embedding.hashing import add_index_prefix as jadd_index_prefix
from persia_tpu.embedding.hashing import hash_stack as jhash_stack
from persia_tpu.embedding.store import EmbeddingStore as JaxStore
from persia_tpu.embedding.worker import EmbeddingWorker as JaxWorker
from persia_tpu.models import DLRM as JaxDLRM
from persia_tpu.parallel.grad_sync import dequantize_int8_np as jdequantize
from persia_tpu.parallel.grad_sync import quantize_int8_ef as jquantize
import persia_tpu_torch.config as tcfg
import persia_tpu_torch.data as tdata
from persia_tpu_torch import jobstate as tjob
from persia_tpu_torch.ctx import TrainCtx
from persia_tpu_torch.embedding import hbm_cache as thbm
from persia_tpu_torch.embedding import optim as toptim
from persia_tpu_torch.embedding.hbm_cache import ctx as tctx_mod
from persia_tpu_torch.embedding.hbm_cache import step as tstep_mod
from persia_tpu_torch.embedding.hbm_cache.groups import CacheLayout, _model_emb_from_gathered
from persia_tpu_torch.embedding.store import EmbeddingStore
from persia_tpu_torch.embedding.worker import EmbeddingWorker
from persia_tpu_torch.models import DLRM
from persia_tpu_torch.parallel.grad_sync import dequantize_int8_np, quantize_int8_ef, quantize_int8_ef_reference
from persia_tpu_torch.testing.watchdog import run_with_watchdog
from persia_tpu_torch.weights import (
    cached_dense_from_flax,
    cached_state_from_flax_bytes,
    cached_state_to_flax_bytes,
    seeded_flax_params_like,
    state_dict_from_flax,
    state_dict_to_flax,
)

TIGHT = dict(rtol=1e-5, atol=1e-6)  # test_cached_ctx_matches_reference's f32 bound
DIM, BOTTOM, TOP, DENSE, B = 8, (16, 8), (32, 16), 4, 16
SLOTS = ("cat_0", "cat_1", "cat_2")
VOCAB = 60


def _watch(fn, what="the stream"):
    return run_with_watchdog(fn, timeout=60.0, what=what)


def _cfg(cfg, hash_stack=False, prefix_bit=8, groups=None):
    """Three slots of dim 8; ``hash_stack``: cat_2 hash-stacked (2 rounds
    into 50 keys)."""
    slots = {n: cfg.SlotConfig(dim=DIM) for n in SLOTS[:2]}
    slots["cat_2"] = cfg.SlotConfig(dim=DIM, hash_stack_config=cfg.HashStackConfig(
        hash_stack_rounds=2, embedding_size=50)) if hash_stack else cfg.SlotConfig(dim=DIM)
    return cfg.EmbeddingConfig(slots_config=slots, feature_index_prefix_bit=prefix_bit, feature_groups=groups or {})


def _batch(seed, b=B, hs_vocab=1000, requires_grad=True):
    rng = np.random.default_rng(seed)
    feats = [jdata.IDTypeFeatureWithSingleID(n, rng.integers(0, VOCAB if n != "cat_2" else hs_vocab, b,
                                                             dtype=np.uint64)) for n in SLOTS]
    kw = dict(labels=[jdata.Label(rng.integers(0, 2, (b, 1)).astype(np.float32))]) if requires_grad else {}
    return jdata.PersiaBatch(
        feats, non_id_type_features=[jdata.NonIDTypeFeature(rng.normal(size=(b, DENSE)).astype(np.float32))],
        requires_grad=requires_grad, **kw)


def _tbatch(batch):
    return tdata.PersiaBatch.from_bytes(batch.to_bytes())


def _opt(kind, mod):
    return {"sgd": lambda: mod.SGD(lr=0.1), "adagrad": lambda: mod.Adagrad(lr=0.1),
            "adam": lambda: mod.Adam(lr=0.01)}[kind]()


def _params():
    return seeded_flax_params_like(DLRM(DENSE, 3, DIM, BOTTOM, TOP, compute_dtype=torch.float32, device="cpu"), 11)


def _port_model():
    return DLRM(DENSE, 3, DIM, BOTTOM, TOP, compute_dtype=torch.float32, device="cpu")


def _port_ctx(ps_slots, wire="float32", opt="adagrad", pooling=False, hash_stack=False, cache_rows=256,
              params=None, store=None, **kw):
    """The port's ctx on seeded weights (``params``), Adam(1e-3), over one
    numpy store: (ctx, store)."""
    params = params if params is not None else _params()
    store = store or EmbeddingStore(capacity=1 << 14, num_internal_shards=2, seed=3,
                                    optimizer=_opt(opt, toptim).config)
    cfg = _cfg(tcfg, hash_stack)
    model = _port_model()
    ctx = thbm.CachedTrainCtx(model, torch.optim.Adam(model.parameters(), lr=1e-3), _opt(opt, toptim),
                              EmbeddingWorker(cfg, [store], device_pooling=pooling), cfg, device="cpu",
                              cache_rows=cache_rows, ps_slots=ps_slots, ps_wire_dtype=wire, **kw).__enter__()
    ctx.init_state()
    zeros = jax.tree.map(np.zeros_like, params)
    cached_dense_from_flax(ctx.state, params, zeros, zeros, jnp.zeros((), jnp.int32))
    return ctx, store


def _jax_ctx(ps_slots, wire="float32", opt="adagrad", pooling=False, hash_stack=False, cache_rows=256, params=None):
    params = params if params is not None else _params()
    store = JaxStore(capacity=1 << 14, num_internal_shards=2, seed=3, optimizer=_opt(opt, joptim).config)
    cfg = _cfg(jcfg, hash_stack)
    ctx = jhbm.CachedTrainCtx(JaxDLRM(embedding_dim=DIM, bottom_mlp=BOTTOM, top_mlp=TOP, compute_dtype=jnp.float32),
                              optax.adam(1e-3), _opt(opt, joptim), JaxWorker(cfg, [store], device_pooling=pooling),
                              cfg, cache_rows=cache_rows, ps_slots=ps_slots, ps_wire_dtype=wire).__enter__()
    jparams = jax.tree.map(jnp.asarray, params)
    tables, emb_state = jhbm.init_cached_tables(ctx.tier.groups, ctx.sparse_cfg)
    ctx.state = jhbm.CachedTrainState(
        params=jparams, batch_stats={}, opt_state=optax.adam(1e-3).init(jparams), tables=tables,
        emb_state=emb_state, emb_batch_state=jnp.ones((2,), jnp.float32), step=jnp.zeros((), jnp.int32))
    return ctx, store


def _all_entries(store):
    """{sign: entry} of every entry of a numpy store (either package)."""
    return {int(sign): np.array(vec) for shard in store._shards for sign, (_, vec) in shard.entries.items()}


# ------------------------------------------------ K15's plain version


def _segments(rng, lengths):
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    n = int(offsets[-1])
    g = np.empty(n, np.float32)
    for a, b in zip(offsets[:-1], offsets[1:]):
        g[a:b] = rng.standard_normal(b - a) * 10.0 ** rng.integers(-6, 2)
    return g, offsets.tolist()


def _residual_departure(got, want, v):
    """The pinned departure of the residual: |port - reference| <= 4 *
    2^-23 * |v| elementwise (the reference's step s * fl(1/127) is within
    1.5 ulps of fl(s / 127), its FMA skips the product's rounding, and
    |q * s| <= 2 |v| wherever q != 0; where q == 0 both are v exactly),
    except where the reference flushed a subnormal to zero (XLA's CPU code
    does; the port keeps subnormals, as nvcc's default -ftz=false)."""
    flushed = (want == 0) & (np.abs(got) < np.finfo(np.float32).tiny)
    gap = np.abs(got.astype(np.float64) - want.astype(np.float64))[~flushed]
    bound = 4 * 2.0 ** -23 * np.abs(v.astype(np.float64))[~flushed]
    assert (gap <= bound).all(), float((gap / np.maximum(bound, 1e-45)).max())


@pytest.mark.parametrize("case", ["unequal", "zeros_and_empty", "bf16_input", "tiny"])
def test_quantize_int8_ef_matches_reference(case):
    """Segments of unequal length (host-pooled (B, D) beside device-pooled
    (P, D) ones), a zero and an empty segment, bf16 gradients, values down
    to 1e-38: three steps with the residual carried, then a reset."""
    rng = np.random.default_rng({"unequal": 0, "zeros_and_empty": 1, "bf16_input": 2, "tiny": 3}[case])
    lengths = {"unequal": [16 * 8, 64 * 8, 7, 1, 300], "zeros_and_empty": [40, 0, 24, 33],
               "bf16_input": [128, 512, 96], "tiny": [50, 70]}[case]
    g, offsets = _segments(rng, lengths)
    if case == "zeros_and_empty":
        g[offsets[2]:offsets[3]] = 0
    if case == "tiny":
        g *= np.float32(1e-36)
    res = np.zeros_like(g)
    for step in range(4):
        if step == 3:
            res = np.zeros_like(g)  # a reset: a new bucketed shape starts from zeros
        tg = torch.from_numpy(g)
        if case == "bf16_input":
            tg = tg.to(torch.bfloat16)
        gin = tg.float().numpy()
        q, scales, new = quantize_int8_ef(tg, torch.from_numpy(res.copy()), offsets)
        q2, s2, new2 = quantize_int8_ef_reference(tg, torch.from_numpy(res.copy()), offsets)
        for a, b in ((q, q2), (scales, s2), (new, new2)):
            assert torch.equal(a, b)  # the CPU wrapper is the plain version
        for s, (a, b) in enumerate(zip(offsets[:-1], offsets[1:])):
            if a == b:
                assert float(scales[s]) == np.float32(1e-30)
                continue
            jq, js, _deq, jres = jax.jit(jquantize)(jnp.asarray(gin[a:b]), jnp.asarray(res[a:b]))
            np.testing.assert_array_equal(q[a:b].numpy(), np.asarray(jq))
            assert scales[s].numpy().tobytes() == np.asarray(js, np.float32).tobytes()
            v = (gin[a:b] + res[a:b]).astype(np.float32)
            _residual_departure(new[a:b].numpy(), np.asarray(jres), v)
            # the port's residual is the two-rounding formula, bit for bit
            step_s = np.float32(np.float32(js) / np.float32(127.0))
            want = (v - (q[a:b].numpy().astype(np.float32) * step_s).astype(np.float32)).astype(np.float32)
            np.testing.assert_array_equal(new[a:b].numpy().view(np.uint32), want.view(np.uint32))
            np.testing.assert_array_equal(dequantize_int8_np(q[a:b].numpy(), scales[s].numpy()),
                                          jdequantize(np.asarray(jq), np.asarray(js)))
        res = new.numpy()
        g = rng.standard_normal(g.shape).astype(np.float32) * g.std()


def test_quantize_int8_ef_refuses_bad_offsets():
    g, r = torch.zeros(10), torch.zeros(10)
    for offs in ([0, 4], [1, 10], [0, 6, 4, 10]):
        with pytest.raises(ValueError, match="offsets"):
            quantize_int8_ef(g, r, offs)
    with pytest.raises(ValueError, match="residual"):
        quantize_int8_ef(g, torch.zeros(9), [0, 10])


# ----------------------------------------------------- routing, refusals


def test_hash_stack_slots_route_to_ps_tier():
    """``make_cache_groups``: a hash-stacked slot and every excluded one go
    to the PS tier, as the reference routes them; an unknown exclude
    raises ``KeyError``."""
    for hs in (False, True):
        for exclude in ((), ("cat_1",), SLOTS):
            jg, jps = jhbm.make_cache_groups(_cfg(jcfg, hs), {DIM: 64}, joptim.Adagrad(lr=0.1).config, exclude=exclude)
            tg, tps = thbm.make_cache_groups(_cfg(tcfg, hs), {DIM: 64}, toptim.Adagrad(lr=0.1).config,
                                             exclude=exclude)
            assert tps == jps
            assert [(g.name, g.pooled_slots, g.raw_slots, g.rows, g.state_dim) for g in tg] == \
                [(g.name, g.pooled_slots, g.raw_slots, g.rows, g.state_dim) for g in jg]
    assert thbm.make_cache_groups(_cfg(tcfg, True), {DIM: 64}, toptim.Adagrad(lr=0.1).config)[1] == ("cat_2",)
    with pytest.raises(KeyError):
        thbm.make_cache_groups(_cfg(tcfg), {DIM: 64}, toptim.Adagrad(lr=0.1).config, exclude=("nope",))


def test_model_inputs_merge_in_sorted_name_order():
    """The PS slots' inputs join the cached ones in string order of the
    names (``cat_10`` before ``cat_2``), as the reference's dict sort."""
    layout = CacheLayout(stacked=(("g", ("cat_1", "cat_3")),), ps=("cat_2", "cat_10", "cat_0"))
    pooled = {"g": ["c1", "c3"]}
    got = _model_emb_from_gathered(layout, pooled, {"raw_9": "r9"}, ["p2", "p10", "p0"])
    assert got == ["p0", "c1", "p10", "p2", "c3", "r9"]


def test_mixed_tier_refusals():
    """One feature group on both tiers, and PS slots beside cache groups
    under prefix bit 0, raise as the reference's; all-PS at prefix bit 0 is
    fine (no cached sign to collide with)."""
    store = EmbeddingStore(capacity=1 << 12, num_internal_shards=2, optimizer=toptim.SGD(lr=0.1).config)
    model = _port_model()
    for cfg, ps, match in ((_cfg(tcfg, groups={"shared": ["cat_0", "cat_2"]}), ["cat_2"], "mixes cached slots"),
                           (_cfg(tcfg, prefix_bit=0), ["cat_2"], "feature_index_prefix_bit")):
        with pytest.raises(ValueError, match=match):
            thbm.CachedTrainCtx(model, torch.optim.Adam(model.parameters()), toptim.SGD(lr=0.1),
                                EmbeddingWorker(cfg, [store]), cfg, device="cpu", cache_rows=64, ps_slots=ps)
    cfg = _cfg(tcfg, prefix_bit=0)
    ctx = thbm.CachedTrainCtx(model, torch.optim.Adam(model.parameters()), toptim.SGD(lr=0.1),
                              EmbeddingWorker(cfg, [store]), cfg, device="cpu", cache_rows=8, ps_slots=SLOTS)
    assert ctx.tier.groups == [] and ctx.tier.dirs == {}
    with pytest.raises(ValueError, match="ps_wire_dtype"):
        thbm.CachedTrainCtx(model, torch.optim.Adam(model.parameters()), toptim.SGD(lr=0.1),
                            EmbeddingWorker(cfg, [store]), cfg, device="cpu", ps_slots=SLOTS, ps_wire_dtype="fp8")


# ------------------------------------- the synchronous steps vs the reference

CASES = {
    # name: (ps slots, wire, optimizer, device pooling, hash stack, cache rows)
    "hash_stack_f32_host": ((), "float32", "adagrad", False, True, 256),
    "all_ps_int8_device": (SLOTS, "int8", "adagrad", True, False, 8),
    "all_ps_f32_device_adam": (SLOTS, "float32", "adam", True, False, 8),
    "mixed_bf16_device_evictions": (("cat_2",), "bfloat16", "adagrad", True, False, 48),
    "mixed_int8_host_sgd": (("cat_1",), "int8", "sgd", False, False, 256),
}
# losses and predictions to the f32 bound on every wire; entries too on the
# f32 and bf16 wires (both packages round the staged entries and the bf16
# gradients alike); the int8 wire's codes can flip where the two
# frameworks' gradients straddle a rounding boundary, moving one entry's
# gradient by scale / 127 of its slot's largest: entries to 2e-4 (7.7e-5
# measured)
ENTRY_TOL = {"float32": TIGHT, "bfloat16": TIGHT, "int8": dict(rtol=0, atol=2e-4)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_mixed_ctx_matches_reference(case):
    ps, wire, opt, pooling, hs, rows = CASES[case]
    params = _params()
    jctx, jstore = _jax_ctx(ps, wire, opt, pooling, hs, rows, params)
    tctx, tstore = _port_ctx(ps, wire, opt, pooling, hs, rows, params)
    assert tctx.tier.ps_slots == jctx.tier.ps_slots
    for s in range(5):
        batch = _batch(s)
        a = jctx.train_step(batch)
        b = tctx.train_step(_tbatch(batch))
        np.testing.assert_allclose(b["loss"], a["loss"], **TIGHT)
        np.testing.assert_allclose(b["preds"], np.asarray(a["preds"]), **TIGHT)
    assert tctx.worker.staleness == 0 and not tctx.worker.post_forward_buffer
    eb = _batch(99, requires_grad=False)
    np.testing.assert_allclose(tctx.eval_batch(_tbatch(eb)), np.asarray(jctx.eval_batch(eb)), **TIGHT)
    if rows < 64 and ps != SLOTS:
        assert tctx.tier.evictions > 0, "the case must evict"
    jctx.flush()
    tctx.flush()
    want, got = _all_entries(jstore), _all_entries(tstore)
    assert set(got) == set(want) and len(want) > 50
    for sign in want:
        np.testing.assert_allclose(got[sign], want[sign], err_msg=str(sign), **ENTRY_TOL[wire])
    if wire == "int8":
        assert set(tctx._ps_residual) == set(int(k) for k in jctx._ps_residual)
        for k, r in tctx._ps_residual.items():
            assert np.abs(r.numpy()).max() > 0  # the residual carries what int8 dropped


def test_all_ps_ctx_runs_no_cache_kernel(monkeypatch):
    """Zero cache groups (every slot on the PS, ``cache_rows`` unused): no
    directory, and neither K12, K13 nor K5 is called, in steps, eval and
    the stream."""
    def never(*a, **kw):
        raise AssertionError("a cache kernel ran with no cache group")

    monkeypatch.setattr(tctx_mod, "_apply_aux", never)
    for name in ("cached_gather", "sparse_update"):
        monkeypatch.setattr(tstep_mod, name, never)
    monkeypatch.setattr(tstep_mod.PooledRows, "apply", never)
    ctx, _ = _port_ctx(SLOTS, "int8", pooling=True, cache_rows=8)
    assert ctx.tier.dirs == {} and ctx.state.tables == {}
    for s in range(2):
        assert np.isfinite(ctx.train_step(_tbatch(_batch(s)))["loss"])
    assert ctx.eval_batch(_tbatch(_batch(50, requires_grad=False))).shape == (B, 1)
    _watch(lambda: ctx.train_stream([_tbatch(_batch(10 + s)) for s in range(4)], prefetch=2, psgrad_batch=2))
    assert ctx.worker.staleness == 0


def test_all_ps_state_bytes_are_flax():
    """A ``CachedTrainState`` with no cache group as flax's bytes of the
    reference's state holding the same arrays (empty pools)."""
    ctx, _ = _port_ctx(SLOTS, "int8", cache_rows=8)
    for s in range(2):
        ctx.train_step(_tbatch(_batch(s)))
    st, opt = ctx.state, ctx.state.optimizer
    first = next(iter(st.model.parameters()))
    params = jax.tree.map(jnp.asarray, state_dict_to_flax(st.model))
    mu, nu = (jax.tree.map(jnp.asarray, state_dict_to_flax(st.model, lambda p, k=k: opt.state[p][k]))
              for k in ("exp_avg", "exp_avg_sq"))
    adam = optax.adam(1e-3).init(params)
    adam = (adam[0]._replace(count=jnp.asarray(int(opt.state[first]["step"]), jnp.int32), mu=mu, nu=nu),) + adam[1:]
    ref = jhbm.CachedTrainState(params=params, batch_stats={}, opt_state=adam, tables={}, emb_state={},
                                emb_batch_state=jnp.asarray(st.emb_batch_state.numpy()),
                                step=jnp.asarray(st.step.numpy()))
    raw = cached_state_to_flax_bytes(st)
    assert flax.serialization.to_bytes(ref) == raw
    fresh, _ = _port_ctx(SLOTS, "int8", cache_rows=8)
    cached_state_from_flax_bytes(fresh.state, raw)
    assert cached_state_to_flax_bytes(fresh.state) == raw


# ------------------------------------------ the reference's oracles, ported


def _hybrid_ctx(opt, params, hash_stack=False, pooling=False):
    """The port's hybrid ``TrainCtx`` on the same weights, Adam(1e-3)."""
    store = EmbeddingStore(capacity=1 << 14, num_internal_shards=2, seed=3, optimizer=_opt(opt, toptim).config)
    cfg = _cfg(tcfg, hash_stack)
    model = _port_model()
    model.load_state_dict(state_dict_from_flax(model, params))
    ctx = TrainCtx(model, torch.optim.Adam(model.parameters(), lr=1e-3), _opt(opt, toptim),
                   EmbeddingWorker(cfg, [store], device_pooling=pooling), cfg, device="cpu").__enter__()
    return ctx, store


def _hs_keys():
    """The hash-stacked slot's table keys (tests/test_hbm_cache.py:551)."""
    slot = _cfg(tcfg, True).slot("cat_2")
    signs = jadd_index_prefix(np.arange(1000, dtype=np.uint64), slot.index_prefix, 8)
    return np.unique(jadd_index_prefix(jhash_stack(signs, 2, 50).reshape(-1), slot.index_prefix, 8))


def test_mixed_tier_matches_hybrid_train_ctx():
    """(tests/test_hbm_cache.py:468) cat_0 and cat_1 cached, the
    hash-stacked cat_2 on the PS, SGD: six steps train every server entry
    as the hybrid ``TrainCtx`` does (losses, eval and entries to 1e-5);
    the same batches as a stream (prefetch 3, psgrad_batch 8: the PS
    forwards up to 11 steps stale) release every ref, and the hash-stack
    table's trained deltas drift from the synchronous ones by under 0.6 of
    their norm and keep their direction (cosine above 0.8), the
    reference's bounds."""
    params = _params()
    batches = [_batch(s) for s in range(6)]
    mixed, mstore = _port_ctx((), opt="sgd", hash_stack=True, cache_rows=512, params=params)
    hybrid, hstore = _hybrid_ctx("sgd", params, hash_stack=True)
    assert mixed.tier.ps_slots == ("cat_2",)
    for b in batches:
        m, h = mixed.train_step(_tbatch(b)), hybrid.train_step(_tbatch(b))
        np.testing.assert_allclose(m["loss"], h["loss"], **TIGHT)
    assert mixed.worker.staleness == 0
    eb = _tbatch(_batch(7, requires_grad=False))
    np.testing.assert_allclose(mixed.eval_batch(eb), hybrid.eval_batch(eb), **TIGHT)
    mixed.flush()
    want, got = _all_entries(hstore), _all_entries(mstore)
    assert set(got) == set(want)
    for sign in want:
        np.testing.assert_allclose(got[sign], want[sign], err_msg=str(sign), **TIGHT)
    keys = [int(k) for k in _hs_keys() if int(k) in want]
    assert len(keys) > 10

    streamed, sstore = _port_ctx((), opt="sgd", hash_stack=True, cache_rows=512, params=params)
    m = _watch(lambda: streamed.train_stream([_tbatch(b) for b in batches]))
    assert m is not None and np.isfinite(m["loss"])
    assert streamed.worker.staleness == 0 and not streamed.worker.post_forward_buffer
    assert streamed.stream_stats()["psgrad_steps"] == len(batches)
    streamed.flush()
    got = _all_entries(sstore)
    a = np.concatenate([got[k] for k in keys])
    b = np.concatenate([want[k] for k in keys])
    init = EmbeddingStore(capacity=1 << 14, num_internal_shards=2, seed=3, optimizer=toptim.SGD(lr=0.1).config)
    i = init.lookup(np.asarray(keys, dtype=np.uint64), DIM, train=True).reshape(-1)
    da, db = a - i, b - i
    assert np.isfinite(a).all()
    assert np.linalg.norm(a - b) / np.linalg.norm(b) < 0.6
    assert float(np.dot(da, db) / (np.linalg.norm(da) * np.linalg.norm(db))) > 0.8


def test_mixed_tier_adam_advances_beta_powers_once():
    """(tests/test_hbm_cache.py:618) Adam: the server powers of every
    feature group (the cached ones by the ctx, the PS-tier one by the
    worker's gradient batch) equal the hybrid tier's after six steps:
    each moved once a step."""
    params = _params()
    mixed, mstore = _port_ctx(("cat_2",), opt="adam", cache_rows=256, params=params)
    hybrid, hstore = _hybrid_ctx("adam", params)
    for s in range(6):
        mixed.train_step(_tbatch(_batch(s)))
        hybrid.train_step(_tbatch(_batch(s)))
    mixed.flush()
    cfg = _cfg(tcfg)
    for name in SLOTS:
        grp = cfg.group_of(name)
        assert mstore._batch_state.get(grp) is not None, name
        np.testing.assert_allclose(mstore._batch_state[grp], hstore._batch_state[grp], rtol=1e-12)
    assert mixed.tier.router.batch_advances == {cfg.group_of(n): 6 for n in SLOTS}


def test_cached_adam_matches_hybrid_adam():
    """(tests/test_hbm_cache.py:1282) Adam on the mixed tier (cat_0, cat_1
    cached in a cache that never evicts, cat_2 on the PS) trains every
    entry, its [m | v] state included, as the hybrid tier's Adam on the
    server after ten steps and a ``publish``: to the reference's bound
    (rtol 2e-4, atol 2e-5: Adam's m / sqrt(v) magnifies the two tiers'
    different f32 sum orders)."""
    params = _params()
    mixed, mstore = _port_ctx(("cat_2",), opt="adam", cache_rows=4096, params=params)
    hybrid, hstore = _hybrid_ctx("adam", params)
    for s in range(10):
        mixed.train_step(_tbatch(_batch(300 + s)))
        hybrid.train_step(_tbatch(_batch(300 + s)))
    mixed.drain()
    mixed.publish()
    want, got = _all_entries(hstore), _all_entries(mstore)
    assert set(got) == set(want) and len(want) > 100
    for sign in want:
        np.testing.assert_allclose(got[sign], want[sign], err_msg=str(sign), rtol=2e-4, atol=2e-5)


def test_all_ps_stream_trains_and_releases_refs(tmp_path):
    """(tests/test_hbm_cache.py:1127) every slot on the PS, the bf16 wire,
    device pooling: the stream (prefetch 3, psgrad_batch 4) releases every
    ref, applies every step exactly once (one journal id a step under the
    cold-started job state; 4 + 4 + 2 steps a flush) and moves the
    Adagrad accumulators of the trained signs."""
    ctx, store = _port_ctx(SLOTS, "bfloat16", pooling=True, cache_rows=8)
    assert ctx.resume(tmp_path) is None  # a cold start arms the journal at epoch 0
    m = _watch(lambda: ctx.train_stream([_tbatch(_batch(s)) for s in range(10)], prefetch=3, psgrad_batch=4))
    assert m is not None and np.isfinite(m["loss"])
    assert ctx.worker.staleness == 0 and not ctx.worker.post_forward_buffer
    st = ctx.stream_stats()
    assert (st["psgrad_steps"], st["psgrad_flushes"]) == (10, 3)
    assert st["tiers"]["cached_slots"] == [] and st["tiers"]["ps_slots"] == list(SLOTS)
    assert set(store._journal) == {tjob.journal_shard_id(tjob.make_journal_id(0, s), 0) for s in range(10)}
    entries = _all_entries(store)
    assert len(entries) > 100
    init = np.float32(toptim.Adagrad(lr=0.1).config.initialization)
    moved = sum(bool((e[DIM:] > init).any()) for e in entries.values())
    assert moved == len(entries), (moved, len(entries))  # every looked-up sign got a gradient


def test_stream_dispatch_failure_releases_in_hand_ps_ref():
    """(tests/test_hbm_cache.py:1164) a dispatch that raises at its third
    step: the stream raises it, and no ref is left, the in-hand one
    included."""
    ctx, _ = _port_ctx(SLOTS, pooling=True, cache_rows=8)
    calls = [0]
    inner = ctx._dispatch

    def failing(*a, **kw):
        calls[0] += 1
        if calls[0] >= 3:
            raise RuntimeError("injected dispatch failure")
        return inner(*a, **kw)

    ctx._dispatch = failing
    with pytest.raises(RuntimeError, match="injected dispatch failure"):
        _watch(lambda: ctx.train_stream([_tbatch(_batch(s)) for s in range(10)], prefetch=3, psgrad_batch=4))
    assert ctx.worker.staleness == 0 and not ctx.worker.post_forward_buffer


def test_all_ps_device_pooling_matches_host_pooling():
    """(tests/test_hbm_cache.py:1243) the PS slots device-pooled (K1/K2's
    plain versions, per-distinct gradients) against host-pooled: the
    synchronous steps' losses and entries to 1e-5; as streams (prefetch 2,
    psgrad_batch 2) every ref released and the entries within 2e-2 (the
    two streams' staleness schedules may differ)."""
    params = _params()
    got = {}
    for pooling in (False, True):
        ctx, store = _port_ctx(SLOTS, pooling=pooling, cache_rows=8, params=params)
        losses = [ctx.train_step(_tbatch(_batch(40 + s)))["loss"] for s in range(5)]
        sctx, sstore = _port_ctx(SLOTS, pooling=pooling, cache_rows=8, params=params)
        m = _watch(lambda: sctx.train_stream([_tbatch(_batch(40 + s)) for s in range(8)], prefetch=2,
                                             psgrad_batch=2))
        assert m is not None and np.isfinite(m["loss"]) and sctx.worker.staleness == 0
        got[pooling] = (losses, _all_entries(store), _all_entries(sstore))
    np.testing.assert_allclose(got[True][0], got[False][0], **TIGHT)
    for i in (1, 2):
        host, dev = got[False][i], got[True][i]
        assert set(host) == set(dev)
        for k in host:
            np.testing.assert_allclose(dev[k], host[k], **(TIGHT if i == 1 else dict(rtol=0, atol=2e-2)))


def test_int8_ps_wire_trains_close_to_f32():
    """(tests/test_hbm_cache.py:1613) all-PS, 16 synchronous steps of 32
    samples, Adagrad(0.1): the int8 wire really quantizes (entries differ
    from the f32 wire's) and drifts from it by under 0.15 of their norm,
    the reference's gate."""
    out = {}
    for wire in ("float32", "int8"):
        ctx, store = _port_ctx(SLOTS, wire, cache_rows=8)
        for s in range(16):
            ctx.train_step(_tbatch(_batch(17 + s, b=32)), fetch_metrics=False)
        ctx.drain()
        assert ctx.worker.staleness == 0
        out[wire] = _all_entries(store)
    assert set(out["float32"]) == set(out["int8"])
    a = np.concatenate([out["int8"][k] for k in sorted(out["float32"])])
    b = np.concatenate([out["float32"][k] for k in sorted(out["float32"])])
    assert np.abs(a - b).max() > 0, "the int8 wire must quantize"
    assert np.linalg.norm(a - b) / np.linalg.norm(b) < 0.15


# ------------------------------------------------------- fences, resume


def test_fenced_all_ps_stream_captures_every_applied_step_and_resumes(tmp_path):
    """All-PS stream with a fence every 4 steps: at each fence the servers
    hold exactly the steps before it (their journal ids), which the
    manifest captures; a fresh ctx over a fresh store resumes from the last
    fence (the same PS slot set) with those entries, trains the rest, and
    every ref is released; a ctx with another PS slot set refuses the
    manifest."""
    batches = [_tbatch(_batch(60 + s)) for s in range(10)]
    ctx, store = _port_ctx(SLOTS, pooling=True, cache_rows=8)
    seen = {}

    def at_fence(gstep):
        seen[gstep] = (set(store._journal), _all_entries(store))

    _watch(lambda: ctx.train_stream(batches, snapshot_every=4, job_state=tmp_path, fence_callback=at_fence,
                                    prefetch=3, psgrad_batch=4))
    assert sorted(seen) == [4, 8] and ctx.worker.staleness == 0
    for gstep, (ids, _) in seen.items():  # a fence's manifest starts the next epoch's ids
        assert ids == {tjob.journal_shard_id(tjob.make_journal_id(s // 4, s), 0) for s in range(gstep)}

    fresh, fstore = _port_ctx(SLOTS, pooling=True, cache_rows=8)
    m = fresh.resume(tmp_path)
    assert m.step == 8 and m.read_json("cache.json")["ps_slots"] == list(SLOTS)
    restored = _all_entries(fstore)
    assert set(restored) == set(seen[8][1])
    for k, v in seen[8][1].items():
        np.testing.assert_array_equal(restored[k], v)
    _watch(lambda: fresh.train_stream(batches[8:], start_step=8, prefetch=3, psgrad_batch=4))
    assert fresh.worker.staleness == 0 and fresh.stream_stats()["psgrad_steps"] == 2

    other, _ = _port_ctx(("cat_1", "cat_2"), pooling=True, cache_rows=64)
    with pytest.raises(ValueError, match="PS-tier slots"):
        other.resume(tmp_path)
