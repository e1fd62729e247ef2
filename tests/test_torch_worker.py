"""The port's host plane vs ``persia_tpu``'s: batch wire format, hashing and
seeded init, store admission, and ``EmbeddingWorker.forward_directly`` — all
integer and float arrays bitwise equal, with both workers on their numpy
routines and with both on their native cores."""

import dataclasses

import numpy as np
import pytest

import persia_tpu.config as jcfg
import persia_tpu.data as jdata
from persia_tpu.embedding import hashing as jhashing
from persia_tpu.embedding import native_worker
from persia_tpu.embedding.optim import Adagrad as JaxAdagrad
from persia_tpu.embedding.store import EmbeddingStore as JaxStore
from persia_tpu.embedding.worker import EmbeddingWorker as JaxWorker
import persia_tpu_torch.config as tcfg
import persia_tpu_torch.data as tdata
from persia_tpu_torch.embedding import hashing as thashing
from persia_tpu_torch.embedding import native_worker as tnative_worker
from persia_tpu_torch.embedding.optim import Adagrad
from persia_tpu_torch.embedding.store import EmbeddingStore
from persia_tpu_torch.embedding.worker import EmbeddingWorker


def _slots(cfg):
    return {
        "cat_0": cfg.SlotConfig(dim=8),
        "cat_1": cfg.SlotConfig(dim=8),
        "multi": cfg.SlotConfig(dim=8, sqrt_scaling=True),
        "stacked": cfg.SlotConfig(
            dim=4, hash_stack_config=cfg.HashStackConfig(hash_stack_rounds=2, embedding_size=50)
        ),
        "hist": cfg.SlotConfig(dim=8, embedding_summation=False, sample_fixed_size=5),
    }


def _configs():
    j = jcfg.EmbeddingConfig(slots_config=_slots(jcfg), feature_index_prefix_bit=8)
    t = tcfg.EmbeddingConfig(slots_config=_slots(tcfg), feature_index_prefix_bit=8)
    return j, t


def _jax_batch(seed, b=24):
    rng = np.random.default_rng(seed)
    feats = [
        jdata.IDTypeFeatureWithSingleID("cat_0", rng.integers(0, 40, b, dtype=np.uint64)),
        jdata.IDTypeFeatureWithSingleID("cat_1", rng.integers(0, 40, b, dtype=np.uint64)),
        jdata.IDTypeFeature("multi", [rng.integers(0, 30, rng.integers(0, 5), dtype=np.uint64) for _ in range(b)]),
        jdata.IDTypeFeature("stacked", [rng.integers(0, 1000, rng.integers(1, 3), dtype=np.uint64) for _ in range(b)]),
        jdata.IDTypeFeature("hist", [rng.integers(0, 20, rng.integers(0, 8), dtype=np.uint64) for _ in range(b)]),
    ]
    return jdata.PersiaBatch(
        feats,
        non_id_type_features=[jdata.NonIDTypeFeature(rng.standard_normal((b, 13)).astype(np.float32))],
        labels=[jdata.Label(rng.integers(0, 2, (b, 1)).astype(np.float32))],
        requires_grad=False,
        batch_id=seed,
        meta=b"m",
    )


@pytest.fixture(params=["numpy", "native"])
def worker_core(request, monkeypatch):
    """Both workers on their numpy routines (dedup sorted), or both on their
    native cores (dedup in first-seen order): the two orders differ, so
    the packages are held to each other one core at a time."""
    if request.param == "numpy":
        monkeypatch.setattr(native_worker, "_load_lib", lambda: None)
        monkeypatch.setattr(tnative_worker, "_load_lib", lambda: None)
    else:
        assert native_worker.available() and tnative_worker.available()
    return request.param


def _assert_same(a_list, b_list):
    assert len(a_list) == len(b_list)
    for a, b in zip(a_list, b_list):
        assert type(a).__name__ == type(b).__name__ and a.name == b.name
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype and x.shape == y.shape, f.name
                np.testing.assert_array_equal(x, y, err_msg=f"{a.name}.{f.name}")
            else:
                assert x == y


def test_wire_format_is_shared():
    jb = _jax_batch(0)
    raw = jb.to_bytes()
    tb = tdata.PersiaBatch.from_bytes(raw)
    assert tb.to_bytes() == raw
    back = jdata.PersiaBatch.from_bytes(tb.to_bytes())
    assert back.batch_id == 0 and back.meta == b"m" and not back.requires_grad
    for f, g in zip(jb.id_type_features, tb.id_type_features):
        assert f.name == g.name
        for x, y in zip(f.flat_counts(), g.flat_counts()):
            np.testing.assert_array_equal(x, y)


def test_prefix_assignment_matches():
    j, t = _configs()
    for name in j.slot_names:
        assert j.slot(name).index_prefix == t.slot(name).index_prefix


@pytest.mark.parametrize(
    "method",
    [
        jcfg.InitializationMethod("uniform", -0.02, 0.05),
        jcfg.InitializationMethod("inverse_sqrt"),
        jcfg.InitializationMethod("normal", 0.0, 0.1),
        jcfg.InitializationMethod("gamma", 0.7, 0.2),
        jcfg.InitializationMethod("poisson", 2.0, 0.0),
    ],
    ids=lambda m: m.kind,
)
def test_init_rows_bit_identical(method):
    signs = np.random.default_rng(1).integers(0, 2 ** 63, 17, dtype=np.uint64)
    tmethod = tcfg.InitializationMethod(method.kind, method.p0, method.p1)
    a = jhashing.init_for_signs(signs, 7, 8, method)
    b = thashing.init_for_signs(signs, 7, 8, tmethod)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    np.testing.assert_array_equal(jhashing.sign_to_shard(signs, 3), thashing.sign_to_shard(signs, 3))
    np.testing.assert_array_equal(jhashing.hash_stack(signs, 3, 100), thashing.hash_stack(signs, 3, 100))


@pytest.mark.parametrize("admit", [1.0, 0.5])
def test_store_lookup_bitwise(admit):
    """Train lookups admit and init (through the admission gate), infer
    lookups read zeros on miss; a sign repeated in one call reads its fresh
    row; a tiny capacity exercises eviction."""
    rng = np.random.default_rng(2)
    kw = dict(capacity=24, num_internal_shards=2, seed=5)
    js = JaxStore(hyperparams=jcfg.HyperParameters(admit_probability=admit),
                  optimizer=JaxAdagrad().config, **kw)
    ts = EmbeddingStore(hyperparams=tcfg.HyperParameters(admit_probability=admit),
                        optimizer=Adagrad().config, **kw)
    for step in range(4):
        signs = rng.integers(0, 60, 20, dtype=np.uint64)
        signs[-1] = signs[0]
        train = step < 3
        a, b = js.lookup(signs, 8, train), ts.lookup(signs, 8, train)
        np.testing.assert_array_equal(a, b)
    assert js.size() == ts.size()


@pytest.mark.parametrize("device_pooling", [False, True])
@pytest.mark.parametrize("replicas", [1, 2])
def test_forward_directly_bitwise(worker_core, device_pooling, replicas):
    jc, tc = _configs()
    mk = dict(capacity=1 << 12, num_internal_shards=4, seed=3)
    jw = JaxWorker(jc, [JaxStore(optimizer=JaxAdagrad(lr=0.1).config, **mk) for _ in range(replicas)],
                   device_pooling=device_pooling)
    tw = EmbeddingWorker(tc, [EmbeddingStore(optimizer=Adagrad(lr=0.1).config, **mk) for _ in range(replicas)],
                         device_pooling=device_pooling)
    first, second = _jax_batch(1), _jax_batch(2)
    # admit the first batch's signs, then serve the second (hits + misses)
    for batch, train in ((first, True), (second, False), (first, False)):
        jout = jw.forward_directly(batch, train=train)
        tout = tw.forward_directly(tdata.PersiaBatch.from_bytes(batch.to_bytes()), train=train)
        _assert_same(jout, tout)
