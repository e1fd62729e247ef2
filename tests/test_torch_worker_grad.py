"""The port's worker gradient path against ``persia_tpu.embedding.worker``:
``slot_gradient_to_keys`` for every kind of slot, and the synchronous
return (``put_forward_ids`` → ``forward_batch_id`` →
``update_gradient_batched`` / ``abort_gradient``) with its staleness count.

Every test runs with both workers on their numpy routines (dedup sorted,
``np.add.at``) and with both on their native cores (dedup in first-seen
order, the native accumulation, which adds in ``np.add.at``'s order).
Keys, every integer and the per-key gradients are exact; the stores'
entries are held to 1e-6."""

import numpy as np
import pytest

import persia_tpu.config as jcfg
import persia_tpu.data as jdata
from persia_tpu.embedding import native_worker
from persia_tpu.embedding import worker as jworker
from persia_tpu.embedding.optim import Adam as JaxAdam
from persia_tpu.embedding.store import EmbeddingStore as JaxStore
import persia_tpu_torch.config as tcfg
import persia_tpu_torch.data as tdata
from persia_tpu_torch.embedding import native_worker as tnative_worker
from persia_tpu_torch.embedding import worker as tworker
from persia_tpu_torch.embedding.optim import Adam
from persia_tpu_torch.embedding.store import EmbeddingStore


def _slots(cfg):
    return {
        "cat": cfg.SlotConfig(dim=8),
        "multi": cfg.SlotConfig(dim=8, sqrt_scaling=True),
        "stacked": cfg.SlotConfig(
            dim=4, hash_stack_config=cfg.HashStackConfig(hash_stack_rounds=3, embedding_size=40)
        ),
        "hist": cfg.SlotConfig(dim=8, embedding_summation=False, sample_fixed_size=5),
        "hist_sqrt": cfg.SlotConfig(dim=8, embedding_summation=False, sample_fixed_size=3, sqrt_scaling=True),
    }


def _configs():
    groups = {"g": ["cat", "multi"]}  # one shared optimizer group, the rest singletons
    return (jcfg.EmbeddingConfig(slots_config=_slots(jcfg), feature_index_prefix_bit=8, feature_groups=groups),
            tcfg.EmbeddingConfig(slots_config=_slots(tcfg), feature_index_prefix_bit=8, feature_groups=groups))


def _batch(seed, b=24):
    rng = np.random.default_rng(seed)
    lists = lambda hi, lo, top: [rng.integers(0, hi, rng.integers(lo, top), dtype=np.uint64) for _ in range(b)]  # noqa: E731
    feats = [
        jdata.IDTypeFeatureWithSingleID("cat", rng.integers(0, 40, b, dtype=np.uint64)),
        jdata.IDTypeFeature("multi", lists(30, 0, 5)),
        jdata.IDTypeFeature("stacked", lists(1000, 1, 4)),
        jdata.IDTypeFeature("hist", lists(20, 0, 8)),
        jdata.IDTypeFeature("hist_sqrt", lists(20, 0, 5)),
    ]
    return jdata.PersiaBatch(
        feats,
        non_id_type_features=[jdata.NonIDTypeFeature(rng.standard_normal((b, 13)).astype(np.float32))],
        labels=[jdata.Label(rng.integers(0, 2, (b, 1)).astype(np.float32))],
        requires_grad=True,
    )


@pytest.fixture(params=["numpy", "native"])
def worker_core(request, monkeypatch):
    """Both workers on their numpy routines, or both on their native cores."""
    if request.param == "numpy":
        monkeypatch.setattr(native_worker, "_load_lib", lambda: None)
        monkeypatch.setattr(tnative_worker, "_load_lib", lambda: None)
    else:
        assert native_worker.available() and tnative_worker.available()
    return request.param


def _grad_for(slot, device_pooled, rng):
    pooled = slot.config.embedding_summation and not device_pooled
    rows = slot.batch_size if pooled else slot.num_distinct
    return rng.standard_normal((rows, slot.config.dim)).astype(np.float32)


@pytest.mark.parametrize("device_pooled", [False, True])
@pytest.mark.parametrize("scale", [1.0, 8.0])
def test_slot_gradient_to_keys(worker_core, device_pooled, scale):
    jc, tc = _configs()
    batch = _batch(1)
    jslots = jworker.preprocess_batch(batch.id_type_features, jc).slots
    tslots = tworker.preprocess_batch(tdata.PersiaBatch.from_bytes(batch.to_bytes()).id_type_features, tc)
    rng = np.random.default_rng(2)
    for js, ts in zip(jslots, tslots):
        np.testing.assert_array_equal(js.keys, ts.keys)
        grad = _grad_for(ts, device_pooled, rng)
        a = jworker.slot_gradient_to_keys(js, grad, scale, device_pooled=device_pooled)
        b = tworker.slot_gradient_to_keys(ts, grad, scale, device_pooled=device_pooled)
        assert b.dtype == np.float32 and b.shape == a.shape == (len(ts.keys), ts.config.dim)
        np.testing.assert_array_equal(b, a)
        grad[0, 0] = np.nan  # a non-finite value skips the whole slot
        assert jworker.slot_gradient_to_keys(js, grad, scale, device_pooled=device_pooled) is None
        assert tworker.slot_gradient_to_keys(ts, grad, scale, device_pooled=device_pooled) is None


def test_slot_gradient_rejects_wrong_row_count(worker_core):
    _, tc = _configs()
    ts = tworker.preprocess_batch(tdata.PersiaBatch.from_bytes(_batch(1).to_bytes()).id_type_features, tc)[3]
    with pytest.raises(ValueError):
        tworker.slot_gradient_to_keys(ts, np.zeros((ts.num_distinct + 1, 8), np.float32))


def _worker_pair(device_pooling, replicas):
    jc, tc = _configs()
    kw = dict(capacity=1 << 12, num_internal_shards=4, seed=3)
    jw = jworker.EmbeddingWorker(jc, [JaxStore(**kw) for _ in range(replicas)], device_pooling=device_pooling)
    tw = tworker.EmbeddingWorker(tc, [EmbeddingStore(**kw) for _ in range(replicas)],
                                 device_pooling=device_pooling)
    jw.register_optimizer(JaxAdam(lr=0.01).config)
    tw.register_optimizer(Adam(lr=0.01).config)
    return jw, tw


def _grads(emb_batches, rng, nan_slot=None):
    """Device-side gradients shaped like each slot's staged input."""
    out = {}
    for eb in emb_batches:
        rows = eb.pooled if hasattr(eb, "pooled") else eb.distinct
        g = rng.standard_normal(rows.shape).astype(np.float32)
        if eb.name == nan_slot:
            g[-1, -1] = np.inf
        out[eb.name] = g
    return out


@pytest.mark.parametrize("device_pooling", [False, True])
@pytest.mark.parametrize("replicas", [1, 2])
def test_update_gradient_batched_and_staleness(worker_core, device_pooling, replicas):
    """Three batches: the second aborted, the others updated (one with a
    non-finite slot, skipped on both sides). Stores, staleness, refs and
    Adam's per-group batch advances agree."""
    jw, tw = _worker_pair(device_pooling, replicas)
    rng = np.random.default_rng(4)
    for step in range(3):
        batch = _batch(10 + step)
        jref = jw.put_forward_ids(batch)
        tref = tw.put_forward_ids(tdata.PersiaBatch.from_bytes(batch.to_bytes()))
        assert jref == tref
        jout = jw.forward_batch_id(jref, train=True)
        tout = tw.forward_batch_id(tref, train=True)
        assert jw.staleness == tw.staleness == 1
        if step == 1:
            jw.abort_gradient(jref), tw.abort_gradient(tref)
            tw.abort_gradient(tref)  # a second abort is a no-op
        else:
            grads = _grads(tout, rng, nan_slot="multi" if step == 2 else None)
            js = jw.update_gradient_batched(jref, grads, scale_factor=2.0)
            ts = tw.update_gradient_batched(tref, grads, scale_factor=2.0)
            assert js == ts == ({"multi": 1} if step == 2 else {})
        assert jw.staleness == tw.staleness == 0
        with pytest.raises(tworker.ForwardIdNotFound):
            tw.update_gradient_batched(tref, {})
        with pytest.raises(tworker.ForwardIdNotFound):
            tw.forward_batch_id(tref)
        assert [type(e).__name__ for e in jout] == [type(e).__name__ for e in tout]
    assert tw.lookup_router.batch_advances == jw.lookup_router.batch_advances
    for jr, tr in zip(jw.lookup_router.replicas, tw.lookup_router.replicas):
        assert jr.size() == tr.size() > 0
        for sh in jr._shards:
            for sign, (_, vec) in sh.entries.items():
                np.testing.assert_allclose(tr.get_embedding_entry(sign), vec, rtol=1e-6, atol=1e-7)


def test_forward_directly_keeps_no_training_state(worker_core):
    _, tw = _worker_pair(True, 1)
    tw.forward_directly(tdata.PersiaBatch.from_bytes(_batch(1).to_bytes()), train=True)
    assert tw.staleness == 0 and not tw.post_forward_buffer and not tw.forward_id_buffer
