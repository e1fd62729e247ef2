"""The port's sparse optimizers and the store's gradient path against
``persia_tpu.embedding.optim`` and ``persia_tpu.embedding.store``: every
entry bit for bit (the same numpy operations in the same order)."""

import numpy as np
import pytest

import persia_tpu.config as jcfg
from persia_tpu.embedding import optim as joptim
from persia_tpu.embedding.store import EmbeddingStore as JaxStore
import persia_tpu_torch.config as tcfg
from persia_tpu_torch.embedding import optim as toptim
from persia_tpu_torch.embedding.store import EmbeddingStore

OPTIMIZERS = {
    "sgd": lambda m: m.SGD(lr=0.1),
    "sgd_decay": lambda m: m.SGD(lr=0.1, weight_decay=0.01),
    "adagrad": lambda m: m.Adagrad(lr=0.1),
    "adagrad_decay_momentum": lambda m: m.Adagrad(lr=0.05, weight_decay=0.02, g_square_momentum=0.9),
    "adagrad_vectorwise": lambda m: m.Adagrad(lr=0.1, vectorwise_shared=True),
    "adam": lambda m: m.Adam(lr=0.01),
    "adam_decay": lambda m: m.Adam(lr=0.01, betas=(0.8, 0.99), weight_decay=0.1, eps=1e-6),
}


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.uint32)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_update_dense_bitwise(name):
    """Five updates of one entry, Adam's batch powers advanced between them."""
    jc, tc = OPTIMIZERS[name](joptim).config, OPTIMIZERS[name](toptim).config
    assert tc.state_dim(8) == jc.state_dim(8)
    rng = np.random.default_rng(1)
    emb = {k: rng.standard_normal(8).astype(np.float32) for k in ("j", "t")}
    emb["t"] = emb["j"].copy()
    state = {"j": jc.init_state(8), "t": tc.init_state(8)}
    np.testing.assert_array_equal(_bits(state["j"]), _bits(state["t"]))
    bs_j, bs_t = jc.initial_batch_state(), tc.initial_batch_state()
    assert bs_j == bs_t
    for _ in range(5):
        bs_j, bs_t = jc.advance_batch_state(bs_j), tc.advance_batch_state(bs_t)
        assert bs_j == bs_t
        grad = rng.standard_normal(8).astype(np.float32)
        jc.update_dense(emb["j"], state["j"], grad, bs_j)
        tc.update_dense(emb["t"], state["t"], grad, bs_t)
        np.testing.assert_array_equal(_bits(emb["j"]), _bits(emb["t"]))
        np.testing.assert_array_equal(_bits(state["j"]), _bits(state["t"]))


def _store_pair(name, bound, capacity=64):
    kw = dict(capacity=capacity, num_internal_shards=2, seed=5)
    js = JaxStore(hyperparams=jcfg.HyperParameters(weight_bound=bound), **kw)
    ts = EmbeddingStore(hyperparams=tcfg.HyperParameters(weight_bound=bound), **kw)
    js.register_optimizer(OPTIMIZERS[name](joptim).config)
    ts.register_optimizer(OPTIMIZERS[name](toptim).config)
    return js, ts


def _assert_stores_equal(js, ts):
    assert js.size() == ts.size()
    for jshard, tshard in zip(js._shards, ts._shards):
        assert list(jshard.entries) == list(tshard.entries)  # the same LRU order
        for sign, (dim, vec) in jshard.entries.items():
            tdim, tvec = tshard.entries[sign]
            assert tdim == dim
            np.testing.assert_array_equal(_bits(vec), _bits(tvec))
            np.testing.assert_array_equal(_bits(ts.get_embedding_entry(sign)), _bits(vec))


@pytest.mark.parametrize("name", ["sgd_decay", "adagrad", "adagrad_vectorwise", "adam"])
@pytest.mark.parametrize("bound", [10.0, 0.02, 0.0])
def test_store_update_gradients_bitwise(name, bound):
    """Admit by train lookups, then update twice per group: signs never
    admitted are skipped and counted, a small weight bound clamps, and a
    capacity below the signs used evicts (LRU order compared too)."""
    js, ts = _store_pair(name, bound, capacity=32)
    rng = np.random.default_rng(2)
    admitted = rng.integers(0, 1000, 48, dtype=np.uint64)
    js.lookup(admitted, 8, True), ts.lookup(admitted, 8, True)
    _assert_stores_equal(js, ts)
    assert ts.size() < len(set(admitted.tolist()))  # some were evicted
    misses = 0
    for step in range(4):
        group = step % 2
        js.advance_batch_state(group), ts.advance_batch_state(group)
        signs = np.concatenate([rng.choice(admitted, 20), rng.integers(5000, 6000, 4, dtype=np.uint64)])
        present = {int(s) for sh in ts._shards for s in sh.entries}
        misses += sum(int(s) not in present for s in signs)
        grads = (rng.standard_normal((len(signs), 8)) * 3).astype(np.float32)
        js.update_gradients(signs, grads, group)
        ts.update_gradients(signs, grads, group)
        _assert_stores_equal(js, ts)
    assert ts.grad_misses == misses > 0
    if bound:
        assert all(np.abs(vec[:8]).max() <= bound for sh in ts._shards for _, vec in sh.entries.values())


def test_store_update_batched_bitwise():
    """Two groups of different dims and optimizer groups in one call equal
    the reference's call; a group never advanced takes the first batch's
    powers on both sides."""
    js, ts = _store_pair("adam", 10.0, capacity=1 << 10)
    rng = np.random.default_rng(3)
    a = rng.integers(0, 500, 30, dtype=np.uint64)
    b = rng.integers(500, 1000, 20, dtype=np.uint64)
    for s in (js, ts):
        s.lookup(a, 8, True)
        s.lookup(b, 4, True)
        s.advance_batch_state(0)
    signs = np.concatenate([a, b])
    key_ofs = np.array([0, 30, 50], np.int64)
    dims = np.array([8, 4], np.uint32)
    grads = rng.standard_normal(30 * 8 + 20 * 4).astype(np.float32)
    groups = np.array([0, 3], np.int32)  # group 3 was never advanced
    js.update_batched(signs, key_ofs, dims, grads, groups)
    ts.update_batched(signs, key_ofs, dims, grads, groups)
    _assert_stores_equal(js, ts)
    assert ts.grad_misses == 0


def test_register_optimizer_resets_batch_state_and_widens_entries():
    """Registering Adam over Adagrad entries: lookups re-init the entries
    to the new width (the reference's width check), the beta powers start
    over."""
    js, ts = _store_pair("adagrad", 10.0)
    signs = np.arange(10, dtype=np.uint64)
    for s in (js, ts):
        s.lookup(signs, 8, True)
        s.advance_batch_state(0)
        s.register_optimizer((joptim if s is js else toptim).Adam(lr=0.01).config)
        s.lookup(signs, 8, True)
        s.advance_batch_state(0)
        s.update_gradients(signs, np.ones((10, 8), np.float32), 0)
    _assert_stores_equal(js, ts)
    assert len(ts.get_embedding_entry(3)) == 8 + 16
    assert ts.get_embedding_entry(12345) is None


def test_update_without_optimizer_raises():
    ts = EmbeddingStore()
    with pytest.raises(RuntimeError):
        ts.update_gradients(np.zeros(1, np.uint64), np.zeros((1, 4), np.float32))
    ts.register_optimizer(toptim.SGD().config)
    with pytest.raises(ValueError):
        ts.update_gradients(np.zeros(2, np.uint64), np.zeros((1, 4), np.float32))
