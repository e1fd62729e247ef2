"""The port's native PS core (``persia_tpu_torch/native/ps.cpp``) against
the reference's (``native/ps.cpp``) and against the port's numpy store.

- Against the reference's core, bit for bit: lookup rows, every entry
  after update trajectories (SGD with weight decay, Adagrad,
  Adagrad-vectorwise, Adam), LRU survivor sets, grad misses, admission,
  the weight bound, dim-mismatch re-init, and the batched calls.
- Against the port's numpy store (the golden model): the seeded init bit
  for bit where libm is glibc's (as ``tests/test_init_methods.py`` gates
  it); floats after updates to rtol 2e-5, atol 1e-6, the reference's own
  tolerance between its two cores (``-mfma`` contracts the update's
  multiply-adds); survivor sets and grad misses exactly.
- Durable state, against the reference's core: ``dump_shard`` bytes after
  lookup and update streams, the LRU survivors of a store rebuilt by
  ``load_shard_bytes``, the bounded apply-journal and
  ``update_batched_journaled``.
"""

import platform

import numpy as np
import pytest

import persia_tpu.config as jcfg
from persia_tpu.embedding import native_store as jns
from persia_tpu.embedding import optim as joptim
import persia_tpu_torch.config as tcfg
from persia_tpu_torch.embedding import native_store as ns
from persia_tpu_torch.embedding import optim as toptim
from persia_tpu_torch.embedding.store import EmbeddingStore

FLOAT_TOL = dict(rtol=2e-5, atol=1e-6)

OPTS = {
    "sgd_wd": lambda m: m.SGD(lr=0.05, weight_decay=0.01),
    "adagrad": lambda m: m.Adagrad(lr=0.1, initialization=0.02, g_square_momentum=0.95),
    "adagrad_vw": lambda m: m.Adagrad(lr=0.1, vectorwise_shared=True),
    "adam": lambda m: m.Adam(lr=0.01),
}


@pytest.fixture(autouse=True)
def both_cores():
    assert ns.native_available() and jns.native_available()


def _glibc() -> bool:
    return platform.libc_ver()[0] == "glibc"


def _trio(opt="sgd_wd", hp=None, **kw):
    """(port native, reference native, port numpy) on one configuration."""
    kw = {**dict(capacity=2048, num_internal_shards=4, seed=9), **kw}
    hp = hp or {}
    return (
        ns.NativeEmbeddingStore(optimizer=OPTS[opt](toptim).config,
                                hyperparams=tcfg.HyperParameters(**hp), **kw),
        jns.NativeEmbeddingStore(optimizer=OPTS[opt](joptim).config,
                                 hyperparams=jcfg.HyperParameters(**hp), **kw),
        EmbeddingStore(optimizer=OPTS[opt](toptim).config, hyperparams=tcfg.HyperParameters(**hp), **kw),
    )


def _expected_misses(ref, signs, dim):
    """Rows an update of ``signs`` skips in the reference core (absent, or
    an entry of another width), read from its entries before the update."""
    width = dim + ref.optimizer.state_dim(dim)
    return sum(1 for s in signs.tolist()
               if (e := ref.get_embedding_entry(s)) is None or ref.get_entry_dim(s) != dim or len(e) != width)


def _same_entries(port, ref, numpy_store, signs):
    for s in signs.tolist():
        a, b, c = port.get_embedding_entry(s), ref.get_embedding_entry(s), numpy_store.get_embedding_entry(s)
        assert (a is None) == (b is None) == (c is None), s
        if a is not None:
            np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
            np.testing.assert_allclose(a, c, **FLOAT_TOL)


def test_init_bitwise():
    port, ref, py = _trio()
    signs = np.array([1, 2, 3, 1 << 50, 0xFFFFFFFFFFFFFFFF], dtype=np.uint64)
    a = port.lookup(signs, 16, train=True)
    np.testing.assert_array_equal(a, ref.lookup(signs, 16, train=True))
    np.testing.assert_array_equal(a, py.lookup(signs, 16, train=True))


@pytest.mark.parametrize("kind,p0,p1", [("normal", 0.1, 0.7), ("poisson", 2.5, 0.0),
                                        ("gamma", 2.0, 0.5), ("inverse_sqrt", 0.0, 0.0)])
def test_init_methods(kind, p0, p1):
    """Each init method: bit for bit the reference core's; the numpy
    store's bit for bit on glibc (transcendentals through one libm), to 1e-6
    elsewhere."""
    signs = np.random.default_rng(3).integers(0, 2**63, 40, dtype=np.uint64)
    port = ns.NativeEmbeddingStore(hyperparams=tcfg.HyperParameters(
        initialization_method=tcfg.InitializationMethod(kind, p0, p1)), seed=5)
    ref = jns.NativeEmbeddingStore(hyperparams=jcfg.HyperParameters(
        initialization_method=jcfg.InitializationMethod(kind, p0, p1)), seed=5)
    py = EmbeddingStore(hyperparams=tcfg.HyperParameters(
        initialization_method=tcfg.InitializationMethod(kind, p0, p1)), seed=5)
    a = port.lookup(signs, 8, train=True)
    np.testing.assert_array_equal(a, ref.lookup(signs, 8, train=True))
    if _glibc():
        np.testing.assert_array_equal(a, py.lookup(signs, 8, train=True))
    else:
        np.testing.assert_allclose(a, py.lookup(signs, 8, train=True), rtol=1e-6, atol=1e-7)


def test_infer_miss_and_dim_gate():
    port, ref, py = _trio("adam")
    signs = np.array([21, 42], dtype=np.uint64)
    for st in (port, ref, py):
        assert not st.lookup(signs, 8, False).any()
        st.lookup(signs[:1], 4, True)
    assert port.size() == ref.size() == py.size() == 1
    for st in (port, ref, py):  # another dim reads zeros, never optimizer state
        assert not st.lookup(signs[:1], 8, False).any()
    np.testing.assert_array_equal(port.lookup(signs, 4, False), ref.lookup(signs, 4, False))
    np.testing.assert_array_equal(port.lookup(signs, 4, False), py.lookup(signs, 4, False))


@pytest.mark.parametrize("opt", list(OPTS))
def test_training_trajectory(opt):
    """20 rounds of train lookups and updates over overlapping signs in a
    store small enough to evict, each update also naming signs never looked
    up (grad misses): entries bit for bit the reference core's, within
    rtol 2e-5 of the numpy store's; survivors and grad misses exact."""
    port, ref, py = _trio(opt, capacity=96)
    rng = np.random.default_rng(0)
    misses = 0
    for step in range(20):
        signs = rng.integers(0, 200, size=64, dtype=np.uint64)
        a = port.lookup(signs, 8, train=True)
        np.testing.assert_array_equal(a, ref.lookup(signs, 8, train=True))
        np.testing.assert_allclose(a, py.lookup(signs, 8, train=True), **FLOAT_TOL)
        upd = np.concatenate([signs, rng.integers(200, 400, size=8, dtype=np.uint64)])
        misses += _expected_misses(ref, upd, 8)
        g = rng.normal(size=(len(upd), 8)).astype(np.float32)
        group = step % 2
        for st in (port, ref, py):
            st.advance_batch_state(group)
            st.update_gradients(upd, g, group)
        assert port.grad_misses == py.grad_misses == misses
    assert misses > 0
    assert port.size() == ref.size() == py.size() == 96
    _same_entries(port, ref, py, np.arange(400, dtype=np.uint64))


def test_lru_eviction_survivors():
    port, ref, py = _trio(capacity=8, num_internal_shards=1)
    rng = np.random.default_rng(2)
    for _ in range(30):
        signs = rng.integers(0, 40, size=5, dtype=np.uint64)
        for st in (port, ref, py):
            st.lookup(signs, 4, True)
    assert port.size() == ref.size() == py.size() == 8
    _same_entries(port, ref, py, np.arange(40, dtype=np.uint64))


def test_dim_mismatch_reinit():
    port, ref, py = _trio()
    signs = np.array([7], dtype=np.uint64)
    for st in (port, ref, py):
        st.lookup(signs, 4, True)
    a = port.lookup(signs, 8, True)
    np.testing.assert_array_equal(a, ref.lookup(signs, 8, True))
    np.testing.assert_array_equal(a, py.lookup(signs, 8, True))
    # an update of the old width misses the re-initialised entry
    for st in (port, py):
        st.update_gradients(signs, np.ones((1, 4), np.float32))
    assert port.grad_misses == py.grad_misses == 1
    _same_entries(port, ref, py, signs)


def test_admission():
    port, ref, py = _trio(hp=dict(admit_probability=0.5))
    signs = np.arange(500, dtype=np.uint64)
    a = port.lookup(signs, 4, True)
    np.testing.assert_array_equal(a, ref.lookup(signs, 4, True))
    np.testing.assert_array_equal(a, py.lookup(signs, 4, True))
    assert port.size() == ref.size() == py.size()
    assert 0 < port.size() < 500
    _same_entries(port, ref, py, signs)


def test_weight_bound():
    port, ref, py = _trio(hp=dict(weight_bound=0.02))
    signs = np.array([3, 4], dtype=np.uint64)
    g = np.array([[5.0] * 4, [-5.0] * 4], np.float32)
    for st in (port, ref, py):
        st.lookup(signs, 4, True)
        st.update_gradients(signs, g * 100)
    out = port.lookup(signs, 4, False)
    np.testing.assert_array_equal(out, ref.lookup(signs, 4, False))
    np.testing.assert_array_equal(out, py.lookup(signs, 4, False))
    assert np.abs(out).max() == np.float32(0.02)


def _batched_fixture(seed=3):
    """Three groups with mixed dims, overlapping signs, two optimizer
    groups."""
    rng = np.random.default_rng(seed)
    groups = [(rng.integers(0, 5000, 700 + 100 * g, dtype=np.uint64), dim, g % 2)
              for g, dim in enumerate((16, 8, 16))]
    key_ofs = np.zeros(len(groups) + 1, dtype=np.int64)
    np.cumsum([len(k) for k, _, _ in groups], out=key_ofs[1:])
    signs = np.concatenate([k for k, _, _ in groups])
    dims = np.array([d for _, d, _ in groups], dtype=np.uint32)
    ogs = np.array([og for _, _, og in groups], dtype=np.int32)
    return groups, signs, key_ofs, dims, ogs


@pytest.mark.parametrize("opt", ["sgd_wd", "adagrad", "adam"])
def test_batched_calls_match_sequential_and_the_other_cores(opt):
    """``lookup_batched`` / ``update_batched`` in one call: bit for bit
    sequential per-group calls on the port's core and the reference core's
    batched calls; within rtol 2e-5 of the numpy store. The groups share
    signs of two dims, so entries re-init between groups."""
    port, ref, py = _trio(opt, capacity=1 << 14)
    seq = ns.NativeEmbeddingStore(optimizer=OPTS[opt](toptim).config, capacity=1 << 14,
                                  num_internal_shards=4, seed=9)
    groups, signs, key_ofs, dims, ogs = _batched_fixture()
    flat = port.lookup_batched(signs, key_ofs, dims, train=True)
    np.testing.assert_array_equal(flat, ref.lookup_batched(signs, key_ofs, dims, train=True))
    np.testing.assert_array_equal(flat, py.lookup_batched(signs, key_ofs, dims, train=True))
    np.testing.assert_array_equal(
        flat, np.concatenate([seq.lookup(k, d, True).reshape(-1) for k, d, _ in groups]))
    rng = np.random.default_rng(11)
    grads = [rng.normal(size=(len(k), d)).astype(np.float32) for k, d, _ in groups]
    gflat = np.concatenate([g.reshape(-1) for g in grads])
    for st in (port, ref, py, seq):
        for og in sorted(set(ogs.tolist())):
            st.advance_batch_state(og)
    port.update_batched(signs, key_ofs, dims, gflat, ogs)
    ref.update_batched(signs, key_ofs, dims, gflat, ogs)
    py.update_batched(signs, key_ofs, dims, gflat, ogs)
    for (k, d, og), g in zip(groups, grads):
        seq.update_gradients(k, g, og)
    assert port.grad_misses == seq.grad_misses == py.grad_misses > 0
    probe = np.unique(signs)
    _same_entries(port, ref, py, probe)
    for s in probe.tolist():
        np.testing.assert_array_equal(port.get_embedding_entry(s), seq.get_embedding_entry(s))


def test_layout_is_checked():
    port, _, _ = _trio()
    signs = np.arange(4, dtype=np.uint64)
    with pytest.raises(ValueError):
        port.lookup_batched(signs, np.array([0, 3]), np.array([4], np.uint32), True)
    with pytest.raises(ValueError):
        port.update_batched(signs, np.array([0, 4]), np.array([4], np.uint32),
                            np.zeros(15, np.float32), np.zeros(1, np.int32))
    with pytest.raises(ValueError):
        port.update_gradients(signs, np.zeros((3, 4), np.float32))


def test_set_get_clear_and_no_optimizer():
    st = ns.NativeEmbeddingStore(capacity=64, num_internal_shards=2, seed=1)
    with pytest.raises(RuntimeError):
        st.update_gradients(np.array([1], np.uint64), np.zeros((1, 4), np.float32))
    vals = np.arange(12, dtype=np.float32).reshape(2, 6)
    st.set_embedding(np.array([5, 6], np.uint64), vals, dim=4)
    np.testing.assert_array_equal(st.get_embedding_entry(6), vals[1])
    assert st.get_embedding_entry(7) is None and st.size() == 2
    st.clear()
    assert st.size() == 0 and st.get_embedding_entry(5) is None


def test_create_store_and_backend_name(monkeypatch):
    kw = dict(capacity=64, num_internal_shards=2)
    assert ns.store_backend_name(ns.create_store("native", **kw)) == "native"
    assert ns.store_backend_name(ns.create_store("numpy", **kw)) == "numpy"
    assert ns.store_backend_name(ns.create_store("auto", **kw)) == "native"
    assert ns.store_backend_name(object()) == "unknown"
    with pytest.raises(ValueError):
        ns.create_store("rocksdb")

    def broken():
        raise RuntimeError("g++ failed")

    monkeypatch.setattr(ns, "_load_lib", broken)
    assert not ns.native_available()
    assert ns.store_backend_name(ns.create_store("auto", **kw)) == "numpy"
    with pytest.raises(RuntimeError):
        ns.create_store("native", **kw)


# ------------------------------------------------------------ durable state


def _stream(stores, steps=12, n=48, vocab=160, seed=4):
    """Train lookups and updates (with grad misses) over overlapping signs."""
    rng = np.random.default_rng(seed)
    for step in range(steps):
        signs = rng.integers(0, vocab, size=n, dtype=np.uint64)
        upd = np.concatenate([signs, rng.integers(vocab, 2 * vocab, size=4, dtype=np.uint64)])
        g = rng.normal(size=(len(upd), 8)).astype(np.float32)
        for st in stores:
            st.lookup(signs, 8, train=True)
            st.advance_batch_state(step % 2)
            st.update_gradients(upd, g, step % 2)


@pytest.mark.parametrize("opt", ["sgd_wd", "adagrad", "adam"])
def test_dump_shard_bytes_match_reference_core(opt):
    """After the same lookup and update stream (evicting), every shard's
    dump is the reference core's byte for byte: the same entries, from the
    least to the most recently used."""
    port, ref, _ = _trio(opt, capacity=96)
    _stream((port, ref))
    assert port.size() == ref.size() == 96
    assert port.num_internal_shards == ref.num_internal_shards == 4
    for i in range(4):
        assert port.dump_shard(i) == ref.dump_shard(i), i
    with pytest.raises(IndexError):
        port.dump_shard(4)


@pytest.mark.parametrize("opt", ["adagrad", "adam"])
def test_loaded_store_keeps_the_lru_order(opt):
    """A store rebuilt from the dumps (loaded into an empty store of
    another shard count too) evicts as the original does: after further
    inserts past capacity, the survivors and their dumps match the
    original's and the reference core's, rebuilt the same way."""
    port, ref, _ = _trio(opt, capacity=64, num_internal_shards=1)
    _stream((port, ref), steps=6, n=24, vocab=80)
    rebuilt = []
    for src, mod, cfgmod, optmod in ((port, ns, tcfg, toptim), (ref, jns, jcfg, joptim)):
        st = mod.NativeEmbeddingStore(optimizer=OPTS[opt](optmod).config, capacity=64,
                                      num_internal_shards=1, seed=9)
        assert st.load_shard_bytes(src.dump_shard(0)) == src.size()
        rebuilt.append(st)
    assert rebuilt[0].dump_shard(0) == port.dump_shard(0) == ref.dump_shard(0)
    rng = np.random.default_rng(8)
    for _ in range(5):
        signs = rng.integers(0, 200, size=20, dtype=np.uint64)
        for st in (port, ref, *rebuilt):
            st.lookup(signs, 8, train=True)
    assert port.dump_shard(0) == ref.dump_shard(0) == rebuilt[0].dump_shard(0) == rebuilt[1].dump_shard(0)
    present = [s for s in range(200) if port.get_embedding_entry(s) is not None]
    assert len(present) == 64
    assert present == [s for s in range(200) if rebuilt[0].get_embedding_entry(s) is not None]


def test_load_rejects_a_torn_payload():
    port, _, _ = _trio()
    port.lookup(np.arange(10, dtype=np.uint64), 8, train=True)
    blob = b"".join(port.dump_shard(i)[4:] for i in range(4))
    whole = np.uint32(port.size()).tobytes() + blob
    fresh = ns.NativeEmbeddingStore(capacity=2048, num_internal_shards=2, seed=9)
    assert fresh.load_shard_bytes(whole) == 10
    for cut in (b"", whole[:3], whole[:-1], whole[:20]):
        with pytest.raises(ValueError):
            fresh.load_shard_bytes(cut)


def test_journal_bounded_probe_and_clear():
    """The journal keeps the newest 65,536 ids (the oldest go first; a
    re-record keeps its place); probe gives 1 (same crc), 0 (unknown) and
    -1 (another crc), as the reference core's does on the same calls."""
    port, ref, _ = _trio()
    cap = 1 << 16
    for st in (port, ref):
        for i in range(cap + 10):
            st.journal_record(i, i * 3)
        st.journal_record(cap + 9, 5)  # a re-record: same place, new crc
    for st in (port, ref):
        assert st.journal_len() == cap
    for jid, crc in ((0, 0), (9, 27), (10, 30), (cap + 8, 3 * (cap + 8)), (cap + 8, 1), (cap + 9, 5),
                     (cap + 9, 3 * (cap + 9)), (1 << 63, 0)):
        assert port.journal_probe(jid, crc) == ref.journal_probe(jid, crc), (jid, crc)
    assert [port.journal_probe(j, c) for j, c in ((0, 0), (10, 30), (10, 31))] == [0, 1, -1]
    port.journal_clear()
    assert port.journal_len() == 0 and port.journal_probe(10, 30) == 0


@pytest.mark.parametrize("opt", ["adagrad", "adam"])
def test_update_batched_journaled_skips_a_duplicate(opt):
    """The first journaled apply of an id applies and records it; a second
    (same or another payload crc) is skipped, on both cores alike."""
    port, ref, _ = _trio(opt, capacity=1 << 14)
    groups, signs, key_ofs, dims, ogs = _batched_fixture(5)
    grads = np.random.default_rng(6).normal(size=int(np.diff(key_ofs) @ dims)).astype(np.float32)
    for st in (port, ref):
        st.lookup_batched(signs, key_ofs, dims, train=True)
        assert st.update_batched_journaled(77, 1234, signs, key_ofs, dims, grads, ogs) is True
    after = {s: port.get_embedding_entry(s) for s in np.unique(signs).tolist()}
    for st in (port, ref):
        assert st.update_batched_journaled(77, 1234, signs, key_ofs, dims, grads, ogs) is False
        assert st.update_batched_journaled(77, 99, signs, key_ofs, dims, grads, ogs) is False
        assert st.journal_len() == 1 and st.journal_probe(77, 1234) == 1
    for s, e in after.items():
        np.testing.assert_array_equal(port.get_embedding_entry(s), e)
        np.testing.assert_array_equal(ref.get_embedding_entry(s), e)
    assert port.update_batched_journaled(78, 1234, signs, key_ofs, dims, grads, ogs) is True
    assert any(not np.array_equal(port.get_embedding_entry(s), e) for s, e in after.items())
