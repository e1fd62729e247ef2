"""The port's job state (``persia_tpu_torch/jobstate.py``, the loader's
``BatchCursor``) against ``persia_tpu``'s:

- journal ids and payload crcs equal the reference's over a grid;
- an epoch directory written by either package is read by the other: the
  latest manifest and its blobs, the fallback past a torn epoch, a blob
  failing its crc, ``prune`` (the manifest cases of
  ``tests/test_checkpoint.py``, each for every writer and reader);
- PS capture and restore: a rewind to the fence clears the journal, on both
  store backends, from a manifest of either package;
- the router's journaled applies skip a replay, as the reference's do, and
  record the same ids and crcs;
- ``BatchCursor`` and the RNG streams' capture, across the packages.
"""

import os

import numpy as np
import pytest

import persia_tpu.data_loader as jloader
from persia_tpu import jobstate as jjob
from persia_tpu.embedding import optim as joptim
from persia_tpu.embedding.store import EmbeddingStore as JaxStore
from persia_tpu.embedding.worker import ShardedLookup as JaxRouter
import persia_tpu_torch.data_loader as tloader
from persia_tpu_torch import jobstate as tjob
from persia_tpu_torch.embedding import optim as toptim
from persia_tpu_torch.embedding.native_store import create_store
from persia_tpu_torch.embedding.store import EmbeddingStore
from persia_tpu_torch.embedding.worker import ShardedLookup

PKG = {"jax": jjob, "port": tjob}
PAIRS = [("jax", "port"), ("port", "jax"), ("port", "port")]


def test_journal_ids_match_the_reference():
    for epoch in (0, 1, 2, 1000, (1 << 24) - 1, 1 << 24, (1 << 30) + 5):
        for step in (0, 1, 7, 1 << 20, (1 << 32) - 1, 1 << 32, (1 << 40) + 3):
            base = tjob.make_journal_id(epoch, step)
            assert base == jjob.make_journal_id(epoch, step)
            for shard in (0, 1, 127):
                assert tjob.journal_shard_id(base, shard) == jjob.journal_shard_id(base, shard)
    for bad in (-1, 0x80, 255):
        with pytest.raises(ValueError):
            tjob.journal_shard_id(1 << 8, bad)


def test_payload_crc_matches_the_reference():
    rng = np.random.default_rng(0)
    for n in (0, 1, 5, 1000):
        keys = rng.integers(0, 2 ** 63, n, dtype=np.uint64)
        grads = rng.normal(size=(n, 16)).astype(np.float32)
        for arrays in ((keys, grads), (grads,), (keys, grads.T, np.arange(3, dtype=np.int8))):
            assert tjob.payload_crc(*arrays) == jjob.payload_crc(*arrays)
    assert tjob.payload_crc(keys, grads) != tjob.payload_crc(keys, grads + 1)


# ------------------------------------------------- manifests, both directions


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_manifest_commit_and_last_good(tmp_path, writer, reader):
    root = str(tmp_path / "js")
    assert PKG[reader].JobStateManager(root).latest() is None
    w = PKG[writer].JobStateManager(root).begin_epoch()
    w.add_blob("dense.state", b"hello world")
    w.add_json("loader.json", {"consumed_batches": 7})
    m = w.commit({"step": 7})
    assert m.job_epoch == 1 and m.step == 7
    got = PKG[reader].JobStateManager(root).latest()
    assert got is not None and got.job_epoch == 1 and got.step == 7
    assert got.read_blob("dense.state") == b"hello world"
    assert got.read_json("loader.json")["consumed_batches"] == 7
    assert got.has("loader.json") and not got.has("nope")
    with pytest.raises(PKG[reader].ManifestError):
        got.read_blob("nope")


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_manifest_last_good_fallback_on_torn_epoch(tmp_path, writer, reader):
    """An epoch cut before its manifest is invisible; a torn manifest is
    skipped, and so is one whose component lost bytes: the reader falls
    back to the newest good epoch."""
    root = str(tmp_path / "js")
    mgr = PKG[writer].JobStateManager(root)
    w1 = mgr.begin_epoch()
    w1.add_blob("dense.state", b"epoch-one")
    w1.commit({"step": 4})
    w2 = mgr.begin_epoch()  # components written, no manifest
    w2.add_blob("dense.state", b"epoch-two")
    assert PKG[reader].JobStateManager(root).latest().job_epoch == 1
    w3 = mgr.begin_epoch()
    w3.add_blob("dense.state", b"epoch-three")
    m3 = w3.commit({"step": 12})
    with open(os.path.join(m3.dir, tjob.MANIFEST_NAME), "wb") as f:
        f.write(b'{"job_epoch": 3, "compo')  # torn write
    got = PKG[reader].JobStateManager(root).latest()
    assert got.job_epoch == 1 and got.read_blob("dense.state") == b"epoch-one"
    w4 = mgr.begin_epoch()
    w4.add_blob("dense.state", b"epoch-four")
    m4 = w4.commit({"step": 16})
    with open(os.path.join(m4.dir, "dense.state"), "wb") as f:
        f.write(b"epoch-fo")  # the pointer's epoch lost bytes
    assert PKG[reader].JobStateManager(root).latest().job_epoch == 1


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_manifest_blob_crc_verified_on_read(tmp_path, writer, reader):
    root = str(tmp_path / "js")
    w = PKG[writer].JobStateManager(root).begin_epoch()
    w.add_blob("dense.state", b"x" * 100)
    m = w.commit({"step": 1})
    path = os.path.join(m.dir, "dense.state")
    raw = bytearray(open(path, "rb").read())
    raw[50] ^= 0xFF
    with open(path, "wb") as f:
        f.write(raw)
    with pytest.raises(PKG[reader].CorruptManifestError):
        PKG[reader].JobStateManager(root).latest().read_blob("dense.state")


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_manifest_prune_keeps_newest(tmp_path, writer, reader):
    root = str(tmp_path / "js")
    mgr = PKG[writer].JobStateManager(root)
    for step in (1, 2, 3, 4):
        w = mgr.begin_epoch()
        w.add_blob("dense.state", b"s%d" % step)
        w.commit({"step": step})
    rmgr = PKG[reader].JobStateManager(root)
    assert rmgr.prune(keep=2) == 2
    assert rmgr.latest().step == 4
    assert len(rmgr._epoch_dirs()) == 2
    assert PKG[writer].JobStateManager(root).begin_epoch().job_epoch == 5
    assert not [f for f in os.listdir(rmgr.latest().dir) if f.startswith(".tmp_")]


# ------------------------------------------------------------ PS rewind


def _signs():
    return np.arange(10, dtype=np.uint64)


@pytest.mark.parametrize("backend", ["numpy", "native"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_restore_ps_rewinds_and_clears_journal(tmp_path, backend, writer):
    """The reference's ``test_restore_ps_rewinds_and_clears_journal`` on the
    port's stores, from a fence either package captured."""
    src = (JaxStore(capacity=1 << 16, num_internal_shards=4, seed=7) if writer == "jax"
           else EmbeddingStore(capacity=1 << 16, num_internal_shards=4, seed=7))
    src.register_optimizer((joptim if writer == "jax" else toptim).Adagrad(lr=0.1).config)
    src.lookup(_signs(), 8, True)
    fence = [src.get_embedding_entry(s).copy() for s in _signs().tolist()]
    mgr = PKG[writer].JobStateManager(str(tmp_path))
    w = mgr.begin_epoch()
    m = w.commit({"step": 3, **PKG[writer].capture_ps(w, [src])})

    store = create_store(backend, capacity=1 << 16, num_internal_shards=4, seed=7,
                         optimizer=toptim.Adagrad(lr=0.1).config)
    m = tjob.JobStateManager(str(tmp_path)).latest()
    assert tjob.restore_ps(m, [store], optimizer=toptim.Adagrad(lr=0.1).config) == 10
    store.update_batched_journaled(
        tjob.make_journal_id(1, 3), 99, _signs(), np.array([0, 10], np.int64), np.array([8], np.uint32),
        np.ones(80, np.float32), np.array([0], np.int32),
    )
    assert store.journal_len() == 1
    assert not np.array_equal(fence[0], store.get_embedding_entry(0))
    assert tjob.restore_ps(m, [store], optimizer=toptim.Adagrad(lr=0.1).config) == 10
    for s, e in zip(_signs().tolist(), fence):
        np.testing.assert_array_equal(store.get_embedding_entry(s), e)
    assert store.journal_len() == 0  # rewound with the data: the id applies again
    with pytest.raises(tjob.ManifestError):
        tjob.restore_ps(m, [store, store])


def test_restore_ps_re_advances_adam_powers(tmp_path):
    """A rewind advances Adam's batch powers to the fence's counts: the
    next update equals the uninterrupted store's."""
    opt = toptim.Adam(lr=0.01).config
    a, b = (EmbeddingStore(capacity=1 << 12, num_internal_shards=2, seed=7, optimizer=opt) for _ in range(2))
    g = np.random.default_rng(1).normal(size=(10, 8)).astype(np.float32)
    for st in (a, b):
        st.lookup(_signs(), 8, True)
        for _ in range(3):
            st.advance_batch_state(0)
            st.update_gradients(_signs(), g, 0)
    mgr = tjob.JobStateManager(str(tmp_path))
    m = tjob.snapshot_job(mgr, 3, replicas=[b], batch_advances={0: 3})
    b.clear()
    _, info = tjob.resume_job(mgr, replicas=[b], optimizer=opt)
    assert info["resumed"] and info["step"] == 3 and info["batch_advances"] == {0: 3}
    assert info["ps_entries_restored"] == 10 and m.meta["ps_bytes"] > 0
    for st in (a, b):
        st.advance_batch_state(0)
        st.update_gradients(_signs(), g, 0)
    for i in range(2):
        assert a.dump_shard(i) == b.dump_shard(i)


# ---------------------------------------------------- exactly once at the router


@pytest.mark.parametrize("backend", ["numpy", "native"])
def test_router_journal_skips_replayed_applies(backend):
    """The reference's ``test_router_journal_skips_replayed_applies``: a
    replay of steps 3–5 under the same ids is skipped on every replica, an
    un-journaled one applies twice; the port's numpy journals hold the
    reference's ids and crcs."""
    def run(router_cls, stores, optim):
        for st in stores:
            st.register_optimizer(optim.Adagrad(lr=0.1).config)
        router = router_cls(stores)
        signs = np.arange(1, 41, dtype=np.uint64)
        router.lookup_groups([(signs, 8)], True)
        rng = np.random.default_rng(0)
        grads = [rng.normal(size=(40, 8)).astype(np.float32) for _ in range(6)]
        for s in list(range(6)) + [3, 4, 5]:
            router.update_groups([(signs, grads[s], 0)], journal_id=tjob.make_journal_id(0, s))
        return router, signs, grads

    stores = [create_store(backend, capacity=1 << 16, num_internal_shards=4, seed=7) for _ in range(2)]
    router, signs, grads = run(ShardedLookup, stores, toptim)
    ref_stores = [JaxStore(capacity=1 << 16, num_internal_shards=4, seed=7) for _ in range(2)]
    ref_router, _, _ = run(JaxRouter, ref_stores, joptim)
    assert router.journal_skips == ref_router.journal_skips == 3 * 2
    for st, ref in zip(stores, ref_stores):
        for i in range(4):
            assert st.dump_shard(i) == ref.dump_shard(i)
        if backend == "numpy":
            assert st._journal == ref._journal
        else:
            assert st.journal_len() == ref.journal_len() == 6
            assert all(st.journal_probe(k, c) == 1 for k, c in ref._journal.items())
    before = [st.dump_shard(0) for st in stores]
    router.update_groups([(signs, grads[5], 0)])  # un-journaled: applies again
    assert [st.dump_shard(0) for st in stores] != before


# ------------------------------------------------------------ cursor and RNG


def test_batch_cursor_matches_the_reference():
    src = list(range(10))
    for skip in (0, 4, 10, 12):
        a, b = tloader.BatchCursor(src, skip=skip), jloader.BatchCursor(src, skip=skip)
        assert list(a) == list(b) == src[skip:]
        assert a.consumed == b.consumed == max(10, skip)
        assert a.state() == b.state()
    cursors = [tloader.BatchCursor(iter(src), skip=4), jloader.BatchCursor(iter(src), skip=4)]
    its = [iter(c) for c in cursors]
    for it in its:  # a batch counts once the consumer asks for the next
        assert [next(it), next(it)] == [4, 5]
    assert cursors[0].state() == cursors[1].state() == {"consumed_batches": 5}


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_rng_capture_roundtrip(writer, reader):
    gen = np.random.default_rng(5)
    gen.normal(size=3)
    np.random.seed(11)
    np.random.normal(size=1)  # leaves a cached gaussian
    snap = PKG[writer].capture_rng_streams({"ds": gen})
    assert snap == jjob.capture_rng_streams({"ds": gen})
    a1, b1 = gen.normal(size=4), np.random.normal(size=4)
    PKG[reader].restore_rng_streams(snap, {"ds": gen})
    np.testing.assert_array_equal(a1, gen.normal(size=4))
    np.testing.assert_array_equal(b1, np.random.normal(size=4))


def test_snapshot_job_meta_matches_the_reference(tmp_path):
    """One snapshot of the same stores by each package: the same components
    with the same bytes, and the same manifest keys."""
    stores = []
    for pkg, st_cls in (("jax", JaxStore), ("port", EmbeddingStore)):
        st = st_cls(capacity=1 << 12, num_internal_shards=3, seed=7)
        st.lookup(np.arange(30, dtype=np.uint64), 8, True)
        stores.append(st)
    ms = [PKG[pkg].snapshot_job(PKG[pkg].JobStateManager(str(tmp_path / pkg)), 5, state_bytes=b"dense",
                                replicas=[st], batch_advances={0: 5}, components={"loader.json": {"c": 5}},
                                meta={"kind": "train_ctx"})
          for pkg, st in zip(("jax", "port"), stores)]
    a, b = (dict(m.meta) for m in ms)
    a.pop("datetime"), b.pop("datetime")
    ca, cb = a.pop("components"), b.pop("components")
    assert a == b and set(ca) == set(cb)
    for name in ca:
        if name != "rng.json":
            assert ms[0].read_blob(name) == ms[1].read_blob(name), name
