"""The port's sparse checkpoints (``persia_tpu_torch/checkpoint.py``), case
by case the reference's ``tests/test_checkpoint.py`` (markers, sessions, a
reused directory, re-sharding, crc trailers, torn and older files, the
status machine), each on both of the port's store backends; and checkpoint
directories moving between the packages: a dump by either loads in the
other with the same entries, re-sharding from 2 replicas to 3 included."""

import json
import os

import numpy as np
import pytest

import persia_tpu.checkpoint as jckpt
import persia_tpu.config as jcfg
from persia_tpu.data import IDTypeFeature as JaxIDTypeFeature
from persia_tpu.data import PersiaBatch as JaxPersiaBatch
from persia_tpu.embedding import optim as joptim
from persia_tpu.embedding.store import EmbeddingStore as JaxStore
from persia_tpu.embedding.worker import EmbeddingWorker as JaxWorker
import persia_tpu_torch.checkpoint as tckpt
import persia_tpu_torch.config as tcfg
from persia_tpu_torch.checkpoint import (
    DONE_MARKER,
    CorruptCheckpointError,
    ModelManagerStatus,
    checkpoint_info,
    dump_store,
    load_store,
)
from persia_tpu_torch.data import IDTypeFeature, PersiaBatch
from persia_tpu_torch.embedding import optim as toptim
from persia_tpu_torch.embedding.hashing import sign_to_shard
from persia_tpu_torch.embedding.native_store import create_store
from persia_tpu_torch.embedding.worker import EmbeddingWorker

BACKENDS = ["numpy", "native"]


@pytest.fixture(params=BACKENDS)
def backend(request):
    return request.param


def _store(backend, seed=7, shards=4):
    return create_store(backend, capacity=1 << 16, num_internal_shards=shards,
                        optimizer=toptim.Adagrad(lr=0.1).config, seed=seed)


def _jstore(seed=7, shards=4):
    return JaxStore(capacity=1 << 16, num_internal_shards=shards, optimizer=joptim.Adagrad(lr=0.1).config, seed=seed)


def _fill(store, n=200, dim=8):
    store.lookup(np.arange(n, dtype=np.uint64), dim, train=True)


def _shard_files(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".emb"))


def test_dump_load_roundtrip(tmp_path, backend):
    s = _store(backend)
    _fill(s)
    d = str(tmp_path / "ckpt")
    dump_store(s, d)
    assert os.path.exists(os.path.join(d, DONE_MARKER))
    assert checkpoint_info(d)["num_replicas"] == 1
    s2 = _store(backend, shards=6)  # another internal shard count still loads
    assert load_store(s2, d) == 200
    signs = np.arange(200, dtype=np.uint64)
    np.testing.assert_array_equal(s.lookup(signs, 8, False), s2.lookup(signs, 8, False))


def test_incomplete_dump_rejected(tmp_path, backend):
    d = str(tmp_path / "ckpt")
    s = _store(backend)
    _fill(s)
    dump_store(s, d)
    os.remove(os.path.join(d, DONE_MARKER))
    with pytest.raises(FileNotFoundError):
        load_store(_store(backend), d)


def test_stale_markers_cannot_complete_new_dump(tmp_path, backend):
    d = str(tmp_path / "ckpt")
    s0, s1 = _store(backend), _store(backend)
    _fill(s0, 100)
    _fill(s1, 100)
    dump_store(s0, d, replica_index=0, replica_size=2, session="old")
    dump_store(s1, d, replica_index=1, replica_size=2, session="old")
    assert os.path.exists(os.path.join(d, DONE_MARKER))
    dump_store(s0, d, replica_index=0, replica_size=2, session="new")
    assert not os.path.exists(os.path.join(d, DONE_MARKER))
    dump_store(s1, d, replica_index=1, replica_size=2, session="new")
    assert checkpoint_info(d)["session"] == "new"


def test_shrinking_internal_shards_removes_stale_files(tmp_path, backend):
    d = str(tmp_path / "ckpt")
    s = _store(backend, shards=8)
    _fill(s)
    dump_store(s, d)
    assert len(_shard_files(d)) == 8
    s_small = _store(backend, shards=3)
    _fill(s_small)
    dump_store(s_small, d)
    assert len(_shard_files(d)) == 3
    assert load_store(_store(backend), d) == 200


def _cfg(cfg):
    return cfg.EmbeddingConfig(slots_config={"a": cfg.SlotConfig(dim=8)})


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_replica_reshard_on_load(tmp_path, backend, writer):
    """A 2-replica dump (by either package) loaded into 3 replicas: each
    keeps the signs it owns, the union is exact, and every replica holds
    the reference's ``load_store`` entries."""
    signs = np.arange(300, dtype=np.uint64)
    d = str(tmp_path / "ckpt")
    if writer == "jax":
        w2 = JaxWorker(_cfg(jcfg), [_jstore(seed=1), _jstore(seed=1)])
        batch = JaxPersiaBatch([JaxIDTypeFeature("a", [signs])], requires_grad=False)
    else:
        w2 = EmbeddingWorker(_cfg(tcfg), [_store(backend, seed=1), _store(backend, seed=1)])
        batch = PersiaBatch([IDTypeFeature("a", [signs])], requires_grad=False)
    before = w2.forward_directly(batch, train=True)
    w2.dump(d)

    stores3 = [_store(backend, seed=1) for _ in range(3)]
    w3 = EmbeddingWorker(_cfg(tcfg), stores3)
    assert w3.load(d) == 300
    after = w3.forward_directly(PersiaBatch([IDTypeFeature("a", [signs])], requires_grad=False), train=False)
    np.testing.assert_array_equal(before[0].pooled, after[0].pooled)
    owners = sign_to_shard(signs, 3)
    refs = [_jstore(seed=1) for _ in range(3)]
    for r in range(3):
        assert stores3[r].size() == int((owners == r).sum())
        assert jckpt.load_store(refs[r], d, replica_index=r, replica_size=3) == stores3[r].size()
        for s in signs.tolist():
            a, b = stores3[r].get_embedding_entry(s), refs[r].get_embedding_entry(s)
            assert (a is None) == (b is None) == (owners[s] != r)
            if a is not None:
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_shard_files_move_between_the_packages(tmp_path, backend, direction):
    """A checkpoint dumped by one package loads in the other: the same
    entries, and the shard files are byte for byte the other's."""
    d, d2 = str(tmp_path / "ckpt"), str(tmp_path / "again")
    src = _jstore() if direction == "jax_to_port" else _store(backend)
    dst = _store(backend, shards=3) if direction == "jax_to_port" else _jstore(shards=3)
    _fill(src, 150)
    src.update_gradients(np.arange(150, dtype=np.uint64), np.full((150, 8), 0.5, np.float32))
    (jckpt if direction == "jax_to_port" else tckpt).dump_store(src, d, session="s")
    assert (tckpt if direction == "jax_to_port" else jckpt).load_store(dst, d) == 150
    for s in range(150):
        np.testing.assert_array_equal(dst.get_embedding_entry(s), src.get_embedding_entry(s))
    (tckpt if direction == "jax_to_port" else jckpt).dump_store(src, d2, session="s")
    for f in _shard_files(d):
        assert open(os.path.join(d, f), "rb").read() == open(os.path.join(d2, f), "rb").read()
    marker = json.load(open(os.path.join(d, "replica_0_done")))
    assert marker["num_internal_shards"] == 4 and marker["session"] == "s"


def test_crc_corrupt_shard_rejected(tmp_path, backend):
    d = str(tmp_path / "ckpt")
    s = _store(backend)
    _fill(s)
    dump_store(s, d)
    victim = os.path.join(d, _shard_files(d)[0])
    raw = bytearray(open(victim, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    with open(victim, "wb") as f:
        f.write(raw)
    with pytest.raises(CorruptCheckpointError):
        load_store(_store(backend), d)


def test_torn_shard_file_rejected(tmp_path, backend):
    d = str(tmp_path / "ckpt")
    s = _store(backend)
    _fill(s)
    dump_store(s, d)
    victim = os.path.join(d, _shard_files(d)[0])
    raw = open(victim, "rb").read()
    with open(victim, "wb") as f:
        f.write(raw[: len(raw) // 2])
    with pytest.raises(CorruptCheckpointError):
        load_store(_store(backend), d)


def test_legacy_trailerless_shards_still_load(tmp_path, backend):
    d = str(tmp_path / "ckpt")
    s = _store(backend)
    _fill(s, 120)
    dump_store(s, d)
    for fname in _shard_files(d):
        p = os.path.join(d, fname)
        raw = open(p, "rb").read()
        assert raw[-4:] == b"PCK1"
        with open(p, "wb") as f:
            f.write(raw[:-8])
    s2 = _store(backend)
    assert load_store(s2, d) == 120
    signs = np.arange(120, dtype=np.uint64)
    np.testing.assert_array_equal(s.lookup(signs, 8, False), s2.lookup(signs, 8, False))


def test_dump_leaves_no_temp_files(tmp_path, backend):
    d = str(tmp_path / "ckpt")
    s = _store(backend)
    _fill(s, 50)
    dump_store(s, d)
    assert not [f for f in os.listdir(d) if f.startswith(".tmp_")]


def test_status_machine(tmp_path, backend):
    st = ModelManagerStatus()
    assert st.get()["status"] == "idle"
    s = _store(backend)
    _fill(s, 50)
    dump_store(s, str(tmp_path / "c"), status=st)
    assert st.get() == {"status": "idle", "progress": 1.0, "error": None}
    with pytest.raises(FileNotFoundError):
        load_store(s, str(tmp_path / "missing"), status=st)
    assert st.get()["status"] == "failed"


def test_dense_blob_roundtrip(tmp_path):
    d = str(tmp_path / "ckpt")
    assert tckpt.load_dense(d, missing_ok=True) is None
    tckpt.dump_dense(b"dense bytes", d)
    assert tckpt.load_dense(d) == jckpt.load_dense(d) == b"dense bytes"
    with pytest.raises(FileNotFoundError):
        tckpt.load_dense(str(tmp_path / "other"))
