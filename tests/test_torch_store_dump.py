"""The port's numpy store (``persia_tpu_torch/embedding/store.py``), its
durable state against the reference's numpy store and the port's native
core:

- ``dump_shard`` bytes after the same lookup and update stream equal the
  reference numpy store's (SGD, Adagrad, Adam), and after a lookup stream
  (evicting) the port's native core's byte for byte. After updates the
  native core's floats differ within rtol 2e-5 (``-mfma`` contracts its
  multiply-adds, ``tests/test_torch_native_store.py``): there the two dumps
  hold the same entries in the same order with the same headers, and their
  floats agree to that tolerance;
- ``load_shard_bytes`` reads either package's dumps, routing by sign;
- the apply-journal: bounded, probe 1 / 0 / -1, cleared; and
  ``update_batched_journaled`` skips a duplicate, as the reference's does.
"""

import struct

import numpy as np
import pytest

import persia_tpu.config as jcfg
from persia_tpu.embedding import optim as joptim
from persia_tpu.embedding.store import EmbeddingStore as JaxStore
import persia_tpu_torch.config as tcfg
from persia_tpu_torch.embedding import native_store as ns
from persia_tpu_torch.embedding import optim as toptim
from persia_tpu_torch.embedding.store import EmbeddingStore

FLOAT_TOL = dict(rtol=2e-5, atol=1e-6)
OPTS = {
    "sgd": lambda m: m.SGD(lr=0.05, weight_decay=0.01),
    "adagrad": lambda m: m.Adagrad(lr=0.1, initialization=0.02),
    "adam": lambda m: m.Adam(lr=0.01),
}


def _stores(opt, capacity=96, shards=4):
    """(port numpy, reference numpy, port native) on one configuration."""
    kw = dict(capacity=capacity, num_internal_shards=shards, seed=9)
    return (
        EmbeddingStore(optimizer=OPTS[opt](toptim).config, hyperparams=tcfg.HyperParameters(), **kw),
        JaxStore(optimizer=OPTS[opt](joptim).config, hyperparams=jcfg.HyperParameters(), **kw),
        ns.NativeEmbeddingStore(optimizer=OPTS[opt](toptim).config, **kw),
    )


def _stream(stores, steps, update=True, seed=4):
    rng = np.random.default_rng(seed)
    for step in range(steps):
        signs = rng.integers(0, 160, size=48, dtype=np.uint64)
        upd = np.concatenate([signs, rng.integers(160, 320, size=4, dtype=np.uint64)])
        g = rng.normal(size=(len(upd), 8)).astype(np.float32)
        for st in stores:
            st.lookup(signs, 8, train=True)
            if update:
                st.advance_batch_state(step % 2)
                st.update_gradients(upd, g, step % 2)


def _entries(blob):
    """[(sign, dim, len, floats)] of a dump, in its order."""
    (n,) = struct.unpack_from("<I", blob, 0)
    off, out = 4, []
    for _ in range(n):
        sign, dim, ln = struct.unpack_from("<QII", blob, off)
        out.append((sign, dim, ln, np.frombuffer(blob, np.float32, ln, off + 16)))
        off += 16 + 4 * ln
    assert off == len(blob)
    return out


@pytest.mark.parametrize("opt", list(OPTS))
def test_dump_equals_the_reference_numpy_store(opt):
    port, ref, _ = _stores(opt)
    _stream((port, ref), 12)
    assert port.size() == ref.size() == 96
    assert port.num_internal_shards == ref.num_internal_shards == 4
    for i in range(4):
        assert port.dump_shard(i) == ref.dump_shard(i), i


@pytest.mark.parametrize("opt", list(OPTS))
def test_dump_equals_the_native_core(opt):
    port, _, native = _stores(opt)
    _stream((port, native), 8, update=False)
    for i in range(4):
        assert port.dump_shard(i) == native.dump_shard(i), i
    _stream((port, native), 8, seed=5)
    for i in range(4):
        a, b = _entries(port.dump_shard(i)), _entries(native.dump_shard(i))
        assert [e[:3] for e in a] == [e[:3] for e in b]
        for (_, _, _, x), (_, _, _, y) in zip(a, b):
            np.testing.assert_allclose(x, y, **FLOAT_TOL)


@pytest.mark.parametrize("source", ["reference_numpy", "port_native"])
def test_load_reads_either_packages_dumps(source):
    """Dumps of 4 shards load into a 3-shard store: every entry, routed by
    sign; the reloaded store dumps the source's entries."""
    port, ref, native = _stores("adam")
    src = {"reference_numpy": ref, "port_native": native}[source]
    _stream((src,), 6)
    dst = EmbeddingStore(optimizer=OPTS["adam"](toptim).config, capacity=1 << 12, num_internal_shards=3, seed=9)
    assert sum(dst.load_shard_bytes(src.dump_shard(i)) for i in range(4)) == src.size() == dst.size()
    for s in range(320):
        a, b = dst.get_embedding_entry(s), src.get_embedding_entry(s)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        dst.load_shard_bytes(src.dump_shard(0)[:-2])


def test_journal_bounded_and_cleared():
    """The reference's ``test_store_journal_bounded_and_cleared`` on both
    numpy stores, whose journals then hold the same ids and crcs."""
    stores = [EmbeddingStore(capacity=1 << 10, num_internal_shards=2, optimizer=toptim.Adagrad(lr=0.1).config),
              JaxStore(capacity=1 << 10, num_internal_shards=2, optimizer=joptim.Adagrad(lr=0.1).config)]
    for s in stores:
        s._journal_cap = 8
        for i in range(20):
            s.journal_record(i, i * 3)
        s.journal_record(15, 7)
        assert s.journal_len() == 8
        assert [s.journal_probe(19, 57), s.journal_probe(0, 0), s.journal_probe(19, 5)] == [1, 0, -1]
    assert list(stores[0]._journal.items()) == [(i, stores[1]._journal[i]) for i in stores[1]._journal_order]
    for s in stores:
        s.journal_clear()
        assert s.journal_len() == 0


def test_update_batched_journaled_skips_a_duplicate():
    port, ref, _ = _stores("adagrad", capacity=1 << 12)
    signs = np.arange(40, dtype=np.uint64)
    key_ofs, dims, ogs = np.array([0, 40]), np.array([8], np.uint32), np.array([0], np.int32)
    grads = np.random.default_rng(0).normal(size=320).astype(np.float32)
    for st in (port, ref):
        st.lookup(signs, 8, train=True)
        assert st.update_batched_journaled(5, 11, signs, key_ofs, dims, grads, ogs) is True
        assert st.update_batched_journaled(5, 11, signs, key_ofs, dims, grads, ogs) is False
        assert st.update_batched_journaled(5, 12, signs, key_ofs, dims, grads, ogs) is False
    for i in range(4):
        assert port.dump_shard(i) == ref.dump_shard(i)
    port.clear()
    assert port.size() == 0 and port.journal_len() == 1  # clear keeps the journal
