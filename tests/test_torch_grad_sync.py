"""The port's dense-sync primitives (``persia_tpu_torch/parallel/
grad_sync.py``, ``mesh.py``, ``distributed.py``, the plain versions of the
kernels K16, K17 and K15 at a shared scale in ``ops``) against the
reference's ``persia_tpu/parallel/grad_sync.py`` on the CPU:

- ``block_quantize_int8``'s codes and scales bit for bit the reference's on
  the same f32 input (blocks of several sizes, an all-zero block, large and
  tiny magnitudes), with and without the ring's error feedback; its error
  and ``block_dequantize_int8`` within 2 ulps of the reference's ``v -
  deq`` / dequantized values (XLA's CPU code multiplies by a rounded
  1/127 where the port divides by 127); the dequantize's accumulate and
  roll as the ring composes them;
- the ring hop's fold (``block_requantize_int8``) bit for bit
  ``block_dequantize_int8``'s plain version then ``block_quantize_int8``'s,
  the sum written back only with ``write_acc``; the folded ring (and the
  sharded ring's reduce-scatter) bit for bit the unfolded one of K16 and
  K17 alone, on n ranks of threads in one process, with the launches a
  rank ``grad_sync``'s docstring gives;
- K15 at a shared scale (``segment_absmax``, ``quantize_int8_ef_shared``):
  the scales ``max(max |g + r|, 1e-30)`` bit for bit, the codes bit for
  bit the reference's ``quantize_int8_ef(g, r, scale=...)`` a leaf at a
  time, as int32 (the reference's codes cast as its bytegrad casts
  them), the residual within 4 ulps of |v| (as the int8 wire's test
  holds it); ``bytegrad_allreduce`` on n ranks of threads bit for bit the
  path that cast int8 codes and made its lengths each call;
- the flat vector in the reference's ``ravel_pytree`` order bit for bit;
  ``_flat_chunk``, ``dense_param_count``, ``dense_sync_wire_bytes`` and
  ``sync_mode_algorithm`` equal to the reference's;
- the ring at n ranks against the reference's ring under ``shard_map`` on
  n CPU devices (the port's ranks spawned over gloo): every rank's sum the
  same bits, within 2 ulps of the reference's largest magnitude, the
  ``ef`` rows within 1e-6;
- the mesh and the process-group setup at one process; ``TrainCtx``'s
  refusals and ``sync_mode`` labels.
"""

import queue
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree
from jax.sharding import PartitionSpec as P

from persia_tpu.parallel import data_parallel_mesh as jax_mesh
from persia_tpu.parallel import grad_sync as jgs
from persia_tpu.parallel.mesh import shard_map_compat
from persia_tpu_torch import distributed as tdist
from persia_tpu_torch.ctx import TrainCtx
from persia_tpu_torch.embedding import optim as toptim
from persia_tpu_torch.embedding.store import EmbeddingStore
from persia_tpu_torch.embedding.worker import EmbeddingWorker
from persia_tpu_torch.ops.block_int8 import (
    block_dequantize_int8,
    block_dequantize_int8_reference,
    block_quantize_int8,
    block_quantize_int8_reference,
    block_requantize_int8,
)
from persia_tpu_torch.ops.quantize_int8 import (
    quantize_int8_ef_reference,
    quantize_int8_ef_shared,
    segment_absmax,
)
from persia_tpu_torch.parallel import grad_sync as tgs
from persia_tpu_torch.parallel.mesh import data_parallel_mesh
from persia_tpu_torch.testing import dense_sync as tds

ULP = 2.0 ** -23


def _vector(seed, blocks, bs, zero_block=True):
    rng = np.random.default_rng(seed)
    mags = 10.0 ** rng.integers(-20, 6, blocks)
    v = (rng.normal(size=blocks * bs) * np.repeat(mags, bs)).astype(np.float32)
    if zero_block:
        v[:bs] = 0.0
    return v


@pytest.mark.parametrize("feedback", [False, True])
@pytest.mark.parametrize("bs", [1, 16, 100, 256, 2048])
def test_block_quantize_matches_reference(bs, feedback):
    """Codes and scales bit for bit, the error within 2 ulps of |x|."""
    blocks = max(2, 2048 // bs)
    v = _vector(bs, blocks, bs)
    ef = (_vector(bs + 1, blocks, bs, zero_block=False) * np.float32(1e-3)).astype(np.float32)
    x = v + ef if feedback else v
    jq, js, jdeq = jgs.block_quantize_int8(jnp.asarray(x), bs)
    q, s, err = block_quantize_int8(torch.from_numpy(v), bs, ef=torch.from_numpy(ef) if feedback else None)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    want = x - np.asarray(jdeq)
    np.testing.assert_array_less(np.abs(err.numpy() - want), 2 * ULP * np.abs(x) + 1e-45)
    if not feedback:  # the all-zero block
        assert (s.numpy()[0] == np.float32(1e-30)) and (q.numpy()[:bs] == 0).all()
    # the error is what the codes lost: |err| <= half a step of the block
    step = np.repeat(s.numpy(), bs) / 127.0
    assert (np.abs(err.numpy()) <= step / 2 * (1 + 1e-5) + 1e-45).all()


def test_block_quantize_writes_the_callers_error_row():
    v = torch.from_numpy(_vector(3, 4, 64))
    err = torch.full((256,), 7.0)
    q, s, e = block_quantize_int8(v, 64, err=err)
    assert e is err
    torch.testing.assert_close(err, block_quantize_int8_reference(v, 64)[2], rtol=0, atol=0)
    with pytest.raises(ValueError, match="multiple"):
        block_quantize_int8(v[:100], 64)
    with pytest.raises(ValueError, match="ef"):
        block_quantize_int8(v, 64, ef=torch.zeros(3))


@pytest.mark.parametrize("n,roll", [(1, 0), (2, 1), (4, 1), (4, 3)])
def test_block_dequantize_matches_reference(n, roll):
    """``q * (scale / 127)`` within an ulp of the reference's (XLA's
    rounded 1/127), rows rolled into chunk order as its all-gather's, and
    the hop's ``(base + ef) + deq``."""
    bs, chunk = 32, 128
    v = _vector(n * 10 + roll, n * chunk // bs, bs)
    q, s, _ = block_quantize_int8(torch.from_numpy(v), bs)
    want_rows = np.asarray(jgs.block_dequantize_int8(jnp.asarray(q.numpy()), jnp.asarray(s.numpy()), bs))
    want = np.roll(want_rows.reshape(n, chunk), roll, axis=0).reshape(-1)
    got = block_dequantize_int8(q, s, bs, n=n, roll=roll)
    np.testing.assert_array_less(np.abs(got.numpy() - want), ULP * np.abs(want) + 1e-45)
    assert torch.equal(got, block_dequantize_int8_reference(q, s, bs, n, roll))
    base = torch.from_numpy(_vector(5, n * chunk // bs, bs, zero_block=False))
    ef = base * 1e-3
    acc = base.clone()
    out = block_dequantize_int8(q, s, bs, n=n, roll=roll, base=acc, ef=ef, out=acc)
    assert out is acc
    torch.testing.assert_close(acc, (base + ef) + got, rtol=0, atol=0)
    with pytest.raises(ValueError, match="roll"):
        block_dequantize_int8(q, s, bs, n=n, roll=n)


def _bits_equal(a, b):
    return a.dtype == b.dtype and torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


@pytest.mark.parametrize("feedback", [False, True])
@pytest.mark.parametrize("bs", [16, 256])
def test_block_requantize_is_dequantize_then_quantize(bs, feedback):
    """The fused hop: codes, scales and errors bit for bit K17's plain
    version (``(base + ef) + deq``) then K16's (no feedback); ``base`` left
    as it was without ``write_acc``."""
    blocks = 4096 // bs
    q_in, sc_in, _ = block_quantize_int8(torch.from_numpy(_vector(bs + 2, blocks, bs)), bs)
    base = torch.from_numpy(_vector(bs + 3, blocks, bs, zero_block=False))
    ef = base * 1e-3 if feedback else None
    before = base.clone()
    q, s, err = block_requantize_int8(q_in, sc_in, base, ef, bs)
    x = block_dequantize_int8_reference(q_in, sc_in, bs, base=before, ef=ef)
    q2, s2, e2 = block_quantize_int8_reference(x, bs)
    assert _bits_equal(q, q2) and _bits_equal(s, s2) and _bits_equal(err, e2)
    assert _bits_equal(base, before)


def test_block_requantize_writes_the_sum_and_the_callers_error_row():
    """With ``write_acc`` the sum lands in ``base``, the error in the
    caller's row; shapes it cannot take raise."""
    bs = 64
    q_in, sc_in, _ = block_quantize_int8(torch.from_numpy(_vector(5, 8, bs)), bs)
    base = torch.from_numpy(_vector(6, 8, bs, zero_block=False))
    ef = base * 1e-3
    x = block_dequantize_int8_reference(q_in, sc_in, bs, base=base, ef=ef)
    err = torch.full((8 * bs,), 7.0)
    q, s, e = block_requantize_int8(q_in, sc_in, base, ef, bs, err=err, write_acc=True)
    assert e is err and _bits_equal(base, x) and _bits_equal(err, block_quantize_int8_reference(x, bs)[2])
    with pytest.raises(ValueError, match="q_in"):
        block_requantize_int8(q_in[:bs], sc_in, base, None, bs)
    with pytest.raises(ValueError, match="sc_in"):
        block_requantize_int8(q_in, sc_in[:2], base, None, bs)
    with pytest.raises(ValueError, match="multiple"):
        block_requantize_int8(q_in[:100], sc_in, base[:100], None, bs)


class _ThreadMesh:
    """n ranks as threads of one process: the ring's exchange through a
    queue a rank (one sender each, so in order), the all-gather through a
    slot a rank between two barriers (no rank writes the next gather's
    slot before every rank has read this one's); every wait bounded."""

    WAIT = 30.0

    def __init__(self, n):
        self.size = n
        self.inbox = [queue.Queue() for _ in range(n)]
        self.slots = [None] * n
        self.barrier = threading.Barrier(n, timeout=self.WAIT)

    def rank_view(self, rank):
        mesh = self

        class _Rank:
            size, backend = mesh.size, "threads"

            def ring_exchange(self, tensors):
                mesh.inbox[(rank + 1) % mesh.size].put([t.clone() for t in tensors])
                return mesh.inbox[rank].get(timeout=mesh.WAIT)

            def all_gather(self, t):
                mesh.slots[rank] = t.clone()
                mesh.barrier.wait()
                rows = torch.stack(mesh.slots)
                mesh.barrier.wait()
                return rows

            def all_reduce(self, t, op="sum"):
                rows = self.all_gather(t)
                return t.copy_(rows.sum(0) if op == "sum" else rows.amax(0))

        view = _Rank()
        view.rank = rank
        return view


def _unfolded_ring(acc, mesh, bs, ef, err, sharded):
    """The ring of K16 and K17 alone, a launch each a hop: hop s quantizes
    chunk (me - s) % n (``ef`` at hop 0), sends it and accumulates chunk
    (me - s - 1) % n; the all-gather quantizes the owned chunk again."""
    n, me = mesh.size, mesh.rank
    A, F = acc.view(n, -1), ef.view(n, -1)
    for s in range(n - 1):
        si = (me - s) % n
        q, sc, err[si] = block_quantize_int8_reference(A[si], bs, F[si] if s == 0 else None)
        q_in, sc_in = mesh.ring_exchange([q, sc])
        ri = (me - s - 1) % n
        A[ri] = block_dequantize_int8_reference(q_in, sc_in, bs, base=A[ri], ef=F[ri])
    own = (me + 1) % n
    if sharded:
        return A[own]
    q, sc, err[own] = block_quantize_int8_reference(A[own], bs, F[own] if n == 1 else None)
    return block_dequantize_int8_reference(mesh.all_gather(q).reshape(-1), mesh.all_gather(sc).reshape(-1), bs,
                                           n, 1 % n)


@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_folded_ring_is_the_unfolded_ring_bit_for_bit(monkeypatch, n, sharded):
    """The ring with each hop's accumulate folded into the next quantize
    (and the last hop's into the all-gather's) against the ring of K16 and
    K17 alone, on n ranks of threads: every rank's sum (the sharded ring:
    its owned chunk's) and error rows the same bits; a rank's launches
    those ``grad_sync``'s docstring gives (n + 1 at n >= 2, 2 at n = 1; the
    sharded ring n, none at n = 1)."""
    bs, p = 16, 200
    chunk, p_pad = tgs._flat_chunk(p, n, bs)
    rng = np.random.default_rng(40 + n)
    grads = rng.normal(size=(n, p_pad)).astype(np.float32)
    grads[:, p:] = 0
    efs = (rng.normal(size=(n, p_pad)) * 1e-3).astype(np.float32)
    calls = {"block_quantize_int8": 0, "block_requantize_int8": 0, "block_dequantize_int8": 0}
    lock = threading.Lock()
    for name in calls:
        def counted(*a, _fn=getattr(tgs, name), _name=name, **kw):
            with lock:
                calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(tgs, name, counted)
    folded_mesh, unfolded_mesh = _ThreadMesh(n), _ThreadMesh(n)
    out = [None] * n

    def rank_main(r):
        acc, ef = torch.from_numpy(grads[r].copy()), torch.from_numpy(efs[r].copy())
        err = torch.zeros(n, chunk)
        if sharded:
            got, _own = tgs.ring_reduce_scatter_block_int8(acc.clone(), folded_mesh.rank_view(r), bs, ef, err)
        else:
            got, _new_ef = tgs._block_ring_allreduce_flat(acc.clone(), ef, tgs.BlockInt8Ring(block_size=bs),
                                                          folded_mesh.rank_view(r))
        want_err = torch.zeros(n, chunk)
        want = _unfolded_ring(acc.clone(), unfolded_mesh.rank_view(r), bs, ef, want_err, sharded)
        out[r] = (got, err if sharded else _new_ef.view(n, chunk), want, want_err)

    threads = [threading.Thread(target=rank_main, args=(r,), daemon=True) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads) and all(o is not None for o in out)
    for got, err, want, want_err in out:
        assert _bits_equal(got, want) and _bits_equal(err, want_err)
    want_calls = ({"block_quantize_int8": int(n > 1), "block_requantize_int8": max(0, n - 2),
                   "block_dequantize_int8": int(n > 1)} if sharded else
                  {"block_quantize_int8": 1, "block_requantize_int8": n - 1, "block_dequantize_int8": 1})
    assert {k: v // n for k, v in calls.items()} == want_calls and all(v % n == 0 for v in calls.values())


def test_shared_scale_quantize_matches_reference():
    """Each leaf's scale ``max(max |g + r|, 1e-30)``; the codes at a shared
    scale (here 1.5x a leaf's own, and one leaf all zeros) bit for bit the
    reference's ``quantize_int8_ef(g, r, scale=...)``; the residual within 4
    ulps of |v|."""
    offsets = [0, 1, 33, 33, 500, 2000, 2001]
    rng = np.random.default_rng(0)
    g = (rng.normal(size=offsets[-1]) * 10.0 ** rng.integers(-3, 3, offsets[-1])).astype(np.float32)
    g[1:33] = 0
    r = (rng.normal(size=offsets[-1]) * 1e-4).astype(np.float32)
    r[1:33] = 0
    scale = segment_absmax(torch.from_numpy(g), torch.from_numpy(r), offsets)
    for s, (a, b) in enumerate(zip(offsets[:-1], offsets[1:])):
        want = max(np.abs(g[a:b] + r[a:b]).max(), np.float32(1e-30)) if b > a else np.float32(1e-30)
        assert scale[s].item() == want
    shared = scale * 1.5
    q, scales, res = quantize_int8_ef_shared(torch.from_numpy(g), torch.from_numpy(r.copy()), offsets, shared)
    # the codes as int32 (the sum's dtype): the reference's int8 codes cast
    # as its bytegrad casts them
    assert q.dtype == torch.int32
    for s, (a, b) in enumerate(zip(offsets[:-1], offsets[1:])):
        if b == a:
            continue
        jq, js, _, jr = jgs.quantize_int8_ef(jnp.asarray(g[a:b]), jnp.asarray(r[a:b]),
                                            scale=jnp.maximum(jnp.float32(shared[s].item()), 1e-30))
        np.testing.assert_array_equal(q[a:b].numpy(), np.asarray(jq.astype(jnp.int32)))
        assert scales[s].item() == float(js)
        v = g[a:b] + r[a:b]
        np.testing.assert_array_less(np.abs(res[a:b].numpy() - np.asarray(jr)), 4 * ULP * np.abs(v) + 1e-45)
    # the plain version's int8 codes widened; scales and residual the same bits
    ref_q, ref_s, ref_r = quantize_int8_ef_reference(torch.from_numpy(g), torch.from_numpy(r.copy()), offsets,
                                                     scale=shared)
    assert torch.equal(q, ref_q.to(torch.int32)) and torch.equal(scales, ref_s) and _bits_equal(res, ref_r)
    with pytest.raises(ValueError, match="scale"):
        quantize_int8_ef_shared(torch.from_numpy(g), torch.from_numpy(r), offsets, shared[:2])


def _bytegrad_before(flat, residual, offsets, mesh):
    """bytegrad_allreduce as it was before its codes came as int32: the
    int8 codes (the plain version's) cast for the sum, the lengths made
    each call, no output_size."""
    scale = mesh.all_reduce(segment_absmax(flat, residual, offsets), "max")
    q, _scales, new_res = quantize_int8_ef_reference(flat, residual, offsets, scale=scale)
    summed = mesh.all_reduce(q.to(torch.int32))
    lengths = torch.tensor(np.diff(offsets))
    step = torch.repeat_interleave(scale / torch.full((), 127.0), lengths)
    return tgs._div(summed.float() * step, mesh.size), new_res


@pytest.mark.parametrize("n", [1, 3])
def test_bytegrad_sums_int32_codes_with_lengths_made_once(monkeypatch, n):
    """``bytegrad_allreduce`` on n ranks of threads, with the lengths made
    once (as ``build_sync_train_step`` makes them) and passed to every call
    (two steps): each rank's mean and new residual bit for bit the path that
    cast int8 codes to int32 and made the lengths every call; it sums the
    int32 codes the quantize returns and gives ``repeat_interleave`` its
    ``output_size``."""
    offsets = [0, 1, 33, 33, 500, 2000, 2001]
    rng = np.random.default_rng(7)
    gs = [(rng.normal(size=offsets[-1]) * 10.0 ** rng.integers(-3, 3, offsets[-1])).astype(np.float32)
          for _ in range(n)]
    rs = [(rng.normal(size=offsets[-1]) * 1e-4).astype(np.float32) for _ in range(n)]
    calls = {"codes": [], "output_size": []}
    shared, repeat = tgs.quantize_int8_ef_shared, torch.repeat_interleave

    def spy_shared(*args, **kw):
        out = shared(*args, **kw)
        calls["codes"].append(out[0].dtype)
        return out

    def spy_repeat(*args, **kw):
        calls["output_size"].append(kw.get("output_size"))
        return repeat(*args, **kw)

    def run(fn, **kw):
        mesh = _ThreadMesh(n)
        out = [None] * n

        def rank(i):
            out[i] = fn(torch.from_numpy(gs[i]), torch.from_numpy(rs[i].copy()), offsets, mesh.rank_view(i), **kw)

        threads = [threading.Thread(target=rank, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert all(o is not None for o in out)
        return out

    want = run(_bytegrad_before)
    monkeypatch.setattr(tgs, "quantize_int8_ef_shared", spy_shared)
    monkeypatch.setattr(torch, "repeat_interleave", spy_repeat)
    lengths = torch.tensor(np.diff(offsets))
    for _ in range(2):
        got = run(tgs.bytegrad_allreduce, lengths=lengths)
        for (mean, res), (mean0, res0) in zip(got, want):
            assert _bits_equal(mean, mean0) and _bits_equal(res, res0)
    assert calls["codes"] == [torch.int32] * (2 * n) and calls["output_size"] == [offsets[-1]] * (2 * n)


def test_flat_vector_and_geometry_match_reference():
    """The flat parameters in ``ravel_pytree``'s order bit for bit; the
    ring's geometry, the parameter count, the wire model and the mode
    table the reference's."""
    model, params = tds.model_and_params(dict(tds.SPEC, top=(32, 16), bottom=(16, 8)))
    want = np.asarray(ravel_pytree(jax.tree.map(jnp.asarray, params))[0])
    got = tgs.ravel(tgs.dense_leaves(model), lambda p: p.detach()).numpy()
    np.testing.assert_array_equal(got, want)
    leaves = tgs.dense_leaves(model)
    back = torch.zeros_like(torch.from_numpy(got)) + torch.from_numpy(got) * 2
    tgs.unravel_into(back, leaves, lambda p: p.data)
    np.testing.assert_array_equal(tgs.ravel(leaves, lambda p: p.detach()).numpy(), want * 2)
    p_count = tgs.dense_param_count(model)
    assert p_count == jgs.dense_param_count(jax.tree.map(jnp.asarray, params)) == want.size
    for n in (1, 2, 3, 4, 8):
        for bs in (1, 16, 256):
            assert tgs._flat_chunk(p_count, n, bs) == jgs._flat_chunk(p_count, n, bs)
        for mode in tgs.DENSE_SYNC_MODES + ("implicit-psum", "local"):
            for bs in (64, 256):
                assert tgs.dense_sync_wire_bytes(mode, p_count, n, bs) == jgs.dense_sync_wire_bytes(mode, p_count, n,
                                                                                                     bs)
    assert tgs.DENSE_SYNC_MODES == jgs.DENSE_SYNC_MODES
    for mode in tgs.DENSE_SYNC_MODES:
        (a, sa), (b, sb) = tgs.sync_mode_algorithm(mode, 64), jgs.sync_mode_algorithm(mode, 64)
        assert type(a).__name__ == type(b).__name__ and sa == sb and vars(a) == vars(b)
    with pytest.raises(ValueError, match="unknown dense sync mode"):
        tgs.sync_mode_algorithm("int4")
    with pytest.raises(ValueError, match="block_size"):
        tgs.BlockInt8Ring(block_size=0)


# --------------------------------------------------- the ring across ranks


@pytest.mark.parametrize("n", [1, 2, 4])
def test_ring_allreduce_matches_reference(n):
    """``_block_ring_allreduce_flat`` on n gloo ranks against the reference
    under ``shard_map`` on n CPU devices, from the same per-rank vectors and
    residuals: every rank's sum the same bits, within 2 ulps of the
    reference's largest magnitude; each rank's new ``ef`` within 1e-6 of
    the reference's row (the sum's rounding order differs, the codes do
    not)."""
    bs, p = 16, 200
    chunk, p_pad = jgs._flat_chunk(p, n, bs)
    rng = np.random.default_rng(n)
    per_dev = np.zeros((n, p_pad), np.float32)
    per_dev[:, :p] = rng.normal(size=(n, p)).astype(np.float32)
    ef = (rng.normal(size=(n, p_pad)) * 1e-3).astype(np.float32)
    algo = jgs.BlockInt8Ring(block_size=bs)

    def f(x, e):
        s, new_ef = jgs._block_ring_allreduce_flat(x[0][:p], e[0], algo, n)
        return s, new_ef[None]

    mesh = jax_mesh(n)
    want_sum, want_ef = jax.jit(shard_map_compat(f, mesh=mesh, in_specs=(P("data"), P("data")),
                                                 out_specs=(P(), P("data")), check_vma=False))(
        jnp.asarray(per_dev), jnp.asarray(ef))
    want_sum, want_ef = np.asarray(want_sum), np.asarray(want_ef)
    got = tds.run_function(n, tds.ring_allreduce_rank, bs, per_dev, ef, timeout=120)
    for r, (s, e) in enumerate(got):
        np.testing.assert_array_equal(s, got[0][0])
        np.testing.assert_allclose(s, want_sum, rtol=0, atol=2 * ULP * np.abs(want_sum).max())
        np.testing.assert_allclose(e, want_ef[r], rtol=0, atol=1e-6)


# ------------------------------------------------ the mesh and the setup


def test_single_process_mesh_and_setup(monkeypatch):
    """No process group: a mesh of one rank whose collectives move nothing;
    ``initialize_process_group`` runs as a single process without a world
    and raises for a world without an address; ``DistributedOption``
    refuses ep and sp above 1."""
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert tdist.initialize_process_group() is False and tdist.process_counts() == (0, 1)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        tdist.initialize_process_group()
    mesh = data_parallel_mesh()
    assert (mesh.size, mesh.rank, mesh.group, mesh.backend) == (1, 0, None, "local")
    assert mesh.rows(32) == (0, 32)
    t = torch.arange(4.0)
    assert mesh.all_reduce(t) is t and mesh.all_gather(t).shape == (1, 4)
    with pytest.raises(ValueError, match="process group"):
        data_parallel_mesh(2)
    assert tdist.DistributedOption(dp=4).total() == 4
    for kw in (dict(ep=2), dict(sp=2)):
        with pytest.raises(NotImplementedError):
            tdist.DistributedOption(**kw)


def _ctx(**kw):
    model, _ = tds.model_and_params(tds.SPEC)
    cfg = tds.embedding_config(tds.SPEC)
    worker = EmbeddingWorker(cfg, [EmbeddingStore(capacity=1 << 12, optimizer=toptim.Adagrad(lr=0.1).config)])
    return TrainCtx(model, torch.optim.Adam(model.parameters(), lr=1e-3), toptim.Adagrad(lr=0.1), worker, cfg,
                    device="cpu", **kw)


def test_train_ctx_refusals_and_labels():
    """``dense_sync`` without a mesh, with the dynamic loss scale, or of an
    unknown mode raises, as the reference's; ``sync_mode`` is "local"
    without a mesh or at one rank, else the mode; the wire bytes are 0 at
    one rank; the sharded update over another optimizer raises."""
    with pytest.raises(ValueError, match="mesh"):
        _ctx(dense_sync="f32")
    with pytest.raises(ValueError, match="mutually"):
        _ctx(mesh=data_parallel_mesh(), dense_sync="f32", dynamic_loss_scale=True)
    with pytest.raises(ValueError, match="unknown dense sync mode"):
        _ctx(mesh=data_parallel_mesh(), dense_sync="fp4")
    assert _ctx().sync_mode == _ctx(mesh=data_parallel_mesh()).sync_mode == "local"
    ctx = _ctx(mesh=data_parallel_mesh(), dense_sync="block-int8-ring")
    ctx.init_state()
    assert ctx.sync_mode == "block-int8-ring" and ctx.dense_wire_bytes_per_step() == 0
    assert ctx.state.sync.ef.shape == (ctx.state.sync.p_pad,) and ctx.state.sync.p_pad % 256 == 0
    model, _ = tds.model_and_params(tds.SPEC)
    with pytest.raises(ValueError, match="Adam"):
        tgs.init_sync_opt_state(model, torch.optim.SGD(model.parameters(), lr=0.1), data_parallel_mesh(),
                                tgs.GradientAllReduce(), sharded_update=True)
    with pytest.raises(ValueError, match="sharded_update"):
        tgs.build_sync_train_step(model, torch.optim.Adam(model.parameters()), data_parallel_mesh(),
                                  tgs.ByteGradAllReduce(), sharded_update=True)
    with pytest.raises(ValueError, match="worker"):
        TrainCtx(model, torch.optim.Adam(model.parameters()), toptim.Adagrad(lr=0.1), None,
                 tds.embedding_config(tds.SPEC), device="cpu")


def test_sharded_state_round_trips_through_flax_bytes():
    """At one rank the sharded ring's state (Adam over the flat chunk, the
    ``ef`` row) writes the reference's wrapper ((1, chunk) moments, (1,
    Ppad) ``ef``, the count) and loads back into a fresh ctx bit for bit."""
    from persia_tpu_torch.serialization import msgpack_restore
    from persia_tpu_torch.weights import train_state_from_flax_bytes, train_state_to_flax_bytes

    a = _ctx(mesh=data_parallel_mesh(), dense_sync="block-int8-ring-sharded").__enter__()
    a.init_state()
    for b in tds.batches(tds.SPEC, 2, 9):
        a.train_step(b)
    raw = train_state_to_flax_bytes(a.state)
    tree = msgpack_restore(raw)["opt_state"]
    st = a.state.sync
    assert np.asarray(tree["opt"]["0"]["mu"]).shape == (1, st.chunk) and np.asarray(tree["ef"]).shape == (1, st.p_pad)
    assert int(np.asarray(tree["opt"]["0"]["count"])) == 2 and np.abs(np.asarray(tree["opt"]["0"]["nu"])).max() > 0
    b = _ctx(mesh=data_parallel_mesh(), dense_sync="block-int8-ring-sharded").__enter__()
    b.init_state()
    train_state_from_flax_bytes(b.state, raw)
    assert train_state_to_flax_bytes(b.state) == raw


def test_sharded_update_is_adam_elementwise():
    """The sharded update's Adam over a chunk of the flat parameters is the
    ctx's Adam elementwise: at one rank ``f32-sharded`` and ``f32`` train
    the same bits."""
    batches = tds.batches(tds.SPEC, 3, 9)
    outs = []
    for mode in ("f32", "f32-sharded"):
        ctx = _ctx(mesh=data_parallel_mesh(), dense_sync=mode).__enter__()
        ctx.init_state()
        losses = [ctx.train_step(b)["loss"] for b in batches]
        outs.append((losses, tgs.ravel(tgs.dense_leaves(ctx.model), lambda p: p.detach()).numpy()))
    assert outs[0][0] == outs[1][0]
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
