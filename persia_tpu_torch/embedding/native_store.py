"""ctypes bindings of the port's native parameter-server core
(``persia_tpu_torch/native/ps.cpp``; counterpart of
``persia_tpu/embedding/native_store.py``).

``NativeEmbeddingStore`` has the surface of the numpy
``persia_tpu_torch.embedding.store.EmbeddingStore``, which stays the golden
model: the same entries, evictions and grad misses, and floats within rtol
2e-5 of it (``-mfma`` contracts the update's multiply-adds).
``create_store(backend="auto")`` prefers the native core and falls back to
numpy where ``g++`` cannot build it; ``"native"`` requires it. A ``ctypes``
call releases the GIL, so the loader's threads run lookups and updates
side by side; the core locks per internal shard.
"""

from __future__ import annotations

import ctypes
import logging
import threading
from typing import Optional

import numpy as np

from persia_tpu_torch.config import HyperParameters
from persia_tpu_torch.embedding._native_build import NATIVE_SRC, build_so, cxx_flags
from persia_tpu_torch.embedding.optim import OptimizerConfig
from persia_tpu_torch.embedding.store import EmbeddingStore

logger = logging.getLogger("persia_tpu_torch.native")

# ps_set_init_method's codes (the reference's INIT_KIND_CODES)
INIT_KIND_CODES = {"uniform": 0, "gamma": 1, "poisson": 2, "normal": 3, "inverse_sqrt": 4}

_LIB: Optional[ctypes.CDLL] = None
_LOAD_LOCK = threading.Lock()


def build_native():
    """Compile the PS core unless built (see ``_native_build.build_so``)."""
    return build_so([NATIVE_SRC / "ps.cpp"], "libpersia_torch_ps.so", cxx_flags())


def _load_lib() -> ctypes.CDLL:
    global _LIB
    with _LOAD_LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(build_native()))
        u64, u32, i64, i32, f32 = (
            ctypes.c_uint64, ctypes.c_uint32, ctypes.c_int64, ctypes.c_int32, ctypes.c_float,
        )
        p = ctypes.c_void_p
        u64p, f32p = ctypes.POINTER(u64), ctypes.POINTER(f32)
        i64p, u32p, i32p = ctypes.POINTER(i64), ctypes.POINTER(u32), ctypes.POINTER(i32)
        lib.ps_create.restype = p
        lib.ps_create.argtypes = [u64, u32, u64]
        lib.ps_destroy.restype = None
        lib.ps_destroy.argtypes = [p]
        lib.ps_configure.restype = None
        lib.ps_configure.argtypes = [p, ctypes.c_double, ctypes.c_double, ctypes.c_double, f32]
        lib.ps_set_init_method.restype = None
        lib.ps_set_init_method.argtypes = [p, i32, ctypes.c_double, ctypes.c_double]
        lib.ps_register_optimizer.restype = None
        lib.ps_register_optimizer.argtypes = [p, i32, f32, f32, f32, f32, f32, i32, f32, f32]
        lib.ps_lookup.restype = None
        lib.ps_lookup.argtypes = [p, u64p, i64, u32, i32, f32p]
        lib.ps_lookup_batched.restype = None
        lib.ps_lookup_batched.argtypes = [p, u64p, i64p, u32p, i64p, i32, i32, f32p]
        lib.ps_advance_batch_state.restype = None
        lib.ps_advance_batch_state.argtypes = [p, i32]
        lib.ps_update_gradients.restype = i32
        lib.ps_update_gradients.argtypes = [p, u64p, i64, u32, f32p, i32]
        lib.ps_update_batched.restype = i32
        lib.ps_update_batched.argtypes = [p, u64p, i64p, u32p, f32p, i64p, i32p, i32]
        lib.ps_set_embedding.restype = None
        lib.ps_set_embedding.argtypes = [p, u64p, i64, u32, u32, f32p]
        lib.ps_get_entry.restype = i32
        lib.ps_get_entry.argtypes = [p, u64, f32p, i32]
        lib.ps_get_entry_dim.restype = i32
        lib.ps_get_entry_dim.argtypes = [p, u64]
        lib.ps_checkout.restype = i64
        lib.ps_checkout.argtypes = [p, u64p, i64, u32, f32p]
        lib.ps_probe_entries.restype = i64
        lib.ps_probe_entries.argtypes = [p, u64p, i64, u32, f32p, ctypes.POINTER(ctypes.c_uint8)]
        lib.ps_size.restype = i64
        lib.ps_size.argtypes = [p]
        lib.ps_clear.restype = None
        lib.ps_clear.argtypes = [p]
        lib.ps_grad_misses.restype = i64
        lib.ps_grad_misses.argtypes = [p]
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.ps_dump_shard_size.restype = i64
        lib.ps_dump_shard_size.argtypes = [p, u32]
        lib.ps_dump_shard.restype = i64
        lib.ps_dump_shard.argtypes = [p, u32, u8p, i64]
        lib.ps_load_shard.restype = i64
        lib.ps_load_shard.argtypes = [p, u8p, i64]
        lib.ps_journal_record.restype = None
        lib.ps_journal_record.argtypes = [p, u64, u32]
        lib.ps_journal_probe.restype = i32
        lib.ps_journal_probe.argtypes = [p, u64, u32]
        lib.ps_journal_len.restype = i64
        lib.ps_journal_len.argtypes = [p]
        lib.ps_journal_clear.restype = None
        lib.ps_journal_clear.argtypes = [p]
        _LIB = lib
        return lib


def _check_group_layout(signs: np.ndarray, key_ofs: np.ndarray, dims: np.ndarray) -> None:
    """The batched calls trust this layout with raw pointers: reject a bad
    one here."""
    if len(key_ofs) != len(dims) + 1:
        raise ValueError("key_ofs must have len(dims) + 1 entries")
    if key_ofs[0] != 0 or key_ofs[-1] != len(signs):
        raise ValueError("key_ofs must start at 0 and end at len(signs)")
    if np.any(np.diff(key_ofs) < 0):
        raise ValueError("key_ofs must be non-decreasing")


def _group_offsets(key_ofs: np.ndarray, dims: np.ndarray):
    """(float offset of each group in the flat buffer, total floats)."""
    sizes = np.diff(key_ofs) * dims.astype(np.int64)
    ofs = np.zeros(len(dims), dtype=np.int64)
    np.cumsum(sizes[:-1], out=ofs[1:])
    return ofs, int(sizes.sum())


def _ptr(a: np.ndarray, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


class NativeEmbeddingStore:
    """One parameter-server replica's store, backed by the C++ core; the
    numpy ``EmbeddingStore``'s surface and semantics."""

    def __init__(
        self,
        capacity: int = 1 << 20,
        num_internal_shards: int = 8,
        hyperparams: HyperParameters = HyperParameters(),
        optimizer: Optional[OptimizerConfig] = None,
        seed: int = 0,
    ):
        if num_internal_shards <= 0 or capacity <= 0:
            raise ValueError("capacity and num_internal_shards must be positive")
        self._lib = _load_lib()
        self._h = self._lib.ps_create(capacity, num_internal_shards, seed)
        if not self._h:
            raise MemoryError("ps_create failed")
        self._num_shards = num_internal_shards
        self.seed = seed
        self.optimizer: Optional[OptimizerConfig] = None
        self.hyperparams = hyperparams
        lo, hi = hyperparams.emb_initialization
        self._lib.ps_configure(self._h, lo, hi, hyperparams.admit_probability, hyperparams.weight_bound)
        m = hyperparams.resolved_init_method()
        self._lib.ps_set_init_method(self._h, INIT_KIND_CODES[m.kind], m.p0, m.p1)
        if optimizer is not None:
            self.register_optimizer(optimizer)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.ps_destroy(h)
            self._h = None

    def register_optimizer(self, optimizer: OptimizerConfig) -> None:
        """Register the sparse optimizer; Adam's batch powers restart."""
        self.optimizer = optimizer
        o = optimizer
        self._lib.ps_register_optimizer(
            self._h, o.kind, o.lr, o.weight_decay, o.initialization,
            o.g_square_momentum, o.eps, int(o.vectorwise_shared), o.beta1, o.beta2,
        )

    def lookup(self, signs: np.ndarray, dim: int, train: bool) -> np.ndarray:
        """Fetch ``(len(signs), dim)`` embedding rows."""
        signs = np.ascontiguousarray(signs, dtype=np.uint64)
        out = np.empty((len(signs), dim), dtype=np.float32)
        self._lib.ps_lookup(self._h, _ptr(signs, ctypes.c_uint64), len(signs), dim, int(train),
                            _ptr(out, ctypes.c_float))
        return out

    def lookup_batched(
        self, signs: np.ndarray, key_ofs: np.ndarray, dims: np.ndarray, train: bool
    ) -> np.ndarray:
        """Multi-slot lookup in one native call (layout: the numpy store's
        ``lookup_batched``). State effects are exactly sequential per-group
        ``lookup`` calls."""
        signs = np.ascontiguousarray(signs, dtype=np.uint64)
        key_ofs = np.ascontiguousarray(key_ofs, dtype=np.int64)
        dims = np.ascontiguousarray(dims, dtype=np.uint32)
        _check_group_layout(signs, key_ofs, dims)
        out_ofs, total = _group_offsets(key_ofs, dims)
        out = np.empty(total, dtype=np.float32)
        self._lib.ps_lookup_batched(
            self._h, _ptr(signs, ctypes.c_uint64), _ptr(key_ofs, ctypes.c_int64),
            _ptr(dims, ctypes.c_uint32), _ptr(out_ofs, ctypes.c_int64),
            len(dims), int(train), _ptr(out, ctypes.c_float),
        )
        return out

    def advance_batch_state(self, group: int) -> None:
        """Advance Adam's beta powers of ``group`` once per gradient batch."""
        self._lib.ps_advance_batch_state(self._h, group)

    def update_gradients(self, signs: np.ndarray, grads: np.ndarray, group: int = 0) -> None:
        """Apply the registered optimizer to each sign's entry in turn, then
        clamp to ±weight_bound; absent signs are skipped and counted."""
        if grads.shape[0] != len(signs):
            raise ValueError("signs/grads length mismatch")
        signs = np.ascontiguousarray(signs, dtype=np.uint64)
        grads = np.ascontiguousarray(grads, dtype=np.float32)
        rc = self._lib.ps_update_gradients(
            self._h, _ptr(signs, ctypes.c_uint64), len(signs), grads.shape[1],
            _ptr(grads, ctypes.c_float), group,
        )
        if rc != 0:
            raise RuntimeError("no optimizer registered")

    def update_batched(
        self, signs: np.ndarray, key_ofs: np.ndarray, dims: np.ndarray,
        grads: np.ndarray, opt_groups: np.ndarray,
    ) -> None:
        """Multi-slot gradient update in one native call; ``grads`` is flat
        in ``lookup_batched``'s layout. Exactly sequential per-group
        ``update_gradients`` calls."""
        signs = np.ascontiguousarray(signs, dtype=np.uint64)
        key_ofs = np.ascontiguousarray(key_ofs, dtype=np.int64)
        dims = np.ascontiguousarray(dims, dtype=np.uint32)
        _check_group_layout(signs, key_ofs, dims)
        grads = np.ascontiguousarray(grads, dtype=np.float32).reshape(-1)
        opt_groups = np.ascontiguousarray(opt_groups, dtype=np.int32)
        if len(opt_groups) != len(dims):
            raise ValueError("opt_groups must have one entry per group")
        grad_ofs, total = _group_offsets(key_ofs, dims)
        if grads.size != total:
            raise ValueError("grads size does not match key_ofs/dims layout")
        rc = self._lib.ps_update_batched(
            self._h, _ptr(signs, ctypes.c_uint64), _ptr(key_ofs, ctypes.c_int64),
            _ptr(dims, ctypes.c_uint32), _ptr(grads, ctypes.c_float),
            _ptr(grad_ofs, ctypes.c_int64), _ptr(opt_groups, ctypes.c_int32), len(dims),
        )
        if rc != 0:
            raise RuntimeError("no optimizer registered")

    @property
    def grad_misses(self) -> int:
        """Gradient rows whose sign was absent (evicted, never admitted, or
        of another width)."""
        return int(self._lib.ps_grad_misses(self._h))

    def set_embedding(self, signs: np.ndarray, values: np.ndarray, dim: Optional[int] = None) -> None:
        """Insert or overwrite whole entries ``[emb | state]`` (``values`` is
        (n, entry width)); ``dim`` is the embedding width (default: all)."""
        signs = np.ascontiguousarray(signs, dtype=np.uint64)
        values = np.ascontiguousarray(values, dtype=np.float32)
        if values.ndim != 2 or values.shape[0] != len(signs):
            raise ValueError("values must be (len(signs), entry width)")
        dim = values.shape[1] if dim is None else dim
        if not 0 < dim <= values.shape[1]:
            raise ValueError("dim must lie in [1, entry width]")
        self._lib.ps_set_embedding(self._h, _ptr(signs, ctypes.c_uint64), len(signs), dim,
                                   values.shape[1], _ptr(values, ctypes.c_float))

    def get_embedding_entry(self, sign: int) -> Optional[np.ndarray]:
        """The sign's whole entry ``[emb | optimizer state]`` (no LRU touch),
        or None."""
        # two locked calls (size, then copy): retry if a concurrent eviction
        # or re-init changes the entry between them
        for _ in range(8):
            n = self._lib.ps_get_entry(self._h, sign, None, 0)
            if n < 0:
                return None
            out = np.empty(n, dtype=np.float32)
            n2 = self._lib.ps_get_entry(self._h, sign, _ptr(out, ctypes.c_float), n)
            if n2 == n:
                return out
            if n2 < 0:
                return None
        raise RuntimeError(f"entry for sign {sign} kept changing concurrently")

    def get_entry_dim(self, sign: int) -> Optional[int]:
        """The embedding width of the sign's entry (no LRU touch), or None."""
        d = self._lib.ps_get_entry_dim(self._h, sign)
        return None if d < 0 else int(d)

    # ---------------------------------------------- the cache tier's entries

    def _entry_len(self, dim: int) -> int:
        if self.optimizer is None:  # see EmbeddingStore.checkout_entries
            raise RuntimeError("no optimizer registered")
        return dim + self.optimizer.state_dim(dim)

    def checkout_entries(self, signs: np.ndarray, dim: int) -> np.ndarray:
        """Whole entries ``[emb | optimizer state]``, misses admitted: the
        numpy store's ``checkout_entries``."""
        entry_len = self._entry_len(dim)
        signs = np.ascontiguousarray(signs, dtype=np.uint64)
        out = np.empty((len(signs), entry_len), dtype=np.float32)
        got = self._lib.ps_checkout(self._h, _ptr(signs, ctypes.c_uint64), len(signs), dim,
                                    _ptr(out, ctypes.c_float))
        if got != entry_len:
            raise RuntimeError(f"ps_checkout entry width {got} != {entry_len}")
        return out

    supports_probe_out = True

    def probe_entries(self, signs: np.ndarray, dim: int, vals_out: Optional[np.ndarray] = None,
                      warm_out: Optional[np.ndarray] = None):
        """The numpy store's ``probe_entries`` (warm, vals), except that a
        cold row of ``vals`` is left as it was (callers read warm rows
        only). ``vals_out`` ((n, entry width) f32) and ``warm_out`` ((n,)
        of a 1-byte dtype) are filled in place when given."""
        entry_len = self._entry_len(dim)
        signs = np.ascontiguousarray(signs, dtype=np.uint64)
        n = len(signs)
        vals = np.empty((n, entry_len), dtype=np.float32) if vals_out is None else vals_out
        warm = np.empty(n, dtype=np.uint8) if warm_out is None else warm_out
        if vals.dtype != np.float32 or not vals.flags.c_contiguous or vals.shape[0] < n or vals.shape[1:] != (entry_len,):
            raise ValueError(f"vals_out must be contiguous f32 of at least ({n}, {entry_len})")
        if warm.itemsize != 1 or not warm.flags.c_contiguous or warm.shape[0] < n:
            raise ValueError(f"warm_out must be contiguous 1-byte of at least {n}")
        got = self._lib.ps_probe_entries(self._h, _ptr(signs, ctypes.c_uint64), n, dim,
                                         _ptr(vals, ctypes.c_float), _ptr(warm, ctypes.c_uint8))
        if got != entry_len:
            raise RuntimeError(f"ps_probe_entries entry width {got} != {entry_len}")
        return warm[:n].view(np.bool_), vals

    def clear(self) -> None:
        """Drop every entry and Adam's batch powers (not the journal)."""
        self._lib.ps_clear(self._h)

    def size(self) -> int:
        return int(self._lib.ps_size(self._h))

    @property
    def num_internal_shards(self) -> int:
        return self._num_shards

    # ------------------------------------------------------------ checkpoint

    def dump_shard(self, shard_idx: int) -> bytes:
        """One internal shard in the checkpoint wire format (the numpy
        store's ``dump_shard``), from the least to the most recently used
        entry."""
        n = self._lib.ps_dump_shard_size(self._h, shard_idx)
        if n < 0:
            raise IndexError(f"shard {shard_idx} out of range")
        # the size and the dump take the shard's lock apart: a dump racing
        # with training can see the shard grow in between (the dump then
        # returns -1), so measure again with headroom and retry
        for _ in range(8):
            buf = np.empty(max(n, 4), dtype=np.uint8)
            written = self._lib.ps_dump_shard(self._h, shard_idx, _ptr(buf, ctypes.c_uint8), len(buf))
            if written >= 0:
                return buf[:written].tobytes()
            n = max(self._lib.ps_dump_shard_size(self._h, shard_idx), n * 2)
        raise RuntimeError("dump_shard failed: the shard kept growing concurrently")

    def load_shard_bytes(self, raw: bytes) -> int:
        """Load a dump's entries, each routed by its sign (a dump of any
        shard layout loads); returns the entries loaded. Raises
        ``ValueError`` on a payload shorter than its counts say."""
        buf = np.frombuffer(raw, dtype=np.uint8)
        n = self._lib.ps_load_shard(self._h, _ptr(buf, ctypes.c_uint8), len(buf))
        if n < 0:
            raise ValueError("corrupt shard payload")
        return int(n)

    # --------------------------------------------------------- apply-journal

    def journal_record(self, journal_id: int, crc: int) -> None:
        self._lib.ps_journal_record(self._h, journal_id, crc & 0xFFFFFFFF)

    def journal_probe(self, journal_id: int, crc: int) -> int:
        """1: already applied (the crc matches); 0: unknown; -1: the id
        was recorded with another payload crc."""
        return int(self._lib.ps_journal_probe(self._h, journal_id, crc & 0xFFFFFFFF))

    def journal_len(self) -> int:
        return int(self._lib.ps_journal_len(self._h))

    def journal_clear(self) -> None:
        self._lib.ps_journal_clear(self._h)

    # probe, apply and record through the methods above
    update_batched_journaled = EmbeddingStore.update_batched_journaled


def native_available() -> bool:
    """Whether the native PS core builds and loads here."""
    try:
        _load_lib()
        return True
    except (OSError, RuntimeError) as e:  # no toolchain, or a compile error
        logger.warning("native PS core unavailable: %s", e)
        return False


def store_backend_name(store) -> str:
    """``native`` (the C++ core), ``numpy`` (the golden model), or
    ``unknown``."""
    if isinstance(store, NativeEmbeddingStore):
        return "native"
    if isinstance(store, EmbeddingStore):
        return "numpy"
    return "unknown"


def create_store(backend: str = "auto", **kwargs):
    """A store: ``auto`` prefers the C++ core and falls back to numpy,
    ``native`` requires the C++ core (raises where it cannot build),
    ``numpy`` is the golden model."""
    if backend == "numpy":
        return EmbeddingStore(**kwargs)
    if backend == "native":
        return NativeEmbeddingStore(**kwargs)
    if backend == "auto":
        return NativeEmbeddingStore(**kwargs) if native_available() else EmbeddingStore(**kwargs)
    raise ValueError(f"unknown store backend {backend!r}")
