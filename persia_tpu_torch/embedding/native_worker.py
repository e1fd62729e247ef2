"""ctypes bindings of the port's native embedding-worker loops
(``persia_tpu_torch/native/worker.cpp``; counterpart of
``persia_tpu/embedding/native_worker.py``).

Drop-in accelerators for the numpy routines of
``persia_tpu_torch.embedding.worker``: id dedup (``np.unique``), sum
pooling and per-sign gradient accumulation (``np.add.at``), the index
matrix of raw and device-pooled slots, shard partitioning, and the cache
tier's single-id sign matrix. The library
is built with ``g++`` at the first call that needs it. Where it cannot be
built, ``_load_lib`` returns None, every function here returns None, and
the worker runs its numpy routines. A ``ctypes`` call releases the GIL,
so loader threads overlap in these loops.
"""

from __future__ import annotations

import ctypes
import logging
import threading
from typing import Optional, Tuple

import numpy as np

from persia_tpu_torch.embedding._native_build import NATIVE_SRC, build_so, cxx_flags

logger = logging.getLogger("persia_tpu_torch.native_worker")

_LIB: Optional[ctypes.CDLL] = None
_LOAD_FAILED = False
_LOAD_LOCK = threading.Lock()

_i64p = ctypes.POINTER(ctypes.c_int64)
_u64p = ctypes.POINTER(ctypes.c_uint64)
_f32p = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int32)


def build_native():
    """Compile the worker core unless built (see ``_native_build.build_so``)."""
    return build_so([NATIVE_SRC / "worker.cpp"], "libpersia_torch_worker.so", cxx_flags())


def _load_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _LOAD_FAILED
    with _LOAD_LOCK:
        if _LIB is not None or _LOAD_FAILED:
            return _LIB
        try:
            lib = ctypes.CDLL(str(build_native()))
        except (OSError, RuntimeError) as e:  # no toolchain, or it failed
            logger.warning("native worker core unavailable (%s); using numpy", e)
            _LOAD_FAILED = True
            return None
        i64, u32, i32 = ctypes.c_int64, ctypes.c_uint32, ctypes.c_int32
        lib.wk_dedup.restype = i64
        lib.wk_dedup.argtypes = [_u64p, i64, _u64p, _i64p]
        lib.wk_sum_pool.restype = None
        lib.wk_sum_pool.argtypes = [_f32p, _i64p, _i64p, i64, i64, _f32p]
        lib.wk_grad_accum.restype = None
        lib.wk_grad_accum.argtypes = [_f32p, _i64p, _i64p, i64, i64, _f32p]
        lib.wk_raw_index.restype = None
        lib.wk_raw_index.argtypes = [_i64p, _i64p, i64, i64, i32, _i32p]
        lib.wk_shard_partition.restype = None
        lib.wk_shard_partition.argtypes = [_u64p, i64, u32, _i64p, _i64p]
        lib.wk_build_sid_matrix.restype = None
        lib.wk_build_sid_matrix.argtypes = [ctypes.POINTER(ctypes.c_void_p), _u64p, i64, i64, i32, _u64p]
        _LIB = lib
        return _LIB


def available() -> bool:
    """Whether the native worker core is built and loaded."""
    return _load_lib() is not None


def _ptr(a: np.ndarray, typ):
    return a.ctypes.data_as(typ)


def dedup(ids: np.ndarray) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(distinct, inverse), distinct in first-seen order (``np.unique``
    sorts; every consumer pairs distinct with inverse). None if the native
    core is unavailable."""
    lib = _load_lib()
    if lib is None:
        return None
    ids = np.ascontiguousarray(ids, dtype=np.uint64)
    n = len(ids)
    distinct = np.empty(n, dtype=np.uint64)
    inverse = np.empty(n, dtype=np.int64)
    m = lib.wk_dedup(_ptr(ids, _u64p), n, _ptr(distinct, _u64p), _ptr(inverse, _i64p))
    return distinct[:m].copy(), inverse


def _gather_args(rows: np.ndarray, inverse: np.ndarray, sample_of_id: np.ndarray):
    if len(inverse) != len(sample_of_id):
        raise ValueError("inverse and sample_of_id must have one entry per id")
    return (np.ascontiguousarray(rows, dtype=np.float32),
            np.ascontiguousarray(inverse, dtype=np.int64),
            np.ascontiguousarray(sample_of_id, dtype=np.int64))


def sum_pool(
    rows: np.ndarray, inverse: np.ndarray, sample_of_id: np.ndarray, batch_size: int
) -> Optional[np.ndarray]:
    """``pooled[sample_of_id[i]] += rows[inverse[i]]`` in id order (the order
    of ``np.add.at``), into a (batch_size, dim) f32 array."""
    lib = _load_lib()
    if lib is None:
        return None
    rows, inverse, sample_of_id = _gather_args(rows, inverse, sample_of_id)
    dim = rows.shape[1] if rows.ndim == 2 else 0
    pooled = np.zeros((batch_size, dim), dtype=np.float32)
    lib.wk_sum_pool(
        _ptr(rows, _f32p), _ptr(inverse, _i64p), _ptr(sample_of_id, _i64p),
        len(inverse), dim, _ptr(pooled, _f32p),
    )
    return pooled


def grad_accum(
    grad: np.ndarray, inverse: np.ndarray, sample_of_id: np.ndarray, num_distinct: int
) -> Optional[np.ndarray]:
    """``per_distinct[inverse[i]] += grad[sample_of_id[i]]`` in id order,
    into a (num_distinct, dim) f32 array."""
    lib = _load_lib()
    if lib is None:
        return None
    grad, inverse, sample_of_id = _gather_args(grad, inverse, sample_of_id)
    dim = grad.shape[1]
    out = np.zeros((num_distinct, dim), dtype=np.float32)
    lib.wk_grad_accum(
        _ptr(grad, _f32p), _ptr(inverse, _i64p), _ptr(sample_of_id, _i64p),
        len(inverse), dim, _ptr(out, _f32p),
    )
    return out


def raw_index(
    counts: np.ndarray, inverse: np.ndarray, sample_fixed_size: int, pad: int
) -> Optional[np.ndarray]:
    """(B, L) int32: each sample's first L entries of ``inverse``, padded
    with ``pad``."""
    lib = _load_lib()
    if lib is None:
        return None
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    inverse = np.ascontiguousarray(inverse, dtype=np.int64)
    if int(counts.sum()) != len(inverse):
        raise ValueError("counts must sum to the number of ids")
    B = len(counts)
    out = np.empty((B, sample_fixed_size), dtype=np.int32)
    lib.wk_raw_index(
        _ptr(counts, _i64p), _ptr(inverse, _i64p), B, sample_fixed_size,
        pad, _ptr(out, _i32p),
    )
    return out


def shard_partition(
    signs: np.ndarray, num_shards: int
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(positions grouped by shard, ascending within each; per-shard counts)
    for ``sign_to_shard`` routing, in one pass."""
    lib = _load_lib()
    if lib is None:
        return None
    signs = np.ascontiguousarray(signs, dtype=np.uint64)
    n = len(signs)
    pos = np.empty(n, dtype=np.int64)
    counts = np.empty(num_shards, dtype=np.int64)
    lib.wk_shard_partition(_ptr(signs, _u64p), n, num_shards, _ptr(pos, _i64p), _ptr(counts, _i64p))
    return pos, counts


def build_sid_matrix(id_arrays, prefixes: np.ndarray, prefix_bit: int, out: np.ndarray) -> bool:
    """Fill ``out`` (S, B) uint64 with each slot's prefixed signs in one
    call (the cache tier's single-id path): ``id_arrays`` are S contiguous
    (B,) uint64 arrays, ``prefixes`` (S,). False if the native core is
    unavailable (the caller prefixes in numpy)."""
    lib = _load_lib()
    if lib is None:
        return False
    S, B = out.shape
    # the native call trusts raw pointers: reject what numpy would
    if len(id_arrays) != S:
        raise ValueError(f"expected {S} id arrays, got {len(id_arrays)}")
    for a in id_arrays:
        if a.dtype != np.uint64 or a.size < B or not a.flags.c_contiguous:
            raise ValueError("id arrays must be contiguous uint64 of at least B ids")
    if out.dtype != np.uint64 or not out.flags.c_contiguous:
        raise ValueError("out must be a contiguous uint64 (S, B) array")
    ptrs = (ctypes.c_void_p * S)(*[a.ctypes.data for a in id_arrays])
    prefixes = np.ascontiguousarray(prefixes, dtype=np.uint64)
    lib.wk_build_sid_matrix(ptrs, _ptr(prefixes, _u64p), S, B, prefix_bit, _ptr(out, _u64p))
    return True
