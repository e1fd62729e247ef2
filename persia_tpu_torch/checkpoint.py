"""Sparse checkpoints on local disk (counterpart of ``persia_tpu/checkpoint.py``;
the files are the reference's, so a checkpoint moves between the packages).

- One file per internal shard of each PS replica,
  ``replica_{r}_shard_{i}.emb``: the stores' shard wire format (u32 count,
  then per entry u64 sign, u32 dim, u32 len and len f32), then a trailer of
  its crc32 (LE u32) and the magic ``PCK1``. Files without the trailer
  (older dumps) still load; a file whose crc does not match, or that does
  not parse, raises ``CorruptCheckpointError``.
- A marker per replica, ``replica_{r}_done`` (its shard count and the
  dump's session), and the master ``embedding_dump_done``, written by the
  replica that finds every replica's marker of this session: a marker left
  by an earlier dump into the directory cannot complete this one.
- Loading filters each entry by ``hashing.sign_to_shard`` when the replica
  count changed (re-sharding on load); a change of the internal shard count
  needs nothing, as each entry routes by its sign.

Every file is written by ``jobstate.fsync_write_bytes`` (temp + fsync +
atomic rename). The reference's remote storage backends are not ported.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from persia_tpu_torch.embedding.hashing import sign_to_shard
from persia_tpu_torch.jobstate import fsync_write_bytes

DONE_MARKER = "embedding_dump_done"
DENSE_NAME = "dense.ckpt"
_IO_THREADS = 4  # shard files written or read at once

# the shard file's trailer: crc32 of the payload (LE u32) and this magic
_CRC_MAGIC = b"PCK1"


class CorruptCheckpointError(RuntimeError):
    """A checkpoint shard file is torn or corrupt (crc or format)."""


def _wrap_shard_blob(data: bytes) -> bytes:
    return data + struct.pack("<I", zlib.crc32(data) & 0xFFFFFFFF) + _CRC_MAGIC


def _unwrap_shard_blob(blob: bytes, name: str) -> bytes:
    """The payload with its trailer checked and stripped; a blob without
    the magic (an older dump) passes through to the loader's format
    check."""
    if len(blob) >= 8 and blob[-4:] == _CRC_MAGIC:
        data, (crc,) = blob[:-8], struct.unpack("<I", blob[-8:-4])
        if (zlib.crc32(data) & 0xFFFFFFFF) != crc:
            raise CorruptCheckpointError(
                f"shard file {name} failed its crc32 check: the checkpoint is corrupt "
                "(a torn write or bit rot); fall back to an older checkpoint"
            )
        return data
    return blob


class ModelManagerStatus:
    """Thread-safe status of a dump or load: idle, dumping, loading or
    failed, with its progress and error."""

    def __init__(self):
        self._lock = threading.Lock()
        self._state = "idle"
        self._progress = 0.0
        self._error: Optional[str] = None

    def set(self, state: str, progress: float = 0.0, error: Optional[str] = None):
        with self._lock:
            self._state, self._progress, self._error = state, progress, error

    def get(self) -> Dict:
        with self._lock:
            return {"status": self._state, "progress": self._progress, "error": self._error}


def _shard_name(replica: int, shard: int) -> str:
    return f"replica_{replica}_shard_{shard}.emb"


def _marker_name(replica: int) -> str:
    return f"replica_{replica}_done"


def _read_json(path: str) -> Optional[Dict]:
    try:
        with open(path, "rb") as f:
            return json.loads(f.read().decode())
    except (OSError, ValueError):
        return None


def _remove(path: str) -> None:
    try:
        os.remove(path)
    except FileNotFoundError:
        pass


def dump_store(
    store,
    dst_dir: str,
    replica_index: int = 0,
    replica_size: int = 1,
    status: Optional[ModelManagerStatus] = None,
    session: Optional[str] = None,
) -> None:
    """Dump one replica's internal shards (in parallel) and its marker; the
    replica that finds every replica's marker of ``session`` writes the
    master marker. ``session`` ties one dump's replicas together (None: a
    fresh one from the clock, for a lone replica)."""
    status = status or ModelManagerStatus()
    status.set("dumping", 0.0)
    session = session or f"s{time.time_ns()}"
    try:
        os.makedirs(dst_dir, exist_ok=True)
        done_path = os.path.join(dst_dir, DONE_MARKER)
        _remove(done_path)  # this directory's earlier dump is no longer whole
        _remove(os.path.join(dst_dir, _marker_name(replica_index)))
        n = store.num_internal_shards
        prefix = f"replica_{replica_index}_shard_"
        for old in os.listdir(dst_dir):
            if old.startswith(prefix):
                idx = old[len(prefix):].split(".")[0]
                if idx.isdigit() and int(idx) >= n:
                    _remove(os.path.join(dst_dir, old))
        done = 0
        lock = threading.Lock()

        def dump_one(i: int):
            nonlocal done
            fsync_write_bytes(os.path.join(dst_dir, _shard_name(replica_index, i)),
                              _wrap_shard_blob(store.dump_shard(i)))
            with lock:
                done += 1
                status.set("dumping", done / n)

        with ThreadPoolExecutor(max_workers=_IO_THREADS) as pool:
            list(pool.map(dump_one, range(n)))

        fsync_write_bytes(
            os.path.join(dst_dir, _marker_name(replica_index)),
            json.dumps({"num_internal_shards": n, "session": session, "time": time.time()}).encode(),
        )
        markers = [_read_json(os.path.join(dst_dir, _marker_name(r))) for r in range(replica_size)]
        if all(m is not None and m.get("session") == session for m in markers):
            info = {
                "num_replicas": replica_size,
                "session": session,
                "datetime": time.strftime("%Y-%m-%dT%H:%M:%S"),
                "time_us": time.time_ns() // 1000,
            }
            fsync_write_bytes(done_path, json.dumps(info).encode())
        status.set("idle", 1.0)
    except Exception as e:
        status.set("failed", error=repr(e))
        raise


def checkpoint_info(src_dir: str) -> Dict:
    with open(os.path.join(src_dir, DONE_MARKER), "rb") as f:
        return json.loads(f.read().decode())


def iter_shard_entries(blob: bytes) -> Iterator[Tuple[int, bytes]]:
    """(sign, the entry's bytes) of each entry of a shard payload."""
    (n,) = struct.unpack_from("<I", blob, 0)
    off = 4
    for _ in range(n):
        sign, _, ln = struct.unpack_from("<QII", blob, off)
        end = off + 16 + 4 * ln
        if end > len(blob):
            raise ValueError("corrupt shard payload")
        yield sign, blob[off:end]
        off = end


def _filter_blob_for_replica(blob: bytes, replica_index: int, replica_size: int) -> bytes:
    """The payload with only the entries ``replica_index`` owns under the
    routing of ``replica_size`` replicas (re-sharding on load)."""
    if replica_size <= 1:
        return blob
    entries = list(iter_shard_entries(blob))
    if not entries:
        return struct.pack("<I", 0)
    owner = sign_to_shard(np.array([s for s, _ in entries], dtype=np.uint64), replica_size)
    kept = [e for (_, e), own in zip(entries, owner.tolist()) if own == replica_index]
    return struct.pack("<I", len(kept)) + b"".join(kept)


def load_store(
    store,
    src_dir: str,
    replica_index: int = 0,
    replica_size: int = 1,
    status: Optional[ModelManagerStatus] = None,
) -> int:
    """Load a checkpoint's shard files into one replica, keeping the
    entries it owns when the replica count changed. Returns the entries
    loaded."""
    status = status or ModelManagerStatus()
    status.set("loading", 0.0)
    try:
        info = _read_json(os.path.join(src_dir, DONE_MARKER))
        if info is None:
            raise FileNotFoundError(f"no valid {DONE_MARKER} in {src_dir} (incomplete dump?)")
        # only the files the recorded topology wrote; with the same replica
        # count, only this replica's, which hold exactly its signs
        dumped = int(info["num_replicas"])
        files = []
        for r in range(dumped):
            if dumped == replica_size and r != replica_index:
                continue
            marker = _read_json(os.path.join(src_dir, _marker_name(r)))
            shards = int(marker["num_internal_shards"]) if marker else 0
            files += [_shard_name(r, i) for i in range(shards)]
        need_filter = dumped != replica_size
        done = 0
        lock = threading.Lock()

        def load_one(fname: str) -> int:
            nonlocal done
            with open(os.path.join(src_dir, fname), "rb") as f:
                blob = _unwrap_shard_blob(f.read(), fname)
            try:
                if need_filter:
                    blob = _filter_blob_for_replica(blob, replica_index, replica_size)
                n = store.load_shard_bytes(blob)
            except (struct.error, ValueError, IndexError) as e:
                # a blob without the trailer that does not parse is a torn
                # older file (or garbage): corruption, never a partial load
                raise CorruptCheckpointError(
                    f"shard file {fname} does not parse as a checkpoint shard ({e!r}): torn or corrupt"
                ) from e
            with lock:
                done += 1
                status.set("loading", done / max(len(files), 1))
            return n

        with ThreadPoolExecutor(max_workers=_IO_THREADS) as pool:
            loaded = sum(pool.map(load_one, files))
        status.set("idle", 1.0)
        return loaded
    except Exception as e:
        status.set("failed", error=repr(e))
        raise


def dump_dense(state_bytes: bytes, dst_dir: str) -> None:
    fsync_write_bytes(os.path.join(dst_dir, DENSE_NAME), state_bytes)


def load_dense(src_dir: str, missing_ok: bool = False) -> Optional[bytes]:
    """The dense blob; None where there is none and ``missing_ok``."""
    path = os.path.join(src_dir, DENSE_NAME)
    if missing_ok and not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return f.read()
