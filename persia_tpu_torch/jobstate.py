"""Durable job state: step-fenced manifests and exactly-once resume
(counterpart of ``persia_tpu/jobstate.py``; the files and ids it writes are
the reference's, so a job directory moves between the two packages).

- **Epoch manifests** (``JobStateManager``, ``EpochWriter``): a snapshot
  fence writes the job's components (PS shards, the dense state, the loader
  cursor, RNG streams) into one ``epoch_NNNNNNNN`` directory, each file by
  temp + fsync + atomic rename. ``MANIFEST.json``, with every component's
  size and crc32, is written last, so a capture cut short leaves a
  directory the scan skips; then the ``LAST_GOOD`` pointer. A reader falls
  back newest-first past a torn epoch and checks each blob's crc32.
- **Journal ids** (``make_journal_id``, ``journal_shard_id``): a gradient
  batch applied to a PS replica between fences is tagged (epoch, step,
  replica), with ``payload_crc`` of its payload; the store's apply-journal
  lets a resumed trainer's replay skip what the crashed run applied.
- **PS capture and restore** (``capture_ps``, ``restore_ps``): every
  replica's internal shards go into the manifest; a restore rewinds the PS
  to the fence (clear, load, journal clear, the optimizer registered and
  Adam's batch powers advanced to the fence's counts), which makes a
  resumed run bit-identical to an uninterrupted one. Resuming without the
  rewind keeps the PS as the crash left it and relies on the journal.

Local disk only: every write is temp + fsync + rename.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import tempfile
import time
import zlib
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

logger = logging.getLogger("persia_tpu_torch.jobstate")

MANIFEST_NAME = "MANIFEST.json"
LAST_GOOD = "LAST_GOOD"
_KEEP_EPOCHS = 2  # good epochs a snapshot leaves: its own and one to fall back to
_EPOCH_RE = re.compile(r"^epoch_(\d{8})$")

# sampled once: the mode a published file gets is 0o666 less the umask
_UMASK = os.umask(0)
os.umask(_UMASK)


class ManifestError(RuntimeError):
    """A job-state manifest is missing, torn or inconsistent."""


class CorruptManifestError(ManifestError):
    """A manifest component failed its crc32 check."""


# ------------------------------------------------------------ durable writes


def fsync_write_bytes(path: str, data: bytes) -> None:
    """Crash-durable atomic publish on local disk: a temporary file in the
    target directory, ``fsync``, atomic rename, directory ``fsync``. A
    reader never sees a partial file, and a power cut after the return
    cannot lose the rename."""
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp_" + os.path.basename(path))
    try:
        os.fchmod(fd, 0o666 & ~_UMASK)
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(d)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def _fsync_dir(d: str) -> None:
    try:
        dfd = os.open(d, os.O_RDONLY)
    except OSError:
        return  # no directory fsync on this filesystem: the rename is still atomic
    try:
        os.fsync(dfd)
    except OSError:
        pass
    finally:
        os.close(dfd)


# --------------------------------------------------------------- journal ids


def make_journal_id(job_epoch: int, step: int) -> int:
    """The u64 apply-journal id of one gradient batch: the epoch of the
    last committed manifest (24 bits), the global step (32 bits), and a low
    byte left for the PS replica index, so a replay of step ``s`` under the
    same epoch makes the ids the crashed run recorded."""
    return ((job_epoch & 0xFFFFFF) << 40) | ((step & 0xFFFFFFFF) << 8)


def journal_shard_id(base_id: int, replica_index: int) -> int:
    """A ``make_journal_id`` base with the PS replica index mixed in. The
    index stays below 0x80: the low byte's upper half belongs to other
    journaled operations (the reference's reshard handoff)."""
    if not 0 <= replica_index < 0x80:
        raise ValueError(
            f"replica_index {replica_index} outside the gradient-id namespace [0, 0x80)"
        )
    return base_id | replica_index


def payload_crc(*arrays) -> int:
    """crc32 over a gradient batch's payload arrays, in order (each as its
    C-order bytes): the crc the journal records beside the id."""
    c = 0
    for a in arrays:
        c = zlib.crc32(np.ascontiguousarray(a).view(np.uint8).data, c)
    return c & 0xFFFFFFFF


# --------------------------------------------------------------- RNG streams


def capture_rng_streams(generators: Optional[Dict[str, np.random.Generator]] = None) -> Dict:
    """A JSON-able snapshot of numpy's global MT19937 state and of the named
    ``np.random.Generator``s the caller passes (a dataset's, say)."""
    kind, keys, pos, has_gauss, cached = np.random.get_state()
    out: Dict = {
        "numpy_global": [kind, np.asarray(keys).tolist(), int(pos), int(has_gauss), float(cached)],
    }
    for name, g in (generators or {}).items():
        out[f"gen:{name}"] = g.bit_generator.state
    return out


def restore_rng_streams(state: Dict, generators: Optional[Dict[str, np.random.Generator]] = None) -> None:
    g = state.get("numpy_global")
    if g:
        kind, keys, pos, has_gauss, cached = g
        np.random.set_state((kind, np.asarray(keys, dtype=np.uint32), int(pos), int(has_gauss), float(cached)))
    for name, gen in (generators or {}).items():
        s = state.get(f"gen:{name}")
        if s is not None:
            gen.bit_generator.state = s


# ------------------------------------------------------------------ manifest


class Manifest:
    """Read view of one committed epoch: ``meta`` is ``MANIFEST.json``; a
    blob is checked against its recorded size and crc32 on every read."""

    def __init__(self, epoch_dir: str, meta: Dict):
        self.dir = epoch_dir
        self.meta = meta

    @property
    def job_epoch(self) -> int:
        return int(self.meta["job_epoch"])

    @property
    def step(self) -> int:
        return int(self.meta.get("step", 0))

    @property
    def components(self) -> Dict[str, Dict]:
        return self.meta.get("components", {})

    def has(self, name: str) -> bool:
        return name in self.components

    def read_blob(self, name: str) -> bytes:
        comp = self.components.get(name)
        if comp is None:
            raise ManifestError(f"manifest {self.dir} has no component {name!r}")
        with open(os.path.join(self.dir, name), "rb") as f:
            data = f.read()
        if len(data) != int(comp["bytes"]) or (zlib.crc32(data) & 0xFFFFFFFF) != int(comp["crc32"]):
            raise CorruptManifestError(
                f"component {name!r} of {self.dir} is torn or corrupt "
                f"({len(data)} bytes, crc mismatch vs manifest record)"
            )
        return data

    def read_json(self, name: str):
        return json.loads(self.read_blob(name).decode())


class EpochWriter:
    """Collects one epoch's components, then commits its manifest (written
    last: until then the epoch is invisible)."""

    def __init__(self, root: str, job_epoch: int):
        self.root = root
        self.job_epoch = job_epoch
        self.dir = os.path.join(root, f"epoch_{job_epoch:08d}")
        self._components: Dict[str, Dict] = {}
        self._committed = False
        os.makedirs(self.dir, exist_ok=True)

    def add_blob(self, name: str, data: bytes) -> None:
        if self._committed:
            raise ManifestError("epoch already committed")
        fsync_write_bytes(os.path.join(self.dir, name), data)
        self._components[name] = {"bytes": len(data), "crc32": zlib.crc32(data) & 0xFFFFFFFF}

    def add_json(self, name: str, obj) -> None:
        self.add_blob(name, json.dumps(obj).encode())

    def commit(self, meta: Optional[Dict] = None) -> Manifest:
        """Publish ``MANIFEST.json``, then the ``LAST_GOOD`` pointer. A crash
        before the manifest leaves an invisible directory; one between the
        two is covered by the scan's newest-first fallback."""
        manifest = dict(meta or {})
        manifest["job_epoch"] = self.job_epoch
        manifest["components"] = self._components
        manifest.setdefault("datetime", time.strftime("%Y-%m-%dT%H:%M:%S"))
        fsync_write_bytes(os.path.join(self.dir, MANIFEST_NAME), json.dumps(manifest).encode())
        fsync_write_bytes(
            os.path.join(self.root, LAST_GOOD),
            json.dumps({"job_epoch": self.job_epoch, "dir": os.path.basename(self.dir)}).encode(),
        )
        self._committed = True
        return Manifest(self.dir, manifest)


class JobStateManager:
    """Owns a job-state root directory of epoch manifests."""

    def __init__(self, root: str):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)

    def _epoch_dirs(self) -> List[Tuple[int, str]]:
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        return sorted((int(m.group(1)), os.path.join(self.root, n))
                      for n in names if (m := _EPOCH_RE.match(n)))

    def begin_epoch(self) -> EpochWriter:
        dirs = self._epoch_dirs()
        return EpochWriter(self.root, dirs[-1][0] + 1 if dirs else 1)

    def _load_manifest(self, epoch_dir: str) -> Optional[Manifest]:
        """One epoch's manifest, or None unless its JSON parses and every
        component it names exists at its recorded size (the crc32 is
        checked per blob on read: the scan stays cheap)."""
        try:
            with open(os.path.join(epoch_dir, MANIFEST_NAME), "rb") as f:
                meta = json.loads(f.read().decode())
        except (OSError, ValueError):
            return None
        if "job_epoch" not in meta or "components" not in meta:
            return None
        for name, comp in meta["components"].items():
            try:
                if os.path.getsize(os.path.join(epoch_dir, name)) != int(comp["bytes"]):
                    return None
            except OSError:
                return None
        return Manifest(epoch_dir, meta)

    def latest(self) -> Optional[Manifest]:
        """The newest loadable manifest: ``LAST_GOOD``'s first, then a
        newest-first scan (a crash between manifest and pointer, or a
        pointer to an epoch since damaged)."""
        tried = set()
        ptr = self._read_pointer()
        if ptr is not None:
            d = os.path.join(self.root, ptr)
            tried.add(d)
            m = self._load_manifest(d)
            if m is not None:
                return m
            logger.warning("jobstate: LAST_GOOD points at %s, whose manifest does not verify; "
                           "falling back to the newest good epoch", ptr)
        for _, d in reversed(self._epoch_dirs()):
            if d not in tried and (m := self._load_manifest(d)) is not None:
                return m
        return None

    def _read_pointer(self) -> Optional[str]:
        try:
            with open(os.path.join(self.root, LAST_GOOD), "rb") as f:
                return json.loads(f.read().decode()).get("dir")
        except (OSError, ValueError):
            return None

    def prune(self, keep: int = 2) -> int:
        """Remove all but the newest ``keep`` good epochs, never the one
        ``LAST_GOOD`` names. Returns the directories removed."""
        ptr = self._read_pointer()
        good = [(e, d) for e, d in self._epoch_dirs() if self._load_manifest(d) is not None]
        removed = 0
        for _, d in (good[:-keep] if keep > 0 else good):
            if ptr is not None and os.path.basename(d) == ptr:
                continue
            shutil.rmtree(d, ignore_errors=True)
            removed += 1
        return removed


# --------------------------------------------------------- trainer snapshots


def coerce_manager(job_state: Union[str, JobStateManager]) -> JobStateManager:
    return job_state if isinstance(job_state, JobStateManager) else JobStateManager(job_state)


def snapshot_job(
    mgr: JobStateManager,
    step: int,
    *,
    state_bytes: Optional[bytes] = None,
    replicas: Optional[Sequence] = None,
    batch_advances: Optional[Dict[int, int]] = None,
    components: Optional[Dict[str, object]] = None,
    meta: Optional[Dict] = None,
    generators: Optional[Dict[str, np.random.Generator]] = None,
    blobs: Optional[Dict[str, bytes]] = None,
    timings: Optional[Dict[str, float]] = None,
) -> Manifest:
    """One step-fenced snapshot under a new epoch: PS shards, the dense
    state, JSON components, raw ``blobs`` and the RNG streams, committed at
    once. The caller holds the fence: nothing in flight (the loader
    flushed). ``timings``, where given, receives the ms of the PS capture
    (``ps_capture``), of the dense state's write (``dense_write``) and of
    the rest up to the commit (``commit``)."""
    t0 = time.perf_counter()
    writer = mgr.begin_epoch()
    m: Dict = {"step": int(step)}
    if replicas is not None:
        m.update(capture_ps(writer, replicas))
        if batch_advances:
            m["ps_batch_advances"] = {str(k): int(v) for k, v in batch_advances.items()}
    t1 = time.perf_counter()
    if state_bytes is not None:
        writer.add_blob("dense.state", state_bytes)
    t2 = time.perf_counter()
    for name, data in (blobs or {}).items():
        writer.add_blob(name, data)
    for name, obj in (components or {}).items():
        writer.add_json(name, obj)
    writer.add_json("rng.json", capture_rng_streams(generators))
    m.update(meta or {})
    manifest = writer.commit(m)
    mgr.prune(_KEEP_EPOCHS)
    if timings is not None:
        timings.update(ps_capture=(t1 - t0) * 1e3, dense_write=(t2 - t1) * 1e3,
                       commit=(time.perf_counter() - t2) * 1e3)
    return manifest


def resume_job(
    mgr: JobStateManager,
    *,
    replicas: Optional[Sequence] = None,
    rewind_ps: bool = True,
    optimizer=None,
    generators: Optional[Dict[str, np.random.Generator]] = None,
) -> Tuple[Optional[Manifest], Dict]:
    """The newest good manifest and the fence state rebuilt from it:
    ``(manifest or None, recovery info)``. ``rewind_ps`` rewinds the PS to
    the fence (``restore_ps``); without it the PS keeps its state and the
    replayed window's applies dedupe against the journal."""
    t0 = time.monotonic()
    manifest = mgr.latest()
    if manifest is None:
        return None, {"resumed": False, "step": 0, "job_epoch": 0}
    adv = {int(k): int(v) for k, v in manifest.meta.get("ps_batch_advances", {}).items()}
    restored = 0
    if rewind_ps and replicas is not None and manifest.meta.get("ps_replicas"):
        restored = restore_ps(manifest, replicas, optimizer=optimizer, batch_advances=adv)
    if manifest.has("rng.json"):
        restore_rng_streams(manifest.read_json("rng.json"), generators)
    info = {
        "resumed": True,
        "step": manifest.step,
        "job_epoch": manifest.job_epoch,
        "ps_rewound": bool(rewind_ps),
        "ps_entries_restored": restored,
        "time_to_resume_s": round(time.monotonic() - t0, 4),
        "batch_advances": adv,
    }
    return manifest, info


# -------------------------------------------------------- PS capture/restore


def _shard_blob_name(replica: int, shard: int) -> str:
    return os.path.join("ps", f"replica_{replica}_shard_{shard}.emb")


def capture_ps(writer: EpochWriter, replicas: Sequence) -> Dict:
    """Every replica's internal shards into the epoch; returns the topology
    the manifest records."""
    shards_per = []
    total = 0
    for ri, rep in enumerate(replicas):
        n = int(rep.num_internal_shards)
        shards_per.append(n)
        for si in range(n):
            blob = rep.dump_shard(si)
            writer.add_blob(_shard_blob_name(ri, si), blob)
            total += len(blob)
    return {"ps_replicas": len(replicas), "ps_internal_shards": shards_per, "ps_bytes": total}


def restore_ps(manifest: Manifest, replicas: Sequence, optimizer=None,
               batch_advances: Optional[Dict[int, int]] = None) -> int:
    """Rewind the replicas to the manifest's fence: each is cleared, its
    journal cleared (the ids past the fence must apply again), the
    optimizer registered, its shards loaded and Adam's batch powers
    advanced to the fence's counts. Returns the entries restored."""
    meta = manifest.meta
    n_reps = int(meta.get("ps_replicas", 0))
    if n_reps != len(replicas):
        raise ManifestError(
            f"manifest captured {n_reps} PS replicas but the resuming job has {len(replicas)}; "
            "re-shard through checkpoint.load_store instead"
        )
    shards_per = meta.get("ps_internal_shards", [])
    restored = 0
    for ri, rep in enumerate(replicas):
        rep.clear()
        rep.journal_clear()
        if optimizer is not None:
            rep.register_optimizer(optimizer)
        for si in range(int(shards_per[ri])):
            restored += rep.load_shard_bytes(manifest.read_blob(_shard_blob_name(ri, si)))
        for group, count in (batch_advances or {}).items():
            for _ in range(int(count)):
                rep.advance_batch_state(int(group))
    return restored
