"""Race-safe builds of the port's native host cores (counterpart of
``persia_tpu/embedding/_native_build.py``).

``build_so`` compiles C++ sources with ``g++`` into a shared library, once:

- the library is named by nothing but its path; a stamp beside it holds a
  hash of the source bytes and the full flag vector, and a library whose
  stamp differs is rebuilt (a flag change never reuses a stale build);
- concurrent builders (pytest workers, the loader's threads, a second
  process) serialise on an ``flock``'d lock file and re-check the stamp
  under it, so the losers load the winner's build;
- ``g++`` writes to a per-process temporary file that ``os.replace`` moves
  into place, so a concurrent ``dlopen`` sees the old library or the new
  one, never a mix.

Libraries land in ``build/torch_native/`` beside the package.
"""

from __future__ import annotations

import fcntl
import hashlib
import logging
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import List, Sequence

logger = logging.getLogger("persia_tpu_torch.native")

NATIVE_SRC = Path(__file__).resolve().parent.parent / "native"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "torch_native"

_PROC_LOCK = threading.Lock()


def cxx_flags() -> List[str]:
    """The reference's flags (``persia_tpu/embedding/native_store.py:37``),
    so both packages' cores compute the same floats on one machine; the
    x86 vector flags only where the host is x86-64."""
    arch = ["-mavx2", "-mfma"] if platform.machine() in ("x86_64", "AMD64") else []
    return ["-O3", *arch, "-std=c++17", "-fPIC", "-shared", "-Wall"]


def _build_hash(srcs: Sequence[Path], flags: Sequence[str]) -> str:
    h = hashlib.sha256()
    for p in srcs:
        h.update(hashlib.sha256(Path(p).read_bytes()).hexdigest().encode())
        h.update(b"\x00")
    h.update(("flags:" + "\x1f".join(flags)).encode())
    return h.hexdigest()


def _is_fresh(so: Path, stamp: Path, h: str) -> bool:
    return so.exists() and stamp.exists() and stamp.read_text().strip() == h


def build_so(srcs: Sequence[Path], name: str, flags: Sequence[str]) -> Path:
    """Build ``srcs`` into ``BUILD_DIR / name`` with ``g++`` unless a build
    of the same sources and flags is there; returns the library's path.
    Raises ``RuntimeError`` (``g++`` failed, its errors in the message) or
    ``OSError`` (no ``g++``) when it cannot build."""
    so = BUILD_DIR / name
    stamp = so.with_name(name + ".srchash")
    flags = list(flags)
    with _PROC_LOCK:
        h = _build_hash(srcs, flags)
        if _is_fresh(so, stamp, h):
            return so
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(so.with_name(name + ".lock"), "w") as lf:
            fcntl.flock(lf, fcntl.LOCK_EX)
            try:
                if _is_fresh(so, stamp, h):
                    return so  # another process built it meanwhile
                tmp = so.with_name(f"{name}.tmp.{os.getpid()}")
                cmd = ["g++", *flags, "-o", str(tmp), *map(str, srcs)]
                logger.info("building %s: %s", name, " ".join(cmd))
                try:
                    # blocking under the lock is the point: concurrent
                    # builders wait for one compile
                    res = subprocess.run(cmd, capture_output=True, text=True)
                    if res.returncode != 0:
                        raise RuntimeError(f"g++ failed to build {name}:\n{res.stderr}")
                    os.replace(tmp, so)
                finally:
                    if tmp.exists():
                        tmp.unlink()
                stamp_tmp = stamp.with_name(f"{stamp.name}.tmp.{os.getpid()}")
                stamp_tmp.write_text(h)
                os.replace(stamp_tmp, stamp)
                return so
            finally:
                fcntl.flock(lf, fcntl.LOCK_UN)
