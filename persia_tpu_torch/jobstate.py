"""Durable writes of job state (the part of ``persia_tpu/jobstate.py`` the
fused tier's checkpoint needs)."""

from __future__ import annotations

import os
import tempfile

# sampled once: the mode a published file gets is 0o666 less the umask
_UMASK = os.umask(0)
os.umask(_UMASK)


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
