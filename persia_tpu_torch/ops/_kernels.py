"""Build and load the port's CUDA kernels.

All sources under ``persia_tpu_torch/csrc`` are compiled by ``nvcc`` for
``sm_90a`` (one process per source, all started together), linked into one
shared library with a plain C interface, and loaded with ``ctypes``. The
library lands in ``build/torch_kernels/`` beside the package, named by a
hash of the sources and flags, so an edited source builds anew and an
unchanged one is reused. Nothing is built until a kernel is first launched.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

DTYPE_F32 = 0
DTYPE_BF16 = 1

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# what the last build printed (ptxas registers / shared memory / spills per
# kernel) and how long it took; empty when the library was already built
build_log = ""
build_seconds = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: no CUDA toolkit on PATH or CUDA_HOME")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    sources, headers = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources + headers:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libpersia_torch_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile and link the kernel library unless it is already built."""
    global build_log, build_seconds
    so = library_path()
    if so.exists():
        return so
    t0 = time.perf_counter()
    nvcc = _nvcc()
    sources, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in sources]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(sources, objs)
        ]
        logs = []
        failed = []
        for src, p in zip(sources, procs):
            out, _ = p.communicate()
            logs.append(f"== {src.name}\n{out}")
            if p.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_so = os.path.join(tmp, so.name)
        link = subprocess.run(
            [nvcc, "-shared", "-o", tmp_so, *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernel library failed:\n{link.stdout}")
        os.replace(tmp_so, so)  # atomic: a concurrent loader sees all or nothing
    build_log = "\n".join(logs)
    build_seconds = time.perf_counter() - t0
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.persia_dot_interaction.restype = i32
            lib.persia_dot_interaction.argtypes = [vp, vp, i32, i32, i32, i32, i32, i32, i32, i32, vp]
            lib.persia_tf32_split.restype = i32
            lib.persia_tf32_split.argtypes = [vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, vp]
            lib.persia_flash_attention_fwd_tf32x3.restype = i32
            lib.persia_flash_attention_fwd_tf32x3.argtypes = [
                vp, vp, vp, i32, i32, i32, i32, f32, i32,
                i32, i32, i32, i32, i32, i32, i32, i32, i32, vp,
            ]
            lib.persia_dot_interaction_bwd.restype = i32
            lib.persia_dot_interaction_bwd.argtypes = [vp, vp, vp, i32, i32, i32, i32, i32, i32, i32, i32, vp]
            lib.persia_gather_pool_fwd.restype = i32
            lib.persia_gather_pool_fwd.argtypes = [vp, vp, i32, i32, i32, i32, i32, i32, i32, i32, i32, vp]
            lib.persia_gather_pool_bwd.restype = i32
            lib.persia_gather_pool_bwd.argtypes = [
                vp, vp, vp, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, vp,
            ]
            lib.persia_flash_attention_fwd_wgmma.restype = i32
            lib.persia_flash_attention_fwd_wgmma.argtypes = [
                vp, vp, vp, vp, i32, i32, i32, i32, f32, i32,
                i32, i32, i32, i32, i32, i32, i32, i32, vp,
            ]
            lib.persia_fused_gather.restype = i32
            lib.persia_fused_gather.argtypes = [vp, i32, ctypes.c_longlong, i32, vp, i32, i32, vp, vp, vp]
            lib.persia_sparse_update.restype = i32
            lib.persia_sparse_update.argtypes = [
                vp, i32, ctypes.c_longlong, i32, vp, vp, vp, vp, vp, i32, vp,
                i32, i32, f32, f32, f32, f32, f32, f32, f32, f32,
                vp, i32, i32, vp,
            ]
            lib.persia_update_keys.restype = i32
            lib.persia_update_keys.argtypes = [vp, i32, vp, vp]
            lib.persia_raw_gather_fwd.restype = i32
            lib.persia_raw_gather_fwd.argtypes = [vp, vp, i32, i32, i32, i32, i32, i32, i32, i32, i32, vp]
            lib.persia_raw_gather_bwd.restype = i32
            lib.persia_raw_gather_bwd.argtypes = [vp, vp, vp, *[i32] * 13, vp]
            lib.persia_attention_pool_fwd.restype = i32
            lib.persia_attention_pool_fwd.argtypes = [vp, vp, vp, vp, vp, *[i32] * 8, vp]
            lib.persia_attention_pool_bwd.restype = i32
            lib.persia_attention_pool_bwd.argtypes = [vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, i32,
                                                      i32, i32, vp]
            lib.persia_batch_norm_fwd.restype = i32
            lib.persia_batch_norm_fwd.argtypes = [vp] * 7 + [i32] * 4 + [f32] * 3 + [i32] * 5 + [vp]
            lib.persia_batch_norm_bwd.restype = i32
            lib.persia_batch_norm_bwd.argtypes = [vp] * 7 + [i32] * 9 + [vp]
            ll = ctypes.c_longlong
            lib.persia_cache_aux.restype = i32
            lib.persia_cache_aux.argtypes = [vp, i32, ll, i32, vp, i32, vp, i32, i32, vp, i32, vp, i32,
                                             vp, vp, i32, vp, i32, vp, vp, i32, vp, i32, f32, f32,
                                             vp, vp, vp, i32, vp, i32, vp, ll, i32, ll, vp]
            lib.persia_entry_rows.restype = i32
            lib.persia_entry_rows.argtypes = [vp, i32, ll, i32, vp, i32, vp, i32, i32, vp, i32, vp, vp]
            lib.persia_cached_gather.restype = i32
            lib.persia_cached_gather.argtypes = [vp, i32, ll, i32, vp, ll, vp, ll, i32, vp, i32, vp, vp, vp, vp]
            lib.persia_quantize_int8_ef.restype = i32
            lib.persia_quantize_int8_ef.argtypes = [vp, i32, vp, ctypes.POINTER(i32), i32, vp, vp, vp, vp, vp,
                                                    i32, i32, i32, i32, vp]
            lib.persia_segment_absmax.restype = i32
            lib.persia_segment_absmax.argtypes = [vp, i32, vp, ctypes.POINTER(i32), i32, vp, vp, *[i32] * 5, vp]
            lib.persia_quantize_int8_shared.restype = i32
            lib.persia_quantize_int8_shared.argtypes = [vp, i32, vp, ctypes.POINTER(i32), i32, vp, vp, vp, vp,
                                                        *[i32] * 5, vp]
            lib.persia_stream_capture.restype = i32
            lib.persia_stream_capture.argtypes = [vp, ctypes.POINTER(i32), ctypes.POINTER(ctypes.c_ulonglong)]
            lib.persia_block_int8_quantize.restype = i32
            lib.persia_block_int8_quantize.argtypes = [vp, vp, i32, i32, vp, vp, vp, i32, i32, i32, vp]
            lib.persia_block_requantize_int8.restype = i32
            lib.persia_block_requantize_int8.argtypes = [vp, vp, vp, vp, i32, i32, vp, vp, vp, vp, i32, i32, i32, vp]
            lib.persia_block_int8_dequantize.restype = i32
            lib.persia_block_int8_dequantize.argtypes = [vp, vp, i32, ll, i32, i32, vp, vp, vp, i32, i32, i32, vp]
            lib.persia_lp_ring_mix.restype = i32
            lib.persia_lp_ring_mix.argtypes = [vp] * 10 + [ctypes.POINTER(i32), i32, i32, i32, vp]
            _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def stream_handle(tensor: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on the tensor's device."""
    return torch.cuda.current_stream(tensor.device).cuda_stream


def capture_id(stream: int) -> Optional[int]:
    """The id of the CUDA graph capture that ``stream`` (a raw handle) is
    in, None when it is in none."""
    capturing, cid = ctypes.c_int(0), ctypes.c_ulonglong(0)
    check(library().persia_stream_capture(stream, ctypes.byref(capturing), ctypes.byref(cid)), "stream_capture")
    return cid.value if capturing.value else None
