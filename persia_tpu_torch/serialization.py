"""The msgpack subset that ``flax.serialization`` writes, in numpy alone (the
port imports neither flax nor msgpack), so the port reads and writes the
reference's dense-state bytes.

``msgpack_serialize(tree)`` gives the bytes of
``flax.serialization.msgpack_serialize`` for a tree of dicts (str keys, in
their order), None, bools, ints, floats, strs, bytes, lists, numpy arrays
and numpy scalars: every integer and length in its shortest msgpack form,
floats as float64. An array is ext 1 holding the packed ``(shape, dtype
name, C-order bytes)``; a numpy scalar ext 3 holding the same for its
0-d array; an array over ``MAX_CHUNK_SIZE`` bytes the chunked map flax
writes. ``msgpack_restore`` reads them back. numpy has no bfloat16: a
bfloat16 array is held as its raw 16-bit words in a 2-byte void dtype
(``BF16``) and named ``bfloat16`` in the bytes.
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple

import numpy as np

BF16 = np.dtype("V2")  # a bfloat16 array's raw 16-bit words
MAX_CHUNK_SIZE = 2 ** 30  # flax's: arrays of more bytes are written in chunks
_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


def _dtype_name(dt: np.dtype) -> str:
    return "bfloat16" if dt == BF16 else dt.name


def _dtype_from_name(name: str) -> np.dtype:
    return BF16 if name == "bfloat16" else np.dtype(name)


def _pack_len(out: List[bytes], n: int, fix: int, fix_max: int, codes: Tuple[int, int, int]) -> None:
    """A length header: ``fix | n`` below ``fix_max`` (fix None: no fix
    form), else the 8-, 16- or 32-bit form of ``codes`` (None: absent)."""
    if fix is not None and n < fix_max:
        out.append(bytes([fix | n]))
    elif codes[0] is not None and n < 1 << 8:
        out.append(struct.pack(">BB", codes[0], n))
    elif n < 1 << 16:
        out.append(struct.pack(">BH", codes[1], n))
    elif n < 1 << 32:
        out.append(struct.pack(">BI", codes[2], n))
    else:
        raise ValueError(f"msgpack length {n} out of range")


def _pack_int(out: List[bytes], v: int) -> None:
    if 0 <= v < 128:
        out.append(bytes([v]))
    elif -32 <= v < 0:
        out.append(struct.pack(">b", v))
    elif v >= 0:
        for code, fmt, lim in ((0xCC, ">BB", 1 << 8), (0xCD, ">BH", 1 << 16), (0xCE, ">BI", 1 << 32),
                               (0xCF, ">BQ", 1 << 64)):
            if v < lim:
                out.append(struct.pack(fmt, code, v))
                return
        raise ValueError(f"integer {v} out of msgpack's range")
    else:
        for code, fmt, lim in ((0xD0, ">Bb", 1 << 7), (0xD1, ">Bh", 1 << 15), (0xD2, ">Bi", 1 << 31),
                               (0xD3, ">Bq", 1 << 63)):
            if v >= -lim:
                out.append(struct.pack(fmt, code, v))
                return
        raise ValueError(f"integer {v} out of msgpack's range")


def _pack_ext(out: List[bytes], code: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(bytes([fixed[n], code]))
    else:
        _pack_len(out, n, None, 0, (0xC7, 0xC8, 0xC9))
        out.append(bytes([code]))
    out.append(data)


def _ndarray_payload(a: np.ndarray) -> bytes:
    out: List[bytes] = []
    _pack(out, [list(a.shape), _dtype_name(a.dtype), np.ascontiguousarray(a).tobytes()])
    return b"".join(out)


def _chunk(a: np.ndarray) -> dict:
    """flax's chunked form of an array over ``MAX_CHUNK_SIZE`` bytes."""
    size = max(1, MAX_CHUNK_SIZE // a.dtype.itemsize)
    flat = a.reshape(-1)
    return {_CHUNKED: True,
            "shape": {str(i): d for i, d in enumerate(a.shape)},
            "chunks": {str(i): flat[o:o + size] for i, o in enumerate(range(0, flat.size, size))}}


def _pack(out: List[bytes], x: Any) -> None:
    if x is None:
        out.append(b"\xc0")
    elif x is True or x is False:
        out.append(b"\xc3" if x else b"\xc2")
    elif isinstance(x, np.ndarray):
        if x.dtype.hasobject:
            raise ValueError("object arrays cannot be serialized")
        if x.size * x.dtype.itemsize > MAX_CHUNK_SIZE:
            _pack(out, _chunk(x))
        else:
            _pack_ext(out, _EXT_NDARRAY, _ndarray_payload(x))
    elif isinstance(x, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_payload(np.asarray(x)))
    elif type(x) is int:
        _pack_int(out, x)
    elif type(x) is float:
        out.append(struct.pack(">Bd", 0xCB, x))
    elif type(x) is str:
        b = x.encode()
        _pack_len(out, len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out.append(b)
    elif type(x) in (bytes, bytearray):
        _pack_len(out, len(x), None, 0, (0xC4, 0xC5, 0xC6))
        out.append(bytes(x))
    elif type(x) is dict:
        _pack_len(out, len(x), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    elif type(x) is list:
        _pack_len(out, len(x), 0x90, 16, (None, 0xDC, 0xDD))
        for v in x:
            _pack(out, v)
    else:
        raise TypeError(f"cannot serialize {type(x).__name__}")


def msgpack_serialize(tree) -> bytes:
    """The bytes of ``flax.serialization.msgpack_serialize(tree)``."""
    out: List[bytes] = []
    _pack(out, tree)
    return b"".join(out)


class _Reader:
    def __init__(self, raw: bytes):
        self.buf = memoryview(raw)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        v = self.buf[self.pos:self.pos + n]
        self.pos += n
        return v

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        c = self.unpack(">B")
        if c < 0x80:
            return c
        if c >= 0xE0:
            return c - 0x100
        if c < 0x90:
            return self._map(c & 0x0F)
        if c < 0xA0:
            return [self.value() for _ in range(c & 0x0F)]
        if c < 0xC0:
            return bytes(self.take(c & 0x1F)).decode()
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}  # bin
        if c in sized:
            return bytes(self.take(self.unpack(sized[c])))
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if c in strs:
            return bytes(self.take(self.unpack(strs[c]))).decode()
        nums = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if c in nums:
            return self.unpack(nums[c])
        if c in (0xDC, 0xDD):
            return [self.value() for _ in range(self.unpack(">H" if c == 0xDC else ">I"))]
        if c in (0xDE, 0xDF):
            return self._map(self.unpack(">H" if c == 0xDE else ">I"))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if c in fixext:
            n = fixext[c]
        elif c in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[c])
        else:
            raise ValueError(f"unsupported msgpack type byte {c:#x}")
        code = self.unpack(">b")
        return _ext(code, bytes(self.take(n)))

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def _ext(code: int, data: bytes):
    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
        raise ValueError(f"unsupported msgpack ext type {code}")
    r = _Reader(data)
    shape, name, buf = r.value()
    a = np.frombuffer(buf, dtype=_dtype_from_name(name)).reshape(shape)
    return a[()] if code == _EXT_NPSCALAR else a


def _unchunk(tree):
    if type(tree) is not dict:
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(raw: bytes):
    """The tree of ``flax.serialization.msgpack_restore(raw)``: arrays as
    numpy (read-only views of ``raw``), chunked arrays joined."""
    r = _Reader(raw)
    tree = r.value()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes after the msgpack value")
    return _unchunk(tree)
