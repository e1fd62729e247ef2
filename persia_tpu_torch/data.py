"""Batch datatypes + binary wire format (counterpart of ``persia_tpu/data.py``).

The wire format is byte for byte the one ``persia_tpu`` writes, so a batch
serialized by either package loads in the other: magic ``PTB1``, a
little-endian header, CSR id slots (u32 offsets + u64 signs), then the
dense features and labels as (name, dtype code, shape, bytes) records.
"""

from __future__ import annotations

import io
import os
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from persia_tpu_torch.config import MAX_BATCH_SIZE

_MAGIC = b"PTB1"

_DTYPE_CODES: Dict[str, int] = {
    "float32": 0,
    "float64": 1,
    "float16": 2,
    "int8": 3,
    "int16": 4,
    "int32": 5,
    "int64": 6,
    "uint8": 7,
    "uint16": 8,
    "uint32": 9,
    "uint64": 10,
    "bool": 11,
}
_CODE_DTYPES = {v: np.dtype(k) for k, v in _DTYPE_CODES.items()}


def _skip_check_data() -> bool:
    """``PERSIA_SKIP_CHECK_DATA=1`` skips per-sample validation on the
    ingest path (the same switch ``persia_tpu`` reads)."""
    return os.environ.get("PERSIA_SKIP_CHECK_DATA", "0") == "1"


def _check_dtype(array: np.ndarray, who: str) -> None:
    if array.dtype.name not in _DTYPE_CODES:
        raise TypeError(f"{who}: unsupported dtype {array.dtype}")


class IDTypeFeature:
    """One sparse slot: a list-of-lists of u64 signs, one variable-length
    list per sample, kept in CSR form (``flat`` ids + per-sample ``counts``);
    the list-of-arrays ``data`` view is materialized lazily."""

    def __init__(self, name: str, data: Optional[Sequence[np.ndarray]]):
        self.name = name
        self._flat: Optional[np.ndarray] = None
        self._counts: Optional[np.ndarray] = None
        if data is None:  # from_flat path fills _flat/_counts
            self._data: Optional[List[np.ndarray]] = None
            return
        data = list(data)
        if len(data) > MAX_BATCH_SIZE:
            raise ValueError(f"batch_size {len(data)} exceeds MAX_BATCH_SIZE {MAX_BATCH_SIZE}")
        if not _skip_check_data():
            for sample in data:
                if not isinstance(sample, np.ndarray) or sample.dtype != np.uint64:
                    raise TypeError(
                        f"IDTypeFeature {name!r}: every sample must be a np.uint64 ndarray"
                    )
                if sample.ndim != 1:
                    raise TypeError(f"IDTypeFeature {name!r}: samples must be 1-D")
        self._data = data

    @classmethod
    def from_flat(cls, name: str, flat: np.ndarray, counts: np.ndarray) -> "IDTypeFeature":
        """Construct directly from the CSR form. ``flat``: all ids
        concatenated (u64); ``counts``: ids per sample."""
        if flat.dtype != np.uint64 or flat.ndim != 1:
            raise TypeError(f"IDTypeFeature {name!r}: flat must be 1-D np.uint64")
        counts = np.ascontiguousarray(counts, dtype=np.int64)
        if len(counts) > MAX_BATCH_SIZE:
            raise ValueError(
                f"batch_size {len(counts)} exceeds MAX_BATCH_SIZE {MAX_BATCH_SIZE}"
            )
        if int(counts.sum()) != len(flat):
            raise ValueError(f"IDTypeFeature {name!r}: counts sum != len(flat)")
        f = cls(name, None)
        f._flat = np.ascontiguousarray(flat)
        f._counts = counts
        return f

    def flat_counts(self) -> Tuple[np.ndarray, np.ndarray]:
        """(flat ids (n,), counts (B,)) — computed once and cached."""
        if self._flat is None:
            data = self._data
            self._counts = np.fromiter((len(s) for s in data), count=len(data), dtype=np.int64)
            self._flat = np.concatenate(data) if self._counts.sum() else np.empty(0, np.uint64)
        return self._flat, self._counts

    @property
    def data(self) -> List[np.ndarray]:
        if self._data is None:
            if len(self._counts) == 0:
                self._data = []
            else:
                self._data = np.split(self._flat, np.cumsum(self._counts[:-1]))
        return self._data

    @property
    def batch_size(self) -> int:
        return len(self._counts) if self._counts is not None else len(self._data)

    def __len__(self) -> int:
        return self.batch_size


class IDTypeFeatureWithSingleID:
    """One sparse slot where each sample has exactly one id."""

    def __init__(self, name: str, data: np.ndarray):
        if not isinstance(data, np.ndarray) or data.dtype != np.uint64 or data.ndim != 1:
            raise TypeError(
                f"IDTypeFeatureWithSingleID {name!r}: data must be a 1-D np.uint64 ndarray"
            )
        if len(data) > MAX_BATCH_SIZE:
            raise ValueError(f"batch_size {len(data)} exceeds MAX_BATCH_SIZE {MAX_BATCH_SIZE}")
        self.name = name
        self.data = data

    @property
    def batch_size(self) -> int:
        return len(self.data)

    def to_lil(self) -> IDTypeFeature:
        return IDTypeFeature.from_flat(self.name, self.data, np.ones(len(self.data), dtype=np.int64))


class NdarrayDataBase:
    """Dense ndarray payload with name + dtype validation."""

    DEFAULT_NAME = "ndarray_base"

    def __init__(self, data: np.ndarray, name: Optional[str] = None):
        if not isinstance(data, np.ndarray):
            raise TypeError(f"{self.DEFAULT_NAME}: data must be an ndarray")
        _check_dtype(data, self.DEFAULT_NAME)
        if data.ndim < 1:
            raise TypeError(f"{self.DEFAULT_NAME}: data must have at least 1 dim")
        if len(data) > MAX_BATCH_SIZE:
            raise ValueError(f"batch_size {len(data)} exceeds MAX_BATCH_SIZE {MAX_BATCH_SIZE}")
        self.data = np.ascontiguousarray(data)
        self._name = name

    @property
    def name(self) -> str:
        return self._name if self._name is not None else self.DEFAULT_NAME

    @property
    def batch_size(self) -> int:
        return len(self.data)

    def __len__(self) -> int:
        return len(self.data)


class NonIDTypeFeature(NdarrayDataBase):
    DEFAULT_NAME = "non_id_type_feature"


class Label(NdarrayDataBase):
    DEFAULT_NAME = "label"


def _write_ndarray(buf: io.BytesIO, name: str, arr: np.ndarray) -> None:
    name_b = name.encode()
    buf.write(struct.pack("<H", len(name_b)))
    buf.write(name_b)
    buf.write(struct.pack("<BB", _DTYPE_CODES[arr.dtype.name], arr.ndim))
    buf.write(struct.pack(f"<{arr.ndim}q", *arr.shape))
    buf.write(arr.tobytes())


def _read_ndarray(buf: io.BytesIO) -> Tuple[str, np.ndarray]:
    (name_len,) = struct.unpack("<H", buf.read(2))
    name = buf.read(name_len).decode()
    code, ndim = struct.unpack("<BB", buf.read(2))
    shape = struct.unpack(f"<{ndim}q", buf.read(8 * ndim))
    dtype = _CODE_DTYPES[code]
    n = int(np.prod(shape)) if shape else 1
    # copy: frombuffer views are read-only; deserialized batches must behave
    # like locally-constructed (writable) ones
    arr = np.frombuffer(buf.read(n * dtype.itemsize), dtype=dtype).reshape(shape).copy()
    return name, arr


class PersiaBatch:
    """One batch: sparse id slots + dense features + labels + meta.
    ``requires_grad=True`` batches must carry labels."""

    def __init__(
        self,
        id_type_features: Sequence,
        non_id_type_features: Optional[Sequence[NonIDTypeFeature]] = None,
        labels: Optional[Sequence[Label]] = None,
        requires_grad: bool = True,
        batch_id: Optional[int] = None,
        meta: Optional[bytes] = None,
    ):
        if len(id_type_features) == 0:
            raise ValueError("id_type_features must be non-empty")
        converted: List[IDTypeFeature] = []
        for f in id_type_features:
            if isinstance(f, IDTypeFeatureWithSingleID):
                f = f.to_lil()
            elif not isinstance(f, IDTypeFeature):
                raise TypeError(f"unsupported id feature type {type(f)}")
            converted.append(f)
        batch_size = converted[0].batch_size
        for f in converted:
            if f.batch_size != batch_size:
                raise ValueError(f"id feature {f.name!r} batch_size {f.batch_size} != {batch_size}")
        non_id_type_features = list(non_id_type_features or [])
        labels_list = list(labels or [])
        for x in non_id_type_features + labels_list:
            if x.batch_size != batch_size:
                raise ValueError(f"{x.name!r} batch_size {x.batch_size} != {batch_size}")
        if requires_grad and not labels_list:
            raise ValueError("requires_grad=True batch must carry labels")
        if batch_id is not None and batch_id < 0:
            raise ValueError("batch_id must be non-negative")

        self.id_type_features = converted
        self.non_id_type_features = non_id_type_features
        self.labels = labels_list
        self.requires_grad = requires_grad
        self.batch_id = batch_id
        self.meta = meta

    @property
    def batch_size(self) -> int:
        return self.id_type_features[0].batch_size

    def to_bytes(self) -> bytes:
        """Serialize to the shared wire format."""
        buf = io.BytesIO()
        buf.write(_MAGIC)
        flags = 1 if self.requires_grad else 0
        if self.meta is not None:
            flags |= 2
        batch_id = self.batch_id if self.batch_id is not None else -1
        meta = self.meta or b""
        buf.write(
            struct.pack(
                "<BqIHHH",
                flags,
                batch_id,
                len(meta),
                len(self.id_type_features),
                len(self.non_id_type_features),
                len(self.labels),
            )
        )
        buf.write(meta)
        for f in self.id_type_features:
            name_b = f.name.encode()
            buf.write(struct.pack("<H", len(name_b)))
            buf.write(name_b)
            values, counts = f.flat_counts()
            offsets = np.zeros(len(counts) + 1, dtype=np.int64)
            np.cumsum(counts, out=offsets[1:])
            if offsets[-1] > 0xFFFFFFFF:
                raise ValueError(
                    f"id feature {f.name!r}: {offsets[-1]} total ids exceeds the "
                    f"u32 wire offset limit"
                )
            buf.write(struct.pack("<I", len(counts)))
            buf.write(offsets.astype(np.uint32).tobytes())
            if len(counts):
                buf.write(values.astype(np.uint64, copy=False).tobytes())
        for x in self.non_id_type_features:
            _write_ndarray(buf, x.name, x.data)
        for x in self.labels:
            _write_ndarray(buf, x.name, x.data)
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, raw: bytes) -> "PersiaBatch":
        buf = io.BytesIO(raw)
        if buf.read(4) != _MAGIC:
            raise ValueError("bad magic: not a PersiaBatch payload")
        flags, batch_id, meta_len, n_id, n_dense, n_label = struct.unpack(
            "<BqIHHH", buf.read(struct.calcsize("<BqIHHH"))
        )
        meta = buf.read(meta_len) if flags & 2 else None
        id_feats = []
        for _ in range(n_id):
            (name_len,) = struct.unpack("<H", buf.read(2))
            name = buf.read(name_len).decode()
            (bs,) = struct.unpack("<I", buf.read(4))
            offsets = np.frombuffer(buf.read(4 * (bs + 1)), dtype=np.uint32)
            values = np.frombuffer(buf.read(8 * int(offsets[-1])), dtype=np.uint64).copy()
            counts = np.diff(offsets.astype(np.int64))
            id_feats.append(IDTypeFeature.from_flat(name, values, counts))
        dense = []
        for _ in range(n_dense):
            name, arr = _read_ndarray(buf)
            dense.append(NonIDTypeFeature(arr, name=name))
        labels = []
        for _ in range(n_label):
            name, arr = _read_ndarray(buf)
            labels.append(Label(arr, name=name))
        return cls(
            id_feats,
            non_id_type_features=dense,
            labels=labels,
            requires_grad=bool(flags & 1),
            batch_id=None if batch_id == -1 else batch_id,
            meta=meta,
        )
