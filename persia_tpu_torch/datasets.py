"""File-backed dataset readers producing ``PersiaBatch`` streams.

Counterpart of ``persia_tpu/datasets.py``: for the same file and arguments
every batch is byte for byte the reference reader's
(``PersiaBatch.to_bytes``). The reader covers the Criteo display-advertising
schema (the north-star bench config, BASELINE.json): streaming TSV —
optionally gzip'd, optionally parquet when pyarrow exists — into LIL
``PersiaBatch``es without materializing the file.

Criteo-Kaggle row format (tab-separated)::

    label \t I1..I13 (ints, may be empty) \t C1..C26 (hex ids, may be empty)

Dense integers go through the standard ``log(x+1)`` transform (negatives
clamp to 0 first); categorical hex ids become raw u64 signs — the PS tier
is a hash table over the full u64 space, so no vocabulary capping is
needed; empty categorical fields map to a per-slot out-of-band sentinel
sign so "missing" learns its own embedding.
"""

from __future__ import annotations

import gzip
import os
from typing import Iterator, List, Optional, Sequence

import numpy as np

from persia_tpu_torch.data import (
    IDTypeFeatureWithSingleID,
    Label,
    NonIDTypeFeature,
    PersiaBatch,
)

N_CRITEO_DENSE = 13
N_CRITEO_SPARSE = 26

# "missing categorical" sentinel base: far above the 32-bit hex-id space the
# Kaggle dataset uses, one sentinel per slot
_MISSING_BASE = np.uint64(1) << np.uint64(60)


class CriteoTSV:
    """Streaming Criteo TSV/parquet reader.

    ``batches(batch_size)`` yields ``PersiaBatch``es until the file ends;
    the final short batch is dropped by default (static device shapes),
    keep it with ``drop_remainder=False``. ``limit_batches`` bounds the
    stream (epoch budget control).
    """

    def __init__(
        self,
        path: str,
        slot_names: Optional[Sequence[str]] = None,
        requires_grad: bool = True,
    ):
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        self.path = path
        self.slot_names = (
            list(slot_names)
            if slot_names is not None
            else [f"cat_{i}" for i in range(N_CRITEO_SPARSE)]
        )
        if len(self.slot_names) != N_CRITEO_SPARSE:
            raise ValueError(
                f"Criteo schema has {N_CRITEO_SPARSE} categorical slots, "
                f"got {len(self.slot_names)} names"
            )
        self.requires_grad = requires_grad

    # ----------------------------------------------------------- row source

    def _rows(self) -> Iterator[List[str]]:
        if self.path.endswith(".parquet"):
            yield from self._parquet_rows()
            return
        opener = gzip.open if self.path.endswith(".gz") else open
        with opener(self.path, "rt") as f:
            for line in f:
                line = line.rstrip("\n")
                if line:
                    yield line.split("\t")

    def _parquet_rows(self) -> Iterator[List[str]]:
        try:
            import pyarrow.parquet as pq
        except ImportError as e:  # pragma: no cover - env-dependent
            raise RuntimeError(
                "parquet input needs pyarrow, which is not installed"
            ) from e
        table = pq.read_table(self.path)
        cols = [table.column(i).to_pylist() for i in range(table.num_columns)]
        for row in zip(*cols):
            yield ["" if v is None else str(v) for v in row]

    # -------------------------------------------------------------- batching

    def batches(
        self,
        batch_size: int,
        drop_remainder: bool = True,
        limit_batches: Optional[int] = None,
    ) -> Iterator[PersiaBatch]:
        labels: List[float] = []
        dense: List[List[float]] = []
        sparse: List[List[np.uint64]] = [[] for _ in range(N_CRITEO_SPARSE)]
        emitted = 0

        def flush() -> PersiaBatch:
            ids = [
                IDTypeFeatureWithSingleID(
                    self.slot_names[i], np.asarray(sparse[i], dtype=np.uint64)
                )
                for i in range(N_CRITEO_SPARSE)
            ]
            batch = PersiaBatch(
                ids,
                non_id_type_features=[
                    NonIDTypeFeature(np.asarray(dense, dtype=np.float32))
                ],
                labels=[
                    Label(np.asarray(labels, dtype=np.float32).reshape(-1, 1))
                ],
                requires_grad=self.requires_grad,
            )
            labels.clear()
            dense.clear()
            for s in sparse:
                s.clear()
            return batch

        for row in self._rows():
            if len(row) < 1 + N_CRITEO_DENSE + N_CRITEO_SPARSE:
                row = row + [""] * (
                    1 + N_CRITEO_DENSE + N_CRITEO_SPARSE - len(row)
                )
            labels.append(float(row[0]) if row[0] else 0.0)
            drow = []
            for i in range(N_CRITEO_DENSE):
                v = row[1 + i]
                x = float(v) if v else 0.0
                drow.append(float(np.log1p(max(x, 0.0))))
            dense.append(drow)
            for i in range(N_CRITEO_SPARSE):
                v = row[1 + N_CRITEO_DENSE + i]
                sparse[i].append(
                    np.uint64(int(v, 16)) if v
                    else _MISSING_BASE + np.uint64(i)
                )
            if len(labels) == batch_size:
                yield flush()
                emitted += 1
                if limit_batches is not None and emitted >= limit_batches:
                    return
        if labels and not drop_remainder:
            yield flush()
