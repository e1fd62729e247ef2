"""The port's Criteo and 100T data sources against the reference's, byte
for byte (``PersiaBatch.to_bytes``: ids, dense features, labels and
``batch_id``):

- ``CriteoSynthetic`` (``persia_tpu_torch/testing/datasets.py``) at the
  Kaggle and 1TB vocabularies, several seeds, a ``start_batch_id`` and a
  short last batch; ``Synthetic100T``; the vocabulary tables;
- ``CriteoTSV`` (``persia_tpu_torch/datasets.py``) over
  ``tests/fixtures/criteo_tiny.tsv``, a gzip copy, missing fields,
  negative and empty integers, short rows, the remainder and the limit; a
  TSV written from the port's ``CriteoSynthetic`` the way
  ``benchmarks/criteo_file_auc.py`` writes one; parquet through pyarrow,
  and the ``RuntimeError`` where pyarrow does not import.
"""

import gzip
import pathlib
import shutil
import sys

import numpy as np
import pytest

import persia_tpu.datasets as ref_files
import persia_tpu.testing as ref
import persia_tpu_torch.datasets as port_files
import persia_tpu_torch.testing as port

FIXTURE = pathlib.Path(__file__).resolve().parent / "fixtures" / "criteo_tiny.tsv"


def _same_batches(ours, theirs, n=None):
    ours, theirs = list(ours), list(theirs)
    assert len(ours) == len(theirs)
    if n is not None:
        assert len(ours) == n
    for a, b in zip(ours, theirs):
        assert a.batch_id == b.batch_id
        assert a.to_bytes() == b.to_bytes()
    return ours


def test_vocab_tables_are_the_references():
    assert tuple(port.CRITEO_KAGGLE_VOCABS) == tuple(ref.CRITEO_KAGGLE_VOCABS)
    assert tuple(port.CRITEO_1TB_VOCABS) == tuple(ref.CRITEO_1TB_VOCABS)
    assert port.CRITEO_NUM_DENSE == ref.datasets.CRITEO_NUM_DENSE == 13
    assert sum(port.CRITEO_1TB_VOCABS) == 183_873_726


@pytest.mark.parametrize("scale", ["kaggle", "1tb"])
@pytest.mark.parametrize("seed,task_seed", [(0, 7), (42, 7), (5, 7), (4242, 11)])
def test_criteo_synthetic_batches_are_the_references(scale, seed, task_seed):
    """Three full batches and a short fourth, from batch id 3."""
    vocabs = port.CRITEO_KAGGLE_VOCABS if scale == "kaggle" else port.CRITEO_1TB_VOCABS
    kw = dict(num_samples=3 * 128 + 37, vocab_sizes=vocabs, seed=seed, task_seed=task_seed)
    ours = _same_batches(port.CriteoSynthetic(**kw).batches(128, start_batch_id=3),
                         ref.CriteoSynthetic(**kw).batches(128, start_batch_id=3), n=4)
    assert [b.batch_id for b in ours] == [3, 4, 5, 6]
    assert len(ours[-1].labels[0].data) == 37
    ids = np.asarray(ours[0].id_type_features[0].data)
    assert ids.dtype == np.uint64 and (ids < vocabs[0]).all()


def test_criteo_synthetic_quality_stream_is_the_references():
    """The quality gate's stream: [1M] x 26, seed 5, task seed 7, no grad."""
    kw = dict(num_samples=2 * 512, vocab_sizes=[1_000_000] * 26, seed=5, task_seed=7, noise=0.5)
    _same_batches(port.CriteoSynthetic(**kw).batches(512, requires_grad=False),
                  ref.CriteoSynthetic(**kw).batches(512, requires_grad=False), n=2)


@pytest.mark.parametrize("kw", [dict(), dict(num_slots=3, ids_per_sample=1, seed=7),
                                dict(num_slots=8, ids_per_sample=5, seed=0)])
def test_synthetic_100t_batches_are_the_references(kw):
    args = dict(num_samples=2 * 64 + 9, **kw)
    ours = _same_batches(port.Synthetic100T(**args).batches(64, start_batch_id=1),
                         ref.Synthetic100T(**args).batches(64, start_batch_id=1), n=3)
    f = ours[0].id_type_features[0]
    assert len(f.data) == 64 and all(len(x) == args.get("ids_per_sample", 4) for x in f.data)


# ------------------------------------------------------------ CriteoTSV


@pytest.mark.parametrize("batch_size", [1, 7, 64, 5000])
@pytest.mark.parametrize("drop_remainder", [True, False])
def test_tsv_fixture_batches_are_the_references(batch_size, drop_remainder):
    kw = dict(batch_size=batch_size, drop_remainder=drop_remainder)
    ours = _same_batches(port_files.CriteoTSV(str(FIXTURE)).batches(**kw),
                         ref_files.CriteoTSV(str(FIXTURE)).batches(**kw))
    rows = sum(1 for line in FIXTURE.read_text().splitlines() if line)
    assert len(ours) == (rows // batch_size if drop_remainder else -(-rows // batch_size))


@pytest.mark.parametrize("limit", [1, 3, 1000])
def test_tsv_limit_batches_is_the_references(limit):
    kw = dict(batch_size=16, limit_batches=limit, drop_remainder=False)
    ours = _same_batches(port_files.CriteoTSV(str(FIXTURE)).batches(**kw),
                         ref_files.CriteoTSV(str(FIXTURE)).batches(**kw))
    assert len(ours) <= limit


def test_tsv_gzip_is_the_references(tmp_path):
    gz = tmp_path / "criteo_tiny.tsv.gz"
    with open(FIXTURE, "rb") as src, gzip.open(gz, "wb") as dst:
        shutil.copyfileobj(src, dst)
    plain = list(port_files.CriteoTSV(str(FIXTURE)).batches(32, drop_remainder=False))
    ours = _same_batches(port_files.CriteoTSV(str(gz)).batches(32, drop_remainder=False),
                         ref_files.CriteoTSV(str(gz)).batches(32, drop_remainder=False))
    assert [a.to_bytes() for a in ours] == [a.to_bytes() for a in plain]


def test_tsv_missing_fields_short_rows_and_sentinels(tmp_path):
    """Empty labels, integers and categories, negative integers, rows cut
    short (one holds only its label), blank lines skipped; each empty
    category is the slot's sentinel 1 << 60 | slot."""
    rows = [
        "1\t" + "\t".join(["3", "", "-5"] + ["7"] * 10) + "\t" + "\t".join(["a1", ""] + ["ff"] * 24),
        "\t" + "\t".join([""] * 13) + "\t" + "\t".join([""] * 26),
        "0\t12\t0",
        "",
        "1",
        "0\t" + "\t".join(["1"] * 13) + "\t" + "\t".join(format(i * 977, "x") for i in range(26)),
    ]
    path = tmp_path / "rows.tsv"
    path.write_text("\n".join(rows) + "\n")
    (ours,) = _same_batches(port_files.CriteoTSV(str(path)).batches(8, drop_remainder=False),
                            ref_files.CriteoTSV(str(path)).batches(8, drop_remainder=False))
    labels = np.asarray(ours.labels[0].data).reshape(-1)
    np.testing.assert_array_equal(labels, [1, 0, 0, 1, 0])
    dense = np.asarray(ours.non_id_type_features[0].data)
    assert dense[0, 2] == 0.0 and dense[0, 0] == np.float32(np.log1p(3.0))
    cat1 = np.asarray(ours.id_type_features[1].data)
    assert cat1[0] == (1 << 60) | 1 and cat1[2] == (1 << 60) | 1
    assert np.asarray(ours.id_type_features[0].data)[0] == 0xA1
    assert np.asarray(ours.id_type_features[25].data)[3] == (1 << 60) | 25


def test_tsv_refusals(tmp_path):
    for mod in (port_files, ref_files):
        with pytest.raises(FileNotFoundError):
            mod.CriteoTSV(str(tmp_path / "absent.tsv"))
        with pytest.raises(ValueError, match="26 categorical"):
            mod.CriteoTSV(str(FIXTURE), slot_names=["a", "b"])
    names = [f"c{i}" for i in range(26)]
    _same_batches(port_files.CriteoTSV(str(FIXTURE), slot_names=names, requires_grad=False).batches(50),
                  ref_files.CriteoTSV(str(FIXTURE), slot_names=names, requires_grad=False).batches(50))


def _write_like_criteo_file_auc(ds, path, batch_size):
    """``benchmarks/criteo_file_auc.py:43-68``'s writer: label, round(expm1)
    of each dense feature, hex categories, one gzip'd line a sample."""
    with gzip.open(path, "wt") as f:
        for b in ds.batches(batch_size=batch_size):
            dense = np.asarray(b.non_id_type_features[0].data)
            labels = np.asarray(b.labels[0].data).reshape(-1)
            ints = np.rint(np.expm1(np.maximum(dense, 0.0))).astype(np.int64)
            cats = [np.asarray(fi.data).reshape(-1) for fi in b.id_type_features]
            for r in range(len(labels)):
                row = [str(int(labels[r]))] + [str(int(v)) for v in ints[r]]
                row += [format(int(c[r]), "x") for c in cats]
                f.write("\t".join(row) + "\n")


def test_tsv_from_the_ports_synthetic_stream_is_the_references(tmp_path):
    kw = dict(num_samples=3 * 96, vocab_sizes=port.CRITEO_KAGGLE_VOCABS, seed=42)
    ours, theirs = tmp_path / "port.tsv.gz", tmp_path / "ref.tsv.gz"
    _write_like_criteo_file_auc(port.CriteoSynthetic(**kw), ours, 96)
    _write_like_criteo_file_auc(ref.CriteoSynthetic(**kw), theirs, 96)
    assert gzip.open(ours).read() == gzip.open(theirs).read()
    _same_batches(port_files.CriteoTSV(str(ours)).batches(64, drop_remainder=False),
                  ref_files.CriteoTSV(str(ours)).batches(64, drop_remainder=False), n=5)


def _write_parquet(src, path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    rows = [line.split("\t") for line in src.read_text().splitlines() if line]
    cols = list(zip(*[r + [""] * (40 - len(r)) for r in rows]))
    arrays = [pa.array([int(v) if v else None for v in c], pa.int64()) for c in cols[:14]]
    arrays += [pa.array([v or None for v in c], pa.string()) for c in cols[14:]]
    pq.write_table(pa.table(arrays, names=[f"c{i}" for i in range(40)]), path)


def test_parquet_is_the_references(tmp_path):
    path = tmp_path / "criteo_tiny.parquet"
    _write_parquet(FIXTURE, path)
    ours = _same_batches(port_files.CriteoTSV(str(path)).batches(40, drop_remainder=False),
                         ref_files.CriteoTSV(str(path)).batches(40, drop_remainder=False))
    plain = list(port_files.CriteoTSV(str(FIXTURE)).batches(40, drop_remainder=False))
    assert [a.to_bytes() for a in ours] == [a.to_bytes() for a in plain]


def test_parquet_without_pyarrow_raises(tmp_path, monkeypatch):
    path = tmp_path / "x.parquet"
    path.write_bytes(b"PAR1")
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    monkeypatch.setitem(sys.modules, "pyarrow.parquet", None)
    for mod in (port_files, ref_files):
        with pytest.raises(RuntimeError, match="parquet input needs pyarrow"):
            next(mod.CriteoTSV(str(path)).batches(8))
