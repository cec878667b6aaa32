"""The port's native CSV parser and formatter against the JAX package's.

The port compiles its own copy of `csv_parser.cpp` (`native/csv_native.py`)
into ``build/native/``; its parse, its formatted bytes, the errors of
malformed files and `load_csv_shard` must equal the JAX package's native
and numpy paths on the same files. Integer data: every comparison is exact.
"""

import io
import os

import numpy as np
import pytest

from pim_sort_merge_join_tpu.columnar import csv_io as jcsv
from pim_sort_merge_join_tpu.native import csv_native as jnative
from pim_sort_merge_join_tpu_torch import EngineConfig, QueryPipeline
from pim_sort_merge_join_tpu_torch.columnar import csv_io
from pim_sort_merge_join_tpu_torch.native import csv_native


@pytest.fixture(scope="module")
def both_native():
    if not (csv_native.available() and jnative.available()):
        pytest.skip("a native CSV library is unavailable (no compiler?)")


def _rows(seed, shape, lo=-(10**12), hi=10**12):
    return np.random.default_rng(seed).integers(lo, hi, size=shape).astype(np.int64)


def test_library_is_built_from_the_port_source_into_build(both_native):
    path = csv_native.library_path()
    assert path.exists() and path.parent.name == "native" and path.parent.parent.name == "build"
    assert csv_native.SOURCE.parent == csv_io.csv_native.SOURCE.parent
    assert "pim_sort_merge_join_tpu_torch" in str(csv_native.SOURCE)
    assert csv_native.build() == path  # built once, found again


@pytest.mark.parametrize("shape", [(1, 1), (7, 3), (1000, 5), (4099, 4)])
def test_parse_matches_reference_native_and_numpy(tmp_path, both_native, shape):
    rows = _rows(sum(shape), shape)
    path = str(tmp_path / "t.csv")
    jcsv.write_csv(path, rows)
    got = csv_native.parse_csv(path)
    np.testing.assert_array_equal(got, jnative.parse_csv(path))
    np.testing.assert_array_equal(got, jcsv._load_numpy(path, np.int64))
    np.testing.assert_array_equal(csv_io._load_numpy(path, np.int64), rows)
    arr, parser = csv_io.read_csv(path)
    assert parser == "native"
    np.testing.assert_array_equal(arr, rows)


def test_parse_crlf_and_unterminated_last_line(tmp_path, both_native):
    path = str(tmp_path / "t.csv")
    with open(path, "wb") as f:
        f.write(b"col1,col2\r\n1,-2\r\n30,4")
    np.testing.assert_array_equal(csv_native.parse_csv(path), jnative.parse_csv(path))
    np.testing.assert_array_equal(csv_io._load_numpy(path), jcsv._load_numpy(path, np.int64))


@pytest.mark.parametrize("dtype", [np.int64, np.int32, np.uint32])
def test_format_matches_reference(both_native, dtype):
    info = np.iinfo(dtype)
    rows = np.random.default_rng(3).integers(info.min, info.max, (500, 7), dtype=dtype,
                                             endpoint=True)
    rows[0, :2] = info.min, info.max
    body = csv_native.format_csv_body(rows)
    assert body == jnative.format_csv_body(rows)
    assert body.decode() == "\n".join(",".join(map(str, r)) for r in rows.tolist()) + "\n"


def test_format_prints_uint64_unsigned(both_native):
    """The JAX package formats uint64 through int64, so values from 2**63 on
    print negative where its library loads; the port prints them as its
    numpy path does (ROADMAP §3)."""
    rows = np.array([[0, 2**63 - 1], [2**63, 2**64 - 1]], np.uint64)
    assert csv_native.format_csv_body(rows) == b"0,9223372036854775807\n" \
        b"9223372036854775808,18446744073709551615\n"
    assert jnative.format_csv_body(rows).startswith(b"0,9223372036854775807\n-")
    small = rows[:1]
    assert csv_native.format_csv_body(small) == jnative.format_csv_body(small)


@pytest.mark.parametrize("dtype", ["int64", "int32", "uint64", "float64", "float32"])
def test_write_csv_bytes_match_reference(tmp_path, dtype):
    rows = np.abs(_rows(4, (300, 4), -(10**6), 10**6)).astype(dtype)
    if dtype.startswith("float"):
        rows = rows + np.dtype(dtype).type(0.25)
    a, b = tmp_path / "p.csv", tmp_path / "j.csv"
    csv_io.write_csv(str(a), rows)
    jcsv.write_csv(str(b), rows)
    assert a.read_bytes() == b.read_bytes()
    buf, jbuf = io.StringIO(), io.StringIO()
    csv_io.write_csv(buf, rows, names=["a", "b", "c", "d"])
    jcsv.write_csv(jbuf, rows, names=["a", "b", "c", "d"])
    assert buf.getvalue() == jbuf.getvalue() == a.read_text().replace("col1,col2,col3,col4", "a,b,c,d")


@pytest.mark.parametrize(
    "body",
    [b"col1,col2\n1,2\n3,4\n5\n",          # ragged last row
     b"col1,col2\n1,2,9\n3,4\n",           # a row too wide
     b"col1,col2,col3\n1,2\n3,4\n5,6\n"],  # fields not a multiple of the header
)
def test_malformed_files_raise_the_same_errors(tmp_path, both_native, body):
    path = str(tmp_path / "bad.csv")
    with open(path, "wb") as f:
        f.write(body)
    for port_fn, ref_fn in ((csv_native.parse_csv, jnative.parse_csv),
                            (csv_io._load_numpy, lambda p: jcsv._load_numpy(p, np.int64))):
        outcome = []
        for fn in (port_fn, ref_fn):
            try:
                outcome.append(("ok", fn(path).tobytes()))
            except ValueError as e:
                outcome.append(("ValueError", str(e)))
        assert outcome[0] == outcome[1]
        # The native parser counts rows and commas, so it refuses all three;
        # the numpy path only a field count that is no multiple of the header.
        if port_fn is csv_native.parse_csv:
            assert outcome[0][0] == "ValueError"


def test_empty_table_csv_round_trips_like_the_reference(tmp_path):
    path = str(tmp_path / "e.csv")
    csv_io.write_csv(path, np.zeros((0, 3), dtype=np.int64))
    assert open(path).read() == "col1,col2,col3\n"
    assert csv_io.probe_csv(path) == jcsv.probe_csv(path) == (3, 0)
    for got, want in ((csv_io.load_csv_numpy(path), jcsv.load_csv_numpy(path)),
                      (csv_io._load_numpy(path), jcsv._load_numpy(path, np.int64))):
        assert got.shape == want.shape and got.dtype == want.dtype


@pytest.mark.parametrize("num_shards", [1, 2, 3, 4, 5, 6, 7])
def test_load_csv_shard_concatenates_to_the_file_and_equals_the_reference(tmp_path, num_shards):
    rows = _rows(5, (257, 3))
    path = str(tmp_path / "t.csv")
    csv_io.write_csv(path, rows)
    shards = [csv_io.load_csv_shard(path, s, num_shards) for s in range(num_shards)]
    for s, got in enumerate(shards):
        np.testing.assert_array_equal(got, jcsv.load_csv_shard(path, s, num_shards))
    np.testing.assert_array_equal(np.concatenate(shards), csv_io.load_csv_numpy(path))
    with pytest.raises(ValueError, match="out of range"):
        csv_io.load_csv_shard(path, num_shards, num_shards)


def test_snap_to_line_start_matches_reference(tmp_path):
    path = str(tmp_path / "t.csv")
    csv_io.write_csv(path, _rows(6, (40, 2), 0, 10**5))
    size = os.path.getsize(path)
    with open(path, "rb") as f, open(path, "rb") as g:
        start = len(f.readline())
        for pos in range(0, size + 2):
            assert csv_io._snap_to_line_start(f, pos, start, size) == \
                jcsv._snap_to_line_start(g, pos, start, size)


def test_numpy_path_runs_and_is_recorded_without_the_library(tmp_path, monkeypatch):
    rows = _rows(7, (50, 4), 0, 10**4)
    path = str(tmp_path / "t.csv")
    csv_io.write_csv(path, rows)
    monkeypatch.setattr(csv_native, "parse_csv", lambda p: None)
    arr, parser = csv_io.read_csv(path)
    assert parser == "numpy"
    np.testing.assert_array_equal(arr, rows)
    pipe = QueryPipeline(EngineConfig(), device="cpu")
    pipe.run_csv(path, path)
    assert pipe.metrics.stages[0].name == "ingest"
    assert pipe.metrics.stages[0].extra["parser"] == "numpy"


def test_run_csv_records_the_native_parser(tmp_path, both_native):
    rows = _rows(8, (60, 4), 0, 10**4)
    path = str(tmp_path / "t.csv")
    csv_io.write_csv(path, rows)
    pipe = QueryPipeline(EngineConfig(), device="cpu")
    pipe.run_csv(path, path)
    assert '"parser": "native"' in pipe.metrics_json()
