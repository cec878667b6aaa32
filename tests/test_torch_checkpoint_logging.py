"""The port's checkpoint/resume and structured debug log (CPU) against the JAX package.

- The files the port's `StageCheckpointer` writes (``manifest.json`` and one
  ``.npz`` per table) equal the JAX package's key for key, `config_fingerprint`
  is the same string, and a directory written by either package resumes in
  the other with an equal result.
- `run_tables_resumable` equals the JAX package's: first run, resume from
  the ``sorted`` stage (garbage inputs prove it loads), a fingerprint change
  that invalidates, both join modes, and ``join_algorithm="hash"``, which
  both packages ignore on this path.
- With ``debug_log`` the event stream of `run_tables` and `run_csv` (event
  names and fields, timestamps aside) equals the JAX package's.
"""

import io
import json
import logging
import os

import numpy as np
import pytest
import torch

import pim_sort_merge_join_tpu as smj
from pim_sort_merge_join_tpu.engine import checkpoint as jckpt
from pim_sort_merge_join_tpu.engine import logging as jlog
from pim_sort_merge_join_tpu_torch import EngineConfig, QueryPipeline, Table
from pim_sort_merge_join_tpu_torch.columnar import csv_io
from pim_sort_merge_join_tpu_torch.convert import config_from_reference, table_from_reference
from pim_sort_merge_join_tpu_torch.engine import checkpoint as pckpt
from pim_sort_merge_join_tpu_torch.engine import logging as plog
from tests.conftest import make_reference_like_tables


def _port(jt):
    return table_from_reference(np.asarray(jt.data), int(jt.num_rows), jt.names, device="cpu")


def _assert_same(got, want):
    want_data = np.asarray(want.data)
    assert got.data.numpy().dtype == want_data.dtype
    np.testing.assert_array_equal(got.data.numpy(), want_data)
    assert got.num_rows.dtype == torch.int32 and got.num_rows.dim() == 0
    assert int(got.num_rows) == int(want.num_rows)
    assert got.names == want.names


def _dup_rows(rng, n, key_hi=20):
    keys = rng.integers(0, key_hi, size=n)
    return np.column_stack([keys, rng.integers(-1000, 1000, (n, 3))]).astype(np.int64)


def _manifest(d):
    with open(os.path.join(d, "manifest.json")) as f:
        return json.load(f)


def _without_ts(manifest):
    return {**manifest, "stages": {s: {k: v for k, v in e.items() if k != "ts"}
                                   for s, e in manifest["stages"].items()}}


# --- the checkpoint files -------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.int64, np.int32])
def test_checkpoint_files_match_reference_key_for_key(tmp_path, small_tables, dtype):
    r1, r2 = (r.astype(dtype) for r in small_tables)
    j1 = smj.Table.from_numpy(r1, capacity=230, dtype=dtype)
    j2 = smj.Table.from_numpy(r2, dtype=dtype, names=("a", "b", "c", "d"))
    dj, dp = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.StageCheckpointer(dj, "fp").save("sorted", t1=j1, t2=j2)
    pckpt.StageCheckpointer(dp, "fp").save("sorted", t1=_port(j1), t2=_port(j2))
    mj, mp = _manifest(dj), _manifest(dp)
    assert mj.keys() == mp.keys()
    assert mj["stages"]["sorted"].keys() == mp["stages"]["sorted"].keys() == {"ts", "tables"}
    assert _without_ts(mj) == _without_ts(mp)
    assert sorted(os.listdir(dj)) == sorted(os.listdir(dp))
    for name in ("sorted.t1.npz", "sorted.t2.npz"):
        with np.load(os.path.join(dj, name)) as zj, np.load(os.path.join(dp, name)) as zp:
            assert sorted(zj.files) == sorted(zp.files) == ["data", "num_rows"]
            for k in zj.files:
                assert zj[k].dtype == zp[k].dtype and zj[k].shape == zp[k].shape
                np.testing.assert_array_equal(zj[k], zp[k])


def test_checkpoint_roundtrip_stages_and_fingerprint(tmp_path, small_tables):
    t = _port(smj.Table.from_numpy(small_tables[0], capacity=256))
    ck = pckpt.StageCheckpointer(str(tmp_path), "fp1")
    assert ck.completed_stages() == [] and not ck.has("sorted")
    ck.save("sorted", t1=t)
    ck.save("joined", result=t)
    assert ck.has("sorted") and ck.completed_stages() == ["sorted", "joined"]
    back = ck.load_table("sorted", "t1", device="cpu")
    assert torch.equal(back.data, t.data) and back.names == t.names
    assert back.num_rows.dtype == torch.int32 and int(back.num_rows) == int(t.num_rows)
    # Another fingerprint sees nothing, and a broken manifest counts as empty.
    assert not pckpt.StageCheckpointer(str(tmp_path), "fp2").has("sorted")
    with pytest.raises(KeyError, match="no checkpoint"):
        pckpt.StageCheckpointer(str(tmp_path), "fp2").load("sorted")
    with open(tmp_path / "manifest.json", "w") as f:
        f.write("{not json")
    assert ck.completed_stages() == []
    assert not os.path.exists(tmp_path / "manifest.json.tmp")


@pytest.mark.parametrize(
    "kw",
    [{}, {"join_algorithm": "hash", "join_mode": "inner", "join_slack": 2.5},
     {"checkpoint_dir": "/some/dir", "debug_log": True, "dtype": "int32"},
     {"predicate1": smj.Predicate(2, "<=", -7), "narrow_keys": False, "narrow_data": True,
      "heavy_hitter_fraction": 0.25, "sort_algorithm": "pallas_bitonic"}],
)
def test_config_fingerprint_equals_reference(kw):
    ref = smj.EngineConfig(**kw)
    cfg = config_from_reference(ref)
    assert pckpt.config_fingerprint(cfg) == jckpt.config_fingerprint(ref)
    if kw:
        assert pckpt.config_fingerprint(cfg) != pckpt.config_fingerprint(EngineConfig())


# --- run_tables_resumable ----------------------------------------------------------


def _resumable_configs(d, **kw):
    kw.setdefault("predicate1", smj.Predicate(0, ">", 100))
    kw.setdefault("predicate2", smj.Predicate(0, ">", 100))
    ref = smj.EngineConfig(checkpoint_dir=d, **kw)
    return ref, config_from_reference(ref)


@pytest.mark.parametrize(
    "kw",
    [{}, {"join_mode": "inner", "join_slack": 8.0}, {"join_algorithm": "hash"},
     {"join_algorithm": "hash", "join_mode": "inner", "join_slack": 8.0},
     {"sort_algorithm": "pallas_bitonic"}],
)
def test_run_tables_resumable_matches_reference_and_resumes(tmp_path, kw):
    rng = np.random.default_rng(121)
    r1, r2 = make_reference_like_tables(rng, 300) if "join_mode" not in kw else (
        _dup_rows(rng, 300, 400) + 50, _dup_rows(rng, 280, 400) + 50)
    dj, dp = str(tmp_path / "jax"), str(tmp_path / "port")
    ref, _ = _resumable_configs(dj, **kw)
    _, cfg = _resumable_configs(dp, **kw)
    if kw.get("sort_algorithm") == "pallas_bitonic":
        # The JAX bitonic kernel does not run compiled on the CPU; its "xla"
        # sort is the same stable order (the bitonic sort's vals are an arange).
        ref, _ = _resumable_configs(dj, **{**kw, "sort_algorithm": "xla"})
    j1, j2 = smj.Table.from_numpy(r1, capacity=320), smj.Table.from_numpy(r2)
    want = smj.QueryPipeline(ref).run_tables_resumable(j1, j2)
    pipe = QueryPipeline(cfg, device="cpu")
    got = pipe.run_tables_resumable(_port(j1), _port(j2))
    _assert_same(got, want)
    assert pckpt.StageCheckpointer(dp, pckpt.config_fingerprint(cfg)).completed_stages() == [
        "sorted", "joined"]
    assert [s["stage"] for s in json.loads(pipe.metrics_json())["stages"]] == ["filter_sort", "join"]
    # Resume: garbage inputs of the same shape prove the sorted stage is loaded.
    garbage = Table(data=torch.zeros_like(_port(j1).data), num_rows=torch.tensor(3, dtype=torch.int32),
                    names=j1.names)
    pipe2 = QueryPipeline(cfg, device="cpu")
    _assert_same(pipe2.run_tables_resumable(garbage, garbage), want)
    assert [s["stage"] for s in json.loads(pipe2.metrics_json())["stages"]] == ["join"]


def test_run_tables_resumable_fingerprint_change_invalidates(tmp_path, small_tables):
    r1, r2 = small_tables
    d = str(tmp_path)
    j1, j2 = smj.Table.from_numpy(r1), smj.Table.from_numpy(r2)
    _, cfg_a = _resumable_configs(d)
    QueryPipeline(cfg_a, device="cpu").run_tables_resumable(_port(j1), _port(j2))
    ref_b, cfg_b = _resumable_configs(d, predicate1=smj.Predicate(0, ">", 300))
    assert not pckpt.StageCheckpointer(d, pckpt.config_fingerprint(cfg_b)).has("sorted")
    got = QueryPipeline(cfg_b, device="cpu").run_tables_resumable(_port(j1), _port(j2))
    _assert_same(got, smj.QueryPipeline(
        smj.EngineConfig(**{**ref_b.__dict__, "checkpoint_dir": str(tmp_path / "ref")})
    ).run_tables_resumable(j1, j2))
    assert _manifest(d)["fingerprint"] == pckpt.config_fingerprint(cfg_b)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_directory_resumes_in_the_other_package(tmp_path, small_tables, writer):
    r1, r2 = small_tables
    d = str(tmp_path)
    ref, cfg = _resumable_configs(d)
    j1, j2 = smj.Table.from_numpy(r1), smj.Table.from_numpy(r2)
    if writer == "jax":
        want = smj.QueryPipeline(ref).run_tables_resumable(j1, j2)
    else:
        want = QueryPipeline(cfg, device="cpu").run_tables_resumable(_port(j1), _port(j2))
    zeros = np.zeros_like(r1)
    if writer == "jax":
        got = QueryPipeline(cfg, device="cpu").run_tables_resumable(
            *(Table.from_numpy(zeros, device="cpu") for _ in range(2)))
        _assert_same(got, want)
    else:
        got = smj.QueryPipeline(ref).run_tables_resumable(*(smj.Table.from_numpy(zeros) for _ in range(2)))
        _assert_same(want, got)


def test_run_tables_resumable_without_a_directory_is_run_tables(small_tables):
    r1, r2 = small_tables
    ref = smj.EngineConfig(join_algorithm="hash")
    j1, j2 = smj.Table.from_numpy(r1), smj.Table.from_numpy(r2)
    got = QueryPipeline(config_from_reference(ref), device="cpu").run_tables_resumable(_port(j1), _port(j2))
    _assert_same(got, smj.QueryPipeline(ref).run_tables_resumable(j1, j2))


# --- the debug log -----------------------------------------------------------------


def test_log_event_lines_match_reference():
    bj, bp = io.StringIO(), io.StringIO()
    jlog.configure(stream=bj)
    plog.configure(stream=bp)
    for mod in (jlog, plog):
        mod.log_event("stage_done", stage="sort", rows=123)
        mod.get_logger().warning("plain")
    lj = [json.loads(line) for line in bj.getvalue().splitlines()]
    lp = [json.loads(line) for line in bp.getvalue().splitlines()]
    assert [{k: v for k, v in e.items() if k != "ts"} for e in lj] == [
        {k: v for k, v in e.items() if k != "ts"} for e in lp]
    assert all(isinstance(e["ts"], float) for e in lp)
    # The port's events go to its own logger only.
    assert plog.get_logger().name != jlog.get_logger().name
    plog.configure(stream=io.StringIO(), json_format=False).info("x")


def _events(buf):
    return [{k: v for k, v in json.loads(line).items() if k != "ts"}
            for line in buf.getvalue().splitlines() if line]


def _capture():
    bj, bp = io.StringIO(), io.StringIO()
    jlog.configure(stream=bj)
    plog.configure(stream=bp)
    return bj, bp


@pytest.fixture
def quiet_loggers():
    yield
    for mod in (jlog, plog):
        mod.get_logger().handlers.clear()
        mod.get_logger().setLevel(logging.WARNING)


@pytest.mark.parametrize(
    "kw",
    [{}, {"join_mode": "inner", "join_slack": 0.25}, {"join_algorithm": "hash"},
     {"join_algorithm": "hash", "join_mode": "inner", "join_slack": 9.0}],
)
def test_debug_log_run_tables_events_match_reference(quiet_loggers, kw):
    rng = np.random.default_rng(122)
    r1, r2 = _dup_rows(rng, 200, 300) + 4900, _dup_rows(rng, 180, 300) + 4900
    ref = smj.EngineConfig(debug_log=True, **kw)
    cfg = config_from_reference(ref)
    assert cfg.debug_log is True
    j1, j2 = smj.Table.from_numpy(r1, capacity=230), smj.Table.from_numpy(r2)
    bj, bp = _capture()
    outcome = []
    for run in (lambda: smj.QueryPipeline(ref).run_tables(j1, j2),
                lambda: QueryPipeline(cfg, device="cpu").run_tables(_port(j1), _port(j2))):
        try:
            outcome.append(int(run().num_rows))
        except Exception as e:  # the overflow case raises in both, after its events
            outcome.append(type(e).__name__)
    assert outcome[0] == outcome[1]
    ej, ep = _events(bj), _events(bp)
    assert [e["event"] for e in ep] == ["filter", "join"]
    assert ep == ej


@pytest.mark.parametrize("kw", [{}, {"join_algorithm": "hash", "dtype": "int32"},
                                {"join_mode": "inner", "join_slack": 4.0}])
def test_debug_log_run_csv_events_match_reference(tmp_path, quiet_loggers, kw):
    rows1 = make_reference_like_tables(np.random.default_rng(123), 300)[0]
    rows2 = make_reference_like_tables(np.random.default_rng(124), 300)[0]
    d1, d2 = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    csv_io.write_csv(d1, rows1)
    csv_io.write_csv(d2, rows2)
    ref = smj.EngineConfig(predicate1=smj.Predicate(0, ">", 50), predicate2=smj.Predicate(0, ">", 50),
                           debug_log=True, **kw)
    out = str(tmp_path / "r.csv")
    bj, bp = _capture()
    want = smj.QueryPipeline(ref).run_csv(d1, d2, out)
    got = QueryPipeline(config_from_reference(ref), device="cpu").run_csv(d1, d2, out)
    _assert_same(got, want)
    ej, ep = _events(bj), _events(bp)
    assert [e["event"] for e in ep] == ["ingest", "filter", "join", "materialize"]
    # The port's ingest event also says which parser read the files.
    assert ep[0].pop("parser") in ("native", "numpy")
    assert ep == ej
    by = {e["event"]: e for e in ep}
    assert by["filter"]["table1_rows_out"] == int(np.sum(rows1[:, 0] > 50))
    assert by["join"]["rows_out"] == by["materialize"]["rows"] == int(got.num_rows)


def test_debug_log_off_emits_nothing(quiet_loggers, small_tables):
    _, bp = _capture()
    r1, r2 = small_tables
    QueryPipeline(EngineConfig(), device="cpu").run_tables(
        Table.from_numpy(r1, device="cpu"), Table.from_numpy(r2, device="cpu"))
    assert bp.getvalue() == ""


def test_run_tables_resumable_refuses_tables_on_another_device(tmp_path, small_tables):
    cfg = EngineConfig(checkpoint_dir=str(tmp_path))
    t = Table.from_numpy(small_tables[0], device="cpu")
    pipe = QueryPipeline(cfg, device="cpu")
    pipe.device = torch.device("meta")  # any device the tables are not on
    with pytest.raises(ValueError, match="pipeline on meta"):
        pipe.run_tables_resumable(t, t)
    assert not os.path.exists(tmp_path / "manifest.json")
