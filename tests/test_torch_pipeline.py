"""The port's query pipeline (plain path, CPU) against the JAX package.

`QueryPipeline.run_tables` must equal the JAX `QueryPipeline.run_tables`
on the whole output buffer and `num_rows`, and `run_csv` must write the
same CSV bytes. Also: the port imports without jax, and a pipeline asked
for a CUDA device that is not there raises instead of running on the CPU.
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import pim_sort_merge_join_tpu as smj
from pim_sort_merge_join_tpu_torch import EngineConfig, QueryPipeline, Table
from pim_sort_merge_join_tpu_torch.columnar import csv_io
from pim_sort_merge_join_tpu_torch.convert import config_from_reference, table_from_reference
from pim_sort_merge_join_tpu_torch.engine.errors import MalformedInputError
from pim_sort_merge_join_tpu_torch.ops import oracle
from tests.conftest import make_reference_like_tables


def _both_run_tables(ref_cfg, r1, r2, cap1=None, cap2=None):
    jt1 = smj.Table.from_numpy(r1, capacity=cap1)
    jt2 = smj.Table.from_numpy(r2, capacity=cap2)
    jpipe = smj.QueryPipeline(ref_cfg)
    want = jpipe.run_tables(jt1, jt2)
    t1, t2 = (table_from_reference(np.asarray(t.data), int(t.num_rows), t.names, device="cpu") for t in (jt1, jt2))
    pipe = QueryPipeline(config_from_reference(ref_cfg), device="cpu")
    got = pipe.run_tables(t1, t2)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    assert int(got.num_rows) == int(want.num_rows)
    assert got.names == want.names
    assert pipe.resolved_narrow_keys is jpipe.resolved_narrow_keys
    assert pipe.resolved_narrow_data is jpipe.resolved_narrow_data
    return got


@pytest.mark.parametrize("nrow", [64, 1000, 5000])
def test_run_tables_matches_reference(nrow):
    r1, r2 = make_reference_like_tables(np.random.default_rng(51), nrow)
    thr = (3 * nrow) // 20
    cfg = smj.EngineConfig(predicate1=smj.Predicate(0, ">", thr), predicate2=smj.Predicate(0, ">", thr))
    got = _both_run_tables(cfg, r1, r2, cap1=nrow + 13)
    assert int(got.num_rows) > 0


@pytest.mark.parametrize(
    "kind", ["wide_keys", "wide_payload", "dtype_int32", "forced_narrow_off", "default_predicate"]
)
def test_run_tables_probe_and_options_match_reference(kind):
    rng = np.random.default_rng(52)
    r1, r2 = make_reference_like_tables(rng, 600)
    cfg = smj.EngineConfig(predicate1=smj.Predicate(0, ">", 100), predicate2=smj.Predicate(0, ">", 100))
    if kind == "wide_keys":
        r1[3, 0] = 2**33
    elif kind == "wide_payload":
        r2[5, 2] = -(2**35)
    elif kind == "dtype_int32":
        r1, r2 = r1.astype(np.int32), r2.astype(np.int32)
        cfg = smj.EngineConfig(dtype="int32", predicate1=cfg.predicate1, predicate2=cfg.predicate2)
        jt1, jt2 = (smj.Table.from_numpy(r, dtype=np.int32) for r in (r1, r2))
        want = smj.QueryPipeline(cfg).run_tables(jt1, jt2)
        t1, t2 = (table_from_reference(np.asarray(t.data), int(t.num_rows), t.names, device="cpu") for t in (jt1, jt2))
        got = QueryPipeline(config_from_reference(cfg), device="cpu").run_tables(t1, t2)
        assert got.data.dtype == torch.int32
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
        assert int(got.num_rows) == int(want.num_rows)
        return
    elif kind == "forced_narrow_off":
        cfg = smj.EngineConfig(predicate1=cfg.predicate1, predicate2=cfg.predicate2,
                               narrow_keys=False, narrow_data=False)
    elif kind == "default_predicate":
        cfg = smj.EngineConfig()
    _both_run_tables(cfg, r1, r2)


def _write_pair(tmp_path, r1, r2):
    p1, p2 = str(tmp_path / "d1.csv"), str(tmp_path / "d2.csv")
    csv_io.write_csv(p1, r1)
    csv_io.write_csv(p2, r2)
    return p1, p2


@pytest.mark.parametrize("narrow_keys", ["auto", True, False])
def test_run_csv_byte_identical_to_reference(tmp_path, narrow_keys):
    r1, r2 = make_reference_like_tables(np.random.default_rng(53), 3000)
    p1, p2 = _write_pair(tmp_path, r1, r2)
    cfg = smj.EngineConfig(narrow_keys=narrow_keys)
    o_ref, o_port = str(tmp_path / "ref.csv"), str(tmp_path / "port.csv")
    smj.QueryPipeline(cfg).run_csv(p1, p2, o_ref)
    pipe = QueryPipeline(config_from_reference(cfg), device="cpu")
    res = pipe.run_csv(p1, p2, o_port)
    with open(o_ref, "rb") as f_ref, open(o_port, "rb") as f_port:
        assert f_port.read() == f_ref.read()
    np.testing.assert_array_equal(res.to_numpy(), oracle.pipeline_oracle(r1, r2))
    assert [s["stage"] for s in json.loads(pipe.metrics_json())["stages"]] == [
        "ingest", "host_to_device", "execute", "materialize",
    ]


def test_run_csv_validates_narrow_and_dtype(tmp_path):
    rows = np.array([[2**31, 1, 1, 1], [5, 2, 2**31, 2]], dtype=np.int64)
    p1, p2 = _write_pair(tmp_path, rows, rows)
    with pytest.raises(MalformedInputError, match="narrow_keys"):
        QueryPipeline(EngineConfig(narrow_keys=True), device="cpu").run_csv(p1, p2)
    with pytest.raises(MalformedInputError, match="narrow_data"):
        QueryPipeline(EngineConfig(narrow_data=True), device="cpu").run_csv(p1, p2)
    with pytest.raises(MalformedInputError, match="int32"):
        QueryPipeline(EngineConfig(dtype="int32"), device="cpu").run_csv(p1, p2)


def test_port_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['flax'] = None\n"
        "import pim_sort_merge_join_tpu_torch as p\n"
        "import pim_sort_merge_join_tpu_torch.convert, pim_sort_merge_join_tpu_torch.ops.oracle\n"
        "from pim_sort_merge_join_tpu_torch.ops.kernels import build, hbm_sort, join_scan\n"
        "from pim_sort_merge_join_tpu_torch.exchange import collectives, partition, shuffle, skew\n"
        "from pim_sort_merge_join_tpu_torch.engine import checkpoint, distributed\n"
        "from pim_sort_merge_join_tpu_torch.runner import cli, multihost, simulator\n"
        "from pim_sort_merge_join_tpu_torch.utils.validate import check_sharded_table\n"
        "from pim_sort_merge_join_tpu_torch.convert import sharded_from_reference\n"
        "from pim_sort_merge_join_tpu_torch.tools import collective_probe\n"
        "assert 'jax' not in {m.split('.')[0] for m, v in sys.modules.items() if v is not None}\n"
        "print(sorted(p.__all__))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "QueryPipeline" in out.stdout


def test_cuda_pipeline_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-GPU refusal")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        QueryPipeline(EngineConfig(), device="cuda")
    with pytest.raises(ValueError, match="unsupported device"):
        QueryPipeline(EngineConfig(), device="meta")


def test_default_device_without_gpu_raises_and_never_runs_on_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-GPU refusal")
    from pim_sort_merge_join_tpu_torch import device as device_mod

    assert device_mod.DEFAULT_DEVICE == "cuda"
    rows = np.arange(12, dtype=np.int64).reshape(4, 3)
    p = str(tmp_path / "t.csv")
    csv_io.write_csv(p, rows)
    for make in (
        QueryPipeline,
        lambda: QueryPipeline(EngineConfig()),
        lambda: Table.from_numpy(rows),
        lambda: Table.empty(3, 8),
        lambda: csv_io.load_csv(p),
        lambda: table_from_reference(rows, 4, ("a", "b", "c")),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    # The CPU is there when asked for by name.
    assert QueryPipeline(device="cpu").device.type == "cpu"
    assert Table.from_numpy(rows, device="cpu").device.type == "cpu"


def test_tables_on_another_device_are_refused():
    t = Table.from_numpy(np.ones((4, 3), np.int64), device="meta")
    with pytest.raises(ValueError, match="pipeline on cpu"):
        QueryPipeline(EngineConfig(), device="cpu").run_tables(t, t)
