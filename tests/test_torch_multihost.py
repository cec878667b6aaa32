"""The port's multi-process entry points on the CPU.

`runner/multihost.py` as two processes in one Gloo group (meeting in a
`file://` store under the test's directory, each parsing its byte range of
the CSVs): the result CSV's bytes against the oracle's, ``--aggregate``,
``--checkpoint-dir`` run then resume, the narrow probe agreeing across
processes, ``--bench-reps``. The CLI's ``--simulator 4`` and
``--distributed`` against the single-device CLI's bytes, with jax kept
out. Checkpoints across packages: the exchange-boundary arrays written by
the port's ranks equal the JAX package's for the same P and inputs, either
package resumes the other's, and `sharded_from_reference` gives each rank
its block. Every subprocess and spawned group has a time limit.
"""

from __future__ import annotations

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax_dist_reference as ref
import torch_dist_cases as cases
from pim_sort_merge_join_tpu.engine import checkpoint as jcheckpoint
from pim_sort_merge_join_tpu.engine import distributed as jdist
from pim_sort_merge_join_tpu_torch.columnar import csv_io
from pim_sort_merge_join_tpu_torch.convert import sharded_from_reference
from pim_sort_merge_join_tpu_torch.engine import checkpoint as pcheckpoint
from pim_sort_merge_join_tpu_torch.engine import distributed as pdist
from pim_sort_merge_join_tpu_torch.ops import oracle
from pim_sort_merge_join_tpu_torch.runner import cli
from pim_sort_merge_join_tpu_torch.runner.simulator import spawn_simulator
from pim_sort_merge_join_tpu_torch.utils.validate import ValidationError, check_sharded_table

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_JAX = {"JAX_PLATFORMS": "", "PYTHONPATH": REPO}


def _tables(seed: int, n: int = 600, big_last_key: bool = False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        keys = rng.permutation(np.arange(1, 3 * n))[:n].astype(np.int64)
        out.append(np.column_stack([keys, rng.integers(1, 3 * n, (n, 3))]).astype(np.int64))
    if big_last_key:
        out[0][-1, 0] = 2**40  # in the second process's byte range only
    return out


def _csv_bytes(rows) -> bytes:
    buf = io.StringIO()
    csv_io.write_csv(buf, rows)
    return buf.getvalue().encode()


def _two_processes(tmp_path, r1, r2, sel, out_name="result.csv", extra=()):
    p1, p2 = str(tmp_path / "d1.csv"), str(tmp_path / "d2.csv")
    csv_io.write_csv(p1, r1)
    csv_io.write_csv(p2, r2)
    out = str(tmp_path / out_name)
    store = tmp_path / f"store_{out_name}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "pim_sort_merge_join_tpu_torch.runner.multihost", p1, p2, "-o", out,
         "--coordinator", f"file://{store}", "--num-processes", "2", "--process-id", str(pid),
         "--backend", "gloo", "--device", "cpu", "--select-val1", str(sel), "--select-val2",
         str(sel), "--exchange-slack", "3.0", *extra],
        cwd=REPO, env={**os.environ, **NO_JAX}, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=120)
            outs.append((p.returncode, stdout.decode(), stderr.decode()))
    finally:
        for p in procs:
            p.kill()
    for rc, _, stderr in outs:
        assert rc == 0, stderr[-3000:]
    return out, outs


def test_two_processes_write_the_oracle_bytes(tmp_path):
    r1, r2 = _tables(11)
    out, outs = _two_processes(tmp_path, r1, r2, 300)
    want = oracle.pipeline_oracle(r1, r2, pred1=(0, ">", 300), pred2=(0, ">", 300))
    assert open(out, "rb").read() == _csv_bytes(want)
    assert "narrow_keys resolved=True" in outs[0][2]


def test_two_processes_agree_on_the_narrow_probe(tmp_path):
    """Only process 1's rows hold a key beyond int32: the global MIN/MAX
    must resolve narrow off on both, and the bytes stay exact."""
    r1, r2 = _tables(23, 400, big_last_key=True)
    out, outs = _two_processes(tmp_path, r1, r2, 133)
    assert "narrow_keys resolved=False" in outs[0][2]
    want = oracle.pipeline_oracle(r1, r2, pred1=(0, ">", 133), pred2=(0, ">", 133))
    assert open(out, "rb").read() == _csv_bytes(want)


def test_two_processes_aggregate(tmp_path):
    rng = np.random.default_rng(31)
    r1 = np.column_stack([rng.integers(1, 40, 500), rng.integers(1, 100, (500, 3))]).astype(np.int64)
    out, _ = _two_processes(tmp_path, r1, r1.copy(), 0, extra=["--aggregate", "sum"])
    np.testing.assert_array_equal(csv_io.load_csv_numpy(out),
                                  oracle.hash_aggregate_oracle(r1, 0, 1, "sum"))


def test_two_processes_checkpoint_then_resume(tmp_path):
    r1, r2 = _tables(47, 500)
    ckdir = str(tmp_path / "ckpt")
    want = _csv_bytes(oracle.pipeline_oracle(r1, r2, pred1=(0, ">", 250), pred2=(0, ">", 250)))
    out, outs = _two_processes(tmp_path, r1, r2, 250, "r1.csv", ["--checkpoint-dir", ckdir])
    assert open(out, "rb").read() == want
    assert "resumed_from=[]" in outs[0][2]
    assert {"manifest.json", "exchanged.t1.npz", "exchanged.t2.npz"} <= set(os.listdir(ckdir))
    out, outs = _two_processes(tmp_path, r1, r2, 250, "r2.csv", ["--checkpoint-dir", ckdir])
    assert open(out, "rb").read() == want
    assert "resumed_from=['exchanged', 'joined']" in outs[0][2]


def test_two_processes_bench_reps(tmp_path):
    import json

    r1, r2 = _tables(5, 300)
    _, outs = _two_processes(tmp_path, r1, r2, 100, extra=["--bench-reps", "2"])
    line = json.loads(outs[0][1].strip().splitlines()[-1])
    assert line["processes"] == 2 and line["backend"] == "gloo" and len(line["times_ms"]) == 2
    assert outs[1][1].strip() == ""  # rank 0 alone reports


@pytest.mark.parametrize("flags", [["--simulator", "4"], ["--distributed", "--device", "cpu"]])
def test_cli_multi_device_writes_the_single_device_bytes(tmp_path, flags):
    r1, r2 = _tables(3, 700)
    p1, p2 = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    csv_io.write_csv(p1, r1)
    csv_io.write_csv(p2, r2)
    sel = ["--select-val1", "300", "--select-val2", "300"]
    single, multi = str(tmp_path / "single.csv"), str(tmp_path / "multi.csv")
    assert cli.main(["run", p1, p2, "-o", single, *sel, "--device", "cpu"]) == 0
    code = ("import sys; sys.modules['jax'] = None\n"
            "from pim_sort_merge_join_tpu_torch.runner import cli\n"
            f"rc = cli.main(['run', {p1!r}, {p2!r}, '-o', {multi!r}, *{sel + flags!r}])\n"
            "assert 'jax' not in {m.split('.')[0] for m, v in sys.modules.items() if v}\n"
            "sys.exit(rc)\n")
    done = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          env={**os.environ, **NO_JAX}, timeout=120)
    assert done.returncode == 0, done.stderr[-3000:]
    assert open(multi, "rb").read() == open(single, "rb").read()
    want = oracle.pipeline_oracle(r1, r2, pred1=(0, ">", 300), pred2=(0, ">", 300))
    assert open(single, "rb").read() == _csv_bytes(want)


def test_cli_distributed_under_torchrun_writes_the_single_device_bytes(tmp_path):
    """``--distributed --backend gloo`` on two ranks that torchrun starts:
    the group comes from torchrun's environment, rank 0 writes and
    reports, rank 1 prints nothing."""
    r1, r2 = _tables(8, 500)
    p1, p2 = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    csv_io.write_csv(p1, r1)
    csv_io.write_csv(p2, r2)
    sel = ["--select-val1", "250", "--select-val2", "250"]
    single, multi = str(tmp_path / "single.csv"), str(tmp_path / "multi.csv")
    assert cli.main(["run", p1, p2, "-o", single, *sel, "--device", "cpu"]) == 0
    done = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "--tee", "3", "-m", "pim_sort_merge_join_tpu_torch.runner.cli", "run", p1, p2, "-o",
         multi, *sel, "--distributed", "--backend", "gloo", "--device", "cpu", "--metrics"],
        cwd=REPO, capture_output=True, text=True, env={**os.environ, **NO_JAX}, timeout=120)
    assert done.returncode == 0, done.stderr[-3000:]
    assert open(multi, "rb").read() == open(single, "rb").read()
    reported = [line for line in done.stdout.splitlines() if '"stages"' in line]
    assert len(reported) == 1 and reported[0].startswith("[default0]:")
    assert "[default0]:wrote" in done.stderr and "[default1]:wrote" not in done.stderr


CKPT_CASE = {"label": "interchange", "kind": "resumable", "tables": ("reference_like", 61, 400),
             "cfg": {"predicate1": (0, ">", 200), "predicate2": (0, ">", 200),
                     "splitter_sample": 64}}


@pytest.fixture(scope="module")
def port_checkpoint(tmp_path_factory):
    """The interchange case's checkpoints, written by the port on 4 ranks."""
    d = tmp_path_factory.mktemp("port_ckpt")
    return spawn_simulator(cases.run_cases, 4, [CKPT_CASE], str(d), timeout=120)["interchange"]


def _arrays(directory, stage):
    with np.load(os.path.join(directory, f"{stage}.npz")) as z:
        return {k: z[k] for k in z.files}


def test_checkpoint_arrays_equal_jax_and_load_through_the_reference_view(port_checkpoint,
                                                                          tmp_path):
    want = ref.run(CKPT_CASE, 4, str(tmp_path))
    ours, theirs = port_checkpoint["checkpoint"], want["checkpoint"]
    for stage in ("exchanged.t1", "exchanged.t2"):
        a, b = _arrays(ours, stage), _arrays(theirs, stage)
        for k in ("data", "counts"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
        cap = b["data"].shape[0] // 4
        for r in range(4):
            st = sharded_from_reference(b, r, 4, device="cpu")
            assert int(st.num_rows) == b["counts"][r]
            np.testing.assert_array_equal(st.data.numpy(), a["data"][r * cap:(r + 1) * cap])
    with pytest.raises(ValueError, match="not a table over 3 ranks"):
        sharded_from_reference(_arrays(theirs, "exchanged.t1"), 0, 3, device="cpu")


def test_jax_resumes_a_port_checkpoint(port_checkpoint):
    """The JAX package, pointed at the port's directory, resumes at the join
    (zero tables in) and gives the port's result."""
    import dataclasses

    m = ref.mesh(4)
    cfg = dataclasses.replace(ref.config(CKPT_CASE), checkpoint_dir=port_checkpoint["checkpoint"])
    pipe = jdist.DistributedQueryPipeline(cfg, m)
    assert pipe.checkpoint_stages() == ["exchanged", "joined"]
    r1, _ = cases.tables(CKPT_CASE)
    zeros = jdist.ShardedTable.from_numpy(np.zeros_like(r1), m, "p")
    out = pipe.run_tables_resumable(zeros, zeros)
    ref.same_global(port_checkpoint["resume"], {"data": np.asarray(out._host_arrays()[0]),
                                                "counts": np.asarray(out._host_arrays()[1])})
    with pytest.raises(ValueError, match="shards"):
        jcheckpoint.StageCheckpointer(
            cfg.checkpoint_dir, jcheckpoint.config_fingerprint(cfg) + "|mesh=4",
        ).load_sharded("exchanged", "t1", ref.mesh(8), "p")


def test_port_resumes_a_jax_checkpoint(tmp_path):
    """One rank (no process group): the port resumes the JAX package's
    checkpoint of a one-device mesh and gives its result."""
    case = {**CKPT_CASE, "label": "one_device"}
    want = ref.run(case, 1, str(tmp_path))
    cfg = cases.port_config(case, checkpoint_dir=want["checkpoint"])
    pipe = pdist.DistributedQueryPipeline(cfg, device="cpu")
    assert pipe.checkpoint_stages() == ["exchanged", "joined"]
    r1, _ = cases.tables(case)
    zeros = pdist.ShardedTable.from_numpy(np.zeros_like(r1), device="cpu")
    out = pipe.run_tables_resumable(zeros, zeros)
    ref.same_global({"data": out.host_arrays()[0], "counts": out.host_arrays()[1]}, want["resume"])
    np.testing.assert_array_equal(out.to_numpy(), ref.oracle_rows(case))


def test_check_sharded_table():
    st = pdist.ShardedTable.from_numpy(np.arange(40, dtype=np.int64).reshape(10, 4), device="cpu")
    check_sharded_table(st)
    st.num_rows = torch.tensor(11, dtype=torch.int32)
    with pytest.raises(ValidationError, match="outside"):
        check_sharded_table(st)


def test_a_checkpointer_without_a_group_is_one_process(tmp_path):
    """The single-device pipeline's checkpointer reads and writes alone."""
    ck = pcheckpoint.StageCheckpointer(str(tmp_path), "f")
    st = pdist.ShardedTable.from_numpy(np.arange(12, dtype=np.int64).reshape(4, 3), device="cpu")
    ck.save("exchanged", t1=st)
    assert ck.completed_stages() == ["exchanged"]
    got = ck.load_sharded("exchanged", "t1", device="cpu")
    assert torch.equal(got.data, st.data) and int(got.num_rows) == 4
