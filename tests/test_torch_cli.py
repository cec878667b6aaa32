"""The port's command line and launcher against the JAX package's.

`smj-torch run` (`runner/cli.py`) writes the same bytes as `smj-tpu run` on
the same small CSVs for every ``--dtype`` and both join algorithms;
``generate`` writes the same files; the multi-device flags and ``bench``
exit non-zero without importing jax; `runner.run` prints ``OUTPUT MATCH``.
Every run here names ``--device cpu``; without it the port runs on the card.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from pim_sort_merge_join_tpu.runner import cli as jcli
from pim_sort_merge_join_tpu_torch.columnar import csv_io
from pim_sort_merge_join_tpu_torch.engine.profiling import trace_path
from pim_sort_merge_join_tpu_torch.runner import cli, run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    a, b = str(d / "a.csv"), str(d / "b.csv")
    assert cli.main(["generate", "2000", "--out1", a, "--out2", b, "--seed", "3"]) == 0
    return a, b


@pytest.mark.parametrize("keys", ["unique", "uniform", "zipf"])
def test_generate_writes_the_reference_files(tmp_path, keys):
    ours = [str(tmp_path / f"p{i}.csv") for i in (1, 2)]
    theirs = [str(tmp_path / f"j{i}.csv") for i in (1, 2)]
    args = ["500", "--cols", "5", "--seed", "4", "--keys", keys]
    assert cli.main(["generate", *args, "--out1", ours[0], "--out2", ours[1]]) == 0
    assert jcli.main(["generate", *args, "--out1", theirs[0], "--out2", theirs[1]]) == 0
    for p, j in zip(ours, theirs):
        assert open(p, "rb").read() == open(j, "rb").read()


@pytest.mark.parametrize("algorithm", ["sort_merge", "hash"])
@pytest.mark.parametrize("dtype", ["int64", "uint64", "int32", "float64"])
def test_run_writes_the_reference_bytes(tmp_path, pair, dtype, algorithm):
    flags = ["--dtype", dtype, "--join-algorithm", algorithm, "--select-val1", "900",
             "--select-val2", "700"]
    ours, theirs = str(tmp_path / "p.csv"), str(tmp_path / "j.csv")
    assert cli.main(["run", *pair, "-o", ours, *flags, "--device", "cpu"]) == 0
    assert jcli.main(["run", *pair, "-o", theirs, *flags]) == 0
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    assert len(open(ours).read().splitlines()) > 100


def test_run_inner_join_with_metrics_and_debug(tmp_path, pair, capsys):
    flags = ["--join-mode", "inner", "--narrow-keys", "--metrics"]
    ours, theirs = str(tmp_path / "p.csv"), str(tmp_path / "j.csv")
    assert cli.main(["run", *pair, "-o", ours, *flags, "--device", "cpu"]) == 0
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert metrics["stages"][0]["stage"] == "ingest"
    assert metrics["stages"][0]["parser"] in ("native", "numpy")
    assert jcli.main(["run", *pair, "-o", theirs, *flags]) == 0
    assert open(ours, "rb").read() == open(theirs, "rb").read()


def test_run_profile_writes_a_trace(tmp_path, pair):
    out, prof = str(tmp_path / "p.csv"), str(tmp_path / "prof")
    assert cli.main(["run", *pair, "-o", out, "--profile", prof, "--device", "cpu"]) == 0
    with open(trace_path(prof)) as f:
        trace = json.load(f)
    assert trace["traceEvents"]
    want = run.main([*pair, str(tmp_path / "r.csv"), "--device", "cpu"])
    assert want == 0 and open(out, "rb").read() == open(str(tmp_path / "r.csv"), "rb").read()


@pytest.mark.parametrize("argv", [["bench"]])
def test_multi_device_and_bench_exit_nonzero_without_jax(argv):
    code = ("import sys; from pim_sort_merge_join_tpu_torch.runner import cli; "
            f"rc = cli.main({argv!r}); "
            "assert not [m for m in sys.modules if m == 'jax' or m.startswith('pim_sort_merge_join_tpu.')]; "
            "sys.exit(rc)")
    done = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": REPO})
    assert done.returncode == 2, done.stderr
    assert "The H100 benchmark" in done.stderr


def test_the_default_device_is_the_card(tmp_path, pair, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["run", *pair, "-o", str(tmp_path / "p.csv")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main([*pair, str(tmp_path / "r.csv")])


def test_launcher_prints_output_match(tmp_path, pair, capsys):
    out = str(tmp_path / "r.csv")
    assert run.main([*pair, out, "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    want = csv_io.load_csv_numpy(out)
    assert f"OUTPUT MATCH: {want.shape[0]} rows -> {out}" in printed
    for stage in ("ingest", "host_to_device", "execute", "materialize", "total"):
        assert f"{stage}:" in printed


def test_launcher_exits_1_on_a_mismatch(tmp_path, pair, monkeypatch, capsys):
    from pim_sort_merge_join_tpu_torch.ops import oracle

    real = oracle.pipeline_oracle
    monkeypatch.setattr(oracle, "pipeline_oracle", lambda *a, **k: real(*a, **k)[1:])
    assert run.main([*pair, str(tmp_path / "r.csv"), "--device", "cpu"]) == 1
    assert "MISMATCH" in capsys.readouterr().err


def test_launcher_as_a_module(tmp_path, pair):
    done = subprocess.run(
        [sys.executable, "-m", "pim_sort_merge_join_tpu_torch.runner.run", *pair,
         str(tmp_path / "r.csv"), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, env={**os.environ, "PYTHONPATH": REPO})
    assert done.returncode == 0, done.stderr
    assert "OUTPUT MATCH" in done.stdout
    assert np.array_equal(csv_io.load_csv_numpy(str(tmp_path / "r.csv")).shape[1:], (7,))
