"""The build lock across processes (`utils/build_lock.py`): two processes
that reach first use of the kernels (or of the native CSV parser) at the
same moment build once, and both get the one library. The compiler is a
stub that logs each call, sleeps and writes its output, so this runs on
the CPU; the builds go to the test's own directory."""

from __future__ import annotations

import os
import subprocess
import sys
import time

import pytest

from pim_sort_merge_join_tpu_torch.ops.kernels import build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUB = """#!{python}
import os, sys, time
with open(os.environ["STUB_LOG"], "a") as f:
    f.write(" ".join(sys.argv[1:]) + "\\n")
time.sleep(0.3)
open(sys.argv[sys.argv.index("-o") + 1], "wb").close()
"""
# Each process says it is ready, waits for the go, then builds.
RACE = """import os, sys, time
from pathlib import Path
from {module} import {name} as m
m.BUILD_DIR = Path(sys.argv[1])
Path(sys.argv[2], f"ready{{os.getpid()}}").touch()
while not Path(sys.argv[2], "go").exists():
    time.sleep(0.005)
print(m.build())
"""


@pytest.mark.parametrize("target,compiler,calls", [
    ("pim_sort_merge_join_tpu_torch.ops.kernels.build", "nvcc", len(build.sources()) + 1),
    ("pim_sort_merge_join_tpu_torch.native.csv_native", "g++", 1),
])
def test_two_processes_build_once(tmp_path, target, compiler, calls):
    stubs, sync, out = tmp_path / "bin", tmp_path / "sync", tmp_path / "build"
    stubs.mkdir()
    sync.mkdir()
    stub = stubs / compiler
    stub.write_text(STUB.format(python=sys.executable))
    stub.chmod(0o755)
    log = tmp_path / "calls.log"
    module, name = target.rsplit(".", 1)
    env = {**os.environ, "PATH": f"{stubs}{os.pathsep}{os.environ['PATH']}", "STUB_LOG": str(log),
           "CXX": str(stub), "PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, "-c", RACE.format(module=module, name=name),
                               str(out), str(sync)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    try:
        deadline = time.monotonic() + 60
        while len(list(sync.glob("ready*"))) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        (sync / "go").touch()
        results = [p.communicate(timeout=60) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), [err for _, err in results]
    paths = {stdout.strip() for stdout, _ in results}
    assert len(paths) == 1 and os.path.exists(paths.pop())
    assert len(log.read_text().splitlines()) == calls
