"""The narrow probe (`ops/kernels/probe.narrow_extremes`), on the CPU.

CPU buffers take the plain version and launch nothing; anything else goes
to the kernel's wrapper, which raises where it does not launch. Tables of
a type the fused path does not narrow resolve "auto" to False unprobed. The wrapper's checks raise the plain version's errors, and
`narrow_extremes_blocked_plain`, the kernel's loads walked thread by thread,
equals the plain version over the card's adversarial cases
(`chip_smoke.probe_cases`) in every layout. The ``probe`` stage counts the
probe's launches and nothing where no probe runs; `narrow_fits` on the
plain version's extremes decides as the host probe of `run_csv` does at the
int32 window's edges. The kernel itself is held against the plain version
on the card (`tests/test_torch_kernels_cuda.py`).
"""

import json

import numpy as np
import pytest
import torch

import chip_smoke
from pim_sort_merge_join_tpu_torch import EngineConfig, Predicate, QueryPipeline, Table
from pim_sort_merge_join_tpu_torch.columnar.generate import generate_table
from pim_sort_merge_join_tpu_torch.engine import pipeline
from pim_sort_merge_join_tpu_torch.engine.pipeline import narrow_fits, resolve_narrow
from pim_sort_merge_join_tpu_torch.ops import kernels
from pim_sort_merge_join_tpu_torch.ops.kernels import build, probe
from pim_sort_merge_join_tpu_torch.ops.kernels.probe import narrow_extremes, narrow_extremes_plain

I32 = np.iinfo(np.int32)
I64 = np.iinfo(np.int64)


def small_cases():
    """The adversarial cases of a few thousand elements or fewer."""
    cases = chip_smoke.probe_cases(np.random.default_rng(20))
    return [c for c in cases if c[1].size + c[2].size < 5000]


@pytest.mark.parametrize("dtype", [np.int64, np.uint64])
def test_cpu_takes_the_plain_version_with_no_launch(dtype):
    rng = np.random.default_rng(3)
    a1 = rng.integers(I64.min, I64.max, (101, 4), dtype=np.int64).view(dtype)
    a2 = rng.integers(-5, 5, (57, 3), dtype=np.int64).view(dtype)
    d1, d2 = torch.from_numpy(a1), torch.from_numpy(a2)
    launches, counted = build.launches, kernels.launch_counts()
    lo, hi = narrow_extremes(d1, d2, 2, 1)
    assert build.launches == launches and kernels.launch_counts() == counted
    want_lo, want_hi = narrow_extremes_plain(d1, d2, 2, 1)
    assert torch.equal(lo, want_lo) and torch.equal(hi, want_hi)
    # The order keys' extremes, from numpy.
    ok1, ok2 = (a.view(np.int64) ^ (I64.min if dtype == np.uint64 else 0) for a in (a1, a2))
    keys = np.concatenate([ok1[:, 2], ok2[:, 1]])
    values = np.concatenate([ok1.ravel(), ok2.ravel()])
    assert lo.tolist() == [keys.min(), values.min()] and hi.tolist() == [keys.max(), values.max()]


@pytest.mark.parametrize("dtype", [torch.int64, torch.uint64])
def test_other_devices_go_to_the_kernel_wrapper(dtype):
    """Off the CPU, int64 and uint64 buffers launch or raise."""
    d = torch.zeros((4, 4), dtype=dtype, device="meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        narrow_extremes(d, d, 0, 0)
    with pytest.raises(ValueError, match="one CUDA device"):
        narrow_extremes(torch.zeros((4, 4), dtype=dtype), d, 0, 0)


def _routes(monkeypatch):
    """Which of the plain version and the wrapper `narrow_extremes` calls."""
    taken = []
    monkeypatch.setattr(probe, "narrow_extremes_plain", lambda *a: taken.append("plain"))
    monkeypatch.setattr(probe, "narrow_extremes_cuda", lambda *a: taken.append("kernel"))
    return taken


@pytest.mark.parametrize("name", ["int32", "uint32", "float32", "float64"])
def test_tables_of_another_type_resolve_auto_to_false_unprobed(name, monkeypatch):
    """`one_to_one_keys` narrows only int64 and uint64 keys, so on tables of
    another type than the configuration's "auto" resolves to False and no
    probe runs; flags given outright stay. `narrow_extremes` itself routes
    by device alone: such buffers off the CPU reach the wrapper."""
    taken = _routes(monkeypatch)
    rows, dtype = generate_table(16, seed=1).astype(name), getattr(torch, name)
    t1, t2 = (Table.from_numpy(rows, dtype=dtype, device="cpu") for _ in range(2))
    resolved = resolve_narrow(EngineConfig(), t1, t2)
    assert (resolved.narrow_keys, resolved.narrow_data) == (False, False)
    given = resolve_narrow(EngineConfig(), t1, t2, narrow=True, narrow_data=True)
    assert (given.narrow_keys, given.narrow_data) == (True, True)
    assert taken == []
    for device in ("cpu", "meta"):
        d = torch.zeros((4, 4), dtype=dtype, device=device)
        narrow_extremes(d, d, 0, 0)
    assert taken == ["plain", "kernel"]


@pytest.mark.parametrize("case", chip_smoke.probe_error_cases(), ids=lambda c: c[0])
def test_wrapper_checks_raise_the_plain_versions_errors(case):
    _, s1, s2, k1, k2 = case
    d1, d2 = (torch.arange(int(np.prod(s)), dtype=torch.int64).view(s) for s in (s1, s2))
    want = chip_smoke.probe_error(case, "cpu")
    try:
        keys = probe._checked(d1, d2, k1, k2)
    except Exception as e:  # noqa: BLE001 - the error itself is compared
        assert (type(e).__name__, str(e)) == want
    else:
        assert want is None
        assert keys == (k1 % s1[1], k2 % s2[1])


@pytest.mark.parametrize("dtype", [torch.int32, torch.float64])
def test_wrapper_refuses_types_it_does_not_read(dtype):
    d = torch.zeros((4, 4), dtype=dtype)
    with pytest.raises(ValueError, match="int64/uint64"):
        probe._checked(d, d, 0, 0)


@pytest.mark.parametrize("threads", [1, 7, 256])
@pytest.mark.parametrize("view", ["contiguous", "one element in", "every other row",
                                  "column slice", "column-major"])
def test_blocked_walk_matches_plain(view, threads):
    """Each layout of table 1 beside table 2 as it is and column-major."""
    for name, a1, a2, k1, k2 in small_cases():
        d1, d2 = torch.from_numpy(a1), torch.from_numpy(a2)
        want = torch.cat(narrow_extremes_plain(d1, d2, k1, k2))
        v2 = chip_smoke.probe_views(d2)
        w1 = chip_smoke.probe_views(d1)[view]
        if min(a1.shape) > 1:  # a single row or column is contiguous in any layout
            assert probe._vec(w1) == (view == "contiguous"), name
        for w2 in (v2["contiguous"], v2["column-major"]):
            got = torch.cat(probe.narrow_extremes_blocked_plain(w1, w2, k1, k2, threads=threads))
            assert torch.equal(got, want), (name, view, threads)


def test_blocked_walk_splits_pairs_across_rows():
    """Rows of 3 and 7 elements: a 16-byte pair straddles two rows, and
    the key column is the pair's second element as often as its first."""
    d1 = torch.arange(3 * 5, dtype=torch.int64).view(5, 3)
    d2 = torch.arange(7 * 3, dtype=torch.int64).view(3, 7) + 100
    for k1 in range(3):
        for k2 in range(7):
            want = torch.cat(narrow_extremes_plain(d1, d2, k1, k2))
            assert want.tolist() == [k1, 0, 100 + 14 + k2, 120]
            for threads in (1, 2, 3, 5):
                got = torch.cat(probe.narrow_extremes_blocked_plain(d1, d2, k1, k2, threads=threads))
                assert torch.equal(got, want), (k1, k2, threads)


def counting_probe(calls):
    """`narrow_extremes` as one kernel launch would count it: the plain
    version, with one launch added to `ops/kernels/build.launches`."""

    def fake(d1, d2, k1, k2):
        calls.append((k1, k2))
        build.launched("narrow_extremes")
        return narrow_extremes_plain(d1, d2, k1, k2)

    return fake


# (configuration, run_tables arguments, probe launches)
PROBE_RUNS = {
    "auto": (dict(), dict(), 1),
    "keys_auto_data_given": (dict(narrow_data=False), dict(), 1),
    "data_auto_keys_given": (dict(narrow_keys=True), dict(), 1),
    "both_given": (dict(narrow_keys=True, narrow_data=False), dict(), 0),
    "both_given_off": (dict(narrow_keys=False, narrow_data=False), dict(), 0),
    "arguments_given": (dict(), dict(narrow=False, narrow_data=False), 0),
    "int32": (dict(dtype="int32"), dict(), 0),
    "float64": (dict(dtype="float64"), dict(), 0),
}


@pytest.mark.parametrize("run", list(PROBE_RUNS))
def test_probe_stage_counts_the_probes_launches(run, monkeypatch):
    cfg_kw, args, want = PROBE_RUNS[run]
    calls = []
    monkeypatch.setattr(pipeline, "narrow_extremes", counting_probe(calls))
    p = Predicate(0, ">", 300)
    dtype = cfg_kw.get("dtype", "int64")
    t1, t2 = (Table.from_numpy(generate_table(2000, seed=s), device="cpu", dtype=np.dtype(dtype))
              for s in (1, 2))
    pipe = QueryPipeline(EngineConfig(predicate1=p, predicate2=p, **cfg_kw), device="cpu")
    out = pipe.run_tables(t1, t2, **args)
    (execute,) = json.loads(pipe.metrics_json())["stages"]
    probe_stage = execute["stages"][0]
    assert probe_stage["stage"] == "probe"
    assert probe_stage["launches"] == want == len(calls)
    assert probe_stage.get("readbacks", 0) == want
    assert all(s["launches"] == 0 for s in execute["stages"][1:])
    assert int(out.num_rows) > 0
    if want:
        assert pipe.resolved_narrow_keys is cfg_kw.get("narrow_keys", True)
        assert pipe.resolved_narrow_data is cfg_kw.get("narrow_data", True)


EDGES_INT64 = [I32.min - 1, I32.min, 0, I32.max - 1, I32.max, I64.min, I64.max]
EDGES_UINT64 = [0, I32.max - 1, I32.max, 2**63, 2**64 - 1]


@pytest.mark.parametrize(
    "dtype,key,other",
    [(np.int64, k, o) for k in EDGES_INT64 for o in (I32.min - 1, I32.max - 1, I32.max)]
    + [(np.uint64, k, o) for k in EDGES_UINT64 for o in (I32.max - 1, 2**32)],
)
def test_narrow_fits_decides_as_the_host_probe(dtype, key, other):
    """One key and one payload value at the window's edges, the rest inside
    it; the buffers padded past their rows (zeros), as the card's are."""
    rows = [np.array([[5, 1, 2, 3], [7, 4, 5, 6], [9, 7, 8, 9]], np.int64).astype(dtype)
            for _ in range(2)]
    rows[0][1, 0] = dtype(key)
    rows[1][2, 3] = dtype(other)
    t1, t2 = (Table.from_numpy(r, capacity=8, device="cpu", dtype=dtype) for r in rows)
    got = narrow_fits(*narrow_extremes_plain(t1.data, t2.data, 0, 0), t1.data.dtype)
    cfg = EngineConfig(dtype=np.dtype(dtype).name)
    want = (cfg.resolve_narrow(rows[0][:, 0], rows[1][:, 0]).narrow_keys,
            cfg.resolve_narrow_data(*rows).narrow_data)
    assert got == want
    resolved = resolve_narrow(cfg, t1, t2)
    assert (resolved.narrow_keys, resolved.narrow_data) == want
