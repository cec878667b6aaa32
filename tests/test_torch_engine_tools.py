"""The port's roofline model, validation tools and profiling hooks (CPU).

`engine/roofline.py`: filter and join bytes equal the JAX package's model,
the sort term follows the port's own pass schedule, the peak rates come
from the card's name. `utils/validate.py`: `check_table` and
`check_deterministic` on good and broken inputs, beside the JAX package's
functions on the same tables. `engine/profiling.py`: `device_trace` writes
a Chrome trace on the CPU.
"""

import json

import numpy as np
import pytest
import torch

import pim_sort_merge_join_tpu as smj
from pim_sort_merge_join_tpu.engine import roofline as jroof
from pim_sort_merge_join_tpu.utils import validate as jvalidate
from pim_sort_merge_join_tpu_torch import EngineConfig, Predicate, QueryPipeline, Table
from pim_sort_merge_join_tpu_torch.engine import profiling, roofline
from pim_sort_merge_join_tpu_torch.ops.kernels import hbm_sort as hs
from pim_sort_merge_join_tpu_torch.utils import validate

SHAPES = [(100_000, 100_000, 96_000, 95_000, 31_000), (10_000_000, 10_000_000, 8_500_000,
                                                         8_500_000, 3_167_264), (10, 7, 0, 3, 0)]


@pytest.mark.parametrize("dtype", [np.int64, np.int32, np.float64, np.uint64])
@pytest.mark.parametrize("shape", SHAPES)
def test_filter_and_join_bytes_equal_the_reference(shape, dtype):
    for ncol in (2, 4, 7):
        got = roofline.pipeline_traffic(*shape, ncol=ncol, dtype=dtype)
        want = jroof.pipeline_traffic(*shape, ncol=ncol, dtype=dtype)
        assert got.filter_bytes == want.filter_bytes
        assert got.join_bytes == want.join_bytes


@pytest.mark.parametrize("n", [1, hs.RUN, hs.RUN + 1, 2 * hs.RUN + 1, 10_000_000, 20_000_000])
def test_sort_passes_follow_the_pass_schedule(n):
    _, runs = hs.pass_schedule(n)
    assert roofline._sort_passes(n) == 1 + len(runs)
    # int32 keys (or narrowed ones) sort 8-byte elements, int64 keys 12-byte;
    # the rows follow in one gather.
    for itemsize, narrow, elem in ((4, False, 8), (8, True, 8), (8, False, 12)):
        got = roofline._sort_bytes(n, itemsize, 4, narrow=narrow, unique_keys=False)
        assert got == (1 + len(runs)) * 2 * n * elem + 2 * n * 4 * itemsize
    assert roofline._sort_passes(0) == 0


def test_unique_keys_reaches_the_sort_term():
    """A table sort (`sort_by_key`) carries positions and gathers its rows;
    a unique int32 key with one int32 payload sorts as one 8-byte pair."""
    n = 4 * hs.RUN
    table_sort = roofline.pipeline_traffic(n, n, n, n, n, ncol=2, dtype=np.int32)
    unique = roofline.pipeline_traffic(n, n, n, n, n, ncol=2, dtype=np.int32, unique_keys=True)
    passes = roofline._sort_passes(n)
    assert table_sort.sort_bytes == 2 * (passes * 2 * n * 8 + 2 * n * 8)
    assert unique.sort_bytes == 2 * passes * 2 * n * 8
    assert unique.filter_bytes == table_sort.filter_bytes


@pytest.mark.parametrize("name, peak", [("NVIDIA H100 80GB HBM3", 3350.0),
                                        ("NVIDIA H100 PCIe", 2000.0),
                                        ("NVIDIA H100 NVL", 3900.0)])
def test_peak_rate_from_the_card_name(monkeypatch, name, peak):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: name)
    assert roofline.hbm_peak_gbps("cuda") == peak


def test_peak_rate_unknown_card_and_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "Some Card")
    with pytest.raises(ValueError, match="Some Card"):
        roofline.hbm_peak_gbps("cuda")
    assert roofline.hbm_peak_gbps("cpu") == roofline.CPU_NOMINAL_GBPS == 50.0


def test_roofline_fraction_matches_the_reference():
    model = roofline.pipeline_traffic(*SHAPES[1])
    jmodel = jroof.TrafficModel(model.filter_bytes, model.sort_bytes, model.join_bytes)
    for ms in (0.0, 1.0, 9.6, 100.0):
        assert roofline.roofline_fraction(ms, model, 3350.0) == \
            jroof.roofline_fraction(ms, jmodel, 3350.0)
    assert model.speed_of_light_ms(3350.0) == jmodel.speed_of_light_ms(3350.0)


# --- validation -------------------------------------------------------------------------


def _pair(rows, capacity=None, names=None, dtype=np.int64):
    jt = smj.Table.from_numpy(rows, capacity=capacity, names=names, dtype=dtype)
    pt = Table.from_numpy(rows, capacity=capacity, names=names, dtype=dtype, device="cpu")
    return jt, pt


def _outcome(fn, *args, **kw):
    try:
        fn(*args, **kw)
        return "ok"
    except AssertionError as e:
        return str(e)


@pytest.mark.parametrize("dtype", [np.int64, np.int32, np.float64, np.float32, np.uint64, np.uint32])
def test_check_table_matches_the_reference(dtype):
    base = np.array([[1, 9], [2, 8], [2, 7], [5, 6]])
    if dtype == np.uint64:
        base = base.astype(np.uint64) + np.uint64(2**63)
    sorted_rows = base.astype(dtype)
    unsorted = sorted_rows[[0, 2, 3, 1]]
    for rows, col in ((sorted_rows, 0), (unsorted, 0), (sorted_rows, 1), (sorted_rows[:1], 1)):
        jt, pt = _pair(rows, capacity=6, dtype=dtype)
        got, want = (_outcome(validate.check_table, pt, sorted_by=col),
                     _outcome(jvalidate.check_table, jt, sorted_by=col))
        if np.dtype(dtype).kind == "u" and got != "ok":
            # The JAX package's `np.diff` wraps on unsigned columns, so it
            # passes any order; the port compares values (ROADMAP §3).
            assert want == "ok" and "not sorted ascending" in got
        else:
            assert got == want
    jt, pt = _pair(unsorted, dtype=dtype)
    with pytest.raises(validate.ValidationError, match="not sorted ascending at row 2"):
        validate.check_table(pt, sorted_by=0)


def test_check_table_structure():
    jt, pt = _pair(np.arange(8).reshape(4, 2), names=("a", "b"))
    validate.check_table(pt)
    bad_rows = Table(data=pt.data, num_rows=torch.tensor(9, dtype=torch.int32), names=pt.names)
    with pytest.raises(validate.ValidationError, match="num_rows 9 outside"):
        validate.check_table(bad_rows)
    bad_names = Table(data=pt.data, num_rows=pt.num_rows, names=("a", "b", "c"))
    with pytest.raises(validate.ValidationError, match="3 names for 2 columns"):
        validate.check_table(bad_names)
    assert issubclass(validate.ValidationError, AssertionError)


def test_check_table_sorted_in_the_type_order():
    """uint64 beyond 2**63 and floats with -0.0 and +inf order as values,
    not as their bits."""
    u = np.array([[1], [2**63], [2**64 - 1]], np.uint64)
    validate.check_table(Table.from_numpy(u, dtype=np.uint64, device="cpu"), sorted_by=0)
    f = np.array([[-np.inf], [-1.0], [-0.0], [0.0], [np.inf]])
    validate.check_table(Table.from_numpy(f, dtype=np.float64, device="cpu"), sorted_by=0)
    with pytest.raises(validate.ValidationError):
        validate.check_table(Table.from_numpy(u[::-1].copy(), dtype=np.uint64, device="cpu"),
                             sorted_by=0)


def test_check_deterministic_on_a_pipeline_and_on_a_broken_function(small_tables):
    r1, r2 = small_tables
    t1, t2 = (Table.from_numpy(r, device="cpu") for r in (r1, r2))
    pipe = QueryPipeline(EngineConfig(predicate1=Predicate(0, ">", 100),
                                      predicate2=Predicate(0, ">", 100)), device="cpu")
    validate.check_deterministic(pipe.run_tables, t1, t2, reps=3)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(validate.ValidationError, match="nondeterministic"):
        validate.check_deterministic(lambda: {"x": torch.rand(4, generator=gen)})
    with pytest.raises(validate.ValidationError):
        validate.check_deterministic(lambda c=[0]: (c.append(1), torch.zeros(len(c)))[1])
    with pytest.raises(TypeError, match="str"):
        validate.check_deterministic(lambda: "text")


# --- profiling -------------------------------------------------------------------------------


def test_device_trace_writes_a_chrome_trace_on_the_cpu(tmp_path, small_tables):
    r1, r2 = small_tables
    t1, t2 = (Table.from_numpy(r, device="cpu") for r in (r1, r2))
    with profiling.device_trace(str(tmp_path / "prof")) as d:
        QueryPipeline(EngineConfig(), device="cpu").run_tables(t1, t2)
    with open(profiling.trace_path(d)) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_time_cuda_events_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiling.time_cuda_events(lambda: None)
