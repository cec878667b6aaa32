"""The port's stage spans and stage records (`engine/metrics`), on the CPU.

Each test runs over the three query paths of `pipeline_core`: the fused
sort-merge 1:1 join, the staged sort-merge inner join and the hash 1:1
join. Under `torch.profiler`, `run_tables` opens one ``smj.<stage>`` span
per step, flat and in order, with a nested ``smj.sync`` around each host
readback; with the profiler off it makes no span object at all. The
record nests each step under ``execute`` with its counters: the sort
counters equal `hbm_sort.pass_schedule` for the stage's sort sizes.
"""

import json

import numpy as np
import pytest
import torch

from pim_sort_merge_join_tpu_torch import EngineConfig, Predicate, QueryPipeline, Table
from pim_sort_merge_join_tpu_torch.columnar import csv_io
from pim_sort_merge_join_tpu_torch.columnar.generate import generate_table
from pim_sort_merge_join_tpu_torch.ops.kernels.hbm_sort import pass_schedule

CAP1, CAP2 = 9013, 9000  # 18013 elements merge in 3 passes, each table's in 2

PATHS = {
    "fused": dict(),
    "staged": dict(join_mode="inner"),
    "hash": dict(join_algorithm="hash"),
}
STAGES = {
    "fused": ["probe", "keys", "merge", "unmerge", "emit", "readback"],
    "staged": ["probe", "filter", "sort", "join", "readback"],
    "hash": ["probe", "filter", "join", "readback"],
}


def passes(*sizes):
    return sum(1 + len(pass_schedule(n)[1]) for n in sizes)


# The sorts each stage runs, by their sizes (elements = their sum).
SORTS = {
    # merge: the one merge sort; unmerge places the slots' sources and emit
    # gathers the rows, with no sort.
    "fused": {"merge": [CAP1 + CAP2], "unmerge": [], "emit": []},
    # sort: one row sort per table; join: the inner join's merge and
    # un-merge sorts.
    "staged": {"sort": [CAP1, CAP2], "join": [CAP1 + CAP2, CAP1 + CAP2]},
    # join: the restore sort; its children are the fused join core's.
    "hash": {"join": [CAP1]},
}


def tables():
    t1 = Table.from_numpy(generate_table(9000, seed=1), capacity=CAP1, device="cpu")
    t2 = Table.from_numpy(generate_table(9000, seed=2), capacity=CAP2, device="cpu")
    return t1, t2


def pipeline(path, **kw):
    p = Predicate(0, ">", 3 * 9000 // 20)
    return QueryPipeline(EngineConfig(predicate1=p, predicate2=p, **PATHS[path], **kw),
                         device="cpu")


def spans(prof):
    """``(name, start, end)`` of the ``smj.`` spans, by start."""
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith("smj.")),
                  key=lambda s: s[1])


@pytest.mark.parametrize("path", list(PATHS))
def test_spans_are_the_stages_in_order_flat_with_syncs_inside(path):
    pipe = pipeline(path)
    t1, t2 = tables()
    pipe.run_tables(t1, t2)  # warm
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = pipe.run_tables(t1, t2)
    got = spans(prof)
    stages = [s for s in got if s[0] != "smj.sync"]
    assert [s[0] for s in stages] == ["smj." + n for n in STAGES[path]]
    for a, b in zip(stages, stages[1:]):
        assert a[2] <= b[1], f"{a[0]} overlaps {b[0]}"
    syncs = [s for s in got if s[0] == "smj.sync"]
    # One readback in the probe, one for the row count.
    assert len(syncs) == 2
    for _, s, e in syncs:
        owner = [st for st in stages if st[1] <= s and e <= st[2]]
        assert [o[0] for o in owner] in (["smj.probe"], ["smj.readback"])
    assert int(out.num_rows) > 0


@pytest.mark.parametrize("path", list(PATHS))
def test_profiler_off_makes_no_span(path, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function constructed with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    pipe = pipeline(path, debug_log=True)
    out = pipe.run_tables(*tables())
    assert int(out.num_rows) > 0
    execute = json.loads(pipe.metrics_json())["stages"][0]
    assert [s["stage"] for s in execute["stages"]] == (
        ["probe", "debug_filter"] + STAGES[path][1:])


@pytest.mark.parametrize("path", list(PATHS))
def test_record_nests_stages_with_their_counters(path, tmp_path):
    t1, t2 = tables()
    p1, p2, po = (str(tmp_path / f) for f in ("a.csv", "b.csv", "out.csv"))
    csv_io.write_csv(p1, t1.to_numpy())
    csv_io.write_csv(p2, t2.to_numpy())
    pipe = pipeline(path)
    out = pipe.run_csv(p1, p2, po)
    record = json.loads(pipe.metrics_json())["stages"]
    assert [s["stage"] for s in record] == ["ingest", "host_to_device", "execute", "materialize"]
    # run_csv probes the keys on the host, before the tables go up: its
    # probe stage reads nothing back.
    assert [s["stage"] for s in record[2]["stages"]] == STAGES[path]
    assert "readbacks" not in record[2]["stages"][0]
    np.testing.assert_array_equal(csv_io.load_csv_numpy(po), out.to_numpy())

    pipe = pipeline(path)
    out = pipe.run_tables(t1, t2)
    (execute,) = json.loads(pipe.metrics_json())["stages"]
    assert execute["stage"] == "execute"
    children = {s["stage"]: s for s in execute["stages"]}
    assert list(children) == STAGES[path]
    rows = int(out.num_rows)
    assert rows > 0
    assert execute["rows_out"] == children["readback"]["rows_out"] == rows
    assert children["probe"]["readbacks"] == children["readback"]["readbacks"] == 1
    assert children["probe"]["bytes_down"] == 4 * 8 and children["readback"]["bytes_down"] == 4
    assert all(s["launches"] == 0 for s in execute["stages"])  # no kernel on the CPU
    for name, s in children.items():
        want = SORTS[path].get(name, [])
        assert (s.get("elements", 0), s.get("passes", 0)) == (sum(want), passes(*want)), name
    if path == "fused":
        assert children["keys"]["rows_in"] == CAP1 + CAP2
        # The placement reads every merged element.
        assert children["unmerge"]["placed"] == CAP1 + CAP2
        assert children["emit"]["bytes_out"] == CAP1 * 7 * 8
    if path == "hash":
        inner = {s["stage"]: s for s in children["join"]["stages"]}
        assert list(inner) == ["merge", "unmerge", "emit"]
        for name, sizes in SORTS["fused"].items():
            # The join core sorts table 1 with its row index column.
            assert inner[name].get("elements", 0) == sum(sizes), name
            assert inner[name].get("passes", 0) == passes(*sizes), name
        assert inner["unmerge"]["placed"] == CAP1 + CAP2
        # Table 1 with its row index column, table 2 without its key.
        assert inner["emit"]["bytes_out"] == CAP1 * 8 * 8


@pytest.mark.parametrize("sort", ["hbm_sort", "bitonic"])
def test_a_sort_inside_a_stage_counts_its_elements_and_passes(sort):
    """A sort called under an open stage adds its ``elements`` and
    ``passes`` to that stage through `build.count`, whose `counter` is
    `engine/metrics.count`; outside a collector it counts nothing."""
    from pim_sort_merge_join_tpu_torch.engine import metrics
    from pim_sort_merge_join_tpu_torch.ops.kernels import bitonic_sort, build, hbm_sort

    assert build.counter is metrics.count
    keys = torch.arange(1000, 0, -1, dtype=torch.int32)
    vals = torch.arange(1000, dtype=torch.int32)
    if sort == "hbm_sort":
        run, want = (lambda: hbm_sort.hbm_sort_plain((keys, vals))), (1000, passes(1000))
    else:
        run = lambda: bitonic_sort.sort_pairs(keys, vals)  # noqa: E731
        # 1000 pads to the next power of two, at least the kernel's width.
        want = (1000, len(bitonic_sort.bitonic_schedule(max(1024, bitonic_sort.MIN_WIDTH))))
    run()  # no collector: nothing to count into
    collector = metrics.MetricsCollector()
    with metrics.collecting(collector), collector.stage("sort", span=False):
        run()
    (stage,) = collector.stages
    assert (stage.extra["elements"], stage.extra["passes"]) == want
