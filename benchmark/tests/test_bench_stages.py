"""The stage readers (`benchmark/stages.py`) on traced windows made by hand,
whose answers are counted below (microseconds)."""

import pytest

from benchmark import harness, stages, traced

SORT = "void (anonymous namespace)::merge_kernel<false, false>(unsigned long const*)"
SCAN = "void (anonymous namespace)::join_scan_forward_kernel<int>(int const*)"
GATHER = "(anonymous namespace)::gather_rows_kernel((anonymous namespace)::RowsArgs, int)"
TORCH = "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<long> >(int)"
D2H = "Memcpy DtoH (Device -> Pageable)"
H2D = "Memcpy HtoD (Pageable -> Device)"
MEMSET = "Memset (Device)"
LAUNCH, COPY, SET = "cudaLaunchKernel", "cudaMemcpyAsync", "cudaMemsetAsync"
STAGES = ("probe", "keys", "merge", "unmerge", "emit")


def window():
    # Query 1, 0-100: every stage of the fused path, a readback in the probe
    # and one in the row count. Query 2, 100-150: a launch before any stage,
    # a merge, the row count. Between them and after: no query's.
    host_ops = [
        ("smj.probe", 0, 20), ("aten::min", 1, 3), (LAUNCH, 2, 3), ("smj.sync", 9, 18),
        (COPY, 10, 17), ("cudaStreamSynchronize", 11, 17),
        ("smj.keys", 20, 40), (LAUNCH, 21, 22), (COPY, 23, 24),
        ("smj.merge", 40, 60), (LAUNCH, 41, 42), (LAUNCH, 43, 44),
        ("smj.unmerge", 60, 70), (LAUNCH, 61, 62),
        ("smj.emit", 70, 85), (SET, 71, 72), ("cudaLaunchKernelExC", 73, 74),
        ("smj.readback", 85, 98), ("smj.sync", 86, 96), (COPY, 87, 88),
        (LAUNCH, 101, 102),
        ("smj.merge", 103, 130), (LAUNCH, 104, 105),
        ("smj.readback", 130, 148), ("smj.sync", 131, 140), (COPY, 132, 133),
        (LAUNCH, 155, 156),
    ]
    device_ops = [
        (TORCH, 4, 8), (D2H, 12, 14),  # probe: 6
        (TORCH, 25, 27), (H2D, 27, 28),  # keys: 3
        (SORT, 45, 55), (SCAN, 55, 58),  # merge: 13
        (SORT, 62, 66),  # unmerge: 4
        (MEMSET, 72, 73), (GATHER, 75, 80),  # emit: 6
        (D2H, 90, 91),  # readback: 1
        (TORCH, 105, 110),  # no stage: 5
        (SORT, 110, 125),  # merge: 15
        (D2H, 135, 136),  # readback: 1
        (TORCH, 160, 165),  # between queries
    ]
    spans = {"query": [(0, 100), (100, 150)]}
    return traced.TracedWindow(device_ops, spans, host_ops, queries=2, least_bytes=1.0,
                               peak_bytes_per_s=3.35e12)


def read(name, tw):
    return harness.load_module("layers", name).read(tw)


def test_each_op_goes_to_the_stage_that_launched_it():
    tw = window()
    by_stage = stages.attribute(tw)
    want = {"probe": 6, "keys": 3, "merge": 28, "unmerge": 4, "emit": 6, "readback": 2, None: 5}
    assert {k: sum(e - s for _, s, e in ops) for k, ops in by_stage.items()} == want
    inside = traced.inside(tw.device_ops, tw.spans["query"])
    assert sorted(op for ops in by_stage.values() for op in ops) == sorted(inside)
    for stage, us in [("probe", 6), ("keys", 3), ("merge", 28), ("unmerge", 4), ("emit", 6)]:
        assert read(f"{stage}_ms_per_query", tw) == pytest.approx(us / 1e3 / 2)


def test_sync_idle_runs_to_the_next_op_or_the_query_end():
    # Query 1: 18 to the keys' op at 25 (7), 96 to the query's end at 100
    # (4, not to the next query's op at 105); query 2: 140 to its end (10).
    assert read("sync_idle_ms_per_query", window()) == pytest.approx((7 + 4 + 10) / 1e3 / 2)


def test_sync_idle_leaves_out_an_op_still_running():
    tw = window()
    tw.device_ops[2] = (TORCH, 16, 27)  # the keys' op starts inside the probe's sync
    tw.host_ops[7] = (LAUNCH, 15, 16)
    tw.host_ops.sort(key=lambda op: op[1])
    # From 18 the card is busy until 27, then its next op starts at 27.
    assert read("sync_idle_ms_per_query", tw) == pytest.approx((0 + 4 + 10) / 1e3 / 2)


def test_a_missing_launch_attributes_nothing():
    tw = window()
    tw.host_ops.remove((LAUNCH, 61, 62))
    assert stages.attribute(tw) is None
    for stage in STAGES:
        assert read(f"{stage}_ms_per_query", tw) is None


def test_a_program_without_stage_spans_reads_nothing():
    tw = window()
    tw.host_ops = [op for op in tw.host_ops if not op[0].startswith("smj.")]
    for name in [f"{s}_ms_per_query" for s in STAGES] + ["sync_idle_ms_per_query"]:
        assert read(name, tw) is None


def test_breakdown_names_idle_time_by_stage():
    idle = dict(traced.breakdown(window(), top=50)["idle_gaps"])
    # The probe's copy waits 14-17; the keys' host time 20-21, 22-23,
    # 24-25 between its calls and 28-40 after its last op.
    assert idle["query / smj.probe / cudaStreamSynchronize"] == pytest.approx(3 / 1e6)
    assert idle["query / smj.keys"] == pytest.approx(15 / 1e6)
