"""The stage readers (`benchmark/stages.py`) on traced windows made by hand,
whose answers are counted below (microseconds)."""

import bisect
import dataclasses

import pytest

from benchmark import harness, stages, traced

SORT = "void (anonymous namespace)::merge_kernel<false, false>(unsigned long const*)"
SCAN = "void (anonymous namespace)::join_scan_forward_kernel<int>(int const*)"
GATHER = "(anonymous namespace)::gather_rows_kernel((anonymous namespace)::RowsArgs, int)"
TORCH = "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<long> >(int)"
NCCL = "ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)"
D2H = "Memcpy DtoH (Device -> Pageable)"
H2D = "Memcpy HtoD (Pageable -> Device)"
MEMSET = "Memset (Device)"
LAUNCH, COPY, SET = "cudaLaunchKernel", "cudaMemcpyAsync", "cudaMemsetAsync"
STAGES = ("probe", "keys", "merge", "unmerge", "emit")


def window():
    # Query 1, 0-100: every stage of the fused path, a readback in the probe
    # and one in the row count. Query 2, 100-150: a launch before any stage,
    # a merge, the row count. Between them and after: no query's. The last
    # element is the correlation id: a launch call and its device op share
    # one; torch's operators number theirs in a series of their own, which
    # may repeat a launch's (aten::min has 5, as the merge's sort).
    host_ops = [
        ("smj.probe", 0, 20, 90), ("aten::min", 1, 3, 5), (LAUNCH, 2, 3, 1),
        ("smj.sync", 9, 18, 91), (COPY, 10, 17, 2), ("cudaStreamSynchronize", 11, 17, 92),
        ("smj.keys", 20, 40, 93), (LAUNCH, 21, 22, 3), (COPY, 23, 24, 4),
        ("smj.merge", 40, 60, 94), (LAUNCH, 41, 42, 5), (LAUNCH, 43, 44, 6),
        ("smj.unmerge", 60, 70, 95), (LAUNCH, 61, 62, 7),
        ("smj.emit", 70, 85, 96), (SET, 71, 72, 8), ("cudaLaunchKernelExC", 73, 74, 9),
        ("smj.readback", 85, 98, 97), ("smj.sync", 86, 96, 98), (COPY, 87, 88, 10),
        (LAUNCH, 101, 102, 11),
        ("smj.merge", 103, 130, 99), (LAUNCH, 104, 105, 12),
        ("smj.readback", 130, 148, 100), ("smj.sync", 131, 140, 101), (COPY, 132, 133, 13),
        (LAUNCH, 155, 156, 14),
    ]
    device_ops = [
        (TORCH, 4, 8, 1), (D2H, 12, 14, 2),  # probe: 6
        (TORCH, 25, 27, 3), (H2D, 27, 28, 4),  # keys: 3
        (SORT, 45, 55, 5), (SCAN, 55, 58, 6),  # merge: 13
        (SORT, 62, 66, 7),  # unmerge: 4
        (MEMSET, 72, 73, 8), (GATHER, 75, 80, 9),  # emit: 6
        (D2H, 90, 91, 10),  # readback: 1
        (TORCH, 105, 110, 11),  # no stage: 5
        (SORT, 110, 125, 12),  # merge: 15
        (D2H, 135, 136, 13),  # readback: 1
        (TORCH, 160, 165, 14),  # between queries
    ]
    spans = {"query": [(0, 100), (100, 150)]}
    return traced.TracedWindow([op[:3] for op in device_ops], spans,
                               [op[:3] for op in host_ops], queries=2, least_bytes=1.0,
                               peak_bytes_per_s=3.35e12,
                               device_op_ids=[op[3] for op in device_ops],
                               host_op_ids=[op[3] for op in host_ops])


WANT = {"probe": 6, "keys": 3, "merge": 28, "unmerge": 4, "emit": 6, "readback": 2, None: 5}


def read(name, tw):
    return harness.load_module("layers", name).read(tw)


def device_us(by_stage):
    return {k: sum(e - s for _, s, e in ops) for k, ops in by_stage.items()}


def order_pairing(tw):
    """The pairing `stages.attribute` made before it read correlation ids,
    kept as the oracle: a query's k-th launch call is the k-th device op
    that starts inside it, on one clock; None where the counts differ."""
    queries = tw.spans.get("query")
    stages_ = stages._stage_spans(tw)
    starts = [s for s, _, _ in stages_]
    calls = sorted(s for n, s, _ in tw.host_ops if stages.LAUNCH.match(n))
    ops = sorted(tw.device_ops, key=lambda op: op[1])
    op_starts = [op[1] for op in ops]
    out = {}
    for qs, qe in queries:
        q_calls = calls[bisect.bisect_left(calls, qs):bisect.bisect_left(calls, qe)]
        q_ops = ops[bisect.bisect_left(op_starts, qs):bisect.bisect_left(op_starts, qe)]
        if len(q_calls) != len(q_ops):
            return None
        for t, op in zip(q_calls, q_ops):
            i = bisect.bisect_right(starts, t) - 1
            stage = stages_[i][2] if i >= 0 and t < stages_[i][1] else None
            out.setdefault(stage, []).append(op)
    return out


def test_each_op_goes_to_the_stage_that_launched_it():
    tw = window()
    by_stage = stages.attribute(tw)
    assert device_us(by_stage) == WANT
    inside = traced.inside(tw.device_ops, tw.spans["query"])
    assert sorted(op for ops in by_stage.values() for op in ops) == sorted(inside)
    for stage, us in [("probe", 6), ("keys", 3), ("merge", 28), ("unmerge", 4), ("emit", 6)]:
        assert read(f"{stage}_ms_per_query", tw) == pytest.approx(us / 1e3 / 2)


def test_correlation_pairing_equals_the_order_pairing_on_one_stream():
    tw = window()
    assert stages.attribute(tw) == order_pairing(tw)


def test_a_second_stream_out_of_launch_order_is_attributed():
    # The merge of query 1 launches a collective on a second stream at 46;
    # it starts at 100.5, after query 2's first op was launched and inside
    # query 2's span on the device, so the counts of query 1 and 2 differ.
    tw = window()
    tw.host_ops.insert(12, (LAUNCH, 46, 47))
    tw.host_op_ids.insert(12, 15)
    tw.device_ops.append((NCCL, 100.5, 103))
    tw.device_op_ids.append(15)
    assert order_pairing(tw) is None
    assert device_us(stages.attribute(tw)) == {**WANT, "merge": 28 + 2.5}
    assert read("merge_ms_per_query", tw) == pytest.approx(30.5 / 1e3 / 2)


def test_a_device_clock_3_ms_off_is_attributed():
    tw = window()
    tw.device_ops = [(n, s + 3000, e + 3000) for n, s, e in tw.device_ops]
    assert order_pairing(tw) is None
    assert device_us(stages.attribute(tw)) == WANT
    for stage in STAGES:
        assert read(f"{stage}_ms_per_query", tw) == read(f"{stage}_ms_per_query", window())


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


def test_an_op_without_its_launch_goes_to_no_stage():
    # The unmerge's launch call is not in the window: its op, which starts
    # inside query 1, goes to no stage; every other op keeps its stage.
    tw = window()
    k = tw.host_ops.index((LAUNCH, 61, 62))
    del tw.host_ops[k], tw.host_op_ids[k]
    want = {k: v for k, v in WANT.items() if k != "unmerge"}
    assert device_us(stages.attribute(tw)) == {**want, None: 5 + 4}
    assert read("unmerge_ms_per_query", tw) == 0
    assert read("merge_ms_per_query", tw) == pytest.approx(28 / 1e3 / 2)


def test_a_window_without_correlation_ids_reads_nothing():
    tw = dataclasses.replace(window(), device_op_ids=[], host_op_ids=[])
    assert stages.attribute(tw) is None
    for stage in STAGES:
        assert read(f"{stage}_ms_per_query", tw) is None


def test_a_program_without_stage_spans_reads_nothing():
    tw = window()
    keep = [i for i, op in enumerate(tw.host_ops) if not op[0].startswith("smj.")]
    tw.host_ops = [tw.host_ops[i] for i in keep]
    tw.host_op_ids = [tw.host_op_ids[i] for i in keep]
    for name in [f"{s}_ms_per_query" for s in STAGES] + ["sync_idle_ms_per_query"]:
        assert read(name, tw) is None


def test_breakdown_names_idle_time_by_stage():
    idle = dict(traced.breakdown(window(), top=50)["idle_gaps"])
    # The probe's copy waits 14-17; the keys' host time 20-21, 22-23,
    # 24-25 between its calls and 28-40 after its last op.
    assert idle["query / smj.probe / cudaStreamSynchronize"] == pytest.approx(3 / 1e6)
    assert idle["query / smj.keys"] == pytest.approx(15 / 1e6)
