"""Device time by the program's own stages.

The program marks each step of a query with a span ``smj.<stage>`` while
the profiler records (`pim_sort_merge_join_tpu_torch/engine/metrics`), flat
inside `run_tables`, and each host readback with a nested ``smj.sync``.
Here every device op inside the traced ``bench.query`` spans is given to
the stage whose span was open when its launch call was made. A query's
work runs on one stream, so its device ops start in the order of their
launch calls: the k-th launch call of a query (`LAUNCH`) is the k-th
device op that starts inside it. Where a query's launch calls and device
ops differ in number, nothing is attributed. All times are microseconds.
"""

from __future__ import annotations

import bisect
import re

from benchmark.traced import busy, overlap

STAGE_PREFIX = "smj."
SYNC = STAGE_PREFIX + "sync"
# The host calls that put one op on the device's stream.
LAUNCH = re.compile(r"^(?:cudaLaunchKernel\w*|cuLaunchKernel\w*|cudaMemcpyAsync|cudaMemsetAsync)$")


def _stage_spans(tw) -> list:
    """``(start, end, stage)`` of the program's stage spans, by start."""
    return sorted((s, e, n[len(STAGE_PREFIX):]) for n, s, e in tw.host_ops
                  if n.startswith(STAGE_PREFIX) and n != SYNC)


def attribute(tw) -> dict | None:
    """The device ops inside the traced queries by the stage that launched
    them (None: no stage span was open), or None where the launch calls and
    the device ops of a query do not pair or there is nothing to read."""
    queries = tw.spans.get("query")
    if not queries or not tw.device_ops:
        return None
    stages = _stage_spans(tw)
    starts = [s for s, _, _ in stages]
    calls = sorted(s for n, s, _ in tw.host_ops if LAUNCH.match(n))
    ops = sorted(tw.device_ops, key=lambda op: op[1])
    op_starts = [op[1] for op in ops]
    out: dict = {}
    for qs, qe in queries:
        q_calls = calls[bisect.bisect_left(calls, qs):bisect.bisect_left(calls, qe)]
        q_ops = ops[bisect.bisect_left(op_starts, qs):bisect.bisect_left(op_starts, qe)]
        if len(q_calls) != len(q_ops):
            return None
        for t, op in zip(q_calls, q_ops):
            i = bisect.bisect_right(starts, t) - 1
            stage = stages[i][2] if i >= 0 and t < stages[i][1] else None
            out.setdefault(stage, []).append(op)
    return out


def stage_ms_per_query(tw, stage: str) -> float | None:
    """Device time of the ops ``stage`` launched, ms a query; None where
    nothing is attributed or the program marks no stage."""
    by_stage = attribute(tw)
    if not by_stage or not tw.queries or set(by_stage) == {None}:
        return None
    return sum(e - s for _, s, e in by_stage.get(stage, [])) / 1e3 / tw.queries


def sync_idle_ms_per_query(tw) -> float | None:
    """Inside each traced query, the device's idle time from the end of each
    ``smj.sync`` span to the start of the next device op (or the query's
    end), ms a query; None where the program marks no readback."""
    queries = tw.spans.get("query")
    syncs = sorted(e for n, _, e in tw.host_ops if n == SYNC)
    if not queries or not syncs or not tw.device_ops or not tw.queries:
        return None
    busy_ivs = busy(tw.device_ops)
    op_starts = sorted(s for _, s, _ in tw.device_ops)
    idle = 0.0
    for qs, qe in queries:
        for t in syncs[bisect.bisect_right(syncs, qs):bisect.bisect_right(syncs, qe)]:
            i = bisect.bisect_left(op_starts, t)
            stop = min(op_starts[i] if i < len(op_starts) else qe, qe)
            if stop > t:
                idle += (stop - t) - overlap(busy_ivs, [(t, stop)])
    return idle / 1e3 / tw.queries
