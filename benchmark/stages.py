"""Device time by the program's own stages.

The program marks each step of a query with a span ``smj.<stage>`` while
the profiler records (`pim_sort_merge_join_tpu_torch/engine/metrics`), flat
inside `run_tables`, and each host readback with a nested ``smj.sync``.
Here every device op that a traced ``bench.query`` span launched is given
to the stage whose span was open when its launch call (`LAUNCH`) was
made. The op and its call are paired by the profiler's correlation id
(`traced.TracedWindow.device_op_ids`), so the pairing holds whatever
stream the op ran on and wherever the device's clock sits against the
host's; the query and the stage are read on the host's clock alone. An op
whose launch call is not in the window goes to no stage, and to no query
unless it starts inside one. All times are microseconds.
"""

from __future__ import annotations

import bisect
import re

from benchmark.traced import busy, overlap, union

STAGE_PREFIX = "smj."
SYNC = STAGE_PREFIX + "sync"
# The host calls that put one op on the device's stream.
LAUNCH = re.compile(r"^(?:cudaLaunchKernel\w*|cuLaunchKernel\w*|cudaMemcpyAsync|cudaMemsetAsync)$")


def _stage_spans(tw) -> list:
    """``(start, end, stage)`` of the program's stage spans, by start."""
    return sorted((s, e, n[len(STAGE_PREFIX):]) for n, s, e in tw.host_ops
                  if n.startswith(STAGE_PREFIX) and n != SYNC)


def attribute(tw) -> dict | None:
    """The device ops of the traced queries by the stage that launched
    them (None: no stage span was open, or no launch call was found), or
    None where the window keeps no correlation ids or has nothing to read.
    An op belongs to a query if its launch call was made inside the
    query's span, or, with no launch call in the window, if it starts
    inside it."""
    queries = tw.spans.get("query")
    if (not queries or not tw.device_ops or len(tw.device_op_ids) != len(tw.device_ops)
            or len(tw.host_op_ids) != len(tw.host_ops)):
        return None
    stages = _stage_spans(tw)
    starts = [s for s, _, _ in stages]
    launched = {i: s for (n, s, _), i in zip(tw.host_ops, tw.host_op_ids) if LAUNCH.match(n)}
    spans = union(queries)
    span_starts = [s for s, _ in spans]

    def in_query(t: float) -> bool:
        i = bisect.bisect_right(span_starts, t) - 1
        return i >= 0 and t < spans[i][1]

    out: dict = {}
    for op, i in zip(tw.device_ops, tw.device_op_ids):
        t = launched.get(i)
        if t is None:
            if in_query(op[1]):
                out.setdefault(None, []).append(op)
        elif in_query(t):
            j = bisect.bisect_right(starts, t) - 1
            stage = stages[j][2] if j >= 0 and t < stages[j][1] else None
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
