"""What a traced window holds, taken from `torch.profiler`, and the interval
arithmetic the per-layer readers share.

The harness marks its own spans with `torch.profiler.record_function`
(``bench.<name>``: ``bench.query`` around `QueryPipeline.run_tables`),
so they share the profiler's clock with the device's activity. All times are microseconds.

Each device op and each host operation also keeps the profiler's
correlation id (`FunctionEvent.id`): a kernel, copy or memset has the id
of the runtime call that launched it (``cudaLaunchKernel``,
``cudaMemcpyAsync``, ``cudaMemsetAsync``; torch 2.11 on an H100). Torch's
own operators number their events in another series, so an id ties a
device op only to a launch call.
"""

from __future__ import annotations

import bisect
import dataclasses
import re

SPAN_PREFIX = "bench."
SHORT_GAP_US = 10.0  # idle gaps below this are named as one group

Interval = tuple[float, float]


@dataclasses.dataclass
class TracedWindow:
    """The traced part of a window.

    ``device_ops`` are ``(name, start, end)`` of every kernel, copy and
    memset on the card; ``spans`` the harness's spans by name;
    ``host_ops`` ``(name, start, end)`` of the host thread's operations;
    ``queries`` the queries the window traced; ``least_bytes`` what they
    need to move at the least (`roofline.least_bytes`), summed;
    ``peak_bytes_per_s`` the card's published memory rate or None.
    ``device_op_ids`` and ``host_op_ids`` are the correlation ids of
    ``device_ops`` and ``host_ops``, index for index (empty: not kept).
    On a cell of several ranks (`benchmark/ranks.py`) this is rank 0's
    window, and ``ranks`` holds every rank's, in rank order (each with
    ``ranks`` empty); compare times only within one rank's window.
    """

    device_ops: list
    spans: dict
    host_ops: list
    queries: int
    least_bytes: float
    peak_bytes_per_s: float | None
    device_op_ids: list = dataclasses.field(default_factory=list)
    host_op_ids: list = dataclasses.field(default_factory=list)
    ranks: list = dataclasses.field(default_factory=list)

    @property
    def window(self) -> Interval:
        ends = [iv for ivs in self.spans.values() for iv in ivs]
        return min(s for s, _ in ends), max(e for _, e in ends)

    @property
    def window_us(self) -> float:
        start, end = self.window
        return end - start


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def name_pattern(*functions: str) -> re.Pattern:
    """Matches a device name whose function (after any namespace, before
    any template or argument list) is one of ``functions``, each a regular
    expression."""
    return re.compile(r"(?:^|[\s:])(?:" + "|".join(functions) + r")(?=[<(]|$)")


def union(intervals) -> list[Interval]:
    merged: list[list[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def overlap(intervals, spans) -> float:
    """Length of the union of ``intervals`` that lies inside ``spans``."""
    spans = union(spans)
    starts = [s for s, _ in spans]
    total = 0.0
    for s, e in union(intervals):
        i = max(bisect.bisect_right(starts, s) - 1, 0)
        while i < len(spans) and spans[i][0] < e:
            total += max(0.0, min(e, spans[i][1]) - max(s, spans[i][0]))
            i += 1
    return total


def inside(ops, spans) -> list:
    """The ``(name, start, end)`` ops that start inside one of ``spans``."""
    spans = union(spans)
    starts = [s for s, _ in spans]
    out = []
    for op in ops:
        i = bisect.bisect_right(starts, op[1]) - 1
        if i >= 0 and op[1] < spans[i][1]:
            out.append(op)
    return out


def busy(ops) -> list[Interval]:
    return union((s, e) for _, s, e in ops)


def from_profiler(prof, queries: int, least_bytes: float,
                  peak_bytes_per_s: float | None) -> TracedWindow:
    """A `TracedWindow` from a finished `torch.profiler.profile`."""
    from torch.autograd import DeviceType

    device_ops, device_ids, spans, host = [], [], {}, []
    span_thread = None
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # A span's range on the device timeline is no device work.
            if not e.name.startswith(SPAN_PREFIX) and not getattr(e, "is_user_annotation", False):
                device_ops.append((e.name, start, end))
                device_ids.append(e.id)
        elif e.name.startswith(SPAN_PREFIX):
            spans.setdefault(e.name[len(SPAN_PREFIX):], []).append((start, end))
            span_thread = e.thread
        else:
            host.append((e.name, start, end, e.thread, e.id))
    mine = [op for op in host if op[3] == span_thread]
    return TracedWindow(device_ops, spans, [(n, s, e) for n, s, e, _, _ in mine], queries,
                        least_bytes, peak_bytes_per_s, device_ids, [i for *_, i in mine])


def host_chains(host_ops, spans: dict, times) -> list[str]:
    """For each time in ``times`` (ascending), what the host thread was
    doing: the harness span, the outermost and the innermost operation
    running then, as ``span / outer / inner``."""
    events = sorted([(s, e, n) for n, s, e in host_ops]
                    + [(s, e, SPAN_PREFIX + k) for k, ivs in spans.items() for s, e in ivs])
    labels, stack, j = [], [], 0
    for t in times:
        while j < len(events) and events[j][0] <= t:
            stack = [x for x in stack if x[1] > events[j][0]]
            stack.append(events[j])
            j += 1
        live = [x for x in stack if x[1] > t]
        span = next((x[2][len(SPAN_PREFIX):] for x in live if x[2].startswith(SPAN_PREFIX)),
                    "between queries")
        ops = [x[2] for x in live if not x[2].startswith(SPAN_PREFIX)]
        labels.append(" / ".join([span] + ([ops[0]] if ops else [])
                                 + ([ops[-1]] if len(ops) > 1 else [])))
    return labels


def breakdown(tw: TracedWindow, top: int = 10) -> dict:
    """The device operations that took most time and the idle time by what
    the host was doing, each at most ``top`` entries of ``[name, seconds]``."""
    by_name: dict = {}
    for name, s, e in tw.device_ops:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    start, end = tw.window
    runs = [(start, start)] + [iv for iv in busy(tw.device_ops) if iv[1] > start and iv[0] < end]
    runs.append((end, end))
    gaps = [(max(a[1], start), min(b[0], end)) for a, b in zip(runs, runs[1:])]
    gaps = [(s, e) for s, e in gaps if e > s]
    # A long gap is cut where a host operation or span starts or ends, and
    # each piece is named by what the host was doing in it.
    edges = sorted({t for _, a, b in tw.host_ops for t in (a, b)}
                   | {t for ivs in tw.spans.values() for iv in ivs for t in iv})
    pieces = []
    for s, e in gaps:
        if e - s >= SHORT_GAP_US:
            cuts = [s] + edges[bisect.bisect_right(edges, s):bisect.bisect_left(edges, e)] + [e]
            pieces += list(zip(cuts, cuts[1:]))
    idle: dict = {}
    labels = host_chains(tw.host_ops, tw.spans, [(s + e) / 2 for s, e in pieces])
    for (s, e), label in zip(pieces, labels):
        idle[label] = idle.get(label, 0.0) + (e - s)
    short = sum(e - s for s, e in gaps if e - s < SHORT_GAP_US)
    if short:
        idle[f"gaps under {SHORT_GAP_US:g} us"] = short
    gaps_out = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:200], t / 1e6] for n, t in ops],
            "idle_gaps": [[n[:200], t / 1e6] for n, t in gaps_out]}
