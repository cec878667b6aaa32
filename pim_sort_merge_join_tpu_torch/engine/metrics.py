"""Stage metrics: wall timers, row counts, bytes moved, and the query's
stage spans.

Replaces the reference's 7-slot `gettimeofday` timer (`timer.h:38-63`) and
its 3-way CPU->DPU / DPU / DPU->CPU printout (app.c:763-772) with structured
per-stage records that serialize to JSON (the machine-readable output the
reference's `test/run.sh` sweep lacks, SURVEY.md section 4).

A stage opened inside another is recorded as its child (``stages`` in the
parent's record). `QueryPipeline.run_tables` makes its collector the
active one (`collecting`); the ops below it open stages (`stage`) and add
counters (`count`, `sync`) to the innermost open stage of the active
collector, and with none active they record nothing. Every stage also
counts the kernel launches made while it was open, its children's included
(``launches``, from `ops/kernels/build.launches`); the sorts count their
``elements`` and ``passes`` through `ops/kernels/build.count`, which hands
them to this module's `count` (`build.counter`).

While `torch.profiler` records, a stage opens the span ``smj.<name>``, so
the Chrome trace shows each step of a query on the device ops' clock.
Spans stay flat: a stage inside a spanned stage opens none, and
``span=False`` opens none. `sync` marks each host readback with a nested
``smj.sync`` span. With the profiler off no span object is made: a stage
costs one flag check and its counters.
"""

from __future__ import annotations

import contextvars
import dataclasses
import json
import time
from typing import Any

import torch
from torch.autograd import profiler as _autograd_profiler

from pim_sort_merge_join_tpu_torch.ops.kernels import build

SPAN_PREFIX = "smj."

# The collector the running query records into, and whether a stage's span
# is open (so an inner stage opens none).
_ACTIVE: contextvars.ContextVar[MetricsCollector | None] = contextvars.ContextVar(
    "smj_metrics_collector", default=None)
_IN_SPAN: contextvars.ContextVar[bool] = contextvars.ContextVar("smj_in_span", default=False)


@dataclasses.dataclass(slots=True)
class StageMetric:
    name: str
    wall_s: float = 0.0
    rows_in: int | None = None
    rows_out: int | None = None
    bytes_moved: int | None = None
    extra: dict = dataclasses.field(default_factory=dict)
    children: list = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict[str, Any]:
        d = {"stage": self.name, "wall_s": self.wall_s}
        for k in ("rows_in", "rows_out", "bytes_moved"):
            v = getattr(self, k)
            if v is not None:
                d[k] = v
        d.update(self.extra)
        if self.children:
            d["stages"] = [c.to_dict() for c in self.children]
        return d


# The context managers here are classes, not generators, and an open stage
# is its own record: a query opens about ten, and with the profiler off
# their whole cost is this bookkeeping (PERF.md, PR 14).
class _Stage(StageMetric):
    """A stage while it is open: its record, with its span while
    profiling, its clock, its launch count and its collector. It stays in
    the collector's record when it closes."""

    __slots__ = ("collector", "span", "token", "launches0", "t0")

    def __init__(self, collector: MetricsCollector | None, name: str, counts: dict, span: bool):
        self.name, self.wall_s, self.extra, self.children = name, 0.0, counts, []
        self.rows_in = self.rows_out = self.bytes_moved = None
        self.collector, self.span = collector, span

    def __enter__(self) -> StageMetric:
        if self.span and _autograd_profiler._is_profiler_enabled and not _IN_SPAN.get():
            self.span = torch.profiler.record_function(SPAN_PREFIX + self.name)
            self.span.__enter__()
            self.token = _IN_SPAN.set(True)
        else:
            self.span = None
        if self.collector is not None:
            self.collector._open.append(self)
            self.launches0 = build.launches
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.wall_s = time.perf_counter() - self.t0
        c = self.collector
        if c is not None:
            self.extra["launches"] = build.launches - self.launches0
            c._open.pop()
            if c.enabled:
                (c._open[-1].children if c._open else c.stages).append(self)
            self.collector = None  # the record keeps no reference back
        if self.span is not None:
            _IN_SPAN.reset(self.token)
            self.span.__exit__(*exc)


class MetricsCollector:
    """Accumulates per-stage metrics across a pipeline run."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.stages: list[StageMetric] = []
        self._open: list[StageMetric] = []

    def stage(self, name: str, *, span: bool = True, **counts) -> _Stage:
        """A context manager that times stage ``name`` and yields its
        `StageMetric`; ``counts`` start its counters."""
        return _Stage(self, name, counts, span)

    def total_wall_s(self) -> float:
        return sum(m.wall_s for m in self.stages)

    def to_json(self) -> str:
        return json.dumps(
            {
                "stages": [m.to_dict() for m in self.stages],
                "total_wall_s": self.total_wall_s(),
            }
        )

    def summary(self) -> dict[str, float]:
        return {m.name: m.wall_s for m in self.stages}


class _Collecting:
    __slots__ = ("collector", "token")

    def __init__(self, collector: MetricsCollector):
        self.collector = collector

    def __enter__(self) -> MetricsCollector:
        self.token = _ACTIVE.set(self.collector)
        return self.collector

    def __exit__(self, *exc) -> None:
        _ACTIVE.reset(self.token)


def collecting(collector: MetricsCollector) -> _Collecting:
    """A context manager that makes ``collector`` the one `stage` and
    `count` record into."""
    return _Collecting(collector)


def stage(name: str, **counts) -> _Stage:
    """`MetricsCollector.stage` of the active collector; with none active,
    only the span."""
    return _Stage(_ACTIVE.get(), name, counts, True)


def count(**counts: int) -> None:
    """Add ``counts`` to the innermost open stage of the active collector."""
    c = _ACTIVE.get()
    if c is not None and c._open:
        extra = c._open[-1].extra
        for k, v in counts.items():
            extra[k] = extra.get(k, 0) + v


build.counter = count


class _Sync:
    __slots__ = ("nbytes", "span")

    def __init__(self, nbytes: int):
        self.nbytes, self.span = nbytes, None

    def __enter__(self) -> _Sync:
        if _autograd_profiler._is_profiler_enabled:
            self.span = torch.profiler.record_function(SPAN_PREFIX + "sync")
            self.span.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self.span is not None:
            self.span.__exit__(*exc)
        c = _ACTIVE.get()
        if c is not None and c._open:
            extra = c._open[-1].extra
            extra["readbacks"] = extra.get("readbacks", 0) + 1
            extra["bytes_down"] = extra.get("bytes_down", 0) + self.nbytes


def sync(nbytes: int) -> _Sync:
    """A context manager around one host readback of ``nbytes``: the nested
    span ``smj.sync`` while profiling, then ``readbacks`` and
    ``bytes_down`` counted on the innermost open stage."""
    return _Sync(nbytes)
