"""Stage metrics: wall timers, row counts, bytes moved.

Replaces the reference's 7-slot `gettimeofday` timer (`timer.h:38-63`) and
its 3-way CPU->DPU / DPU / DPU->CPU printout (app.c:763-772) with structured
per-stage records that serialize to JSON (the machine-readable output the
reference's `test/run.sh` sweep lacks, SURVEY.md section 4).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Any


@dataclasses.dataclass
class StageMetric:
    name: str
    wall_s: float = 0.0
    rows_in: int | None = None
    rows_out: int | None = None
    bytes_moved: int | None = None
    extra: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        d = {"stage": self.name, "wall_s": self.wall_s}
        for k in ("rows_in", "rows_out", "bytes_moved"):
            v = getattr(self, k)
            if v is not None:
                d[k] = v
        d.update(self.extra)
        return d


class MetricsCollector:
    """Accumulates per-stage metrics across a pipeline run."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.stages: list[StageMetric] = []

    @contextlib.contextmanager
    def stage(self, name: str, **fields):
        m = StageMetric(name=name, extra=dict(fields))
        t0 = time.perf_counter()
        try:
            yield m
        finally:
            m.wall_s = time.perf_counter() - t0
            if self.enabled:
                self.stages.append(m)

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
