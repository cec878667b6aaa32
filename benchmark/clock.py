"""The set-up's clock: the seconds of each part of a run's set-up, from
the process's start. It imports nothing heavy, so `run.py` starts it
before torch is imported."""

from __future__ import annotations

import time


class SetupClock:
    def __init__(self, t_start: float | None = None):
        self.t_start = self.last = time.perf_counter() if t_start is None else t_start
        self.parts: dict[str, float] = {}

    def lap(self, name: str) -> None:
        """The time since the last lap (or the start) is the part ``name``."""
        now = time.perf_counter()
        self.parts[name] = now - self.last
        self.last = now

    def total(self) -> float:
        return self.last - self.t_start
