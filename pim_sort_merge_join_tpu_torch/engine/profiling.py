"""Device profiling hooks (port of `engine/profiling.py`).

`device_trace` runs its body under `torch.profiler` with the CPU and, where
there is a card, the CUDA activities, and writes one Chrome trace
(``trace.json``) that Perfetto and ``chrome://tracing`` read.
`time_cuda_events` is the counterpart of the JAX package's `time_jitted`:
device time of a call from CUDA events after a warmup.
"""

from __future__ import annotations

import contextlib
import os
import statistics
from typing import Callable

import torch

TRACE_FILE = "trace.json"


def trace_path(log_dir: str) -> str:
    """Where `device_trace` writes its Chrome trace."""
    return os.path.join(log_dir, TRACE_FILE)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the body with `torch.profiler` (CPU activities, and CUDA ones
    where a card is present) and write its Chrome trace to
    ``log_dir/trace.json``. Yields ``log_dir``."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(trace_path(log_dir))


def time_cuda_events(fn: Callable, *args, reps: int = 10) -> dict:
    """Device time of ``fn(*args)`` between two CUDA events, after one
    warmup call: ``{"median_s", "min_s", "max_s", "reps"}`` over ``reps``
    calls. Needs a card; the events time the current stream."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_cuda_events: no CUDA device is available")
    fn(*args)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    return {
        "median_s": statistics.median(times),
        "min_s": min(times),
        "max_s": max(times),
        "reps": reps,
    }
