"""One run of one cell: set-up, warm-up, the measured window, the check.

Everything a cell needs is found by name. ``BENCHMARK.json`` names the
cell's configuration (its file) and traffic mix; the configuration names
its generator (``datagen/<generator>.py``); the traffic file names its mode
(``traffic/mode_<mode>.py``); each metric is read by
``end_to_end/<name>.py`` or ``layers/<name>.py``.

The window is a closed loop of one client. Query ``i`` takes its
parameters from the traffic's stream, builds the configuration's
`EngineConfig` and runs through the mode; its latency is the host clock
from the call until its rows are usable. Query 0 and the queries ``offset
+ k * check_every`` after it, ``offset`` drawn from the seed, are checked
(with tracing on, the first query after the traced ones stands for query
0): their rows are brought to host memory while the window's clock stands
still, and once the window has closed and the program's state is freed,
the plain reference works each out again from inputs it makes itself from
the seed, and the rows are compared exactly. With tracing on, the first
``trace_queries`` queries of the window run under `torch.profiler`.

A cell whose traffic mode is sharded runs all of that on ``cell.chips``
ranks, one process a card, this process rank 0 (`benchmark/ranks.py`):
rank 0 keeps the clock and says which query comes next; the peak is the
fullest card's; the readers read rank 0's traced window, which carries
every rank's beside it; the check compares every rank's rows, in rank
order, on rank 0 once the other ranks have exited.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from benchmark import roofline, traced
from benchmark.clock import SetupClock
from benchmark.reference import relational
from benchmark.seeds import derive
from benchmark.traffic import stream

BENCH_DIR = Path(__file__).resolve().parent
CHECKOUT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pim_sort_merge_join_tpu")


def load_benchmark(path: Path = CHECKOUT / "BENCHMARK.json") -> dict:
    return json.loads(path.read_text())


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py``, by its file (names may hold dots)."""
    path = BENCH_DIR / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.{kind}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # metric entries of BENCHMARK.json that this cell reports
    per_layer: list


def find_cell(bench: dict, name: str) -> Cell:
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((CHECKOUT / entry["file"]).read_text())
    traffic = json.loads((BENCH_DIR / "traffic" / f"{w['traffic']}.json").read_text())

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return Cell(name, int(w["chips"]), config, traffic,
                mine(bench["end_to_end"]), mine(bench["per_layer"]))


@dataclasses.dataclass
class Window:
    """What the end-to-end readers read."""

    latencies_s: list
    window_s: float
    rows_in: int
    peak_bytes: int
    setup_s: float


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str | None:
    """The card's name and power limit as `nvidia-smi` gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _span(name: str):
    return torch.profiler.record_function(traced.SPAN_PREFIX + name)


def _no_span(name: str):
    return contextlib.nullcontext()


@dataclasses.dataclass
class Loop:
    """What the window's loop gathered."""

    attempted: int = 0
    latencies_s: list = dataclasses.field(default_factory=list)
    errors: list = dataclasses.field(default_factory=list)
    kept: list = dataclasses.field(default_factory=list)  # (i, params, pair, rows)
    traced_rows: list = dataclasses.field(default_factory=list)  # rows out of traced queries
    window_s: float = 0.0


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        setup: SetupClock | None = None, log=None, rank_hook=None) -> dict:
    """Run ``cell`` once; returns the result line as a dict. ``setup`` is
    the clock started with the process, if any. A cell whose traffic mode
    is sharded runs on ``cell.chips`` ranks with this process as rank 0
    (`benchmark/ranks.py`; ``rank_hook`` as `ranks.Ranks` takes it)."""
    setup = setup or SetupClock()
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    mode_module = load_module("traffic", f"mode_{cell.traffic['mode']}")
    if not getattr(mode_module.Mode, "sharded", False):
        device = torch.device(device)
        side = play(cell, seed, seconds, trace, device, setup, mode_module)
        return report(cell, seed, device, [side], setup, log)
    from benchmark import ranks

    others = ranks.Ranks(cell, seed, seconds, trace, device, rank_hook)
    try:
        with others as group:
            setup.lap("ranks")
            side = play(cell, seed, seconds, trace, group.device, setup, mode_module, group)
            sides = [side]
            if not group.failed:
                try:
                    sides += [Side(None, peak, tw, side.rows_per_table, leaked)
                              for peak, tw, leaked in group.gather((side.peak, side.tw, []))[1:]]
                except RuntimeError as exc:  # a rank that died after the window
                    side.loop.errors.append(f"after the window: {type(exc).__name__}: {exc}")
                    group.fail()
    finally:
        for msg in others.errors:
            log(f"failed: {msg}")
    # Every child has ended and the group is gone.
    return report(cell, seed, group.device, sides, setup, log, group)


@dataclasses.dataclass
class Side:
    """What one rank's set-up and window gave (the loop: rank 0's;
    ``leaked``: a rank > 0's forbidden modules once its window closed)."""

    loop: Loop | None
    peak: int
    tw: traced.TracedWindow | None
    rows_per_table: tuple
    leaked: list = dataclasses.field(default_factory=list)


def memory_peak(device: torch.device) -> int:
    """The most device memory this process has held since the reset after
    the inputs."""
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def play(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
         setup: SetupClock, mode_module, group=None) -> Side:
    """This rank's set-up, warm-up and window (the only rank of a cell of
    one process), its peak, and with ``trace`` its traced window."""
    from benchmark import program

    config, traffic = cell.config, cell.traffic
    generator = load_module("datagen", config["generator"])
    setup.lap("harness")

    # Set-up: the card's context, the inputs, then the cell's own queries as
    # warm-up (the first builds or loads the kernels).
    _sync(device)
    setup.lap("context")
    extra = {} if group is None else {"group": group}
    mode = mode_module.Mode(config, traffic, seed, device, program, generator, **extra)
    _sync(device)
    setup.lap("inputs")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    warm = stream.parameters(traffic, config, seed, "warmup")
    for i in range(int(traffic["warmup_queries"])):
        mode.query(i, program.engine_config(stream.substitute(config["engine"], next(warm))),
                   _no_span)
        _sync(device)
        setup.lap(f"warmup_{i}")
    gc.collect()
    setup.lap("collect")

    prof = None
    trace_queries = int(traffic["trace_queries"]) if trace else 0
    if trace_queries:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
    loop = measure(mode, program, cell, seed, seconds, prof, trace_queries, device, group)
    peak = memory_peak(device)
    rows_per_table, out_ncol, item_bytes = mode.rows_per_table, mode.out_ncol, mode.item_bytes
    # A rank of a sharded mode reads its own block of each table.
    local_rows = getattr(mode, "local_rows_per_table", rows_per_table)
    del mode
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    tw = None
    if prof is not None:
        card = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        least = sum(roofline.least_bytes(local_rows, out_ncol, r, item_bytes)
                    for r in loop.traced_rows)
        tw = traced.from_profiler(prof, len(loop.traced_rows), least,
                                  roofline.peak_bytes_per_s(card))
    return Side(loop, peak, tw, rows_per_table)


def run_rank(cell: Cell, seed: int, seconds: float, trace: bool, group) -> None:
    """A rank > 0 of a sharded cell: what rank 0 does until the window
    closes, then its peak, traced window and forbidden modules to rank 0."""
    mode_module = load_module("traffic", f"mode_{cell.traffic['mode']}")
    side = play(cell, seed, seconds, trace, group.device, SetupClock(), mode_module, group)
    group.gather((side.peak, side.tw, forbidden_modules()))


def report(cell: Cell, seed: int, device: torch.device, sides: list, setup: SetupClock, log,
           group=None) -> dict:
    """The result line from every rank's side (rank 0's first, the only
    one with its loop), after the check. A forbidden module loaded on any
    rank makes the run not correct."""
    loop = sides[0].loop
    leaked = sorted(set(forbidden_modules()).union(*(s.leaked for s in sides)))
    card = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    result = {"correct": False, "attempted": loop.attempted, "failed": len(loop.errors)}
    peaks = [s.peak for s in sides]
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": card,
           "count": cell.chips, "memory_peak_bytes": max(peaks)}
    if group is not None:
        dev["memory_peak_bytes_by_rank"] = peaks
    metrics = {}
    tw = sides[0].tw
    if tw is not None:
        if group is not None:
            tw.ranks = [dataclasses.replace(s.tw, ranks=[]) for s in sides]
        if tw.spans:
            start, end = tw.window
            busy_us = traced.overlap(traced.busy(tw.device_ops), [(start, end)])
            dev.update(busy_s=busy_us / 1e6, window_s=(end - start) / 1e6)
            result["breakdown"] = traced.breakdown(tw)
            for m in cell.per_layer:
                metrics[m["name"]] = (load_module("layers", m["name"]).read(tw), m["unit"])
    else:
        w = Window(loop.latencies_s, loop.window_s, sum(sides[0].rows_per_table), max(peaks),
                   setup.total())
        for m in cell.end_to_end:
            metrics[m["name"]] = (load_module("end_to_end", m["name"]).read(w), m["unit"])
    if device.type == "cuda":
        dev["card"] = card_line()
    result["metrics"] = {name: {"value": value, "unit": unit}
                         for name, (value, unit) in metrics.items() if value is not None}
    result["device"] = dev
    if group is not None:
        result["ranks"] = {"world": group.world, "backend": group.backend,
                           "failed": group.failed, "forbidden": leaked,
                           "control_ms_per_query": group.control_s * 1e3 / (loop.attempted + 1)}
    result["setup_parts"] = setup.parts
    log("setup " + " ".join(f"{k} {v:.3f}" for k, v in setup.parts.items()))

    checks = check(cell.config, seed, loop.kept, loop.errors, device, log)
    result["checked"] = len(loop.kept)
    result["correct"] = (bool(loop.kept) and not leaked and not (group and group.failed)
                         and all(c["value"] <= c["limit"] for c in checks.values()))
    result["checks"] = checks
    for msg in loop.errors[:5]:
        log(f"failed: {msg}")
    if leaked:
        log(f"forbidden modules loaded: {', '.join(leaked)}")
    for name, c in checks.items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    return result


def measure(mode, program, cell: Cell, seed: int, seconds: float, prof, trace_queries: int,
            device: torch.device, group=None) -> Loop:
    """The measured window: a closed loop of one client for ``seconds``,
    not counting the checked queries' copies to host memory. With a
    ``group`` (`benchmark/ranks.py`), rank 0 says before each query which
    comes next, or that the window has closed, and the others follow; a
    failure on any rank ends the window, counted on rank 0."""
    config, traffic = cell.config, cell.traffic
    every = int(traffic["check_every"])
    offset = derive(seed, "check") % every
    first_checked = trace_queries  # no check's copy falls in the traced part
    params = stream.parameters(traffic, config, seed, "window")
    loop = Loop()
    paused = 0.0
    if prof is not None:
        prof.start()
    window_start = time.perf_counter()
    try:
        while True:
            i = loop.attempted
            more = time.perf_counter() - window_start - paused < seconds
            if group is not None:
                group.check()
                word = group.next_query(i if more else None)
                if word not in (i, None):
                    raise RuntimeError(f"rank {group.rank} is at query {i}, rank 0 at {word}")
                more = word is not None
            if not more:
                break
            loop.attempted += 1
            p = next(params)
            tracing = prof is not None and i < trace_queries
            try:
                t0 = time.perf_counter()
                cfg = program.engine_config(stream.substitute(config["engine"], p))
                outcome = mode.query(i, cfg, _span if tracing else _no_span)
                if group is not None:
                    group.check()
                loop.latencies_s.append(time.perf_counter() - t0)
            except Exception as exc:  # a query that fails is counted and reported
                if group is not None:
                    raise
                loop.errors.append(f"query {i} {p}: {type(exc).__name__}: {exc}")
                continue
            if tracing:
                loop.traced_rows.append(outcome.rows_out())
                if i + 1 == trace_queries:
                    _sync(device)
                    prof.stop()
            if i == first_checked or (i > first_checked and (i - offset) % every == 0):
                c0 = time.perf_counter()
                loop.kept.append((i, p, mode.pair(i), outcome.fetch()))
                paused += time.perf_counter() - c0
            del outcome  # the result's memory is free before the next query
    except Exception as exc:
        if group is None or group.rank:
            raise
        loop.errors.append(f"query {loop.attempted - 1}: {type(exc).__name__}: {exc}")
        group.fail()
    loop.window_s = time.perf_counter() - window_start - paused
    if prof is not None and len(loop.traced_rows) < trace_queries:
        _sync(device)
        prof.stop()
    return loop


def references(config: dict, seed: int, queries, device, key_dtype=None):
    """For each ``(pair, params)`` of ``queries``, the plain reference's rows
    (host memory), from inputs made again from the seed; ``key_dtype`` as
    in `relational.run_query`."""
    generator = load_module("datagen", config["generator"])
    inputs, have = None, None
    for pair, params in queries:
        if have != pair:
            inputs = None  # free the last pair before making the next
            inputs, have = generator.make_pair(config, seed, pair, device), pair
        query = stream.substitute(config["engine"], params)
        yield relational.run_query(*inputs, query, key_dtype=key_dtype).cpu().numpy()


def check(config: dict, seed: int, kept: list, errors: list, device: torch.device, log) -> dict:
    """The checked queries against the plain reference: the worst of each
    compared number, beside its limit."""
    worst = {"queries_failed": len(errors), "rows_count_gap": 0, "rows_differing": 0}
    t0 = time.perf_counter()
    wants = references(config, seed, [(pair, p) for _, p, pair, _ in kept], device)
    for (i, p, _, rows), want in zip(kept, wants):
        for name, value in relational.compare(rows, want).items():
            worst[name] = max(worst[name], value)
            if value:
                log(f"query {i} {p}: {name} {value} "
                    f"(rows {rows.shape[0]}, reference {want.shape[0]})")
    log(f"check: {len(kept)} queries against the reference in {time.perf_counter() - t0:.2f} s")
    return {name: {"value": value, "limit": 0} for name, value in worst.items()}
