"""Cells on several ranks (`benchmark/ranks.py`) on the CPU over Gloo, at
20000 rows a table: a test-only cell of the ``upmem-gen-10m``
configuration with the traffic of ``resident-broad`` in the sharded mode.
Faults are put in place in a child rank by the harness's ``rank_hook``."""

import copy
import functools
import multiprocessing
import sys
import time
import types
from multiprocessing import resource_tracker

import pytest
import torch
import torch.distributed as dist

from benchmark import control, harness, program, ranks, traced

SPEC = harness.load_benchmark()
SEED = 2**35 + 3


def sharded(world: int, **traffic) -> harness.Cell:
    cell = copy.deepcopy(harness.find_cell(SPEC, "upmem10m.resident"))
    cell.name, cell.chips = f"upmem20k.sharded{world}", world
    cell.config["scale"]["rows_per_table"] = 20000
    lo, hi = cell.traffic["params"]["t"]["uniform_int"]
    cell.traffic.update({"mode": "sharded", "check_every": 2, "warmup_queries": 1,
                         "params": {"t": {"uniform_int": [lo // 500, hi // 500]}}, **traffic})
    return cell


def run(cell, seconds: float = 3.0, trace: bool = False, hook=None) -> dict:
    return harness.run(cell, SEED, seconds, trace, "cpu", log=lambda msg: None, rank_hook=hook)


def assert_nothing_left():
    assert not dist.is_initialized()
    assert multiprocessing.active_children() == []
    assert resource_tracker._resource_tracker._pid is None  # reaped, no zombie


def broken(kind: str, at: int, rank: int) -> None:
    """A rank hook: on rank ``at`` the timed path is broken as ``kind`` says."""
    if rank != at:
        return
    real = program.DistributedQueryPipeline.run_tables
    calls = []

    def run_tables(self, t1, t2, **kw):
        calls.append(1)
        if kind == "half_the_rows":
            t1 = program.ShardedTable(t1.data, t1.num_rows // 2, t1.names, t1.group)
        if kind == "raises" and len(calls) == 1 + 4:  # after one warm-up query: query 3
            raise RuntimeError("a rank that raises")
        out = real(self, t1, t2, **kw)
        n = int(out.num_rows)
        if kind == "altered_answer" and n:
            out.data[n // 2, -1] += 1
        return out

    program.DistributedQueryPipeline.run_tables = run_tables


def peak_of_rank(rank: int) -> None:
    """A rank hook: rank r reports a peak of (r + 1) * 1000 bytes."""
    harness.memory_peak = lambda device: (rank + 1) * 1000


def loads_flax(rank: int) -> None:
    """A rank hook: rank 1 loads a stand-in module named ``flax``."""
    if rank == 1:
        sys.modules["flax"] = types.ModuleType("flax")


@pytest.mark.parametrize("world", [2, 4])
def test_sound_sharded_run_is_correct(world):
    result = run(sharded(world))
    assert result["correct"], result
    assert result["checked"] >= 2 and result["failed"] == 0
    assert result["ranks"]["world"] == world and result["ranks"]["backend"] == "gloo"
    assert result["device"]["count"] == world
    assert_nothing_left()


@pytest.mark.parametrize("fault, at, world", [("altered_answer", 1, 2), ("half_the_rows", 2, 4)])
def test_a_broken_rank_is_not_correct(fault, at, world):
    result = run(sharded(world), hook=functools.partial(broken, fault, at))
    assert not result["correct"]
    assert result["checks"]["rows_differing"]["value"] > 0
    assert_nothing_left()


def test_a_rank_that_raises_ends_the_run():
    t0 = time.monotonic()
    result = run(sharded(2), seconds=30.0, hook=functools.partial(broken, "raises", 1))
    assert time.monotonic() - t0 < ranks.GROUP_TIMEOUT_S + 30
    assert result["failed"] >= 1 and result["ranks"]["failed"]
    assert not result["correct"]
    assert result["attempted"] == 4  # queries 0 to 3
    assert_nothing_left()


def test_a_forbidden_module_on_a_rank_is_not_correct():
    result = run(sharded(2), seconds=1.0, hook=loads_flax)
    assert not result["correct"]
    assert result["ranks"]["forbidden"] == ["flax"] and "flax" not in sys.modules
    assert not result["ranks"]["failed"]
    assert_nothing_left()


def test_the_peak_is_the_fullest_rank_s(monkeypatch):
    monkeypatch.setattr(harness, "memory_peak", lambda device: 1000)
    result = run(sharded(4), seconds=1.0, hook=peak_of_rank)
    assert result["device"]["memory_peak_bytes_by_rank"] == [1000, 2000, 3000, 4000]
    assert result["device"]["memory_peak_bytes"] == 4000
    assert_nothing_left()


def test_a_traced_run_gives_rank_0_s_window_and_every_rank_s(monkeypatch):
    seen = []
    real = traced.breakdown
    monkeypatch.setattr(traced, "breakdown", lambda tw, *a: seen.append(tw) or real(tw, *a))
    result = run(sharded(4, trace_queries=3), seconds=5.0, trace=True)
    assert result["correct"], result
    (tw,) = seen
    assert len(tw.ranks) == 4 and tw.queries == 3
    assert tw.ranks[0].spans == tw.spans and all(not w.ranks for w in tw.ranks)
    assert all(len(w.spans["query"]) == 3 for w in tw.ranks)
    assert_nothing_left()


def test_a_one_card_cell_starts_no_rank(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a cell of one card started ranks")

    monkeypatch.setattr(ranks, "Ranks", refuse)
    cell = copy.deepcopy(harness.find_cell(SPEC, "upmem10m.resident"))
    cell.config["scale"]["rows_per_table"] = 20000
    lo, hi = cell.traffic["params"]["t"]["uniform_int"]
    cell.traffic["params"]["t"]["uniform_int"] = [lo // 500, hi // 500]
    result = run(cell, seconds=0.5)
    assert result["correct"] and "ranks" not in result
    assert "memory_peak_bytes_by_rank" not in result["device"]
    assert_nothing_left()


def test_control_in_place_of_the_program_on_ranks_is_not_correct():
    """The control on 2 ranks at 6M rows a table, whose keys pass 2^24."""
    cell = sharded(2, check_every=1)
    cell.config["scale"]["rows_per_table"] = 6_000_000
    lo, hi = harness.find_cell(SPEC, "upmem10m.resident").traffic["params"]["t"]["uniform_int"]
    cell.traffic["params"]["t"]["uniform_int"] = [int(lo * 0.6), int(hi * 0.6)]
    result = control.control_result(cell, SEED, 0.1, "cpu")
    assert not result["correct"], result
    assert result["checks"]["rows_differing"]["value"] > 0
    assert result["failed"] == 0
    assert_nothing_left()


def test_placement_and_backend():
    assert ranks.placement("cpu", 3) == ([torch.device("cpu")] * 3, "gloo")
