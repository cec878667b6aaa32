"""A run on the CPU at a small size: sound, it comes out correct; with the
timed path broken underneath, or with the control in the program's place,
it does not."""

import copy

import pytest
import torch

from benchmark import control, harness, program

SPEC = harness.load_benchmark()


def small(cell_name: str) -> harness.Cell:
    cell = copy.deepcopy(harness.find_cell(SPEC, cell_name))
    if "rows_per_table" in cell.config["scale"]:
        cell.config["scale"]["rows_per_table"] = 20000
        lo, hi = cell.traffic["params"]["t"]["uniform_int"]
        cell.traffic["params"]["t"]["uniform_int"] = [lo // 500, hi // 500]
    else:
        cell.config["scale"]["scale_factor"] = 0.002
    cell.traffic["check_every"] = 4
    return cell


def run(cell, seconds: float = 0.5) -> dict:
    return harness.run(cell, 2**35 + 1, seconds, False, "cpu", log=lambda msg: None)


CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result = run(small(cell), seconds=2.0)
    assert result["correct"], result
    assert result["checked"] >= 2 or result["checked"] == result["attempted"]
    assert result["failed"] == 0


def altered(result):
    """One value of the answer changed where it is produced."""
    n = int(result.num_rows)
    if n:
        result.data[n // 2, -1] += 1
    return result


def halved(t):
    """Half of a table's rows left out."""
    return program.Table(data=t.data, num_rows=t.num_rows // 2, names=t.names)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["altered_answer", "half_the_rows"])
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    real = program.QueryPipeline.run_tables

    def broken(self, t1, t2, **kw):
        if fault == "half_the_rows":
            return real(self, halved(t1), t2, **kw)
        return altered(real(self, t1, t2, **kw))

    monkeypatch.setattr(program.QueryPipeline, "run_tables", broken)
    result = run(small(cell))
    assert not result["correct"]
    assert result["checks"]["rows_differing"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_in_place_of_the_program_is_not_correct(cell):
    """The control, the reference with its join keys compared in float32,
    put in the program's place: the harness's own check finds it not
    correct at the least scale whose keys pass 2^24, the traffic's
    range scaled with it."""
    c = copy.deepcopy(harness.find_cell(SPEC, cell))
    scale = 0.6  # 6M rows a table: keys reach 18M, past 2^24
    c.config["scale"]["rows_per_table"] = int(c.config["scale"]["rows_per_table"] * scale)
    lo, hi = c.traffic["params"]["t"]["uniform_int"]
    c.traffic["params"]["t"]["uniform_int"] = [int(lo * scale), int(hi * scale)]
    c.traffic["warmup_queries"] = 1
    c.traffic["check_every"] = 1
    result = control.control_result(c, 2**35 + 1, 0.1, "cpu")
    assert not result["correct"], result
    assert result["checks"]["rows_differing"]["value"] > 0
