"""BENCHMARK.json keeps to its naming rules, finds every piece by name,
and the harness loads no JAX."""

import ast
import json
import re
from pathlib import Path

import pytest

from benchmark import harness

BENCH = Path(__file__).resolve().parents[1]
SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def names():
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[section]:
            yield entry["name"]
    for w in SPEC["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in SPEC["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(names())))
def test_names_are_plain(name):
    assert NAME.fullmatch(name)


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"], ids=lambda m: m["name"])
def test_units_and_readers(metric):
    assert UNIT.fullmatch(metric["unit"])
    kind = "end_to_end" if metric in SPEC["end_to_end"] else "layers"
    assert callable(harness.load_module(kind, metric["name"]).read)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_finds_its_pieces(cell):
    c = harness.find_cell(SPEC, cell)
    assert (BENCH / "datagen" / f"{c.config['generator']}.py").exists()
    assert (BENCH / "traffic" / f"mode_{c.traffic['mode']}.py").exists()
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"} and len(c.end_to_end) >= 2
    assert c.per_layer


def test_each_metric_names_a_reported_end_to_end_metric():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e


def test_forbidden_modules_compares_top_level_names(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "pim_sort_merge_join_tpu_torch_like", sys)
    before = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "pim_sort_merge_join_tpu.ops", sys)
    after = harness.forbidden_modules()
    assert "pim_sort_merge_join_tpu_torch_like" not in after
    assert set(after) - set(before) <= {"jax", "pim_sort_merge_join_tpu"}
    assert {"jax", "pim_sort_merge_join_tpu"} <= set(after)


@pytest.mark.parametrize("path", sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_sources_import_no_jax_and_read_no_jax_benchmark(path):
    source = path.read_text()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            tops = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            tops = [(node.module or "").split(".")[0]]
        else:
            continue
        assert not set(tops) & set(harness.FORBIDDEN), f"{path}: imports {tops}"
    assert not re.search(r"\bbench\.py\b|BENCH_r|\bbench/", source)
