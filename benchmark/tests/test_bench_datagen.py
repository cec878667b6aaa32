"""The generators follow their configurations' rules (CPU, small scale)."""

import copy
import json
from pathlib import Path

import pytest
import torch

from benchmark import harness
from benchmark.datagen import upmem_gen

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def config(name: str, **scale) -> dict:
    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    cfg["scale"].update(scale)
    return cfg


def test_upmem_keys_unique_and_ranges():
    cfg = config("upmem-gen-10m", rows_per_table=5000)
    for t in upmem_gen.make_pair(cfg, 7, 0, "cpu"):
        assert t.shape == (5000, 4) and t.dtype == torch.int64
        assert torch.unique(t[:, 0]).numel() == 5000
        assert int(t[:, 0].min()) >= 1 and int(t[:, 0].max()) <= 15000
        assert int(t[:, 1:].min()) >= 1 and int(t[:, 1:].max()) < 15000


@pytest.mark.parametrize("generator, name, scale", [
    ("upmem_gen", "upmem-gen-10m", {"rows_per_table": 3000}),
])
def test_a_seed_gives_the_same_tables_and_pairs_differ(generator, name, scale):
    gen = harness.load_module("datagen", generator)
    cfg = config(name, **scale)
    a, b = gen.make_pair(cfg, 11, 0, "cpu"), gen.make_pair(copy.deepcopy(cfg), 11, 0, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    c = gen.make_pair(cfg, 11, 1, "cpu")
    assert not torch.equal(a[0], c[0])
