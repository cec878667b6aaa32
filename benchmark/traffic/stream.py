"""The one generator of query parameters, driven by a traffic file.

A traffic file's ``params`` names each parameter with its range:
``{"uniform_int": [lo, hi]}`` (inclusive) or ``{"uniform_date": [first,
last]}`` (ISO days, in days since the configuration's
``encoding.date_epoch``). The range is cut into ``strata`` equal strata;
every block of ``strata`` queries draws one value from each stratum, in a
seeded order. So every seed sends the same mix of sizes, in another order.
"""

from __future__ import annotations

import datetime
from typing import Iterator

import numpy as np

from benchmark.seeds import derive


def value_range(spec: dict, config: dict) -> tuple[int, int]:
    (kind, (lo, hi)), = spec.items()
    if kind == "uniform_int":
        return int(lo), int(hi)
    if kind == "uniform_date":
        epoch = datetime.date.fromisoformat(config["encoding"]["date_epoch"])
        return tuple((datetime.date.fromisoformat(d) - epoch).days for d in (lo, hi))
    raise ValueError(f"unknown parameter kind {kind!r}")


def parameters(traffic: dict, config: dict, seed: int, stream: str) -> Iterator[dict]:
    """An endless stream of ``{name: int}``, one per query."""
    rng = np.random.default_rng(derive(seed, "traffic", traffic["name"], stream))
    ranges = {name: value_range(spec, config) for name, spec in traffic["params"].items()}
    strata = int(traffic.get("strata", 1))
    while True:
        block = {}
        for name, (lo, hi) in ranges.items():
            where = rng.permutation(strata) + rng.random(strata)
            block[name] = lo + np.floor(where * (hi - lo + 1) / strata).astype(np.int64)
        for j in range(strata):
            yield {name: int(values[j]) for name, values in block.items()}


def substitute(template, params: dict):
    """``template`` with every string ``"$name"`` replaced by ``params[name]``."""
    if isinstance(template, dict):
        return {k: substitute(v, params) for k, v in template.items()}
    if isinstance(template, list):
        return [substitute(v, params) for v in template]
    if isinstance(template, str) and template.startswith("$"):
        return params[template[1:]]
    return template
