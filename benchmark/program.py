"""The system under test: all that the benchmark takes from
`pim_sort_merge_join_tpu_torch` (the engine's configuration, its tables and
`QueryPipeline`)."""

from __future__ import annotations

import torch

import pim_sort_merge_join_tpu_torch as smj
from pim_sort_merge_join_tpu_torch import EngineConfig, Predicate, QueryPipeline, Table

__all__ = ["QueryPipeline", "Table", "engine_config", "package_file", "table"]


def engine_config(engine: dict) -> EngineConfig:
    """An `EngineConfig` from a configuration's ``engine`` entry, its
    ``$`` parameters already substituted."""
    fields = dict(engine)
    for name in ("predicate1", "predicate2"):
        fields[name] = Predicate(**fields[name])
    return EngineConfig(**fields)


def table(data: torch.Tensor, names) -> Table:
    """A table whose rows are all of ``data``, on ``data``'s device."""
    num_rows = torch.tensor(data.shape[0], dtype=torch.int32, device=data.device)
    return Table(data=data, num_rows=num_rows, names=tuple(names))


def package_file() -> str:
    return smj.__file__
