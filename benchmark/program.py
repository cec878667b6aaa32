"""The system under test: all that the benchmark takes from
`pim_sort_merge_join_tpu_torch` (the engine's configuration, its tables,
`QueryPipeline`, and for a sharded cell `DistributedQueryPipeline` and
`ShardedTable`)."""

from __future__ import annotations

import torch

import pim_sort_merge_join_tpu_torch as smj
from pim_sort_merge_join_tpu_torch import EngineConfig, Predicate, QueryPipeline, Table
from pim_sort_merge_join_tpu_torch.engine.distributed import DistributedQueryPipeline, ShardedTable

__all__ = ["DistributedQueryPipeline", "QueryPipeline", "ShardedTable", "Table", "engine_config",
           "package_file", "row_block", "table"]


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


def row_block(data: torch.Tensor, names, rank: int, world: int) -> ShardedTable:
    """Rank ``rank``'s block of the table ``data``, which every rank of the
    default group holds the same, on ``data``'s device and without host
    memory: the row-block scatter of `ShardedTable.from_numpy` (rank i
    keeps the next ``n // world + (i < n % world)`` rows, in a block of
    ``ceil(n / world)`` rows, zeros past them)."""
    n, ncol = data.shape
    base, rem = divmod(n, world)
    start, rows = rank * base + min(rank, rem), base + (rank < rem)
    block = torch.zeros((max(-(-n // world), 1), ncol), dtype=data.dtype, device=data.device)
    block[:rows] = data[start:start + rows]
    num_rows = torch.tensor(rows, dtype=torch.int32, device=data.device)
    return ShardedTable(data=block, num_rows=num_rows, names=tuple(names))


def package_file() -> str:
    return smj.__file__
