"""Carry state across from the JAX package: configs, tables and sharded tables.

This system's counterpart of carrying weights across. The functions read
plain attributes and numpy arrays, so this module never imports jax: a
test (or any caller holding a JAX object) passes ``np.asarray(t.data)``,
``int(t.num_rows)`` and ``t.names`` of a JAX table, the host arrays of a
JAX `ShardedTable` (``data``, ``counts``, as its checkpoint holds them), or
the JAX config itself.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from pim_sort_merge_join_tpu_torch.columnar.table import Table
from pim_sort_merge_join_tpu_torch.config import EngineConfig, Predicate
from pim_sort_merge_join_tpu_torch.device import resolve_device


def _predicate(p) -> Predicate:
    return Predicate(col=p.col, op=p.op, value=p.value)


def config_from_reference(obj) -> EngineConfig:
    """The port's `EngineConfig` from any object with the JAX config's fields."""
    kw = {}
    for f in dataclasses.fields(EngineConfig):
        if hasattr(obj, f.name):
            kw[f.name] = getattr(obj, f.name)
    for name in ("predicate1", "predicate2"):
        if name in kw:
            kw[name] = _predicate(kw[name])
    return EngineConfig(**kw)


def table_from_reference(
    data: np.ndarray,
    num_rows: int,
    names: Sequence[str],
    device: str | torch.device | None = None,
) -> Table:
    """A port `Table` holding a JAX table's whole buffer, padding included,
    on ``device`` (the card unless named)."""
    device = resolve_device(device)
    return Table(
        data=torch.from_numpy(np.array(data, order="C")).to(device),
        num_rows=torch.tensor(int(num_rows), dtype=torch.int32, device=device),
        names=tuple(names),
    )


def sharded_from_reference(
    arrays,
    rank: int,
    world: int,
    *,
    group=None,
    names: Sequence[str] | None = None,
    device: str | torch.device | None = None,
):
    """Rank ``rank``'s block of a JAX `ShardedTable` as a port
    `ShardedTable` on ``device`` (the card unless named).

    ``arrays`` holds the reference's global host view: ``data [P * cap,
    ncol]`` and ``counts [P]`` (`ShardedTable._host_arrays`, or a sharded
    checkpoint's arrays); ``world`` must be its P. So both packages can be
    fed the same shards, and a checkpoint written by either loads in the
    other.
    """
    from pim_sort_merge_join_tpu_torch.engine.distributed import ShardedTable

    data, counts = np.asarray(arrays["data"]), np.asarray(arrays["counts"])
    if counts.shape != (world,) or data.shape[0] % world:
        raise ValueError(
            f"a sharded table of {counts.shape[0]} shards and {data.shape[0]} rows is not "
            f"a table over {world} ranks"
        )
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside [0, {world})")
    cap = data.shape[0] // world
    t = table_from_reference(data[rank * cap:(rank + 1) * cap], int(counts[rank]),
                             names if names is not None else (), device)
    return ShardedTable(t.data, t.num_rows, t.names, group)
