"""Carry state across from the JAX package: configs and tables.

This system's counterpart of carrying weights across. The functions read
plain attributes and numpy arrays, so this module never imports jax: a
test (or any caller holding a JAX object) passes ``np.asarray(t.data)``,
``int(t.num_rows)`` and ``t.names`` of a JAX table, or the JAX config
itself.
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
