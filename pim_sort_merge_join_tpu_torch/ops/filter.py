"""Vectorized selection (port of `ops/filter.py`).

The fused pipeline needs only the predicate mask: masked-out rows get
sentinel keys and the join's sorts place the survivors. The staged path
compacts each table first (`apply_filter`).

A predicate compares as `columnar/dtypes.compare` compares: signed
integers and floats as torch compares them (a NaN value fails every
predicate but ``!=``, as in the JAX package), unsigned columns through
their order keys, so a predicate value above the int64 range (a uint64
one) is exact there.
"""

from __future__ import annotations

import dataclasses

import torch

from pim_sort_merge_join_tpu_torch.columnar import dtypes
from pim_sort_merge_join_tpu_torch.columnar.table import Table
from pim_sort_merge_join_tpu_torch.config import Predicate


def predicate_mask(table: Table, pred: Predicate) -> torch.Tensor:
    """Boolean mask of valid rows satisfying the predicate."""
    return table.predicate_mask(pred)


def compact(table: Table, mask: torch.Tensor) -> Table:
    """Stable-compact the masked rows to the front; same capacity.

    The reference sorts the rows stably on the inverted mask, so its buffer
    holds the selected rows in order, then the unselected rows in order.
    A stable-partition scatter gives exactly that buffer.
    """
    count = mask.sum(dtype=torch.int32)
    dest = torch.where(
        mask,
        torch.cumsum(mask, 0) - 1,
        count + torch.cumsum(~mask, 0) - 1,
    )
    rows = dtypes.bits(table.data)
    data = torch.empty_like(rows).index_copy_(0, dest, rows)
    return dataclasses.replace(table, data=dtypes.from_bits(data, table.dtype), num_rows=count)


def apply_filter(table: Table, pred: Predicate) -> Table:
    """SELECT rows satisfying ``pred``; compacted, row order preserved."""
    return compact(table, predicate_mask(table, pred))
