"""Vectorized selection (port of `ops/filter.py`): the predicate mask.

The fused pipeline needs only the mask: masked-out rows get sentinel keys
and the join's sorts place the survivors. `compact`/`apply_filter` belong
to the staged path (ROADMAP, "The staged path and sort_by_key").
"""

from __future__ import annotations

import torch

from pim_sort_merge_join_tpu_torch.columnar.table import Table
from pim_sort_merge_join_tpu_torch.config import Predicate

_OPS = {
    ">": torch.gt,
    ">=": torch.ge,
    "<": torch.lt,
    "<=": torch.le,
    "==": torch.eq,
    "!=": torch.ne,
}


def predicate_mask(table: Table, pred: Predicate) -> torch.Tensor:
    """Boolean mask of valid rows satisfying the predicate."""
    value = torch.tensor(pred.value, dtype=table.dtype, device=table.device)
    return table.valid_mask() & _OPS[pred.op](table.column(pred.col), value)
