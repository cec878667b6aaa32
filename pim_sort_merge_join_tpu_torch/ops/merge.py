"""Pairwise merge of sorted runs, and the log-depth merge tree (port of `ops/merge.py`).

The reference's pairwise merge (`merge_dpu.c`) is one stable sort of the
two runs' concatenation, run 1 first: stability alone keeps run 1's rows
ahead on ties and each run's inner order. The port sorts the masked keys
with the rows as payload (`stable_key_sort_rows`): on CUDA tensors the
`hbm_sort` kernels and one row gather, on CPU tensors their plain versions.
`merge_tree` is the reference host program's binary reduction (app.c:408-547).
"""

from __future__ import annotations

from typing import Sequence

import torch

from pim_sort_merge_join_tpu_torch.columnar import dtypes
from pim_sort_merge_join_tpu_torch.columnar.table import Table
from pim_sort_merge_join_tpu_torch.ops.sort import stable_key_sort_rows


def merge_sorted(t1: Table, t2: Table, key: int) -> Table:
    """Merge two key-sorted tables into one sorted table.

    Both inputs share a schema and are sorted ascending on column ``key``.
    The output has capacity ``cap1 + cap2``, ``num_rows = n1 + n2`` and the
    promoted type of the two tables (as the reference's concatenation,
    `columnar/dtypes.promote`: int64 with uint64 gives float64); ties keep
    run-1 rows first. Each run's padding carries its own type's
    sentinel, so run-1 padding lands before run-2 padding and valid rows
    stay a dense prefix.
    """
    if t1.ncol != t2.ncol:
        raise ValueError(f"schema mismatch: {t1.ncol} vs {t2.ncol} columns")
    dtype = dtypes.promote(t1.dtype, t2.dtype)
    keys = torch.cat([dtypes.order_key(t.masked_keys(key).to(dtype)) for t in (t1, t2)])
    rows = torch.cat([dtypes.bits(t.data.to(dtype)) for t in (t1, t2)])
    return Table(
        data=stable_key_sort_rows([(keys, dtypes.from_bits(rows, dtype))]),
        num_rows=(t1.num_rows + t2.num_rows).to(torch.int32),
        names=t1.names,
    )


def merge_tree(tables: Sequence[Table], key: int) -> Table:
    """Log-depth pairwise reduction of N sorted runs into one sorted table:
    each round merges adjacent pairs and carries an odd leftover."""
    if not tables:
        raise ValueError("merge_tree needs at least one run")
    runs = list(tables)
    while len(runs) > 1:
        nxt = [merge_sorted(runs[i], runs[i + 1], key) for i in range(0, len(runs) - 1, 2)]
        if len(runs) % 2:
            nxt.append(runs[-1])
        runs = nxt
    return runs[0]
