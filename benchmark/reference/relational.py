"""The plain reference of the benchmark's queries, in plain torch.

Filter both tables, sort each stably on its join key, join, emit table-1
columns then table-2 columns without its key: the semantics of the
upstream's `cpu_app.c` (1:1, the k-th duplicate of a key in table 1 with
the k-th in table 2) and of the SQL inner join (every pair, in table-1
order, then table-2 order). It runs on any device, from the inputs the
benchmark made, and imports nothing of the program.

``key_dtype`` compares the join keys in another type: the control, which
must fail the comparison, passes ``torch.float32``.
"""

from __future__ import annotations

import numpy as np
import torch

OPS = {">": torch.gt, ">=": torch.ge, "<": torch.lt, "<=": torch.le,
       "==": torch.eq, "!=": torch.ne}


def _filter(t: torch.Tensor, pred: dict) -> torch.Tensor:
    return t[OPS[pred["op"]](t[:, pred["col"]], pred["value"])]


def _sorted(t: torch.Tensor, key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    order = torch.sort(key, stable=True).indices
    return t[order], key[order]


def _occurrence(keys: torch.Tensor) -> torch.Tensor:
    """Rank of each element of sorted ``keys`` within its run of equals."""
    iota = torch.arange(keys.shape[0], device=keys.device)
    return iota - torch.searchsorted(keys, keys, side="left")


def run_query(t1: torch.Tensor, t2: torch.Tensor, query: dict,
              key_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The query's rows, ``[rows, c1 + c2 - 1]``, from two ``[n, c]``
    tables whose rows are all valid. ``query`` holds ``predicate1``,
    ``predicate2`` (``{"col", "op", "value"}``), ``join_key1``,
    ``join_key2`` and ``join_mode`` ("one_to_one" or "inner")."""
    k1c, k2c = query["join_key1"], query["join_key2"]
    f1, f2 = _filter(t1, query["predicate1"]), _filter(t2, query["predicate2"])
    cast = (lambda k: k) if key_dtype is None else (lambda k: k.to(key_dtype))
    s1, k1 = _sorted(f1, cast(f1[:, k1c]))
    s2, k2 = _sorted(f2, cast(f2[:, k2c]))
    lo = torch.searchsorted(k2, k1, side="left")
    hi = torch.searchsorted(k2, k1, side="right")
    if query["join_mode"] == "one_to_one":
        occ = _occurrence(k1)
        hit = occ < hi - lo
        rows1 = torch.nonzero(hit).squeeze(1)
        rows2 = (lo + occ)[hit]
    elif query["join_mode"] == "inner":
        count = hi - lo
        rows1 = torch.repeat_interleave(torch.arange(k1.shape[0], device=k1.device), count)
        first = torch.cumsum(count, 0) - count
        rows2 = lo[rows1] + torch.arange(rows1.shape[0], device=k1.device) - first[rows1]
    else:
        raise ValueError(f"join_mode {query['join_mode']!r}")
    keep2 = [c for c in range(t2.shape[1]) if c != k2c]
    return torch.cat([s1[rows1], s2[rows2][:, keep2]], dim=1)


def compare(got: np.ndarray, want: np.ndarray) -> dict:
    """The numbers the check compares: ``rows_count_gap``, the difference
    of the row counts, and ``rows_differing``, the rows of the shorter
    that differ in any column plus that gap. Both are 0 when equal."""
    if got.ndim != 2 or got.shape[1] != want.shape[1]:
        return {"rows_count_gap": abs(got.shape[0] - want.shape[0]),
                "rows_differing": max(got.shape[0], want.shape[0])}
    n = min(got.shape[0], want.shape[0])
    gap = abs(got.shape[0] - want.shape[0])
    differ = int(np.count_nonzero((got[:n] != want[:n]).any(axis=1)))
    return {"rows_count_gap": gap, "rows_differing": differ + gap}
