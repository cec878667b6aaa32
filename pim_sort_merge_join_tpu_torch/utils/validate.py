"""Invariant checks (port of `utils/validate.py`): host-side debugging
tools that the query paths never call on their own, except the three
ingest checks of `run_csv`.

- `check_dtype_range`, `check_narrow_keys`, `check_narrow_data`: a narrowing
  cast or the narrow-key / narrow-data paths fail loudly instead of wrapping;
- `check_table`: a table's structural invariants, and its order on a column
  in the type's order (`columnar/dtypes.order_key`);
- `check_sharded_table`: every rank's row count within the capacity (a
  collective over the table's group);
- `check_deterministic`: two runs of a pipeline give the same bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from pim_sort_merge_join_tpu_torch.columnar import dtypes
from pim_sort_merge_join_tpu_torch.columnar.table import Table
from pim_sort_merge_join_tpu_torch.engine.errors import MalformedInputError


class ValidationError(AssertionError):
    pass


def check_dtype_range(rows: np.ndarray, dtype, name: str = "input") -> None:
    """Raise MalformedInputError when values exceed a narrow dtype's range."""
    dtype = np.dtype(dtype)
    if dtype.itemsize >= 8 or not np.issubdtype(dtype, np.integer):
        return
    info = np.iinfo(dtype)
    if rows.size and (rows.max() > info.max or rows.min() < info.min):
        raise MalformedInputError(
            f"{name}: values exceed configured dtype {dtype} range "
            f"[{info.min}, {info.max}]"
        )


def check_narrow_keys(rows: np.ndarray, key: int, name: str = "input") -> None:
    """Raise MalformedInputError when join-key values do not fit int32
    (INT32_MAX itself is the narrow sentinel)."""
    if not rows.size:
        return
    info = np.iinfo(np.int32)
    col = rows[:, key]
    if col.max() >= info.max or col.min() < info.min:
        raise MalformedInputError(
            f"{name}: join-key values outside [{info.min}, {info.max}) -- "
            "narrow_keys=True requires every key to fit int32; disable it "
            "for this data"
        )


def check_narrow_data(rows: np.ndarray, name: str = "input") -> None:
    """Raise MalformedInputError when ANY table value does not fit int32."""
    if not rows.size:
        return
    info = np.iinfo(np.int32)
    if rows.max() >= info.max or rows.min() < info.min:
        raise MalformedInputError(
            f"{name}: table values outside [{info.min}, {info.max}) -- "
            "narrow_data=True requires every value to fit int32; disable it "
            "for this data"
        )


def check_table(table: Table, *, sorted_by: int | None = None) -> None:
    """Validate a table's structural invariants (reads it back): ``num_rows``
    within the capacity, one name per column, and with ``sorted_by`` the
    valid rows ascending on that column in the type's order."""
    n = int(table.num_rows)
    if not 0 <= n <= table.capacity:
        raise ValidationError(f"num_rows {n} outside [0, capacity {table.capacity}]")
    if table.names and len(table.names) != table.ncol:
        raise ValidationError(f"{len(table.names)} names for {table.ncol} columns")
    if sorted_by is not None and n > 1:
        col = table.data[:n, sorted_by]
        key = dtypes.order_key(col)
        ok = key[1:] >= key[:-1]
        if not bool(ok.all()):
            bad = int(torch.argmin(ok.to(torch.int8)))
            vals = col.cpu().numpy()
            raise ValidationError(
                f"column {sorted_by} not sorted ascending at row {bad}: "
                f"{vals[bad]} > {vals[bad + 1]}"
            )


def check_sharded_table(st) -> None:
    """Validate a `ShardedTable`'s per-rank counts against its capacity,
    from the counts gathered to every rank (so every rank raises alike)."""
    counts = st.counts()
    bad = np.nonzero((counts < 0) | (counts > st.capacity))[0]
    if bad.size:
        raise ValidationError(
            f"shards {bad.tolist()} have counts outside [0, {st.capacity}]: "
            f"{counts[bad].tolist()}"
        )


def _leaves(out) -> list[torch.Tensor]:
    if isinstance(out, Table):
        return [out.data, out.num_rows]
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _leaves(o)]
    if isinstance(out, dict):
        return [t for k in sorted(out) for t in _leaves(out[k])]
    raise TypeError(f"check_deterministic: cannot compare a {type(out).__name__}")


def _host_bytes(t: torch.Tensor) -> tuple:
    a = t.detach().cpu().numpy()
    return a.dtype.str, a.shape, a.tobytes()


def check_deterministic(fn, *args, reps: int = 2) -> None:
    """Run ``fn(*args)`` ``reps`` times; identical bytes out or raise.

    Every tensor of the result (a table's whole buffer and row count, or
    tensors in tuples, lists and dicts) must have the same type, shape and
    bytes in every run, so an order that atomics or a scheduler decide
    shows up as a difference.
    """
    first = [_host_bytes(t) for t in _leaves(fn(*args))]
    for _ in range(reps - 1):
        again = [_host_bytes(t) for t in _leaves(fn(*args))]
        if again != first:
            raise ValidationError("nondeterministic pipeline output")
