"""Columnar device-table model (PyTorch port of `columnar/table.py`).

A table is a fixed-capacity row-major ``[capacity, ncol]`` tensor plus a
0-d int32 ``num_rows`` tensor on the same device. Rows at index
``>= num_rows`` are padding; every operator masks them out. The layout is
the JAX package's, so a test compares the two buffers as they are. The
buffer holds any of the six types of `columnar/dtypes`; operators compare
its `order_keys` and move its bits (`dtypes.bits`).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from pim_sort_merge_join_tpu_torch.columnar import dtypes
from pim_sort_merge_join_tpu_torch.columnar.dtypes import key_sentinel
from pim_sort_merge_join_tpu_torch.device import resolve_device

__all__ = ["Table", "concat_tables", "key_sentinel"]


def _default_names(ncol: int) -> tuple:
    return tuple(f"col{i + 1}" for i in range(ncol))


@dataclasses.dataclass
class Table:
    """A fixed-capacity columnar table on one device.

    Attributes:
      data: ``[capacity, ncol]`` tensor; ``data[:, c]`` is column ``c``.
      num_rows: 0-d int32 tensor on ``data``'s device; rows
        ``[0, num_rows)`` are valid.
      names: tuple of column names (``col1``, ``col2``, ...).
    """

    data: torch.Tensor
    num_rows: torch.Tensor
    names: tuple = ()

    @property
    def ncol(self) -> int:
        return self.data.shape[1]

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    def column(self, c: int) -> torch.Tensor:
        """Logical column ``c`` as a 1D ``[capacity]`` tensor."""
        return self.data[:, c]

    @classmethod
    def from_numpy(
        cls,
        array: np.ndarray,
        *,
        capacity: int | None = None,
        names: Sequence[str] | None = None,
        dtype=torch.int64,
        device: str | torch.device | None = None,
    ) -> "Table":
        """Build a table on ``device`` (the card unless named) from a
        row-major ``[nrow, ncol]`` host array. ``dtype`` (a torch or numpy
        type) is the table's; the array is converted to it as numpy's
        assignment converts, as the JAX package's does."""
        device = resolve_device(device)
        dtype = dtypes.as_torch_dtype(dtype)
        if array.ndim != 2:
            raise ValueError(f"expected 2D [nrow, ncol] array, got {array.shape}")
        nrow, ncol = array.shape
        capacity = nrow if capacity is None else capacity
        if capacity < nrow:
            raise ValueError(f"capacity {capacity} < nrow {nrow}")
        names = _default_names(ncol) if names is None else tuple(names)
        buf = np.zeros((capacity, ncol), dtype=dtypes.numpy_dtype(dtype))
        buf[:nrow] = array
        return cls(
            data=torch.from_numpy(buf).to(device),
            num_rows=torch.tensor(nrow, dtype=torch.int32, device=device),
            names=names,
        )

    @classmethod
    def empty(
        cls,
        ncol: int,
        capacity: int,
        *,
        names=None,
        dtype=torch.int64,
        device: str | torch.device | None = None,
    ) -> "Table":
        device = resolve_device(device)
        return cls(
            data=torch.zeros((capacity, ncol), dtype=dtypes.as_torch_dtype(dtype), device=device),
            num_rows=torch.tensor(0, dtype=torch.int32, device=device),
            names=_default_names(ncol) if names is None else tuple(names),
        )

    def valid_mask(self) -> torch.Tensor:
        """Boolean ``[capacity]`` mask of valid rows."""
        iota = torch.arange(self.capacity, dtype=torch.int32, device=self.device)
        return iota < self.num_rows

    def predicate_mask(self, pred) -> torch.Tensor:
        """Boolean ``[capacity]`` mask of valid rows on which ``pred`` (a
        `config.Predicate`) holds, as `dtypes.compare` compares."""
        return self.valid_mask() & dtypes.compare(self.column(pred.col), pred.op, pred.value)

    def masked_keys(self, col: int) -> torch.Tensor:
        """Column ``col`` in the table's type with padding rows replaced by
        `key_sentinel` (the type's maximum, +inf for floats)."""
        sent = dtypes.sentinel_bits(self.dtype)
        col_bits = torch.where(self.valid_mask(), dtypes.bits(self.data[:, col]), sent)
        return dtypes.from_bits(col_bits, self.dtype)

    def order_keys(
        self, col: int, dtype: torch.dtype | None = None, mask: torch.Tensor | None = None
    ) -> torch.Tensor:
        """`dtypes.order_key` of column ``col`` taken as ``dtype`` (the
        table's own by default; a join's the two tables' promoted type),
        rows outside ``mask`` (padding by default) the order sentinel: what
        the sorts and joins compare. A table of another type is converted
        as the reference's concatenation converts it, its own sentinel
        included."""
        valid = self.valid_mask() if mask is None else mask
        if dtype is None or dtype == self.dtype:
            return torch.where(valid, dtypes.order_key(self.data[:, col]),
                               dtypes.order_max(self.dtype))
        masked = torch.where(valid, dtypes.bits(self.data[:, col]), dtypes.sentinel_bits(self.dtype))
        return dtypes.order_key(dtypes.from_bits(masked, self.dtype).to(dtype))

    def to_numpy(self) -> np.ndarray:
        """Row-major ``[num_rows, ncol]`` host array of the valid rows."""
        n = int(self.num_rows)
        return self.data[:n].cpu().numpy().copy()

    def with_capacity(self, capacity: int) -> "Table":
        """Return a copy padded with zeros / truncated to a new capacity."""
        cap, ncol = self.data.shape
        if capacity == cap:
            return self
        if capacity > cap:
            data = self.data.new_zeros((capacity, ncol))
            data[:cap] = self.data
        else:
            data = self.data[:capacity]
        return dataclasses.replace(self, data=data)


def concat_tables(tables: Sequence[Table]) -> Table:
    """Concatenate same-schema tables row-wise, compacting valid rows.

    The valid rows of each table, in table order, then zeros up to the sum
    of the input capacities; names and type are the first table's. Each
    table's valid rows are its prefix, so the counts are read in one host
    read and the rows are moved as their bits in one `torch.cat` on the
    first table's device.
    """
    if not tables:
        raise ValueError("concat_tables needs at least one table")
    first = tables[0]
    device, dtype = first.device, first.dtype
    counts = torch.stack([t.num_rows.to(device) for t in tables]).tolist()
    parts = [dtypes.bits(t.data[:n].to(device=device, dtype=dtype))
             for t, n in zip(tables, counts)]
    pad = sum(t.capacity for t in tables) - sum(counts)
    data = torch.cat(parts + [parts[0].new_zeros((pad, first.ncol))])
    return Table(
        data=dtypes.from_bits(data, dtype),
        num_rows=torch.tensor(sum(counts), dtype=torch.int32, device=device),
        names=first.names,
    )
