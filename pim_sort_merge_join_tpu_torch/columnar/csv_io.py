"""CSV ingest and result materialization (port of `columnar/csv_io.py`).

The numpy parser and the reference's byte format for results. The native
ctypes parser of the JAX package is not ported yet (ROADMAP: "The native
CSV shim and the launcher"); the output bytes do not depend on it.
"""

from __future__ import annotations

from typing import Sequence, TextIO

import numpy as np
import torch

from pim_sort_merge_join_tpu_torch.columnar.table import Table


def probe_csv(path: str) -> tuple[int, int]:
    """Return ``(ncol, nrow)``: columns from the header, rows from line count."""
    with open(path, "rb") as f:
        header = f.readline()
        ncol = header.count(b",") + 1
        nrow = sum(chunk.count(b"\n") for chunk in iter(lambda: f.read(1 << 20), b""))
    return ncol, nrow


def _parse_body(body: bytes, ncol: int, dtype, path: str) -> np.ndarray:
    """Bulk parse CSV body bytes: split once, reshape (the reference's `atoi`)."""
    if not body:
        return np.zeros((0, ncol), dtype=np.dtype(dtype))
    fields = body.replace(b"\r", b"").replace(b"\n", b",").rstrip(b",").split(b",")
    arr = np.array(fields, dtype=np.int64)
    if arr.size % ncol != 0:
        raise ValueError(
            f"malformed CSV {path!r}: {arr.size} fields is not a multiple of "
            f"the {ncol}-column header (ragged row?)"
        )
    return arr.reshape(-1, ncol).astype(np.dtype(dtype), copy=False)


def load_csv_numpy(path: str, dtype=np.int64) -> np.ndarray:
    """Load a CSV into a row-major ``[nrow, ncol]`` host array."""
    with open(path, "rb") as f:
        raw = f.read()
    nl = raw.index(b"\n")
    ncol = raw[:nl].count(b",") + 1
    return _parse_body(raw[nl + 1 :], ncol, dtype, path)


def load_csv(
    path: str,
    *,
    capacity: int | None = None,
    dtype: torch.dtype = torch.int64,
    device: str | torch.device | None = None,
) -> Table:
    """Load a CSV into a :class:`Table` on ``device`` (the card unless named)."""
    arr = load_csv_numpy(path)
    return Table.from_numpy(arr, capacity=capacity, dtype=dtype, device=device)


def write_csv(
    path_or_file: str | TextIO, array: np.ndarray, *, names: Sequence[str] | None = None
) -> None:
    """Write result rows byte-identically to the reference writer.

    Header ``col1..colN``, then ``%ld``-formatted rows, comma separated,
    ``\\n`` line endings (app.c:727-755).
    """
    nrow, ncol = array.shape
    if names is None:
        names = [f"col{i + 1}" for i in range(ncol)]
    own = isinstance(path_or_file, str)
    f = open(path_or_file, "w", newline="") if own else path_or_file
    try:
        f.write(",".join(names) + "\n")
        if nrow:
            lines = [",".join(map(str, row)) for row in array.tolist()]
            f.write("\n".join(lines) + "\n")
    finally:
        if own:
            f.close()


def write_table_csv(path: str, table: Table) -> None:
    write_csv(path, table.to_numpy(), names=table.names)
