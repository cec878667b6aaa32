"""CSV ingest and result materialization (port of `columnar/csv_io.py`).

Two ingest paths, which give the same ``[nrow, ncol]`` int64 arrays: the
port's native multithreaded parser (`native/csv_native.py`, compiled with
g++ at first use) and, where it cannot be built, a numpy bulk split. Every
field is parsed as an integer, whatever the table type (the reference's
`atoi`, app.c:80). `read_csv` says which one ran. `load_csv_shard` parses
one byte span of a file. Results are written byte-identically to the
reference writer, integer tables through the native formatter.
"""

from __future__ import annotations

import os
from typing import Sequence, TextIO

import numpy as np
import torch

from pim_sort_merge_join_tpu_torch.columnar.table import Table
from pim_sort_merge_join_tpu_torch.native import csv_native


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


def _load_numpy(path: str, dtype=np.int64) -> np.ndarray:
    """The numpy path alone."""
    with open(path, "rb") as f:
        raw = f.read()
    nl = raw.index(b"\n")
    ncol = raw[:nl].count(b",") + 1
    return _parse_body(raw[nl + 1 :], ncol, dtype, path)


def read_csv(path: str, dtype=np.int64) -> tuple[np.ndarray, str]:
    """``(rows, parser)``: the file as a row-major ``[nrow, ncol]`` host
    array, and which parser read it: "native" wherever the library builds,
    else "numpy"."""
    arr = csv_native.parse_csv(path)
    if arr is not None:
        return arr.astype(np.dtype(dtype), copy=False), "native"
    return _load_numpy(path, dtype), "numpy"


def load_csv_numpy(path: str, dtype=np.int64) -> np.ndarray:
    """Load a CSV into a row-major ``[nrow, ncol]`` host array."""
    return read_csv(path, dtype)[0]


def _snap_to_line_start(f, pos: int, data_start: int, size: int) -> int:
    """First line-start byte offset at or after ``pos``."""
    if pos <= data_start:
        return data_start
    if pos >= size:
        return size
    f.seek(pos - 1)
    if f.read(1) == b"\n":
        return pos  # pos already begins a line
    scanned = 0
    while True:
        chunk = f.read(1 << 16)
        if not chunk:
            return size
        i = chunk.find(b"\n")
        if i >= 0:
            return pos + scanned + i + 1
        scanned += len(chunk)


def load_csv_shard(path: str, shard: int, num_shards: int, dtype=np.int64) -> np.ndarray:
    """Parse only this shard's byte range of a CSV.

    The data region after the header is cut into ``num_shards`` byte spans
    snapped forward to line boundaries; every line belongs to exactly one
    shard and the concatenation over shards equals `load_csv_numpy`.
    """
    if not 0 <= shard < num_shards:
        raise ValueError(f"shard {shard} out of range [0, {num_shards})")
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        header = f.readline()
        ncol = header.count(b",") + 1
        data_start = f.tell()
        span = size - data_start
        lo = _snap_to_line_start(f, data_start + (span * shard) // num_shards, data_start, size)
        hi = _snap_to_line_start(f, data_start + (span * (shard + 1)) // num_shards, data_start, size)
        f.seek(lo)
        body = f.read(hi - lo)
    return _parse_body(body, ncol, dtype, path)


def load_csv(
    path: str,
    *,
    capacity: int | None = None,
    dtype=torch.int64,
    device: str | torch.device | None = None,
) -> Table:
    """Load a CSV into a :class:`Table` of ``dtype`` on ``device`` (the card
    unless named)."""
    arr = load_csv_numpy(path)
    return Table.from_numpy(arr, capacity=capacity, dtype=dtype, device=device)


def write_csv(
    path_or_file: str | TextIO, array: np.ndarray, *, names: Sequence[str] | None = None
) -> None:
    """Write result rows byte-identically to the reference writer.

    Header ``col1..colN``, then ``%ld``-formatted rows, comma separated,
    ``\\n`` line endings (app.c:727-755); float tables as Python prints
    their values. Integer bodies go through the native formatter where it
    builds (uint64 printed unsigned).
    """
    nrow, ncol = array.shape
    if names is None:
        names = [f"col{i + 1}" for i in range(ncol)]
    header = ",".join(names) + "\n"
    body = None
    if nrow and np.issubdtype(array.dtype, np.integer):
        body = csv_native.format_csv_body(array)
    own = isinstance(path_or_file, str)
    if own and body is not None:
        with open(path_or_file, "wb") as f:
            f.write(header.encode())
            f.write(body)
        return
    f = open(path_or_file, "w", newline="") if own else path_or_file
    try:
        f.write(header)
        if body is not None:
            f.write(body.decode())
        elif nrow:
            lines = [",".join(map(str, row)) for row in array.tolist()]
            f.write("\n".join(lines) + "\n")
    finally:
        if own:
            f.close()


def write_table_csv(path: str, table: Table) -> None:
    write_csv(path, table.to_numpy(), names=table.names)
