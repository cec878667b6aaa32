"""Row gather: a CUDA kernel for Hopper, and the plain version.

``out[i, c + q] = src[idx[i], cols[q]]``: the rows of a row-major table taken
by an index (a sort's permutation, or a join's source rows), the kept
columns written into a column window of a row-major output. It takes the
place of the payload planes that rode the TPU sort
(`pim_sort_merge_join_tpu/ops/pallas/hbm_sort.py`, the non-key operands)
wherever the payload is a table's rows, and of the row takes of the join's
emit. Gathering a table column by column reads each row's 32-byte sector
once per column; `csrc/gather.cu` reads it once per row.

A call takes *parts* ``(src, idx, cols)``, each a table with its own index,
whose windows follow each other in the same output rows from column 0 on.
The kernel takes two parts per launch, so a join writes both tables'
columns in one launch, every output sector whole; it reads rows of at most
``MAX_ROW_BYTES``, so a wider table goes as column slices of that width
(`row_slices`), two to a launch.

With ``live`` (a 0-d int32 tensor on the device) the rows from ``live`` on
are written as zeros and their indices are never read, so an output whose
tail is padding needs no masking pass. Rows past the end of a part's
``idx`` are zeros in that part's window as well.
"""

from __future__ import annotations

import ctypes

import torch

from pim_sort_merge_join_tpu_torch.ops.kernels import build

MAX_ROW_BYTES = 64  # SMJ_ROWS_MAX_BYTES in csrc/gather.cu: the widest row a launch reads
MAX_PARTS = 2  # SMJ_ROWS_MAX_PARTS: parts gathered into one output in one launch

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int


def _check_sizes() -> None:
    built = tuple(
        build.c_function(f, [])()
        for f in ("smj_gather_rows_max_bytes", "smj_gather_rows_max_parts")
    )
    if built != (MAX_ROW_BYTES, MAX_PARTS):
        raise RuntimeError(
            f"gather_rows: the library was built for (row bytes, parts) = {built}, "
            f"this module checks for {(MAX_ROW_BYTES, MAX_PARTS)}"
        )


build.declare(
    {"smj_gather_rows": [_INT, _P, _P, _P, _P, _P, _P, _P, _INT, _P, _P, _I64, _I64, _P]},
    ("gather_rows",),
    _check_sizes,
)


def _checked(parts, out, live):
    """Validate one call; returns ``(parts, out)`` with every part's columns
    listed and the output allocated if none was given."""
    parts = [tuple(p) + (None,) * (3 - len(p)) for p in parts]
    if not parts:
        raise ValueError("gather_rows: no part to gather")
    full = []
    for src, idx, cols in parts:
        if src.dim() != 2 or src.dtype not in (torch.int32, torch.int64):
            raise ValueError(
                f"gather_rows: src must be a 2D int32/int64 table, got {src.dtype} "
                f"{tuple(src.shape)}"
            )
        if idx.dim() != 1 or idx.dtype != torch.int32:
            raise ValueError(
                f"gather_rows: idx must be 1D int32, got {idx.dtype} {tuple(idx.shape)}"
            )
        w = src.shape[1]
        cols = list(range(w)) if cols is None else [int(c) for c in cols]
        if not cols or any(not 0 <= c < w for c in cols):
            raise ValueError(f"gather_rows: cols {cols} must name columns of a table of {w}")
        full.append((src, idx, cols))
    src0, idx0, _ = full[0]
    width = sum(len(cols) for _, _, cols in full)
    if out is None:
        out = torch.empty((idx0.shape[0], width), dtype=src0.dtype, device=src0.device)
    if out.dim() != 2 or not out.is_contiguous() or any(s.dtype != out.dtype for s, _, _ in full):
        raise ValueError(
            f"gather_rows: out must be a contiguous 2D tensor of the tables' type, got "
            f"{out.dtype} {tuple(out.shape)} for {[s.dtype for s, _, _ in full]}"
        )
    if width > out.shape[1]:
        raise ValueError(
            f"gather_rows: {width} kept columns are no window of an output of {out.shape[1]}"
        )
    if live is not None and (live.dtype != torch.int32 or live.numel() != 1):
        raise ValueError(f"gather_rows: live must be one int32, got {live.dtype} {tuple(live.shape)}")
    tensors = [out] + [t for s, i, _ in full for t in (s, i)] + ([] if live is None else [live])
    devices = {t.device for t in tensors}
    if len(devices) != 1 or out.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gather_rows: unsupported devices {sorted(str(d) for d in devices)}")
    for src, idx, _ in full:
        if min(out.shape[0], idx.shape[0]) > 0 and src.shape[0] == 0:
            raise ValueError("gather_rows: no source rows to gather from")
    return full, out


def gather_rows_plain(parts, *, out=None, live=None) -> torch.Tensor:
    """Plain torch version: `index_select` of each part's rows, the kept
    columns written into its window."""
    parts, out = _checked(parts, out, live)
    m = out.shape[0]
    col = 0
    for src, idx, cols in parts:
        lim = min(m, idx.shape[0])
        block = torch.zeros((m, len(cols)), dtype=src.dtype, device=src.device)
        if lim:
            take = idx[:lim].long()
            if live is not None:
                # Indices from `live` on may be anything: they are not read.
                real = torch.arange(lim, device=src.device) < live.reshape(())
                take = torch.where(real, take, 0)
            rows = src.index_select(0, take)[:, cols]
            block[:lim] = rows if live is None else torch.where(real[:, None], rows, 0)
        out[:, col:col + len(cols)] = block
        col += len(cols)
    return out


def row_slices(parts):
    """``parts`` (columns listed) as parts whose rows the kernel can read:
    a table wider than ``MAX_ROW_BYTES`` becomes views of that many bytes of
    its columns, one for each run of kept columns that lie in the same
    slice, in the order of the output's columns."""
    pieces = []
    for src, idx, cols in parts:
        per = MAX_ROW_BYTES // src.element_size()
        if src.shape[1] <= per:
            pieces.append((src, idx, cols))
            continue
        at = 0
        while at < len(cols):
            first = cols[at] // per * per
            end = at
            while end < len(cols) and first <= cols[end] < first + per:
                end += 1
            pieces.append((src[:, first:first + per], idx, [c - first for c in cols[at:end]]))
            at = end
    return pieces


def gather_rows_cuda(parts, *, out=None, live=None) -> torch.Tensor:
    """The kernel, one launch for every ``MAX_PARTS`` of `row_slices`; the
    indices are trusted to be in range where they are read."""
    parts, out = _checked(parts, out, live)
    for src, _, _ in parts:
        if not src.is_contiguous():
            raise ValueError("gather_rows: src must be contiguous (row-major)")
    tensors = [t for s, i, _ in parts for t in (s, i)] + ([] if live is None else [live])
    build.require_cuda("gather_rows", out, *tensors)
    if out.shape[0] == 0:
        return out
    pieces = row_slices(parts)
    col = 0
    for at in range(0, len(pieces), MAX_PARTS):
        group = pieces[at:at + MAX_PARTS]
        k = len(group)
        flat_cols = [c for _, _, cols in group for c in cols]
        err = build.entry("smj_gather_rows")(
            k,
            ctypes.cast((_P * k)(*(s.data_ptr() for s, _, _ in group)), _P),
            ctypes.cast((_INT * k)(*(s.shape[1] for s, _, _ in group)), _P),
            ctypes.cast((_I64 * k)(*(s.stride(0) for s, _, _ in group)), _P),
            ctypes.cast((_P * k)(*(i.data_ptr() for _, i, _ in group)), _P),
            ctypes.cast((_I64 * k)(*(i.shape[0] for _, i, _ in group)), _P),
            ctypes.cast((_INT * k)(*(len(cols) for _, _, cols in group)), _P),
            ctypes.cast((_INT * len(flat_cols))(*flat_cols), _P),
            out.element_size(), None if live is None else live.data_ptr(),
            out.data_ptr() + col * out.element_size(), out.shape[0], out.shape[1],
            build.stream_ptr(out),
        )
        build.check(err, "gather_rows")
        build.launched("gather_rows")
        col += len(flat_cols)
    return out


def gather_rows(parts, *, out=None, live=None) -> torch.Tensor:
    """For each part ``(src, idx, cols)``: ``out[i, c + q] = src[idx[i],
    cols[q]]``, ``c`` starting at 0 and moving on by each part's kept
    columns; returns ``out``.

    ``src`` is a row-major ``[n, w]`` int32/int64 table, ``idx`` int32,
    ``cols`` the kept source columns (all if None or left out), ``out`` a
    contiguous ``[m, W]`` tensor of the tables' type (new, as long as the
    first index and as wide as the kept columns, by default; columns past
    the kept ones stay as they are). Rows ``i >= min(len(idx), live)`` of a
    part's window are zeros. CUDA tensors launch the kernel, CPU tensors
    take the plain version.
    """
    parts = list(parts)
    if parts and parts[0][0].device.type == "cuda":
        return gather_rows_cuda(parts, out=out, live=live)
    return gather_rows_plain(parts, out=out, live=live)
