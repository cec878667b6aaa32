"""The fused 1:1 join's keys: a CUDA kernel for Hopper, and the plain version.

``join_keys(t1, t2, pred1, pred2, key1, key2, narrow)`` is the one key
vector the fused join's merge sort takes, ``cap1 + cap2`` long, table 1's
rows first: row ``i`` of a table gives the order key
(`columnar/dtypes.order_key`) of its key column in the two tables'
promoted type where ``i < num_rows`` and the table's predicate holds on
the row, and the sentinel elsewhere; ``narrow is True`` narrows an 8-byte
integer type's keys to int32 (`dtypes.narrow32`). Its plain version,
`join_keys_plain`, is the torch composition: each table's predicate mask
(`Table.predicate_mask`) and `one_to_one_keys`. It runs on CPU tables;
tables on the card take `join_keys_cuda`, one launch of `csrc/keys.cu`
(its note says how), for every pair of the six table types, the two
types' promotion made in the same pass. The kernel's result equals the
plain version's bit for bit, errors included: a column out of range
raises torch's `IndexError`, a predicate value out of the type's range its
conversion's error, an unknown operator `KeyError`, in the plain version's
order (`_predicate`, `_column`). A card table whose row count breaks the
`Table` invariant (a one-element int32 tensor on the table's device)
raises `ValueError`.
"""

from __future__ import annotations

import ctypes
import struct

import torch

from pim_sort_merge_join_tpu_torch.columnar import dtypes
from pim_sort_merge_join_tpu_torch.columnar.table import Table
from pim_sort_merge_join_tpu_torch.config import Predicate
from pim_sort_merge_join_tpu_torch.ops.kernels import build

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
# A table's buffer (base, rows, ncol, strides, num_rows, kind, shift,
# contiguous), its key column, its predicate (column, holds, value) and its
# type's key sentinel.
_TABLE = [_P, _I64, _INT, _I64, _I64, _P, _INT, _INT, _INT, _INT, _INT, _INT, _I64, _I64]

_NARROWED = (torch.int64, torch.uint64)  # the types whose keys narrow to int32
# Each operator as the outcomes it keeps: bit 0 below the value, bit 1
# equal, bit 2 above, bit 3 unordered (a NaN) (`csrc/keys.cu`'s ``holds``).
_HOLDS = {">": 0b0100, ">=": 0b0110, "<": 0b0001, "<=": 0b0011, "==": 0b0010, "!=": 0b1101}

build.declare({"smj_join_keys": [*_TABLE, *_TABLE, _INT, _INT, _INT, _P, _P]}, ("join_keys",))


def one_to_one_keys(
    t1: Table,
    t2: Table,
    key1: int,
    key2: int,
    mask1: torch.Tensor | None = None,
    mask2: torch.Tensor | None = None,
    *,
    narrow: bool = False,
) -> torch.Tensor:
    """The fused 1:1 join's key vector, table 1's keys first: each table's
    key column as order keys of the two tables' promoted type, rows outside
    its mask (padding by default) the sentinel. ``narrow is True`` narrows
    those of an 8-byte integer type to int32 (an unresolved "auto" stays
    wide)."""
    dtype = dtypes.promote(t1.dtype, t2.dtype)
    keys = torch.cat([t1.order_keys(key1, dtype, mask1), t2.order_keys(key2, dtype, mask2)])
    if narrow is True and dtype in _NARROWED:
        keys = dtypes.narrow32(keys, dtype)
    return keys


def join_keys(t1: Table, t2: Table, pred1: Predicate, pred2: Predicate, key1: int, key2: int,
              narrow: bool) -> torch.Tensor:
    """The fused join's key vector: int32 where narrowed or the promoted
    type is 4 bytes wide, else int64. CPU tables take `join_keys_plain`,
    any other the kernel."""
    if t1.device.type == t2.device.type == "cpu":
        return join_keys_plain(t1, t2, pred1, pred2, key1, key2, narrow)
    return join_keys_cuda(t1, t2, pred1, pred2, key1, key2, narrow)


def join_keys_plain(t1: Table, t2: Table, pred1: Predicate, pred2: Predicate, key1: int,
                    key2: int, narrow: bool) -> torch.Tensor:
    """`join_keys` as torch ops, on any device and any types."""
    m1, m2 = t1.predicate_mask(pred1), t2.predicate_mask(pred2)
    return one_to_one_keys(t1, t2, key1, key2, m1, m2, narrow=narrow)


def _checked_tables(t1: Table, t2: Table) -> None:
    dev = t1.data.device
    for t in (t1, t2):
        if t.data.device != dev or dev.type == "cpu":
            raise ValueError(
                f"join_keys_cuda: tables must share one CUDA device, got {t1.device}, {t2.device}"
            )
        n = t.num_rows
        if n.dtype != torch.int32 or n.numel() != 1 or n.device != dev:
            raise ValueError(
                "join_keys_cuda: a table's num_rows must be one int32 on its device, got "
                f"{n.dtype} {tuple(n.shape)} on {n.device}"
            )


def _type(dtype: torch.dtype) -> list:
    """``[kind, shift]``: 0 signed, 1 unsigned, 2 float; ``1 << shift``
    bytes an element (`csrc/keys.cu`'s ``Kind``)."""
    dtypes.signed_of(dtype)  # one of the six table types
    kind = 2 if dtype.is_floating_point else int(dtypes.is_unsigned(dtype))
    return [kind, 3 if dtype.itemsize == 8 else 2]


def _column(t: Table, c: int) -> int:
    """``c`` as a column of ``t`` in 0 .. ncol - 1 (``-1`` is the last),
    where the plain version's ``t.data[:, c]`` raises, its `IndexError`."""
    t.data[:, c]  # a view: nothing runs on the card
    return c % t.ncol


def _predicate(t: Table, pred: Predicate) -> list:
    """The kernel's predicate arguments for one table, ``[column, holds,
    value]``, checked in `dtypes.compare`'s order: the column, the value
    (`dtypes.order_value` for an unsigned type; torch's conversion, made
    on the host, for the others, a float's as a double's bits), the
    operator."""
    col = _column(t, pred.col)
    if dtypes.is_unsigned(t.dtype):
        value = dtypes.order_value(pred.value, t.dtype)
    else:
        value = torch.tensor(pred.value, dtype=t.dtype).item()
        if t.dtype.is_floating_point:
            (value,) = struct.unpack("<q", struct.pack("<d", value))
    return [col, _HOLDS[pred.op], value]


def _buffer(t: Table) -> list:
    d = t.data
    return [d.data_ptr(), d.shape[0], d.shape[1], d.stride(0), d.stride(1), t.num_rows.data_ptr(),
            *_type(d.dtype), int(d.is_contiguous())]


def join_keys_cuda(t1: Table, t2: Table, pred1: Predicate, pred2: Predicate, key1: int,
                   key2: int, narrow: bool) -> torch.Tensor:
    """`join_keys` from one launch, on two tables of one CUDA device and of
    any two table types; any 2D view of either table is read by its
    strides."""
    _checked_tables(t1, t2)
    p1, p2 = _predicate(t1, pred1), _predicate(t2, pred2)
    k1, k2 = _column(t1, key1), _column(t2, key2)
    dtype = dtypes.promote(t1.dtype, t2.dtype)
    narrowed = narrow is True and dtype in _NARROWED
    n = t1.capacity + t2.capacity
    out_dtype = torch.int32 if narrowed or dtype.itemsize == 4 else torch.int64
    out = torch.empty(n, dtype=out_dtype, device=t1.device)
    if n == 0:
        return out
    err = build.entry("smj_join_keys")(
        *_buffer(t1), k1, *p1, dtypes.sentinel_bits(t1.dtype),
        *_buffer(t2), k2, *p2, dtypes.sentinel_bits(t2.dtype),
        *_type(dtype), int(narrowed), out.data_ptr(), build.stream_ptr(out),
    )
    build.check(err, "join_keys")
    build.launched("join_keys")
    return out
