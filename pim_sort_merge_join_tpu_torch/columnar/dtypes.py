"""The element types of the port's tables, and the order keys its kernels sort.

The JAX package takes int32, int64, uint32, uint64, float32 and float64
tables (the reference's ``T`` modes, `common.h:1-9`, and the narrow int32).
The port's kernels compare signed int32/int64 keys only (`csrc/hbm_sort.cu`,
`csrc/join_scan.cu`), and torch has almost no operators for uint32/uint64
(ordering comparisons, `min`, `max` and `index_copy_` raise for them). So:

- every comparison and sort of a column goes through `order_key`, which maps
  it to the signed integer of the same width whose order is the type's
  order: signed integers are themselves; unsigned ones have their sign bit
  flipped (``x - 2^(w-1)`` as a value); floats take the total-order map of
  the JAX package's `_float_order_bits` in signed form (negative values with
  every bit but the sign flipped), with three rules the JAX package's sorts
  and joins imply: -0.0 is +0.0 (``lax.sort`` ties them, ``==`` matches
  them), and +inf and NaN are the int sentinel, ``ORDER_MAX`` (the join scan
  takes an element as live where its key is not the sentinel; in the JAX
  package a +inf key equals the padding sentinel and a NaN key never
  matches, so both are dead there too);
- a table's data stays in its own type, and everything that only moves it
  (the row and column gathers) moves its bits, a same-width integer `view`
  (`bits`), which costs nothing. So -0.0 stays -0.0 in a result.
"""

from __future__ import annotations

import numpy as np
import torch

# numpy dtype name -> torch dtype: every type of the JAX package's tables.
TORCH_DTYPES = {
    "int32": torch.int32,
    "int64": torch.int64,
    "uint32": torch.uint32,
    "uint64": torch.uint64,
    "float32": torch.float32,
    "float64": torch.float64,
}
NUMPY_DTYPES = {t: np.dtype(name) for name, t in TORCH_DTYPES.items()}
# The signed integer of each type's width: its bits and its order keys.
_SIGNED = {
    torch.int32: torch.int32,
    torch.int64: torch.int64,
    torch.uint32: torch.int32,
    torch.uint64: torch.int64,
    torch.float32: torch.int32,
    torch.float64: torch.int64,
}


def as_torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or a type name."""
    if isinstance(dtype, torch.dtype):
        if dtype not in _SIGNED:
            raise ValueError(f"unsupported table dtype {dtype}")
        return dtype
    name = np.dtype(dtype).name
    if name not in TORCH_DTYPES:
        raise ValueError(f"unsupported table dtype {name!r}; one of {sorted(TORCH_DTYPES)}")
    return TORCH_DTYPES[name]


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return NUMPY_DTYPES[dtype]


def signed_of(dtype: torch.dtype) -> torch.dtype:
    """The signed integer type of ``dtype``'s width (its bits, its order keys)."""
    return _SIGNED[dtype]


def is_unsigned(dtype: torch.dtype) -> bool:
    return dtype in (torch.uint32, torch.uint64)


def bits(x: torch.Tensor) -> torch.Tensor:
    """``x``'s bits as the signed integer of its width: the same tensor for
    int32/int64, a free `view` otherwise."""
    s = _SIGNED[x.dtype]
    return x if s == x.dtype else x.view(s)


def from_bits(b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The inverse of `bits`."""
    return b if b.dtype == dtype else b.view(dtype)


def order_max(dtype: torch.dtype) -> int:
    """The order keys' sentinel for tables of ``dtype``: the signed maximum."""
    return torch.iinfo(_SIGNED[dtype]).max


def key_sentinel(dtype: torch.dtype):
    """Sentinel of masked-out sort keys in the table's own type, which
    sorts after every real key: +inf for floats, the type's maximum
    otherwise (the JAX package's `columnar/table.key_sentinel`). Its order
    key is `order_max`."""
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


def sentinel_bits(dtype: torch.dtype) -> int:
    """The bits of `key_sentinel`, as a value of `signed_of(dtype)`."""
    np_dtype = NUMPY_DTYPES[dtype]
    raw = np.array(key_sentinel(dtype), dtype=np_dtype)
    return int(raw.view(np.dtype(f"int{8 * np_dtype.itemsize}")))


def order_key(x: torch.Tensor) -> torch.Tensor:
    """The signed integer of ``x``'s width whose order is ``x``'s order.

    int32/int64: ``x`` itself. uint32/uint64: the bits with the sign bit
    flipped. float32/float64: the total-order map (non-negative values keep
    their bits, negative ones flip every bit but the sign), with -0.0 mapped
    as +0.0 and +inf and NaN mapped to `order_max`. So equal order keys are
    equal values, and the sentinel +inf orders with the int sentinel.
    """
    s = _SIGNED[x.dtype]
    if s == x.dtype:
        return x
    b = x.view(s)
    info = torch.iinfo(s)
    if is_unsigned(x.dtype):
        return b ^ info.min
    k = torch.where(b < 0, b ^ info.max, b)
    k = torch.where(x == 0, 0, k)
    return torch.where(x < float("inf"), k, info.max)  # +inf and NaN


def from_order_key(k: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The value of ``dtype`` whose `order_key` is ``k``: exact for the
    integer types; for floats `order_max` comes back as +inf (so NaN comes
    back as +inf) and a zero as +0.0."""
    if k.dtype == dtype:
        return k
    info = torch.iinfo(k.dtype)
    if is_unsigned(dtype):
        return (k ^ info.min).view(dtype)
    b = torch.where(k < 0, k ^ info.max, k)
    b = torch.where(k == info.max, sentinel_bits(dtype), b)
    return b.view(dtype)


def order_value(value, dtype: torch.dtype) -> int:
    """`order_key` of one Python number taken as ``dtype``, as a Python int;
    raises `OverflowError` where the type cannot hold an integer value."""
    np_dtype = NUMPY_DTYPES[dtype]
    if np.issubdtype(np_dtype, np.integer):
        info = np.iinfo(np_dtype)
        if not info.min <= int(value) <= info.max:
            raise OverflowError(f"{value} does not fit {np_dtype}")
    scalar = torch.from_numpy(np.array([value], dtype=np_dtype))
    return int(order_key(scalar)[0])


# A predicate's comparison by its operator.
_COMPARE = {
    ">": torch.gt,
    ">=": torch.ge,
    "<": torch.lt,
    "<=": torch.le,
    "==": torch.eq,
    "!=": torch.ne,
}


def compare(x: torch.Tensor, op: str, value) -> torch.Tensor:
    """``x <op> value`` elementwise, a bool tensor. Signed integers and
    floats compare as torch compares them (a NaN fails every operator but
    ``!=``); unsigned ones compare through their order keys, since torch
    has no ordering comparison for them, so a value above the int64 range
    (a uint64 one) is exact there. ``value`` is converted to ``x``'s type
    first, and raises where it does not fit."""
    if is_unsigned(x.dtype):
        x, value = order_key(x), order_value(value, x.dtype)
    else:
        value = torch.tensor(value, dtype=x.dtype, device=x.device)
    return _COMPARE[op](x, value)


def narrow32(keys: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Order keys of an 8-byte integer ``dtype`` whose values fit int32 as
    int32, the sentinel as the int32 sentinel (the JAX package's
    `ops/join._narrow32`, which casts the values)."""
    sent32 = torch.iinfo(torch.int32).max
    values = keys ^ torch.iinfo(torch.int64).min if dtype == torch.uint64 else keys
    return torch.where(keys == order_max(dtype), sent32, values).to(torch.int32)


def promote(a: torch.dtype, b: torch.dtype) -> torch.dtype:
    """The type of a concatenation of ``a`` and ``b`` in the JAX package
    (``jnp.promote_types`` with 64-bit types on): a signed and an unsigned
    integer give the next signed width that holds both, and float64 where
    none does (int64 with uint64); an integer and a float give the float."""
    if a == b:
        return a
    fa, fb = a.is_floating_point, b.is_floating_point
    if fa or fb:
        if fa and fb:
            return torch.float64
        return a if fa else b
    ua, ub = is_unsigned(a), is_unsigned(b)
    wa, wb = torch.iinfo(a).bits, torch.iinfo(b).bits
    if ua == ub:
        return a if wa >= wb else b
    signed_w, unsigned_w = (wb, wa) if ua else (wa, wb)
    if signed_w > unsigned_w:
        return a if ua is False else b
    if unsigned_w == 32:
        return torch.int64
    return torch.float64
