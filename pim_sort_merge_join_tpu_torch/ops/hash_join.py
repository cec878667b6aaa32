"""Hash join and hash aggregate (PyTorch port of `ops/hash_join.py`).

The JAX package realizes "hash" semantics as bijective-hash ordering: a
finalizer-style mix is a permutation of the key space, so equal hashes are
equal keys, and both sides are ordered by hash instead of probed through a
table. The port keeps that dataflow and its results exactly:

- `mix32`/`mix64` are the murmur3 and splitmix64 finalizers. Torch has no
  usable uint64, so they run in the key's own signed width: multiplies wrap,
  the constants are their two's-complement values, and a logical right
  shift is an arithmetic one with the sign-filled bits masked off. The bits
  equal the reference's uint32/uint64 results.
- `hash_column` returns the hash with its sign bit flipped. Its signed order
  is the hash's unsigned order, and the unsigned maximum (the reference's
  padding sentinel) becomes the signed maximum, `key_sentinel`. So the
  port's sorts, join scan and sentinels take hashes as they take keys, and
  every hash path runs on the kernels the sort-merge paths run.
- `hash_join` (1:1 and inner) and `hash_aggregate` follow the reference
  step for step; output rows are in table-1 row order (1:1, inner) or key
  order (aggregate), as there.
- Keys of every table type: unsigned keys hash their bits, float keys the
  bits of `_float_order_bits` (the reference's order map, -0.0 as +0.0),
  bit for bit as the reference hashes them.
- `hash_aggregate` on floats sums each group with `torch.segment_reduce`:
  on CPU tensors in row order, as the reference's scatter adds on the CPU;
  on the card in the library's own fixed order, so every run gives the
  same bits (where `index_add_` adds in whatever order its atomics land),
  within the rounding of an n-term sum of the row-order result. Minima
  and maxima are taken on order keys where torch has no ordering for the
  type (uint32/uint64).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pim_sort_merge_join_tpu_torch.columnar import dtypes
from pim_sort_merge_join_tpu_torch.columnar.table import Table, key_sentinel
from pim_sort_merge_join_tpu_torch.ops import join as join_ops
from pim_sort_merge_join_tpu_torch.ops.sort import (
    stable_key_sort_rows,
    stable_key_sort_rows_with_key,
)


def _signed(c: int, bits: int) -> int:
    """The two's-complement value of the unsigned ``bits``-wide constant ``c``."""
    return c - (1 << bits) if c >> (bits - 1) else c


_M32_1 = _signed(0x85EBCA6B, 32)
_M32_2 = _signed(0xC2B2AE35, 32)
_M64_1 = _signed(0xBF58476D1CE4E5B9, 64)
_M64_2 = _signed(0x94D049BB133111EB, 64)

# The keys whose hash is the all-ones word, the padding sentinel.
SENTINEL_PREIMAGE32 = 0x331DA083
SENTINEL_PREIMAGE64 = _signed(0xCF9A04AFFA6BADC0, 64)


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of the bits of a signed integer tensor."""
    width = 8 * x.element_size()
    return (x >> k) & ((1 << (width - k)) - 1)


def mix32(x: torch.Tensor) -> torch.Tensor:
    """Murmur3 finalizer on the bits of an int32 tensor (a bijection); the
    result's bits equal the reference's uint32 `mix32`."""
    if x.dtype != torch.int32:
        raise ValueError(f"mix32 takes int32 bits, got {x.dtype}")
    x = x ^ _shr(x, 16)
    x = x * _M32_1
    x = x ^ _shr(x, 13)
    x = x * _M32_2
    return x ^ _shr(x, 16)


def mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer on the bits of an int64 tensor (a bijection);
    the result's bits equal the reference's uint64 `mix64`."""
    if x.dtype != torch.int64:
        raise ValueError(f"mix64 takes int64 bits, got {x.dtype}")
    x = x ^ _shr(x, 30)
    x = x * _M64_1
    x = x ^ _shr(x, 27)
    x = x * _M64_2
    return x ^ _shr(x, 31)


def _float_order_bits(keys: torch.Tensor) -> torch.Tensor:
    """The reference's order-preserving bijection float -> unsigned int of
    the same width, as the bits of a signed int: the IEEE bits with every
    bit flipped for negative values and the sign bit set for the others,
    -0.0 taken as +0.0 first so that both zeros hash equal."""
    keys = torch.where(keys == 0, torch.zeros_like(keys), keys)
    b = dtypes.bits(keys)
    return torch.where(b < 0, ~b, b | torch.iinfo(b.dtype).min)


def hash_column(keys: torch.Tensor) -> torch.Tensor:
    """Bijective hash of a key column of any table type, as the signed
    integer of its width, ordered as signed values: the reference's
    unsigned hash ``h`` is ``hash_column(keys) ^ sign bit`` read as
    unsigned. Unsigned keys hash their bits, floats `_float_order_bits`."""
    b = _float_order_bits(keys) if keys.dtype.is_floating_point else dtypes.bits(keys)
    if b.dtype == torch.int32:
        return mix32(b) ^ torch.iinfo(torch.int32).min
    return mix64(b) ^ torch.iinfo(torch.int64).min


def _hashed_keys(table: Table, key: int) -> torch.Tensor:
    """Hashed keys with padding forced to the sentinel (the hash's maximum).

    A valid key that hashes to the maximum is padding as well, in both
    packages. One key per width does: `SENTINEL_PREIMAGE32` and
    `SENTINEL_PREIMAGE64` (the reference's docstring names 0x40ebfa9c, whose
    32-bit hash is 0xf127db48).
    """
    h = hash_column(table.column(key))
    return torch.where(table.valid_mask(), h, key_sentinel(h.dtype))


def _names(ncol: int) -> tuple:
    return tuple(f"col{i + 1}" for i in range(ncol))


def hash_join(
    t1: Table,
    t2: Table,
    key1: int,
    key2: int,
    *,
    mode: str = "one_to_one",
    out_capacity: int | None = None,
) -> Table:
    """Join on hashed-key ordering; output in table-1 row order.

    ``one_to_one`` pairs the k-th duplicate of a key in table-1 row order
    with the k-th in table-2 row order, output capacity table 1's. ``inner``
    is the cross product on duplicate keys; ``out_capacity`` bounds it (the
    true count stays in ``num_rows``).
    """
    cap1 = t1.capacity
    dev = t1.device

    if mode == "one_to_one":
        # The hashed key vectors feed the sort-merge join's core, which
        # needs no sorted input and pairs duplicates in row order on each
        # side; it emits in hash order, with each table-1 row's index in a
        # hidden column of the table's type, and one restore sort puts the
        # rows back in table-1 row order. A float type must hold every
        # row index exactly, or the restore sort scrambles the rows.
        if t1.dtype.is_floating_point:
            mant = np.finfo(dtypes.numpy_dtype(t1.dtype)).nmant + 1
            if cap1 > (1 << mant):
                raise ValueError(
                    f"hash_join one_to_one: capacity {cap1} exceeds the "
                    f"exact-integer range 2**{mant} of table dtype "
                    f"{dtypes.numpy_dtype(t1.dtype).name}; use a wider dtype or "
                    "join_algorithm='sort_merge'"
                )
        h1 = _hashed_keys(t1, key1)
        h2 = _hashed_keys(t2, key2)
        iota1 = torch.arange(cap1, dtype=torch.int32, device=dev)
        ords = iota1.to(t1.dtype if t1.dtype.is_floating_point else dtypes.signed_of(t1.dtype))
        aug = torch.cat([dtypes.bits(t1.data), dtypes.bits(ords)[:, None]], dim=1)
        t1aug = dataclasses.replace(t1, data=dtypes.from_bits(aug, t1.dtype))
        joined = join_ops._one_to_one_merged(t1aug, t2, key2, torch.cat([h1, h2]))
        # joined columns: t1's, the row index (at t1.ncol), t2's without its key.
        ordc = t1.ncol
        num_out = joined.num_rows
        # Matched rows carry distinct row indices; the others get unique
        # keys past them, and their rows are written as zeros.
        j = torch.arange(joined.capacity, dtype=torch.int32, device=dev)
        ords = joined.data[:, ordc]
        ords = ords.to(torch.int32) if ords.dtype.is_floating_point else dtypes.bits(ords).to(torch.int32)
        restore = torch.where(j < num_out, ords, cap1 + j)
        keep = [c for c in range(joined.ncol) if c != ordc]
        data = stable_key_sort_rows([(restore, joined.data, keep)], live=num_out)
        return Table(data=data, num_rows=num_out, names=_names(len(keep)))

    if mode == "inner":
        # Both sides stably sorted by hash (row order kept within a hash),
        # the merged-domain match info, then each table-1 row's matches in
        # table-1 row order.
        h1 = _hashed_keys(t1, key1)
        h2 = _hashed_keys(t2, key2)
        sh1, ord1, rows1 = stable_key_sort_rows_with_key(h1, t1.data)
        sh2, _, rows2 = stable_key_sort_rows_with_key(h2, t2.data)
        s1 = dataclasses.replace(t1, data=rows1)
        s2 = dataclasses.replace(t2, data=rows2)
        info = join_ops._match_info_keys(sh1, sh2)
        out_cap = cap1 if out_capacity is None else out_capacity
        cnt = torch.where(s1.valid_mask(), info.cnt2, 0)
        # inv1[row] = the row's place in hash order.
        io1 = torch.arange(cap1, dtype=torch.int32, device=dev)
        inv1 = torch.empty_like(io1).index_copy_(0, ord1.long(), io1)
        cnt_orig = cnt[inv1.long()]
        starts = torch.cumsum(cnt_orig, 0, dtype=torch.int32) - cnt_orig
        total = cnt_orig.sum(dtype=torch.int32)
        row_orig, offset = join_ops._slot_owners(cnt_orig, starts, out_cap)
        pos_hash = inv1[row_orig.long()]
        src2 = info.lo2[pos_hash.long()] + offset
        return join_ops._emit(s1, s2, key2, pos_hash, src2, total)
    raise ValueError(f"unknown join mode {mode!r}")


_AGGS = ("sum", "count", "min", "max")


def hash_aggregate(table: Table, key: int, value: int, agg: str = "sum") -> Table:
    """Group rows by key column; aggregate the value column.

    Returns a 2-column table (key, aggregate) sorted ascending by key, one
    row per distinct key, zeros past ``num_rows``.

    A group's key is its last row's (the reference's scatter writes every
    row's key, and on the CPU the last one stays; -0.0 and +0.0 are one
    group). Float sums, minima and maxima go group by group through
    `torch.segment_reduce`, in the same order on every run (row order on
    CPU tensors). Groups are emitted in key order with
    the unused slots after every group; the reference gives those slots
    the type's largest finite value as key, so its groups of +inf and NaN
    keys sort behind them and fall off the table; here the unused slots
    take the order sentinel and those groups stay.
    """
    if agg not in _AGGS:
        raise ValueError(f"agg must be one of {_AGGS}, got {agg!r}")
    cap = table.capacity
    dtype = table.dtype
    dev = table.device
    # Group in hash order, emit in key order.
    h = _hashed_keys(table, key)
    sh, _, kv = stable_key_sort_rows_with_key(h, table.data, [key, value])
    sk, sv = dtypes.bits(kv[:, 0]), kv[:, 1]
    # The reference carries the validity flag through its sort. Padding has
    # the sentinel hash, which sorts last, and within equal hashes the sort
    # keeps row order, so the valid rows are exactly the first num_rows.
    iota = torch.arange(cap, dtype=torch.int32, device=dev)
    valid = iota < table.num_rows
    one = torch.ones(1, dtype=torch.bool, device=dev)
    head = valid & torch.cat([one, sh[1:] != sh[:-1]])
    num_groups = head.sum(dtype=torch.int32)
    # Group id per row; padding goes to a spare last slot that is cut off
    # (the reference's scatter mode="drop"). Integer adds, minima and maxima
    # are exact in any order.
    gid = torch.where(valid, torch.cumsum(head, 0, dtype=torch.int32) - 1, cap).long()
    if dtype.is_floating_point:
        out_v = _float_aggregate(sv, gid, cap, agg)
    elif agg in ("sum", "count"):
        vals = dtypes.bits(sv) if agg == "sum" else torch.ones_like(dtypes.bits(sv))
        out_v = torch.zeros(cap + 1, dtype=vals.dtype, device=dev).index_add_(0, gid, vals)
        out_v = dtypes.from_bits(out_v[:cap], dtype)
    else:
        # Minima and maxima of order keys, which order every integer type.
        okey = dtypes.order_key(sv)
        info = torch.iinfo(okey.dtype)
        out_v = torch.full((cap + 1,), info.max if agg == "min" else info.min,
                           dtype=okey.dtype, device=dev).scatter_reduce_(
            0, gid, okey, "amin" if agg == "min" else "amax", include_self=True
        )
        out_v = dtypes.from_order_key(out_v[:cap], dtype)
    # A group's key is its last row's: one writer per slot.
    tail = valid & torch.cat([head[1:] | ~valid[1:], one])
    out_k = torch.zeros(cap + 1, dtype=sk.dtype, device=dev).index_copy_(
        0, torch.where(tail, gid, cap), sk
    )[:cap]
    sort_keys = torch.where(
        iota < num_groups, dtypes.order_key(dtypes.from_bits(out_k, dtype)), dtypes.order_max(dtype)
    )
    rows = torch.stack([out_k, dtypes.bits(out_v)], dim=1)
    data = stable_key_sort_rows([(sort_keys, rows)], live=num_groups)
    return Table(data=dtypes.from_bits(data, dtype), num_rows=num_groups, names=("key", agg))


def _float_aggregate(sv: torch.Tensor, gid: torch.Tensor, cap: int, agg: str) -> torch.Tensor:
    """A float aggregate of each group's values, ``[cap]``: groups are
    contiguous in ``sv`` (valid rows first, ``gid`` the group of each, `cap`
    for padding). Counts are added as ones (exact in any order); sums,
    minima and maxima go group by group through `torch.segment_reduce`
    from the reference's initial value (0, the type's largest and smallest
    finite value), so every run gives the same bits."""
    dev = sv.device
    lengths = torch.zeros(cap + 1, dtype=torch.int64, device=dev).index_add_(
        0, gid, torch.ones_like(gid)
    )[:cap]
    if agg == "count":
        return lengths.to(sv.dtype)
    info = torch.finfo(sv.dtype)
    initial = {"sum": 0.0, "min": info.max, "max": info.min}[agg]
    return torch.segment_reduce(sv, agg, lengths=lengths, unsafe=True, initial=initial)
