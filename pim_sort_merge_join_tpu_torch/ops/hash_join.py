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

Float keys wait for the port's float tables (ROADMAP, "Float keys and
general num_keys=2 on CUDA"); `hash_column` refuses them.
"""

from __future__ import annotations

import dataclasses

import torch

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


def hash_column(keys: torch.Tensor) -> torch.Tensor:
    """Bijective hash of an int32/int64 key column, in the same dtype,
    ordered as signed values: the reference's unsigned hash ``h`` is
    ``hash_column(keys) ^ sign bit`` read as unsigned."""
    if keys.dtype.is_floating_point:
        raise NotImplementedError(
            "hash_column: float keys are not ported yet (ROADMAP, \"Float keys and "
            "general num_keys=2 on CUDA\")"
        )
    if keys.dtype == torch.int32:
        return mix32(keys) ^ torch.iinfo(torch.int32).min
    if keys.dtype == torch.int64:
        return mix64(keys) ^ torch.iinfo(torch.int64).min
    raise ValueError(f"hash_column: int32/int64 keys, got {keys.dtype}")


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
        # hidden column, and one restore sort puts the rows back in table-1
        # row order. The reference checks that a float table's type holds
        # the row index exactly; the port's tables are integer, where it
        # always does.
        h1 = _hashed_keys(t1, key1)
        h2 = _hashed_keys(t2, key2)
        iota1 = torch.arange(cap1, dtype=torch.int32, device=dev)
        t1aug = dataclasses.replace(
            t1, data=torch.cat([t1.data, iota1.to(t1.dtype)[:, None]], dim=1)
        )
        joined = join_ops._one_to_one_merged(t1aug, t2, key2, h1, h2)
        # joined columns: t1's, the row index (at t1.ncol), t2's without its key.
        ordc = t1.ncol
        num_out = joined.num_rows
        # Matched rows carry distinct row indices; the others get unique
        # keys past them, and their rows are written as zeros.
        j = torch.arange(joined.capacity, dtype=torch.int32, device=dev)
        restore = torch.where(j < num_out, joined.data[:, ordc].to(torch.int32), cap1 + j)
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
    """
    if agg not in _AGGS:
        raise ValueError(f"agg must be one of {_AGGS}, got {agg!r}")
    cap = table.capacity
    dtype = table.dtype
    dev = table.device
    # Group in hash order, emit in key order.
    h = _hashed_keys(table, key)
    sh, _, kv = stable_key_sort_rows_with_key(h, table.data, [key, value])
    sk, sv = kv[:, 0], kv[:, 1]
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
    lo, hi = torch.iinfo(dtype).min, torch.iinfo(dtype).max
    buf = torch.zeros(cap + 1, dtype=dtype, device=dev)
    if agg == "sum":
        out_v = buf.index_add_(0, gid, sv)
    elif agg == "count":
        out_v = buf.index_add_(0, gid, torch.ones_like(sv))
    else:
        out_v = buf.fill_(hi if agg == "min" else lo).scatter_reduce_(
            0, gid, sv, "amin" if agg == "min" else "amax", include_self=True
        )
    # Every row of a group has the group's key, so any writer gives it.
    out_k = torch.zeros(cap + 1, dtype=dtype, device=dev).index_copy_(0, gid, sk)
    out_k, out_v = out_k[:cap], out_v[:cap]
    sort_keys = torch.where(iota < num_groups, out_k, hi)
    data = stable_key_sort_rows(
        [(sort_keys, torch.stack([out_k, out_v], dim=1))], live=num_groups
    )
    return Table(data=data, num_rows=num_groups, names=("key", agg))
