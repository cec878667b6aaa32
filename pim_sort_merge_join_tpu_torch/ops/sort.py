"""Sort operators (port of `ops/sort.py`): table sorts and the join's sort seam.

`sort_by_key` orders a table by its key column for the staged path;
`stable_key_sort` is the seam of the join's internal sorts and
`stable_key_sort_rows` its form for a payload that is a table's rows. On
CUDA tensors they run the hand-written kernels (`ops/kernels/`), on CPU
tensors the kernels' plain torch versions. Padding rows carry the key
sentinel, so they sort to the tail and stay invalid.

Keys of every table type reach the kernels as their order keys
(`columnar/dtypes.order_key`); payloads and rows move as their bits, so
they come back bit for bit. Sorted keys come back in their own type.
Where keys tie on their order key they keep their order: -0.0 with +0.0,
and NaN with +inf and the padding (the JAX package puts NaN after +inf).
"""

from __future__ import annotations

import dataclasses

import torch

from pim_sort_merge_join_tpu_torch.columnar import dtypes
from pim_sort_merge_join_tpu_torch.columnar.table import Table
from pim_sort_merge_join_tpu_torch.ops.kernels.bitonic_sort import sort_pairs
from pim_sort_merge_join_tpu_torch.ops.kernels.gather import gather_rows
from pim_sort_merge_join_tpu_torch.ops.kernels.hbm_sort import (
    gather,
    hbm_sort,
    hbm_sort_rows,
    sort_key_permutation,
    sort_permutation,
)

_ALGORITHMS = ("auto", "xla", "hbm_pallas", "hbm_adaptive", "pallas_bitonic")


def _bitonic_keys(table: Table, key: int) -> torch.Tensor:
    """The int32 keys the bitonic sort takes, as the reference makes them
    (`ops/sort.py:115-120`): a wider key clipped to the int32 range by
    value, then cast (floats toward zero, NaN to 0), padding the int32
    sentinel."""
    info = torch.iinfo(torch.int32)
    col = table.column(key)
    if table.dtype == torch.int32:
        vals = col
    elif table.dtype.is_floating_point:
        vals = torch.nan_to_num(col.double(), nan=0.0).clamp(info.min, info.max).to(torch.int32)
    elif table.dtype == torch.uint32:
        vals = (dtypes.bits(col).long() & 0xFFFFFFFF).clamp(max=info.max).to(torch.int32)
    elif table.dtype == torch.uint64:
        b = dtypes.bits(col)
        vals = torch.where(b < 0, info.max, b.clamp(max=info.max)).to(torch.int32)
    else:
        vals = col.clamp(info.min, info.max).to(torch.int32)
    return torch.where(table.valid_mask(), vals, info.max)


def sort_by_key(
    table: Table, key: int, *, algorithm: str = "auto", narrow: bool = False
) -> Table:
    """Sort valid rows ascending by column ``key``; stable on ties.

    "pallas_bitonic" runs the bitonic kernel (`ops/kernels/bitonic_sort`)
    on int32 ``(key, row index)`` pairs and gathers the rows by the result;
    every other algorithm runs `hbm_sort_rows`: the key's order key through
    the sort kernels, the table's rows through one row gather.

    ``narrow`` (resolved by the pipeline): sort 8-byte integer keys as
    int32; every valid key must fit int32. Without it, "pallas_bitonic"
    clips keys wider than int32 to the int32 range, as the reference does
    (`ops/sort.py`), so keys outside that range sort on their clipped
    values (and float keys on their integer part).
    """
    if algorithm not in _ALGORITHMS:
        raise ValueError(f"unknown sort algorithm {algorithm!r}")
    rows = dtypes.bits(table.data).contiguous()
    if algorithm != "pallas_bitonic":
        keys = table.order_keys(key)
        if narrow is True and table.dtype in (torch.int64, torch.uint64):
            keys = dtypes.narrow32(keys, table.dtype)
        data = hbm_sort_rows([(keys, rows)])
    else:
        iota = torch.arange(table.capacity, dtype=torch.int32, device=table.device)
        _, order = sort_pairs(_bitonic_keys(table, key), iota)
        data = gather_rows([(rows, order)])
    return dataclasses.replace(table, data=dtypes.from_bits(data, table.dtype))


def stable_key_sort(
    operands: tuple[torch.Tensor, ...],
    *,
    algorithm: str = "auto",
    stable: bool = True,
    num_keys: int = 1,
    unique_keys: bool = False,
) -> tuple[torch.Tensor, ...]:
    """Stable multi-operand sort by ``operands[:num_keys]``.

    Semantics equal ``jax.lax.sort(operands, num_keys=num_keys,
    is_stable=True)`` on the keys' order keys (`columnar/dtypes`). The port
    has one backend per device, so ``algorithm`` is accepted for the
    reference's signature and does not select anything ("pallas_bitonic"
    has no multi-operand form and means "auto" here, as in the reference):
    CUDA tensors run the `hbm_sort` kernels at every size, CPU tensors its
    plain torch version. Both are always stable, which is a legal
    refinement of ``stable=False``.

    ``unique_keys`` promises that no two elements tie on the keys. It is
    used in one case: one int32 key with one int32 payload then sorts as
    two keys, which is the same order where no key repeats, and the kernels
    carry that pair in one 64-bit element and need no gather.

    Operands of any table type come back in their type and bits; a float
    key's bits ride as one more payload, so -0.0 and NaN come back as
    they went in.
    """
    if algorithm not in _ALGORITHMS:
        raise ValueError(f"unknown sort algorithm {algorithm!r}")
    keys = [dtypes.order_key(o) for o in operands[:num_keys]]
    carried = [dtypes.bits(o) for o in operands[:num_keys] if o.dtype.is_floating_point]
    payloads = [dtypes.bits(o) for o in operands[num_keys:]]
    if (
        unique_keys
        and num_keys == 1
        and not carried
        and len(payloads) == 1
        and keys[0].dtype == torch.int32 == payloads[0].dtype
    ):
        num_keys, keys, payloads = 2, keys + payloads, []
    out = hbm_sort(tuple(keys + carried + payloads), num_keys=num_keys)
    sorted_keys, out = list(out[: len(keys)]), list(out[len(keys):])
    result = []
    for o, k in zip(operands, sorted_keys):
        result.append(dtypes.from_bits(out.pop(0), o.dtype) if o.dtype.is_floating_point
                      else dtypes.from_order_key(k, o.dtype))
    result += [dtypes.from_bits(b, o.dtype) for b, o in zip(out, operands[len(result):])]
    return tuple(result)


def stable_key_sort_rows(
    parts,
    *,
    algorithm: str = "auto",
    out: torch.Tensor | None = None,
    live: torch.Tensor | None = None,
) -> torch.Tensor:
    """`stable_key_sort` of keys whose payloads are tables' rows.

    ``parts`` holds ``(key, rows, cols)`` tuples. For each the result is
    what ``stable_key_sort((key,) + columns)`` gives for the columns
    ``cols`` of ``rows`` (all if None), written as rows into ``out``: the
    first part's window starts at column 0 and the next one's follows it (a
    new tensor as wide as the kept columns by default). Rows
    from ``live`` on are zeros (`ops/kernels/gather.gather_rows`). Keys
    sort by their order keys and rows move as their bits, in the first
    table's type. ``algorithm`` as in `stable_key_sort`.
    """
    if algorithm not in _ALGORITHMS:
        raise ValueError(f"unknown sort algorithm {algorithm!r}")
    dtype = parts[0][1].dtype
    parts = [(dtypes.order_key(k), dtypes.bits(rows), *cols) for k, rows, *cols in parts]
    got = hbm_sort_rows(parts, out=None if out is None else dtypes.bits(out), live=live)
    return dtypes.from_bits(got, dtype)


def stable_key_sort_rows_with_key(key: torch.Tensor, rows: torch.Tensor, cols=None):
    """`stable_key_sort_rows` of one table that also returns the sorted key
    (in its own type) and the sorting permutation: ``(sorted key,
    permutation int32, rows)``, the rows' columns ``cols`` (all if None) in
    the key's stable order."""
    okey = dtypes.order_key(key)
    if key.dtype.is_floating_point:
        # The order key forgets -0.0 and NaN: the key's own bits are taken.
        perm = sort_permutation(okey)
        b = dtypes.bits(key).contiguous()
        skey = dtypes.from_bits(gather(perm, (b,))[0] if b.is_cuda else b[perm.long()], key.dtype)
    else:
        skey, perm = sort_key_permutation(okey)
        skey = dtypes.from_order_key(skey, key.dtype)
    rows_out = gather_rows([(dtypes.bits(rows), perm, cols)])
    return skey, perm, dtypes.from_bits(rows_out, rows.dtype)


def sorted_keys(table: Table, key: int) -> torch.Tensor:
    """Key column of an already-sorted table, with the sentinel padding
    tail, in the table's type."""
    return table.masked_keys(key)
