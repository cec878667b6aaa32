"""Sort operators (port of `ops/sort.py`): table sorts and the join's sort seam.

`sort_by_key` orders a table by its key column for the staged path;
`stable_key_sort` is the seam of the join's internal sorts and
`stable_key_sort_rows` its form for a payload that is a table's rows. On
CUDA tensors they run the hand-written kernels (`ops/kernels/`), on CPU
tensors the kernels' plain torch versions. Padding rows carry the key
sentinel, so they sort to the tail and stay invalid.
"""

from __future__ import annotations

import dataclasses

import torch

from pim_sort_merge_join_tpu_torch.columnar.table import Table
from pim_sort_merge_join_tpu_torch.ops.kernels.bitonic_sort import sort_pairs
from pim_sort_merge_join_tpu_torch.ops.kernels.gather import gather_rows
from pim_sort_merge_join_tpu_torch.ops.kernels.hbm_sort import (
    hbm_sort,
    hbm_sort_rows,
    sort_key_permutation,
)

_ALGORITHMS = ("auto", "xla", "hbm_pallas", "hbm_adaptive", "pallas_bitonic")


def sort_by_key(
    table: Table, key: int, *, algorithm: str = "auto", narrow: bool = False
) -> Table:
    """Sort valid rows ascending by column ``key``; stable on ties.

    "pallas_bitonic" runs the bitonic kernel (`ops/kernels/bitonic_sort`)
    on int32 ``(key, row index)`` pairs and gathers the rows by the result;
    every other algorithm runs `hbm_sort_rows`: the key through the sort
    kernels, the table's rows through one row gather.

    ``narrow`` (resolved by the pipeline): sort 64-bit keys as int32; every
    valid key must fit int32. Without it, "pallas_bitonic" clips 64-bit
    keys to the int32 range, as the reference does (`ops/sort.py`), so
    keys outside that range sort on their clipped values.
    """
    if algorithm not in _ALGORITHMS:
        raise ValueError(f"unknown sort algorithm {algorithm!r}")
    keys = table.masked_keys(key)
    if narrow is True and keys.dtype == torch.int64:
        from pim_sort_merge_join_tpu_torch.ops.join import _narrow32

        keys = _narrow32(keys)
    if algorithm != "pallas_bitonic":
        return dataclasses.replace(table, data=hbm_sort_rows([(keys, table.data.contiguous())]))
    if keys.dtype != torch.int32:
        info = torch.iinfo(torch.int32)
        keys = torch.where(
            table.valid_mask(), keys.clamp(info.min, info.max), info.max
        ).to(torch.int32)
    iota = torch.arange(table.capacity, dtype=torch.int32, device=table.device)
    _, order = sort_pairs(keys, iota)
    return dataclasses.replace(table, data=gather_rows([(table.data.contiguous(), order)]))


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
    is_stable=True)``. The port has one backend per device, so
    ``algorithm`` is accepted for the reference's signature and does not
    select anything ("pallas_bitonic" has no multi-operand form and means
    "auto" here, as in the reference): CUDA tensors run the `hbm_sort`
    kernels at every size, CPU tensors its plain torch version. Both are
    always stable, which is a legal refinement of ``stable=False``.

    ``unique_keys`` promises that no two elements tie on the keys. It is
    used in one case: one int32 key with one int32 payload then sorts as
    two keys, which is the same order where no key repeats, and the kernels
    carry that pair in one 64-bit element and need no gather.
    """
    if algorithm not in _ALGORITHMS:
        raise ValueError(f"unknown sort algorithm {algorithm!r}")
    if (
        unique_keys
        and num_keys == 1
        and len(operands) == 2
        and all(o.dtype == torch.int32 for o in operands)
    ):
        num_keys = 2
    return hbm_sort(operands, num_keys=num_keys)


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
    from ``live`` on are zeros (`ops/kernels/gather.gather_rows`).
    ``algorithm`` as in `stable_key_sort`.
    """
    if algorithm not in _ALGORITHMS:
        raise ValueError(f"unknown sort algorithm {algorithm!r}")
    return hbm_sort_rows(parts, out=out, live=live)


def stable_key_sort_rows_with_key(key: torch.Tensor, rows: torch.Tensor, cols=None):
    """`stable_key_sort_rows` of one table that also returns the sorted key
    and the sorting permutation: ``(sorted key, permutation int32, rows)``,
    the rows' columns ``cols`` (all if None) in the key's stable order."""
    skey, perm = sort_key_permutation(key)
    return skey, perm, gather_rows([(rows, perm, cols)])


def sorted_keys(table: Table, key: int) -> torch.Tensor:
    """Key column of an already-sorted table, with the sentinel padding tail."""
    return table.masked_keys(key)
