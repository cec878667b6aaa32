"""Sort operators (port of `ops/sort.py`): table sorts and the join's sort seam.

`sort_by_key` orders a table by its key column for the staged path;
`stable_key_sort` is the seam of the join's internal sorts. On CUDA
tensors they run the hand-written kernels (`ops/kernels/`), on CPU tensors
the kernels' plain torch versions. Padding rows carry the key sentinel, so
they sort to the tail and stay invalid.
"""

from __future__ import annotations

import dataclasses

import torch

from pim_sort_merge_join_tpu_torch.columnar.table import Table
from pim_sort_merge_join_tpu_torch.ops.kernels.bitonic_sort import sort_pairs
from pim_sort_merge_join_tpu_torch.ops.kernels.hbm_sort import hbm_sort

_ALGORITHMS = ("auto", "xla", "hbm_pallas", "hbm_adaptive", "pallas_bitonic")


def sort_by_key(
    table: Table, key: int, *, algorithm: str = "auto", narrow: bool = False
) -> Table:
    """Sort valid rows ascending by column ``key``; stable on ties.

    "pallas_bitonic" runs the bitonic kernel (`ops/kernels/bitonic_sort`)
    on int32 ``(key, row index)`` pairs and gathers the rows by the result;
    every other algorithm runs `hbm_sort` over the key and the columns.

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
        cols = tuple(table.data[:, c].contiguous() for c in range(table.ncol))
        sorted_ops = hbm_sort((keys,) + cols)
        return dataclasses.replace(table, data=torch.stack(sorted_ops[1:], dim=1))
    if keys.dtype != torch.int32:
        info = torch.iinfo(torch.int32)
        keys = torch.where(
            table.valid_mask(), keys.clamp(info.min, info.max), info.max
        ).to(torch.int32)
    iota = torch.arange(table.capacity, dtype=torch.int32, device=table.device)
    _, order = sort_pairs(keys, iota)
    data = table.data.index_select(0, order)
    return dataclasses.replace(table, data=data)


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
    always stable, which is a legal refinement of ``stable=False`` and makes
    ``unique_keys`` a promise the result does not depend on.
    """
    if algorithm not in _ALGORITHMS:
        raise ValueError(f"unknown sort algorithm {algorithm!r}")
    return hbm_sort(operands, num_keys=num_keys)


def sorted_keys(table: Table, key: int) -> torch.Tensor:
    """Key column of an already-sorted table, with the sentinel padding tail."""
    return table.masked_keys(key)
