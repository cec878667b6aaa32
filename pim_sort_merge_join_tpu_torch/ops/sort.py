"""The sort seam of the join's internal sorts (port of `ops/sort.stable_key_sort`).

`sort_by_key` (the staged path's table sort) comes with the staged path,
ROADMAP, "The staged path and sort_by_key".
"""

from __future__ import annotations

import torch

from pim_sort_merge_join_tpu_torch.ops.kernels.hbm_sort import hbm_sort

_ALGORITHMS = ("auto", "xla", "hbm_pallas", "hbm_adaptive", "pallas_bitonic")


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
    select anything: CUDA tensors run the `hbm_sort` kernels at every size,
    CPU tensors its plain torch version. Both are always stable, which is a
    legal refinement of ``stable=False`` and makes ``unique_keys`` a promise
    the result does not depend on.
    """
    if algorithm not in _ALGORITHMS:
        raise ValueError(f"unknown sort algorithm {algorithm!r}")
    return hbm_sort(operands, num_keys=num_keys)
