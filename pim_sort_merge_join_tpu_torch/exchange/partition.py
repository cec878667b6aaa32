"""Key-space partitioning (port of `exchange/partition.py`): splitter
sampling and destination assignment.

Every rank samples its keys; the samples of both tables, pooled from all
ranks, give P-1 range splitters; each row goes to the rank that owns its
key's range (`destination_of`), or to ``mix(key) % P`` (`hash_destination_of`).
Equal keys always get one destination, which the 1:1 join needs.

The functions take order keys (`columnar/dtypes.order_key`, padding as the
order sentinel, `Table.order_keys`), since torch has no ordering for
uint64: sorting and searching order keys gives the reference's splitters
and destinations for every type. `torch.sort` and `torch.searchsorted`
stand where the reference has `jnp.sort` and `jnp.searchsorted` (plain XLA
there too). Where the reference's float order differs (NaN sorts after
+inf there and counts as a valid sample), the order key's holds: NaN is
the sentinel, and so no valid sample.
"""

from __future__ import annotations

import torch

from pim_sort_merge_join_tpu_torch.ops.hash_join import hash_column


def _sentinel(keys: torch.Tensor) -> int:
    return torch.iinfo(keys.dtype).max


def sample_keys(keys: torch.Tensor, num_valid: torch.Tensor, sample_size: int) -> torch.Tensor:
    """Evenly strided sample of the first ``num_valid`` order keys.

    ``keys`` is a rank's ``[cap]`` order keys (padding already the
    sentinel). Returns ``[sample_size]``: entries repeat when the rank holds
    fewer valid rows than the sample; an empty rank gives sentinels, which
    `choose_splitters` masks out.
    """
    n = num_valid.to(torch.int64)
    s = torch.arange(sample_size, dtype=torch.int64, device=keys.device)
    idx = torch.where(n > 0, (s * n.clamp(min=1)) // sample_size, 0)
    if keys.shape[0] == 0:
        return torch.full((sample_size,), _sentinel(keys), dtype=keys.dtype, device=keys.device)
    return torch.where(n > 0, keys[idx], _sentinel(keys))


def choose_splitters(samples: torch.Tensor, num_partitions: int) -> torch.Tensor:
    """``num_partitions - 1`` ascending splitters from pooled order-key samples.

    ``samples`` pools every rank's samples of both tables, sentinels for
    invalid entries. Rank p owns keys in ``(splitter[p-1], splitter[p]]``
    (`destination_of` searches on the left).
    """
    sorted_samples = torch.sort(samples).values
    valid = (sorted_samples != _sentinel(samples)).sum().to(torch.int64)
    p = torch.arange(1, num_partitions, dtype=torch.int64, device=samples.device)
    idx = torch.minimum((p * valid.clamp(min=1)) // num_partitions, (valid - 1).clamp(min=0))
    return sorted_samples[idx]


def destination_of(keys: torch.Tensor, splitters: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Destination rank in [0, P) per row, int32; invalid rows get P (dropped).

    Equal keys get one destination (the left boundary of the search).
    """
    num_partitions = splitters.shape[0] + 1
    d = torch.searchsorted(splitters.contiguous(), keys.contiguous(), side="left").to(torch.int32)
    return torch.where(valid, d, num_partitions)


def unsigned_remainder(h: torch.Tensor, divisor: int) -> torch.Tensor:
    """``h`` read as an unsigned integer of its width, modulo ``divisor``, as
    int64: from the two 32-bit halves for 64-bit ``h``, so no value wraps."""
    if h.dtype == torch.int32:
        return (h.to(torch.int64) & 0xFFFFFFFF) % divisor
    hi = (h >> 32) & 0xFFFFFFFF
    lo = h & 0xFFFFFFFF
    return ((hi % divisor) * ((1 << 32) % divisor) + lo % divisor) % divisor


def hash_destination_of(keys: torch.Tensor, num_partitions: int, valid: torch.Tensor) -> torch.Tensor:
    """Hash-partitioned destination rank (BASELINE config 3), int32.

    ``keys`` are a key column in the table's type. The reference takes
    ``h % P`` of its unsigned hash ``h``; `hash_column` returns ``h`` with
    its sign bit flipped, so the remainder is taken of those bits read as
    unsigned (`unsigned_remainder`). Equal keys co-locate whatever their
    distribution; rank order does not follow key order.
    """
    hc = hash_column(keys)
    h = hc ^ torch.iinfo(hc.dtype).min
    d = unsigned_remainder(h, num_partitions).to(torch.int32)
    return torch.where(valid, d, num_partitions)
