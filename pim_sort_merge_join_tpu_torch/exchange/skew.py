"""Skew-aware repartitioning (port of `exchange/skew.py`): heavy-hitter
detection and rank co-partitioning (BASELINE config 4, Zipf keys).

Range partitioning sends every row of one key to one rank, which a key
holding a large share of the table overflows. So:

1. `detect_heavy_hitters`: a key above ``heavy_hitter_fraction`` of the
   pooled splitter sample (which every rank holds the same) is heavy; at
   most K = `max_heavy_hitters` exist.
2. `heavy_rank_destination`: heavy rows go to ``rank % P``, ``rank`` the
   row's global occurrence rank of its key (local rank plus the counts of
   the ranks before, from one ``[P, K]`` all-gather). For the 1:1 join
   this is exact: the k-th occurrence in table 1 pairs with the k-th in
   table 2, and both land on rank ``k % P`` in rank order.
3. `gather_heavy_side`: for the inner join table 2's heavy rows go to every
   rank (all-gathered, ``capacity`` per rank, true counts reported).

Keys are order keys (`columnar/dtypes.order_key`), the sentinel the order
maximum, as in `exchange/partition.py`. A heavy key's output rows
interleave across ranks, so the output order differs from the single-chip
order there, as in the reference.
"""

from __future__ import annotations

import torch

from pim_sort_merge_join_tpu_torch.columnar import dtypes
from pim_sort_merge_join_tpu_torch.exchange import collectives
from pim_sort_merge_join_tpu_torch.ops.sort import stable_key_sort_rows


def max_heavy_hitters(fraction: float, num_partitions: int) -> int:
    """Static bound on simultaneous heavy hitters (keys above ``fraction``)."""
    if fraction >= 1.0:
        return 0
    return max(1, min(int(1.0 / max(fraction, 1e-3)), 2 * num_partitions, 16))


def detect_heavy_hitters(samples: torch.Tensor, fraction: float, k_max: int) -> torch.Tensor:
    """Order keys above ``fraction`` of the valid pooled sample: ``[k_max]``
    ascending, sentinel-padded, ready for `torch.searchsorted`. A heavy key
    that the sample misses is range-routed, where the exchange's overflow
    check still sees it."""
    sent = torch.iinfo(samples.dtype).max
    s = torch.sort(samples).values
    nvalid = (s != sent).sum().to(torch.float32)
    lo = torch.searchsorted(s, s, side="left")
    hi = torch.searchsorted(s, s, side="right")
    cnt = (hi - lo).to(torch.float32)
    iota = torch.arange(s.shape[0], dtype=lo.dtype, device=s.device)
    heavy_head = (iota == lo) & (cnt > fraction * nvalid) & (s != sent)
    marked = torch.where(heavy_head, s, sent)
    return torch.sort(marked).values[:k_max]


def mask_heavy_samples(samples: torch.Tensor, heavy_keys: torch.Tensor) -> torch.Tensor:
    """The sample with heavy keys' entries set to the sentinel, so that the
    range splitters balance the remaining rows."""
    idx = torch.searchsorted(heavy_keys, samples, side="left").clamp(max=heavy_keys.shape[0] - 1)
    is_heavy = heavy_keys[idx] == samples
    return torch.where(is_heavy, torch.iinfo(samples.dtype).max, samples)


def heavy_slot_of(keys: torch.Tensor, heavy_keys: torch.Tensor, valid: torch.Tensor):
    """``(is_heavy [n] bool, slot [n] int32 in [0, K))`` membership test."""
    idx = torch.searchsorted(heavy_keys, keys.contiguous(), side="left").to(torch.int32)
    safe = idx.clamp(max=heavy_keys.shape[0] - 1)
    is_heavy = (heavy_keys[safe.to(torch.int64)] == keys) & valid
    return is_heavy, safe


def heavy_rank_destination(is_heavy: torch.Tensor, slot: torch.Tensor, k_max: int,
                           group=None) -> torch.Tensor:
    """``rank % P`` for heavy rows, ``rank`` the global occurrence rank of
    the row's key; int32. A collective (one all-gather of the ``[K]``
    counts). Global rank = the counts of the ranks before + the local rank,
    so the exchange's arrival order (source rank major) delivers each
    rank's heavy rows in ascending global rank."""
    p = collectives.world_size(group)
    me = collectives.rank(group)
    rank_local = torch.zeros(is_heavy.shape, dtype=torch.int32, device=is_heavy.device)
    cnt_local = []
    for k in range(k_max):
        mk = is_heavy & (slot == k)
        rank_local += torch.where(mk, torch.cumsum(mk, 0, dtype=torch.int32) - 1, 0)
        cnt_local.append(mk.sum(dtype=torch.int32))
    all_counts = collectives.all_gather(torch.stack(cnt_local), group)  # [P, K]
    offsets = all_counts[:me].sum(dim=0, dtype=torch.int32)
    rank = rank_local + offsets[slot.to(torch.int64)]
    return torch.remainder(rank, p).to(torch.int32)


def gather_heavy_side(data: torch.Tensor, is_heavy: torch.Tensor, group=None, *, capacity: int):
    """This rank's heavy rows on every rank (the inner join's broadcast side).

    A stable pack puts the heavy rows first (`stable_key_sort_rows`, rows
    riding), ``capacity`` of them are all-gathered. Returns ``(rows
    [P*capacity, ncol], valid [P*capacity] bool, true_count)``: overflow when
    ``true_count > capacity`` on any rank. Slots past a rank's count hold its
    next rows, as in the reference.
    """
    cap, ncol = data.shape
    order = torch.where(is_heavy, 0, 1).to(torch.int32)
    packed = stable_key_sort_rows([(order, dtypes.bits(data).contiguous())])[:capacity]
    if packed.shape[0] < capacity:
        packed = torch.cat([packed, packed.new_zeros((capacity - packed.shape[0], ncol))])
    true_count = is_heavy.sum(dtype=torch.int32)
    sent = torch.clamp(true_count, max=capacity)
    g_rows = collectives.all_gather(packed, group)  # [P, capacity, ncol]
    g_counts = collectives.all_gather(sent.reshape(1), group).reshape(-1)
    p = g_rows.shape[0]
    i = torch.arange(p * capacity, dtype=torch.int32, device=data.device)
    valid = (i % capacity) < g_counts[(i // capacity).to(torch.int64)] if capacity else i < 0
    return dtypes.from_bits(g_rows.reshape(p * capacity, ncol), data.dtype), valid, true_count
