"""The all-to-all row exchange (port of `exchange/shuffle.py`).

Each rank packs its rows into P buckets of C rows (`pack_buckets`), the
ranks exchange the ``[P, C, ncol]`` blocks and the per-bucket counts (one
collective, or ``num_chunks`` over bucket sub-ranges, `collectives.all_to_all`),
and each rank compacts what arrived (`compact_received`). Fixed-capacity
buckets are how variable per-destination counts travel: rows past a
bucket's capacity are dropped deterministically, and the true counts travel
with the data, so the caller sees an overflow (true rows > capacity) and
fails loudly. `exchange_local` is the collective done in one process (the
transpose of P ranks' blocks), for the tests.

Rows keep a deterministic order: received rows are ordered by (source rank,
source position), which the stable sorts downstream carry into the output.
Rows move as their bits (`columnar/dtypes.bits`), so every table type
travels, uint64 included.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pim_sort_merge_join_tpu_torch.columnar import dtypes
from pim_sort_merge_join_tpu_torch.exchange import collectives
from pim_sort_merge_join_tpu_torch.ops.kernels.gather import gather_rows
from pim_sort_merge_join_tpu_torch.ops.sort import stable_key_sort_rows


class ExchangeResult(NamedTuple):
    data: torch.Tensor       # [recv_capacity, ncol] compacted received rows, zeros after
    num_rows: torch.Tensor   # 0-d int32: rows materialized (after the drop)
    true_rows: torch.Tensor  # 0-d int32: rows that should have arrived (overflow if >)


class Packed(NamedTuple):
    blocks: torch.Tensor  # [P, C, ncol] the bits of the rows; block j goes to rank j
    counts: torch.Tensor  # [P, 2] int32: rows placed in bucket j (<= C), rows destined to j


def pack_buckets(data: torch.Tensor, dest: torch.Tensor, num_partitions: int,
                 bucket_capacity: int) -> Packed:
    """Group a rank's rows by destination into P buckets of C rows.

    ``dest`` is the destination rank per row; values ``>= P`` drop the row
    (padding). A stable sort by destination keeps each bucket's rows in
    local order: `stable_key_sort_rows` (the sort kernels and the row
    gather on the card, rows riding as in the reference's multi-operand
    sort). Slots past a bucket's count are never read by the receiver.
    """
    cap, ncol = data.shape
    p, c = num_partitions, bucket_capacity
    dev = data.device
    rows = dtypes.bits(data).contiguous()
    d = torch.clamp(dest.to(torch.int32), 0, p)
    sorted_rows = stable_key_sort_rows([(d, rows)])
    counts = torch.bincount(d.to(torch.int64), minlength=p + 1)[:p].to(torch.int32)
    starts = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    slot = torch.arange(c, dtype=torch.int32, device=dev)
    src = (starts[:, None] + slot[None, :]).clamp(max=max(cap - 1, 0)).reshape(-1)
    if cap == 0:
        blocks = rows.new_zeros((p * c, ncol))
    else:
        blocks = gather_rows([(sorted_rows, src)])
    sent = torch.clamp(counts, max=c)
    return Packed(blocks.reshape(p, c, ncol), torch.stack([sent, counts], dim=1))


def compact_received(blocks: torch.Tensor, counts: torch.Tensor, recv_capacity: int,
                     dtype: torch.dtype) -> ExchangeResult:
    """Compact received blocks into a ``[recv_capacity, ncol]`` table of
    ``dtype``: block i's first ``counts[i, 0]`` rows, in block order, then
    zeros; rows past the capacity are dropped. One row gather whose
    ``live`` is the kept row count."""
    p, c, ncol = blocks.shape
    dev = blocks.device
    sent, true = counts[:, 0], counts[:, 1]
    ends = torch.cumsum(sent, 0, dtype=torch.int32)
    received = ends[-1] if p else torch.zeros((), dtype=torch.int32, device=dev)
    num_rows = torch.clamp(received, max=recv_capacity).to(torch.int32)
    i = torch.arange(recv_capacity, dtype=torch.int32, device=dev)
    block = torch.searchsorted(ends, i, right=True).clamp(max=max(p - 1, 0)).to(torch.int32)
    src = block * c + (i - (ends - sent)[block])
    flat = blocks.reshape(p * c, ncol)
    if p * c == 0:
        out = flat.new_zeros((recv_capacity, ncol))
    else:
        out = gather_rows([(flat, src.to(torch.int32))], live=num_rows.reshape(()))
    return ExchangeResult(dtypes.from_bits(out, dtype), num_rows.reshape(()),
                          true.sum(dtype=torch.int32))


def exchange_local(packs: list[Packed]) -> list[Packed]:
    """The exchange of P ranks' packed blocks done in one process: rank r
    receives block r of every rank, in rank order, with its counts. The
    tests' stand-in for the collective."""
    p = len(packs)
    return [Packed(torch.stack([packs[i].blocks[r] for i in range(p)]),
                   torch.stack([packs[i].counts[r] for i in range(p)]))
            for r in range(p)]


def all_to_all_exchange(
    data: torch.Tensor,
    dest: torch.Tensor,
    group=None,
    *,
    bucket_capacity: int,
    recv_capacity: int | None = None,
    num_chunks: int = 1,
) -> ExchangeResult:
    """Route rows of ``data`` to the rank named by ``dest`` over ``group``.

    A collective: every rank of the group calls it with the same
    capacities. ``data`` is this rank's ``[cap, ncol]`` rows (padding
    allowed), ``dest`` its ``[cap]`` destinations (``>= P`` drops a row),
    ``bucket_capacity`` C the rows it may send to any one rank,
    ``recv_capacity`` the compacted buffer (P*C by default). ``num_chunks``
    moves the payload as that many collectives over bucket sub-ranges
    (one when it does not divide C); the result is the same bits for any
    value.
    """
    p = collectives.world_size(group)
    c = bucket_capacity
    recv_cap = p * c if recv_capacity is None else recv_capacity
    packed = pack_buckets(data, dest, p, c)
    k = max(min(num_chunks, c), 1)
    if c % k != 0:
        k = 1
    step = c // k
    parts = [collectives.all_to_all(packed.blocks[:, i * step:(i + 1) * step].contiguous(), group)
             for i in range(k)]
    recv = parts[0] if k == 1 else torch.cat(parts, dim=1)
    counts = collectives.all_to_all(packed.counts, group)
    return compact_received(recv, counts, recv_cap, data.dtype)
