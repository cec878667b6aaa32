"""Sorted merge-join operators (PyTorch port of `ops/join.py`).

The fused 1:1 join, `_one_to_one_merged`, keeps the JAX package's
merged-domain design: one 2-key merge sort of both key columns with their
concat positions and the join-rank scan that gives every merged element its
output slot. Where the JAX package then sorts the slots back to row
positions and each table by slot, the port places each slot's source rows
straight from the merged domain (`join_scan.place_sources`) and gathers the
rows once. Output rows, their order and `num_rows` equal
the JAX package's exactly (1:1 semantics of join.c:160-173: the k-th
duplicate of a key in table 1 pairs with the k-th duplicate in table 2).

On CUDA tensors the merge sort runs the hand-written `hbm_sort` kernels,
the scan and the placement run the `join_scan` kernels and the rows move
through the `gather_rows` kernel (`ops/kernels/`); on CPU tensors their
plain torch versions run.

The inner join (`merge_join_inner`, the staged path's): the standard SQL
cross product on duplicate keys, over two tables already sorted on their
keys. `_match_info_keys` finds each table-1 row's matches in the merged
key domain (one merge sort, run algebra, one un-merge sort, both through
`stable_key_sort`), and `_emit` gathers both tables' rows into the output
in one row gather.

Output schema: table-1 columns, then table-2 columns without its key, in
the type of the two tables' concatenation (`columnar/dtypes.promote`).

Keys of every table type are compared as their order keys
(`columnar/dtypes.order_key`), so the sorts and the scan take int32/int64
keys only, and a +inf or NaN key is dead like padding (in the JAX package a
+inf key equals its sentinel and a NaN key never equals another). Rows move
as their bits, so a result holds each row's own bits (-0.0 stays -0.0).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pim_sort_merge_join_tpu_torch.columnar import dtypes
from pim_sort_merge_join_tpu_torch.columnar.table import Table
from pim_sort_merge_join_tpu_torch.engine import metrics
from pim_sort_merge_join_tpu_torch.ops.kernels import join_scan
from pim_sort_merge_join_tpu_torch.ops.kernels.gather import gather_rows
from pim_sort_merge_join_tpu_torch.ops.kernels.keys import one_to_one_keys
from pim_sort_merge_join_tpu_torch.ops.sort import (
    _ALGORITHMS,
    sort_key_permutation,
    stable_key_sort,
)


def _out_names(t1: Table, t2: Table, key2: int) -> tuple:
    ncol = t1.ncol + t2.ncol - 1
    return tuple(f"col{i + 1}" for i in range(ncol))


def _out_buffer(t1: Table, t2: Table, key2: int, rows: int):
    """The join's output buffer, not yet written, its bits, and each
    table's data converted to the output type, as bits: ``(out, out_bits,
    data1, data2, keep2)``."""
    dtype = dtypes.promote(t1.dtype, t2.dtype)
    out = torch.empty((rows, t1.ncol + t2.ncol - 1), dtype=dtype, device=t1.device)
    keep2 = [c for c in range(t2.ncol) if c != key2]
    data1, data2 = (dtypes.bits(t.data.to(dtype)).contiguous() for t in (t1, t2))
    return out, dtypes.bits(out), data1, data2, keep2


def _emit(
    t1: Table,
    t2: Table,
    key2: int,
    src1: torch.Tensor,
    src2: torch.Tensor,
    num_out: torch.Tensor,
) -> Table:
    """Gather matched row pairs into the concatenated output table.

    ``src1[j]``/``src2[j]`` give the table-1/table-2 row feeding output row
    ``j``. The first ``min(num_out, len(src1))`` slots are live
    (front-compacted); the others hold zeros, and their sources are not
    read. One row gather writes both tables' columns of the output.
    """
    data, data_bits, data1, data2, keep2 = _out_buffer(t1, t2, key2, src1.shape[0])
    live = num_out.to(torch.int32)
    gather_rows([(data1, src1), (data2, src2, keep2)], out=data_bits, live=live)
    return Table(data=data, num_rows=live, names=_out_names(t1, t2, key2))


class _MatchInfo(NamedTuple):
    lo2: torch.Tensor  # lower bound of the t1 key in the t2 keys, per t1 row
    cnt2: torch.Tensor  # multiplicity of the t1 key in t2, per t1 row
    occ: torch.Tensor  # occurrence rank of the t1 row within its equal-key run


def _run_starts(keys: torch.Tensor) -> torch.Tensor:
    """For sorted ``keys``: index of the first element of each equal run."""
    n = keys.shape[0]
    iota = torch.arange(n, dtype=torch.int32, device=keys.device)
    one = torch.ones(1, dtype=torch.bool, device=keys.device)
    head = torch.cat([one, keys[1:] != keys[:-1]])
    return join_scan.head_broadcast(head, iota)


def _match_info(t1: Table, t2: Table, key1: int, key2: int) -> _MatchInfo:
    """Per-t1-row (lo2, cnt2, occ) via the merged key domain."""
    dtype = dtypes.promote(t1.dtype, t2.dtype)
    return _match_info_keys(t1.order_keys(key1, dtype), t2.order_keys(key2, dtype))


def _match_info_keys(k1: torch.Tensor, k2: torch.Tensor) -> _MatchInfo:
    """Per-k1-element (lo2, cnt2, occ) from pre-masked key vectors: order
    keys (`columnar/dtypes.order_key`) or hashes, int32/int64.

    One stable merge sort of both key columns, whose permutation is each
    element's concat position (table 1 first on ties), the merged keys'
    runs (`join_scan.merged_runs`), and one un-merge sort keyed on the
    position. Both sorts go through the sort seam (`sort_key_permutation`,
    `stable_key_sort`), so on CUDA tensors they run the `hbm_sort` kernels.
    """
    cap1 = k1.shape[0]
    mkeys, mpos = sort_key_permutation(torch.cat([k1, k2]))
    r = join_scan.merged_runs(mkeys, mpos, cap1)
    # Per side-1 element: its key's run in k2 starts at the count of
    # side-2 before its run (base2) and has end2 - base2 members; a side-1
    # element's in-run index is its side rank (side 1 precedes side 2).
    cnt2_m = torch.where(r.live, r.end2() - r.base2, 0)
    occ_m = r.iota - r.run_start
    _, lo2, cnt2, occ = stable_key_sort((mpos, r.base2, cnt2_m, occ_m), unique_keys=True)
    return _MatchInfo(lo2=lo2[:cap1], cnt2=cnt2[:cap1], occ=occ[:cap1])


def _narrow32(k: torch.Tensor) -> torch.Tensor:
    """Map int64 keys whose values fit int32 onto int32.

    Order-preserving: the caller guarantees every valid key lies in
    [INT32_MIN, INT32_MAX), and the 64-bit sentinel maps to the 32-bit one
    (`columnar/dtypes.narrow32` for the order keys of either 8-byte type).
    """
    return dtypes.narrow32(k, torch.int64)


def _merged_dest(mkeys: torch.Tensor, mpos: torch.Tensor, cap1: int):
    """The merged-domain slot computation: the `join_scan` kernels on CUDA
    tensors at every size and key width, `join_scan._merged_dest_plain` on
    CPU."""
    return join_scan.join_scan_dest(mkeys, mpos, cap1)


def _one_to_one_merged(
    t1: Table,
    t2: Table,
    key2: int,
    keys: torch.Tensor,
    *,
    sort_algorithm: str = "auto",
) -> Table:
    """1:1 join core over one pre-masked key vector; sortedness NOT required.

    ``keys`` is both tables' keys, table 1's ``t1.capacity`` first: int32
    or int64 order keys (`ops/kernels/keys.join_keys`, the sentinel where
    masked) or hashes.

    1. merge both key columns: one stable sort, whose permutation is each
       element's concat position (t1 first on ties); the scan gives each
       element its output slot or the drop value (stage ``merge``);
    2. place: each matched element names its row as its slot's source, one
       table per side (`join_scan.place_sources`, stage ``unmerge``). The
       matched slots of each side are exactly ``0 .. num_out-1``, so these
       are the rows the reference's un-merge sort and per-table emit sorts
       put at each slot;
    3. emit: one row gather of both tables into the output, zeros from
       ``num_out`` on (`_emit`, stage ``emit``).

    ``sort_algorithm`` is accepted for the reference's signature and
    checked as `stable_key_sort` checks it; nothing here sorts by it.
    """
    if sort_algorithm not in _ALGORITHMS:
        raise ValueError(f"unknown sort algorithm {sort_algorithm!r}")
    cap1 = t1.capacity
    n = cap1 + t2.capacity

    # --- 1. merge the key columns (t1 wins ties) ---------------------------
    with metrics.stage("merge"):
        mkeys, mpos = sort_key_permutation(keys)
        dest, num_out = _merged_dest(mkeys, mpos, cap1)
    del mkeys

    # --- 2. place each output slot's source rows ---------------------------
    with metrics.stage("unmerge"):
        metrics.count(placed=n)
        src1, src2 = join_scan.place_sources(dest, mpos, cap1, cap1)
    del dest, mpos

    # --- 3. emit: both tables' rows into the output ------------------------
    # The rows move once, in the table's own element type, so
    # ``narrow_data`` has nothing left to narrow here: it is only ever
    # resolved on when every value fits int32, where the result is the same.
    with metrics.stage("emit"):
        out = _emit(t1, t2, key2, src1, src2, num_out)
        metrics.count(bytes_out=out.data.numel() * out.data.element_size())
        return out


def merge_join_one_to_one(
    t1: Table,
    t2: Table,
    key1: int,
    key2: int,
    *,
    narrow: bool = False,
    narrow_data: bool = False,
    sort_algorithm: str = "auto",
) -> Table:
    """Reference-semantics 1:1 merge join; output capacity is t1's.
    ``narrow_data`` is accepted for the reference's signature (see
    `_one_to_one_merged`)."""
    keys = one_to_one_keys(t1, t2, key1, key2, narrow=narrow)
    return _one_to_one_merged(t1, t2, key2, keys, sort_algorithm=sort_algorithm)


def filter_join_one_to_one(
    t1: Table,
    t2: Table,
    key1: int,
    key2: int,
    mask1: torch.Tensor,
    mask2: torch.Tensor,
    *,
    narrow: bool = False,
    narrow_data: bool = False,
    sort_algorithm: str = "auto",
) -> Table:
    """Fused filter + sort + 1:1 join of two UNSORTED tables.

    ``mask1``/``mask2`` select the surviving rows (already AND-ed with
    validity); masked-out rows get sentinel keys and never match. Output
    equals the staged filter -> sort -> join path byte for byte.
    ``narrow_data`` as in `merge_join_one_to_one`.
    """
    keys = one_to_one_keys(t1, t2, key1, key2, mask1, mask2, narrow=narrow)
    return _one_to_one_merged(t1, t2, key2, keys, sort_algorithm=sort_algorithm)


def merge_join_inner(
    t1: Table, t2: Table, key1: int, key2: int, *, out_capacity: int | None = None
) -> Table:
    """Standard inner join (full cross product on duplicate keys).

    ``out_capacity`` bounds the output (default: table-1 capacity); rows
    beyond it are dropped and the true count is still reported in
    ``num_rows``, so callers can detect overflow (num_rows > capacity).
    """
    info = _match_info(t1, t2, key1, key2)
    cnt = torch.where(t1.valid_mask(), info.cnt2, 0)
    starts = torch.cumsum(cnt, 0, dtype=torch.int32) - cnt  # exclusive prefix
    total = cnt.sum(dtype=torch.int32)
    out_cap = t1.capacity if out_capacity is None else out_capacity
    src1, offset = _slot_owners(cnt, starts, out_cap)
    src2 = info.lo2[src1.long()] + offset
    # Slots past `total` hold the last row's values, but they are invalid.
    return _emit(t1, t2, key2, src1, src2, total)


def _slot_owners(cnt: torch.Tensor, starts: torch.Tensor, out_cap: int):
    """For each of ``out_cap`` output slots ``j``: the last row ``i`` with
    ``starts[i] <= j`` among the rows with matches (``cnt > 0``), and ``j -
    starts[i]``; both int32.

    Rows with matches have strictly increasing starts, so placing ``(i,
    starts[i])`` at slot ``starts[i]`` and broadcasting each placed slot
    over the slots up to the next covers every live slot (the reference
    scatters and takes a running max, ``lax.cummax``, which on the card is
    ~85x slower than this broadcast). Dead rows, and rows that start past
    the capacity, go to spare slots of their own that are cut off (the
    reference's scatter ``mode="drop"``). Slot 0 always starts a run: the
    first row with matches starts there, and with none the reference's
    running max is 0 everywhere.
    """
    n = starts.shape[0]
    dev = starts.device
    has = cnt > 0
    i1 = torch.arange(n, dtype=torch.int32, device=dev)
    slot = torch.where(has & (starts < out_cap), starts, out_cap + i1).long()
    placed = torch.zeros(out_cap + n, dtype=torch.bool, device=dev)
    placed = placed.index_fill_(0, slot, True)[:out_cap]
    placed[:1] = True

    def broadcast(vals: torch.Tensor) -> torch.Tensor:
        buf = torch.zeros(out_cap + n, dtype=torch.int32, device=dev)
        return join_scan.head_broadcast(placed, buf.index_copy_(0, slot, vals)[:out_cap])

    j = torch.arange(out_cap, dtype=torch.int32, device=dev)
    return broadcast(i1), j - broadcast(starts)


def merge_join(
    t1: Table,
    t2: Table,
    key1: int,
    key2: int,
    *,
    mode: str = "one_to_one",
    out_capacity: int | None = None,
    presorted: bool = True,
    narrow: bool = False,
    narrow_data: bool = False,
    sort_algorithm: str = "auto",
) -> Table:
    """Join two tables on their key columns.

    ``presorted=False`` (one_to_one only) accepts unsorted inputs: the
    merged-domain core establishes key order itself. ``narrow`` and
    ``narrow_data`` (one_to_one only) ride keys and payloads through the
    core's sorts as int32; ``sort_algorithm`` is passed to its sort seam.
    The inner join needs key-sorted inputs.
    """
    if mode == "one_to_one":
        if not presorted:
            return filter_join_one_to_one(
                t1, t2, key1, key2, t1.valid_mask(), t2.valid_mask(),
                narrow=narrow, narrow_data=narrow_data, sort_algorithm=sort_algorithm,
            )
        return merge_join_one_to_one(
            t1, t2, key1, key2, narrow=narrow, narrow_data=narrow_data,
            sort_algorithm=sort_algorithm,
        )
    if mode == "inner":
        if not presorted:
            raise ValueError("inner join requires key-sorted inputs")
        return merge_join_inner(t1, t2, key1, key2, out_capacity=out_capacity)
    raise ValueError(f"unknown join mode {mode!r}")
