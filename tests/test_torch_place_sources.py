"""The fused 1:1 join's placement (`join_scan.place_sources`), on the CPU.

The join core places each output slot's source rows straight from the
merged domain and gathers the rows once (`ops/join._one_to_one_merged`).
The dataflow it replaced is kept here as the oracle: the un-merge sort
keyed on the merged position, then one emit sort per table keyed on the
row's slot (dropped rows ``n + row``), whose rows are gathered into the
output. Both must give the same output bits and ``num_rows`` exactly.
"""

import numpy as np
import pytest
import torch

from pim_sort_merge_join_tpu_torch.columnar import dtypes
from pim_sort_merge_join_tpu_torch.columnar.table import Table
from pim_sort_merge_join_tpu_torch.ops import join as join_ops
from pim_sort_merge_join_tpu_torch.ops.kernels import join_scan
from pim_sort_merge_join_tpu_torch.ops.sort import (
    sort_key_permutation,
    stable_key_sort,
    stable_key_sort_rows,
)


def _rows(rng, keys, ncol=4):
    keys = np.asarray(keys, dtype=np.int64)
    rows = rng.integers(-(2**20), 2**20, (keys.shape[0], ncol))
    rows[:, 0] = keys
    return rows


def _case(name, rng, dtype):
    """``(rows1, cap1, keep1, rows2, cap2, keep2)``: each table's rows, its
    capacity (padding past the rows) and the filter's mask over its rows."""
    sent = np.iinfo(dtype).max

    def all_kept(rows):
        return np.ones(rows.shape[0], dtype=bool)

    if name == "duplicates_unequal":
        # Key k appears k % 5 times in table 1 and (k * 3) % 4 times in table 2.
        r1 = _rows(rng, rng.permutation(np.repeat(np.arange(40), np.arange(40) % 5)))
        r2 = _rows(rng, rng.permutation(np.repeat(np.arange(40), np.arange(40) * 3 % 4)))
        return r1, r1.shape[0], all_kept(r1), r2, r2.shape[0], all_kept(r2)
    if name == "no_match":
        r1 = _rows(rng, rng.permutation(np.arange(0, 400, 2)))
        r2 = _rows(rng, rng.permutation(np.arange(1, 400, 2)))
        return r1, 256, all_kept(r1), r2, 200, all_kept(r2)
    if name == "all_matched":
        r1 = _rows(rng, rng.permutation(257))
        r2 = _rows(rng, rng.permutation(257))
        return r1, 257, all_kept(r1), r2, 257, all_kept(r2)
    if name == "cap1_lt_cap2":
        r1 = _rows(rng, rng.integers(0, 60, 50))
        r2 = _rows(rng, rng.integers(0, 60, 400))
        return r1, 64, all_kept(r1), r2, 512, all_kept(r2)
    if name == "cap1_gt_cap2":
        r1 = _rows(rng, rng.integers(0, 60, 400))
        r2 = _rows(rng, rng.integers(0, 60, 50))
        return r1, 512, all_kept(r1), r2, 64, all_kept(r2)
    if name == "sentinel_and_padding":
        # Keys equal to the sentinel are dead like padding and masked rows.
        k1 = rng.integers(-30, 30, 300)
        k2 = rng.integers(-30, 30, 280)
        k1[rng.random(300) < 0.15] = sent
        k2[rng.random(280) < 0.15] = sent
        r1, r2 = _rows(rng, k1), _rows(rng, k2)
        return r1, 333, rng.random(300) < 0.8, r2, 301, rng.random(280) < 0.8
    if name == "one_row_table":
        r1 = _rows(rng, [7])
        r2 = _rows(rng, rng.permutation([7, 7, 3, 9, 7, 1]))
        return r1, 1, all_kept(r1), r2, 6, all_kept(r2)
    if name == "empty_side":
        r1 = _rows(rng, rng.integers(0, 20, 90))
        r2 = _rows(rng, np.zeros(0, dtype=np.int64))
        return r1, 96, all_kept(r1), r2, 16, all_kept(r2)
    if name == "empty_buffer":
        r1 = _rows(rng, np.zeros(0, dtype=np.int64))
        r2 = _rows(rng, rng.integers(0, 20, 90))
        return r1, 0, all_kept(r1), r2, 96, all_kept(r2)
    raise ValueError(name)


CASES = ["duplicates_unequal", "no_match", "all_matched", "cap1_lt_cap2", "cap1_gt_cap2",
         "sentinel_and_padding", "one_row_table", "empty_side", "empty_buffer"]


def _inputs(name, dtype):
    rng = np.random.default_rng([CASES.index(name), np.dtype(dtype).itemsize])
    r1, cap1, keep1, r2, cap2, keep2 = _case(name, rng, dtype)
    t1 = Table.from_numpy(r1, capacity=cap1, dtype=dtype, device="cpu")
    t2 = Table.from_numpy(r2, capacity=cap2, dtype=dtype, device="cpu")

    def mask(t, keep):
        m = np.zeros(t.capacity, dtype=bool)
        m[: keep.shape[0]] = keep
        return torch.from_numpy(m) & t.valid_mask()

    keys = join_ops.one_to_one_keys(t1, t2, 0, 0, mask(t1, keep1), mask(t2, keep2))
    assert keys.dtype == torch.from_numpy(np.zeros(0, dtype)).dtype
    return t1, t2, keys[:cap1], keys[cap1:]


def _sorted_emit(t1, t2, key2, dest, mpos, num_out):
    """The dataflow the placement replaced: the un-merge sort and one emit
    sort per table, rows gathered by the sorts' permutations."""
    cap1, cap2 = t1.capacity, t2.capacity
    n = cap1 + cap2
    _, dest_by_pos = stable_key_sort((mpos, dest), unique_keys=True)

    def uniq(d, cap):
        return torch.where(d >= n, n + torch.arange(cap, dtype=torch.int32), d)

    data, data_bits, data1, data2, keep2 = join_ops._out_buffer(t1, t2, key2, cap1)
    stable_key_sort_rows(
        [(uniq(dest_by_pos[:cap1], cap1), data1), (uniq(dest_by_pos[cap1:], cap2), data2, keep2)],
        out=data_bits, live=num_out,
    )
    return Table(data=data, num_rows=num_out, names=join_ops._out_names(t1, t2, key2))


def _assert_same(got, want):
    assert int(got.num_rows) == int(want.num_rows)
    assert got.data.dtype == want.data.dtype and got.data.shape == want.data.shape
    assert torch.equal(dtypes.bits(got.data), dtypes.bits(want.data))
    assert got.names == want.names


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("name", CASES)
def test_placement_equals_the_unmerge_and_emit_sorts(name, dtype):
    t1, t2, k1, k2 = _inputs(name, dtype)
    cap1 = t1.capacity
    mkeys, mpos = sort_key_permutation(torch.cat([k1, k2]))
    dest, num_out = join_scan._merged_dest_plain(mkeys, mpos, cap1)
    want = _sorted_emit(t1, t2, 0, dest, mpos, num_out)
    if name == "no_match" or name.startswith("empty"):
        assert int(num_out) == 0
    if name == "all_matched":
        assert int(num_out) == cap1 == t2.capacity

    src1, src2 = join_scan.place_sources_plain(dest, mpos, cap1, cap1)
    assert src1.dtype == src2.dtype == torch.int32 and src1.shape == src2.shape == (cap1,)
    _assert_same(join_ops._emit(t1, t2, 0, src1, src2, num_out), want)
    # The join core, which dispatches to the plain placement on the CPU.
    _assert_same(join_ops._one_to_one_merged(t1, t2, 0, torch.cat([k1, k2])), want)


def test_placement_fills_each_slot_once_from_its_side():
    t1, t2, k1, k2 = _inputs("duplicates_unequal", np.int64)
    cap1 = t1.capacity
    mkeys, mpos = sort_key_permutation(torch.cat([k1, k2]))
    dest, num_out = join_scan._merged_dest_plain(mkeys, mpos, cap1)
    live = int(num_out)
    assert live > 0
    src1, src2 = join_scan.place_sources(dest, mpos, cap1, cap1)
    # Each side's live slots name distinct rows of its own table whose keys agree.
    assert torch.unique(src1[:live]).numel() == torch.unique(src2[:live]).numel() == live
    assert 0 <= int(src1[:live].min()) and int(src1[:live].max()) < cap1
    assert 0 <= int(src2[:live].min()) and int(src2[:live].max()) < t2.capacity
    assert torch.equal(k1[src1[:live].long()], k2[src2[:live].long()])


def test_core_checks_the_sort_algorithm():
    t1, t2, k1, k2 = _inputs("all_matched", np.int64)
    with pytest.raises(ValueError, match="unknown sort algorithm"):
        join_ops._one_to_one_merged(t1, t2, 0, torch.cat([k1, k2]), sort_algorithm="quick")


def test_placement_refuses_other_devices():
    d = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        join_scan.place_sources(d, d, 2, 2)
