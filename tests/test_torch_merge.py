"""The port's pairwise merge and merge tree (plain path, CPU) against the JAX package.

`merge_sorted` (ties, empty runs, capacities, dtype promotion, other key
columns, the schema check) and `merge_tree` over 1 to 9 runs: the same
runs, carried across with `convert.table_from_reference`, must give the
same whole buffers (padding included), `num_rows`, names and dtypes.
"""

import numpy as np
import pytest
import torch

from pim_sort_merge_join_tpu.columnar.table import Table as JTable
from pim_sort_merge_join_tpu.ops import merge as jmerge
from pim_sort_merge_join_tpu_torch.columnar.table import Table
from pim_sort_merge_join_tpu_torch.convert import table_from_reference
from pim_sort_merge_join_tpu_torch.ops import kernels
from pim_sort_merge_join_tpu_torch.ops import merge as pmerge


def _port(jt):
    return table_from_reference(np.asarray(jt.data), int(jt.num_rows), jt.names, device="cpu")


def _assert_same(got, want):
    want_data = np.asarray(want.data)
    assert got.data.numpy().dtype == want_data.dtype
    np.testing.assert_array_equal(got.data.numpy(), want_data)
    assert got.num_rows.dtype == torch.int32 and got.num_rows.dim() == 0
    assert int(got.num_rows) == int(want.num_rows)
    assert got.names == want.names


def _run(rng, n, cap=None, ncol=4, key_hi=1000, dtype=np.int64, key=0):
    rows = rng.integers(-50, 100, size=(n, ncol))
    rows[:, key] = np.sort(rng.integers(0, key_hi, size=n))
    rows = rows.astype(dtype)
    return JTable.from_numpy(rows, capacity=cap, dtype=dtype)


@pytest.mark.parametrize(
    "n1,cap1,n2,cap2,key_hi",
    [(100, 128, 77, 96, 1000), (50, 50, 60, 60, 3), (0, 16, 40, 40, 10), (30, 32, 0, 0, 10),
     (0, 0, 0, 8, 5), (1, 1, 1, 1, 2)],
)
def test_merge_sorted_matches_reference(n1, cap1, n2, cap2, key_hi):
    rng = np.random.default_rng(n1 * 7 + n2)
    j1, j2 = _run(rng, n1, cap1, key_hi=key_hi), _run(rng, n2, cap2, key_hi=key_hi)
    want = jmerge.merge_sorted(j1, j2, 0)
    got = pmerge.merge_sorted(_port(j1), _port(j2), 0)
    _assert_same(got, want)
    assert got.capacity == cap1 + cap2


def test_merge_sorted_ties_keep_run_one_first():
    r1 = np.array([[5, 1, 1, 1], [5, 2, 2, 2]], dtype=np.int64)
    r2 = np.array([[5, 3, 3, 3]], dtype=np.int64)
    j1, j2 = JTable.from_numpy(r1), JTable.from_numpy(r2)
    got = pmerge.merge_sorted(_port(j1), _port(j2), 0)
    _assert_same(got, jmerge.merge_sorted(j1, j2, 0))
    np.testing.assert_array_equal(got.to_numpy(), np.vstack([r1, r2]))


def test_merge_sorted_empty_run_matches_reference():
    rng = np.random.default_rng(1)
    j1 = _run(rng, 50, 64)
    j2 = JTable.empty(4, 32)
    got = pmerge.merge_sorted(_port(j1), Table.empty(4, 32, device="cpu"), 0)
    _assert_same(got, jmerge.merge_sorted(j1, j2, 0))


@pytest.mark.parametrize("dtypes", [(np.int32, np.int64), (np.int64, np.int32), (np.int32, np.int32)])
def test_merge_sorted_promotes_dtype_like_reference(dtypes):
    """The output takes the promoted type of the runs, as the reference's
    concatenation does; each run's padding keeps its own type's sentinel."""
    rng = np.random.default_rng(2)
    j1 = _run(rng, 40, 48, dtype=dtypes[0], key_hi=2**20)
    j2 = _run(rng, 30, 40, dtype=dtypes[1], key_hi=2**20)
    want = jmerge.merge_sorted(j1, j2, 0)
    got = pmerge.merge_sorted(_port(j1), _port(j2), 0)
    _assert_same(got, want)
    assert got.dtype == torch.promote_types(_port(j1).dtype, _port(j2).dtype)


def test_merge_sorted_other_key_column_and_extremes():
    rng = np.random.default_rng(3)
    info = np.iinfo(np.int64)
    j1 = _run(rng, 60, 64, key=2, key_hi=5)
    rows2 = np.zeros((5, 4), np.int64)
    rows2[:, 2] = [info.min, -1, 0, info.max - 1, info.max]
    j2 = JTable.from_numpy(rows2, capacity=9)
    want = jmerge.merge_sorted(j1, j2, 2)
    _assert_same(pmerge.merge_sorted(_port(j1), _port(j2), 2), want)


def test_merge_schema_mismatch_raises():
    with pytest.raises(ValueError, match="schema mismatch"):
        pmerge.merge_sorted(Table.empty(4, 8, device="cpu"), Table.empty(3, 8, device="cpu"), 0)
    with pytest.raises(ValueError, match="at least one run"):
        pmerge.merge_tree([], 0)


@pytest.mark.parametrize("nruns", range(1, 10))
def test_merge_tree_matches_reference(nruns):
    rng = np.random.default_rng(40 + nruns)
    runs = [_run(rng, 20 + 3 * i, 64, key_hi=50) for i in range(nruns)]
    want = jmerge.merge_tree(runs, 0)
    got = pmerge.merge_tree([_port(r) for r in runs], 0)
    _assert_same(got, want)


def test_merge_plain_path_launches_no_kernel():
    rng = np.random.default_rng(5)
    kernels.reset_launch_counts()
    pmerge.merge_tree([_port(_run(rng, 30, 32)) for _ in range(3)], 0)
    assert all(n == 0 for n in kernels.launch_counts().values())
