"""The port's fused filter + 1:1 join (plain path, CPU) against the JAX package.

Mirrors tests/test_fused_pipeline.py and tests/test_narrow_keys.py: the
same tables, built through `convert.table_from_reference` from the JAX
tables, go through both packages' `filter_join_one_to_one`; the whole
output buffer, `num_rows`, names and dtype must be equal (tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pim_sort_merge_join_tpu.columnar.table import Table as JTable
from pim_sort_merge_join_tpu.config import Predicate as JPredicate
from pim_sort_merge_join_tpu.ops import filter as jfilter
from pim_sort_merge_join_tpu.ops import join as jjoin
from pim_sort_merge_join_tpu_torch import Predicate
from pim_sort_merge_join_tpu_torch.convert import table_from_reference
from pim_sort_merge_join_tpu_torch.ops import filter as filter_ops
from pim_sort_merge_join_tpu_torch.ops import join as join_ops


def _tables(name, rng):
    """(rows1, rows2, pred1, pred2, cap1, cap2, dtype) for one case."""
    def dup():
        keys = rng.integers(0, 20, size=300)
        return np.column_stack([keys, rng.integers(0, 1000, (300, 3))]).astype(np.int64)

    def ref_like(n, lo=1, hi=None):
        hi = 3 * n if hi is None else hi
        keys = rng.choice(np.arange(lo, hi + 1), size=n, replace=False)
        return np.column_stack([keys, rng.integers(1, 3 * n, (n, 3))]).astype(np.int64)

    if name == "duplicates":
        return dup(), dup(), (1, ">", 300), (1, ">", 250), 384, 512, np.int64
    if name == "cap1_gt_cap2":
        return dup(), dup(), (1, ">", 100), (0, ">=", 3), 512, 320, np.int64
    if name == "empty_result":
        return ref_like(200), ref_like(200), (0, ">", 10**9), (0, ">", 0), None, None, np.int64
    if name == "one_sided_filter":
        return dup(), dup(), (2, "<=", 500), (0, ">=", 0), None, None, np.int64
    if name == "int32":
        return dup(), dup(), (1, ">", 100), (1, ">", 100), None, 400, np.int32
    if name == "negative_keys":
        a, b = dup(), dup()
        a[:, 0] = rng.integers(-(2**31), 2**31 - 2, 300)
        b[:, 0] = np.where(rng.random(300) < 0.5, a[:, 0], rng.integers(-(2**31), 2**31 - 2, 300))
        return a, b, (1, ">", -1), (1, ">", -1), None, None, np.int64
    if name == "wide_keys":
        a, b = ref_like(250), ref_like(250)
        a[:, 0] += 2**40
        b[:, 0] += 2**40
        return a, b, (0, ">", 2**40 + 100), (0, ">", 2**40 + 100), 256, None, np.int64
    raise AssertionError(name)


CASES = ["duplicates", "cap1_gt_cap2", "empty_result", "one_sided_filter", "int32",
         "negative_keys", "wide_keys"]


def _run_both(name, narrow, narrow_data, monkeypatch):
    r1, r2, p1, p2, cap1, cap2, dtype = _tables(name, np.random.default_rng(31))
    # The JAX package casts payloads only above a TPU-tuned size; lower the
    # gate so both packages run the same int32 payload path at test size.
    monkeypatch.setattr(jjoin, "NARROW_DATA_PALLAS_MIN", 0)
    jt1 = JTable.from_numpy(r1.astype(dtype), capacity=cap1, dtype=dtype)
    jt2 = JTable.from_numpy(r2.astype(dtype), capacity=cap2, dtype=dtype)
    want = jjoin.filter_join_one_to_one(
        jt1, jt2, 0, 0,
        jfilter.predicate_mask(jt1, JPredicate(*p1)), jfilter.predicate_mask(jt2, JPredicate(*p2)),
        narrow=narrow, narrow_data=narrow_data,
    )
    t1, t2 = (table_from_reference(np.asarray(t.data), int(t.num_rows), t.names, device="cpu") for t in (jt1, jt2))
    got = join_ops.filter_join_one_to_one(
        t1, t2, 0, 0,
        filter_ops.predicate_mask(t1, Predicate(*p1)), filter_ops.predicate_mask(t2, Predicate(*p2)),
        narrow=narrow, narrow_data=narrow_data,
    )
    return got, want


def _assert_same(got, want):
    want_data = np.asarray(want.data)
    assert got.data.numpy().dtype == want_data.dtype
    np.testing.assert_array_equal(got.data.numpy(), want_data)
    assert got.num_rows.dtype == torch.int32 and got.num_rows.dim() == 0
    assert int(got.num_rows) == int(want.num_rows)
    assert got.names == want.names


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("narrow", [False, True])
def test_filter_join_matches_reference(name, narrow, monkeypatch):
    if narrow and name == "wide_keys":
        narrow = False  # keys above 2^31 never resolve narrow
    got, want = _run_both(name, narrow, narrow_data=False, monkeypatch=monkeypatch)
    _assert_same(got, want)
    if name == "empty_result":
        assert int(got.num_rows) == 0
    elif name != "wide_keys":
        assert int(got.num_rows) > 0


@pytest.mark.parametrize("name", ["duplicates", "cap1_gt_cap2", "negative_keys"])
def test_filter_join_narrow_data_matches_reference(name, monkeypatch):
    got, want = _run_both(name, narrow=True, narrow_data=True, monkeypatch=monkeypatch)
    _assert_same(got, want)


def test_merge_join_one_to_one_matches_reference(monkeypatch):
    r1, r2, *_ = _tables("duplicates", np.random.default_rng(32))
    o1 = np.argsort(r1[:, 0], kind="stable")
    o2 = np.argsort(r2[:, 0], kind="stable")
    jt1, jt2 = JTable.from_numpy(r1[o1]), JTable.from_numpy(r2[o2], capacity=400)
    want = jjoin.merge_join_one_to_one(jt1, jt2, 0, 0)
    t1, t2 = (table_from_reference(np.asarray(t.data), int(t.num_rows), t.names, device="cpu") for t in (jt1, jt2))
    _assert_same(join_ops.merge_join_one_to_one(t1, t2, 0, 0), want)


def test_narrow32_matches_reference():
    k = np.array([-(2**31), -5, 0, 2**31 - 2, np.iinfo(np.int64).max], np.int64)
    want = np.asarray(jjoin._narrow32(jnp.asarray(k)))
    got = join_ops._narrow32(torch.from_numpy(k)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
