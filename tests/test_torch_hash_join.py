"""The port's hash join and hash aggregate (plain path, CPU) against the JAX package.

The hashes bit for bit (`mix32`, `mix64`, `hash_column`, extremes and the
sentinels' preimages included), `hash_join` in both modes, `hash_aggregate`
for every aggregate, and ``join_algorithm="hash"`` through `pipeline_core`,
`QueryPipeline.run_tables` and `run_csv`: the same tables, carried across
with `convert.table_from_reference`, must give the same whole buffers
(padding included), `num_rows`, names and dtypes, and the same CSV bytes.
Integer data: every comparison is exact.
"""

import hypothesis.strategies as st
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings

import pim_sort_merge_join_tpu as smj
from pim_sort_merge_join_tpu.engine import errors as jerrors
from pim_sort_merge_join_tpu.engine import pipeline as jpipeline
from pim_sort_merge_join_tpu.ops import hash_join as jhash
from pim_sort_merge_join_tpu_torch import EngineConfig, QueryPipeline
from pim_sort_merge_join_tpu_torch.columnar import csv_io
from pim_sort_merge_join_tpu_torch.convert import config_from_reference, table_from_reference
from pim_sort_merge_join_tpu_torch.engine import pipeline as pipeline_mod
from pim_sort_merge_join_tpu_torch.engine.errors import JoinOverflowError
from pim_sort_merge_join_tpu_torch.ops import hash_join as phash
from pim_sort_merge_join_tpu_torch.ops import kernels
from tests.conftest import make_reference_like_tables

I32, I64 = np.iinfo(np.int32), np.iinfo(np.int64)
EXTREMES32 = [0, -1, 1, I32.min, I32.min + 1, I32.max, I32.max - 1, 0x40EBFA9C,
              phash.SENTINEL_PREIMAGE32, 12345, -987654321]
EXTREMES64 = [0, -1, 1, I64.min, I64.min + 1, I64.max, I64.max - 1, 0x40EBFA9C,
              phash.SENTINEL_PREIMAGE32, phash.SENTINEL_PREIMAGE64, 2**32, -(2**32), 2**40 + 7]


def _port(jt):
    return table_from_reference(np.asarray(jt.data), int(jt.num_rows), jt.names, device="cpu")


def _jtable(rows, capacity=None):
    return smj.Table.from_numpy(rows, capacity=capacity, dtype=rows.dtype)


def _assert_same(got, want):
    want_data = np.asarray(want.data)
    assert got.data.numpy().dtype == want_data.dtype
    np.testing.assert_array_equal(got.data.numpy(), want_data)
    assert got.num_rows.dtype == torch.int32 and got.num_rows.dim() == 0
    assert int(got.num_rows) == int(want.num_rows)
    assert got.names == want.names


def _dup_rows(rng, n, key_hi=20, dtype=np.int64):
    keys = rng.integers(0, key_hi, size=n)
    return np.column_stack([keys, rng.integers(-1000, 1000, (n, 3))]).astype(dtype)


# --- the hashes ---------------------------------------------------------------


def _bits_of(t, np_uint):
    return t.numpy().view(np_uint)


@pytest.mark.parametrize("width", [32, 64])
def test_mix_bit_exact_on_extremes_and_random(width):
    rng = np.random.default_rng(11 + width)
    if width == 32:
        x = np.concatenate([np.array(EXTREMES32, np.int64),
                            rng.integers(I32.min, I32.max, 5000, endpoint=True)]).astype(np.int32)
        got, want = phash.mix32(torch.from_numpy(x)), jhash.mix32(jnp.asarray(x))
        np.testing.assert_array_equal(_bits_of(got, np.uint32), np.asarray(want))
    else:
        x = np.concatenate([np.array(EXTREMES64, np.int64),
                            rng.integers(I64.min, I64.max, 5000, endpoint=True)])
        got, want = phash.mix64(torch.from_numpy(x)), jhash.mix64(jnp.asarray(x))
        np.testing.assert_array_equal(_bits_of(got, np.uint64), np.asarray(want))


@given(seed=st.integers(0, 2**32 - 1))
@settings(max_examples=25, deadline=None)
def test_hash_column_is_the_reference_hash_with_its_sign_bit_flipped(seed):
    rng = np.random.default_rng(seed)
    for dtype, info, u in ((np.int32, I32, np.uint32), (np.int64, I64, np.uint64)):
        x = rng.integers(info.min, info.max, 300, endpoint=True).astype(dtype)
        got = phash.hash_column(torch.from_numpy(x))
        want = np.asarray(jhash.hash_column(jnp.asarray(x)))
        assert got.dtype == torch.from_numpy(x).dtype
        sign = u(1) << u(8 * np.dtype(dtype).itemsize - 1)
        np.testing.assert_array_equal(_bits_of(got, u) ^ sign, want)
        # Signed order of the port's hash is the unsigned order of the reference's.
        np.testing.assert_array_equal(np.argsort(got.numpy(), kind="stable"),
                                      np.argsort(want, kind="stable"))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_hashed_keys_padding_and_sentinel_preimage_match_reference(dtype):
    pre = phash.SENTINEL_PREIMAGE32 if dtype == np.int32 else phash.SENTINEL_PREIMAGE64
    rows = np.array([[pre, 1], [5, 2], [7, 3]], dtype)
    jt = _jtable(rows, capacity=5)
    want = np.asarray(jhash._hashed_keys(jt, 0))
    got = phash._hashed_keys(_port(jt), 0)
    u = np.uint32 if dtype == np.int32 else np.uint64
    sign = u(1) << u(8 * np.dtype(dtype).itemsize - 1)
    np.testing.assert_array_equal(_bits_of(got, u) ^ sign, want)
    # The valid key `pre` hashes to the unsigned maximum: padding in both.
    assert want[0] == np.iinfo(u).max and int(got[0]) == np.iinfo(dtype).max


def test_hash_column_refuses_floats_naming_the_roadmap_item():
    """Float keys are ported (ROADMAP, "Float keys and general num_keys=2 on
    CUDA"): they hash as the reference hashes them, -0.0 as +0.0
    (`tests/test_torch_dtypes.py` has every type); the mixes still refuse
    a width that is not theirs."""
    keys = np.array([0.0, -0.0, 1.5, -np.inf, np.inf], np.float64)
    want = np.asarray(jhash.hash_column(jnp.asarray(keys)))
    got = phash.hash_column(torch.from_numpy(keys)).numpy().view(np.uint64) ^ np.uint64(2**63)
    np.testing.assert_array_equal(got, want)
    assert got[0] == got[1]
    with pytest.raises(ValueError):
        phash.mix32(torch.zeros(3, dtype=torch.int64))


# --- hash_join ----------------------------------------------------------------


def _pairs(name, rng):
    if name == "small_tables":
        r1, r2 = make_reference_like_tables(rng, 200)
        return r1, r2, 256, 224
    if name == "dup_tables":
        return _dup_rows(rng, 300), _dup_rows(rng, 300), None, None
    if name == "int32_dups":
        return _dup_rows(rng, 400, 30, np.int32), _dup_rows(rng, 350, 30, np.int32), 512, None
    if name == "extreme_keys":
        k = np.array(EXTREMES64, np.int64)
        r1 = np.column_stack([rng.choice(k, 200), rng.integers(0, 9, (200, 2))])
        r2 = np.column_stack([rng.choice(k, 150), rng.integers(0, 9, (150, 4))])
        return r1, r2, 230, 160
    if name == "extreme_keys_int32":
        k = np.array(EXTREMES32, np.int64)
        r1 = np.column_stack([rng.choice(k, 200), rng.integers(0, 9, (200, 3))]).astype(np.int32)
        r2 = np.column_stack([rng.choice(k, 180), rng.integers(0, 9, (180, 3))]).astype(np.int32)
        return r1, r2, None, 200
    if name == "no_match":
        r1 = _dup_rows(rng, 100)
        r2 = _dup_rows(rng, 90)
        r2[:, 0] += 1000
        return r1, r2, None, None
    if name == "empty_side":
        return _dup_rows(rng, 100), _dup_rows(rng, 0), None, 8
    raise AssertionError(name)


CASES = ["small_tables", "dup_tables", "int32_dups", "extreme_keys", "extreme_keys_int32",
         "no_match", "empty_side"]


@pytest.mark.parametrize("name", CASES)
def test_hash_join_one_to_one_matches_reference(name):
    r1, r2, c1, c2 = _pairs(name, np.random.default_rng(101))
    j1, j2 = _jtable(r1, c1), _jtable(r2, c2)
    want = jhash.hash_join(j1, j2, 0, 0, mode="one_to_one")
    got = phash.hash_join(_port(j1), _port(j2), 0, 0, mode="one_to_one")
    _assert_same(got, want)


@pytest.mark.parametrize("out_capacity", [None, 10, 4000])
@pytest.mark.parametrize("name", CASES)
def test_hash_join_inner_matches_reference(name, out_capacity):
    r1, r2, c1, c2 = _pairs(name, np.random.default_rng(102))
    j1, j2 = _jtable(r1, c1), _jtable(r2, c2)
    want = jhash.hash_join(j1, j2, 0, 0, mode="inner", out_capacity=out_capacity)
    got = phash.hash_join(_port(j1), _port(j2), 0, 0, mode="inner", out_capacity=out_capacity)
    _assert_same(got, want)


def test_hash_join_inner_overflow_reports_the_true_count():
    rng = np.random.default_rng(103)
    j1, j2 = _jtable(_dup_rows(rng, 300, 5)), _jtable(_dup_rows(rng, 300, 5))
    want = jhash.hash_join(j1, j2, 0, 0, mode="inner", out_capacity=50)
    got = phash.hash_join(_port(j1), _port(j2), 0, 0, mode="inner", out_capacity=50)
    _assert_same(got, want)
    assert int(got.num_rows) > got.capacity == 50


@pytest.mark.parametrize("mode", ["one_to_one", "inner"])
def test_hash_join_other_key_columns_match_reference(mode):
    rng = np.random.default_rng(104)
    r1, r2 = _dup_rows(rng, 250, 15), _dup_rows(rng, 200, 15)
    r1[:, 2] = rng.integers(0, 15, 250)
    r2[:, 1] = rng.integers(0, 15, 200)
    j1, j2 = _jtable(r1, 260), _jtable(r2)
    want = jhash.hash_join(j1, j2, 2, 1, mode=mode)
    got = phash.hash_join(_port(j1), _port(j2), 2, 1, mode=mode)
    _assert_same(got, want)


def test_hash_join_sentinel_preimage_is_dropped_like_padding():
    """A valid key whose hash is the maximum never matches, in both packages."""
    pre = phash.SENTINEL_PREIMAGE64
    r1 = np.array([[pre, 1], [3, 2], [pre, 3]], np.int64)
    r2 = np.array([[3, 7], [pre, 8]], np.int64)
    for mode in ("one_to_one", "inner"):
        j1, j2 = _jtable(r1), _jtable(r2)
        want = jhash.hash_join(j1, j2, 0, 0, mode=mode)
        got = phash.hash_join(_port(j1), _port(j2), 0, 0, mode=mode)
        _assert_same(got, want)
        assert int(got.num_rows) == 1


def test_hash_join_unknown_mode_raises():
    t = _port(_jtable(_dup_rows(np.random.default_rng(0), 10)))
    with pytest.raises(ValueError, match="join mode"):
        phash.hash_join(t, t, 0, 0, mode="outer")


def test_hash_inner_join_runs_no_cummax(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("cummax on the hash inner join")

    monkeypatch.setattr(torch, "cummax", refuse)
    monkeypatch.setattr(torch, "cummin", refuse)
    rng = np.random.default_rng(105)
    j1, j2 = _jtable(_dup_rows(rng, 200)), _jtable(_dup_rows(rng, 200))
    _assert_same(phash.hash_join(_port(j1), _port(j2), 0, 0, mode="inner"),
                 jhash.hash_join(j1, j2, 0, 0, mode="inner"))


# --- hash_aggregate -----------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.int64, np.int32])
@pytest.mark.parametrize("agg", ["sum", "count", "min", "max"])
def test_hash_aggregate_matches_reference(agg, dtype, dup_tables):
    rows = dup_tables[0].astype(dtype)
    j = _jtable(rows, capacity=320)
    want = jhash.hash_aggregate(j, 0, 2, agg)
    _assert_same(phash.hash_aggregate(_port(j), 0, 2, agg), want)


@pytest.mark.parametrize("agg", ["sum", "count", "min", "max"])
def test_hash_aggregate_extremes_and_wrapping_sums_match_reference(agg):
    rng = np.random.default_rng(106)
    keys = rng.choice(np.array(EXTREMES64, np.int64), 400)
    vals = rng.choice(np.array([I64.min, I64.max, -1, 0, 1, 2**62]), 400)
    rows = np.column_stack([keys, vals, rng.integers(0, 5, 400)])
    j = _jtable(rows, capacity=410)
    want = jhash.hash_aggregate(j, 0, 1, agg)
    _assert_same(phash.hash_aggregate(_port(j), 0, 1, agg), want)


@given(seed=st.integers(0, 2**32 - 1), n=st.integers(0, 128))
@settings(max_examples=20, deadline=None)
def test_hash_aggregate_random_tables_match_reference(seed, n):
    rng = np.random.default_rng(seed)
    rows = np.column_stack([rng.integers(-6, 6, n), rng.integers(-50, 50, (n, 2))]).astype(np.int64)
    j = _jtable(rows, capacity=128)
    for agg in ("sum", "min"):
        _assert_same(phash.hash_aggregate(_port(j), 0, 1, agg), jhash.hash_aggregate(j, 0, 1, agg))


def test_hash_aggregate_unknown_agg_raises():
    t = _port(_jtable(_dup_rows(np.random.default_rng(0), 10)))
    with pytest.raises(ValueError, match="agg must be one of"):
        phash.hash_aggregate(t, 0, 1, "avg")


# --- the pipeline ---------------------------------------------------------------


def _hash_configs(**kw):
    ref = smj.EngineConfig(join_algorithm="hash", **kw)
    return ref, config_from_reference(ref)


@pytest.mark.parametrize("join_mode", ["one_to_one", "inner"])
@pytest.mark.parametrize("dtype", ["int64", "int32"])
def test_pipeline_core_hash_matches_reference(join_mode, dtype):
    rng = np.random.default_rng(107)
    np_dtype = np.dtype(dtype)
    r1, r2 = _dup_rows(rng, 300, 40, np_dtype), _dup_rows(rng, 280, 40, np_dtype)
    ref, cfg = _hash_configs(join_mode=join_mode, dtype=dtype,
                             predicate1=smj.Predicate(1, ">", -200),
                             predicate2=smj.Predicate(2, "<=", 500), join_slack=4.0)
    j1, j2 = _jtable(r1, 320), _jtable(r2)
    _assert_same(pipeline_mod.pipeline_core(_port(j1), _port(j2), cfg),
                 jpipeline.pipeline_core(j1, j2, ref))


@pytest.mark.parametrize("join_mode", ["one_to_one", "inner"])
@pytest.mark.parametrize("tables", ["small_tables", "dup_tables"])
def test_run_tables_hash_matches_reference(request, tables, join_mode):
    r1, r2 = request.getfixturevalue(tables)
    ref, cfg = _hash_configs(join_mode=join_mode, join_slack=40.0,
                             predicate1=smj.Predicate(0, ">", 5), predicate2=smj.Predicate(0, ">", 5))
    jpipe = smj.QueryPipeline(ref)
    want = jpipe.run_tables(_jtable(r1), _jtable(r2))
    pipe = QueryPipeline(cfg, device="cpu")
    got = pipe.run_tables(_port(_jtable(r1)), _port(_jtable(r2)))
    _assert_same(got, want)
    # The probe still resolves; the hash branch ignores what it found.
    assert pipe.resolved_narrow_keys is jpipe.resolved_narrow_keys
    assert pipe.resolved_narrow_data is jpipe.resolved_narrow_data


@pytest.mark.parametrize("join_slack", [0.5, 1.0])
def test_run_tables_hash_inner_overflow_raises_when_the_reference_does(join_slack):
    rng = np.random.default_rng(108)
    r1, r2 = _dup_rows(rng, 300), _dup_rows(rng, 300)
    ref, cfg = _hash_configs(join_mode="inner", join_slack=join_slack,
                             predicate1=smj.Predicate(0, ">=", 0), predicate2=smj.Predicate(0, ">=", 0))
    with pytest.raises(jerrors.JoinOverflowError) as ref_err:
        smj.QueryPipeline(ref).run_tables(_jtable(r1), _jtable(r2))
    with pytest.raises(JoinOverflowError) as port_err:
        QueryPipeline(cfg, device="cpu").run_tables(_port(_jtable(r1)), _port(_jtable(r2)))
    assert port_err.value.true_rows == ref_err.value.true_rows
    assert port_err.value.capacity == ref_err.value.capacity


@pytest.mark.parametrize("join_mode", ["one_to_one", "inner"])
@pytest.mark.parametrize("dtype", ["int64", "int32"])
def test_run_csv_hash_byte_identical_to_reference(tmp_path, join_mode, dtype):
    rng = np.random.default_rng(109)
    p1, p2 = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    csv_io.write_csv(p1, _dup_rows(rng, 500, 60) + 1000)
    csv_io.write_csv(p2, _dup_rows(rng, 450, 60) + 1000)
    ref, cfg = _hash_configs(join_mode=join_mode, dtype=dtype, join_slack=16.0,
                             predicate1=smj.Predicate(0, ">", 1010),
                             predicate2=smj.Predicate(0, ">", 1005))
    o_ref, o_port = str(tmp_path / "ref.csv"), str(tmp_path / "port.csv")
    want = smj.QueryPipeline(ref).run_csv(p1, p2, o_ref, capacity=520)
    got = QueryPipeline(cfg, device="cpu").run_csv(p1, p2, o_port, capacity=520)
    _assert_same(got, want)
    with open(o_ref, "rb") as a, open(o_port, "rb") as b:
        assert a.read() == b.read()


def test_hash_plain_path_launches_no_kernel():
    rng = np.random.default_rng(110)
    kernels.reset_launch_counts()
    for mode in ("one_to_one", "inner"):
        cfg = EngineConfig(join_algorithm="hash", join_mode=mode, join_slack=10.0)
        QueryPipeline(cfg, device="cpu").run_tables(_port(_jtable(_dup_rows(rng, 100) + 9000)),
                                                    _port(_jtable(_dup_rows(rng, 100) + 9000)))
    phash.hash_aggregate(_port(_jtable(_dup_rows(rng, 50))), 0, 1, "max")
    assert all(n == 0 for n in kernels.launch_counts().values())
