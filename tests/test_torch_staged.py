"""The port's staged sort-merge inner join (plain path, CPU) against the JAX package.

Every stage of the staged path, `compact`/`apply_filter` -> `sort_by_key`
-> `merge_join_inner`, and the whole query through `pipeline_core`,
`QueryPipeline.run_tables` and `run_csv` with ``join_mode="inner"``: the
same tables, carried across with `convert.table_from_reference`, must give
the same whole buffers (padding included), `num_rows`, names and dtypes,
and the same CSV bytes. Integer data: every comparison is exact.

The JAX package cannot run its compiled bitonic kernel on the CPU. Where
the port's "pallas_bitonic" sort is checked, the JAX side runs "xla" (the
same stable sort, since the bitonic sort's vals are an arange) or its
bitonic path with the Pallas kernel in interpret mode.
"""

import functools

import numpy as np
import pytest
import torch

import pim_sort_merge_join_tpu as smj
from pim_sort_merge_join_tpu.engine import errors as jerrors
from pim_sort_merge_join_tpu.engine import pipeline as jpipeline
from pim_sort_merge_join_tpu.ops import filter as jfilter
from pim_sort_merge_join_tpu.ops import join as jjoin
from pim_sort_merge_join_tpu.ops import sort as jsort
from pim_sort_merge_join_tpu.ops.pallas import sort_kernel as jbitonic
from pim_sort_merge_join_tpu_torch import EngineConfig, Predicate, QueryPipeline
from pim_sort_merge_join_tpu_torch.columnar import csv_io
from pim_sort_merge_join_tpu_torch.convert import config_from_reference, table_from_reference
from pim_sort_merge_join_tpu_torch.engine import pipeline as pipeline_mod
from pim_sort_merge_join_tpu_torch.engine.errors import JoinOverflowError
from pim_sort_merge_join_tpu_torch.ops import filter as filter_ops
from pim_sort_merge_join_tpu_torch.ops import join as join_ops
from pim_sort_merge_join_tpu_torch.ops import kernels, oracle
from pim_sort_merge_join_tpu_torch.ops import sort as sort_ops
from tests.conftest import make_reference_like_tables

ALGORITHMS = ["auto", "xla", "hbm_pallas", "hbm_adaptive", "pallas_bitonic"]


def _port(jt):
    return table_from_reference(np.asarray(jt.data), int(jt.num_rows), jt.names, device="cpu")


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


def _jtable(rows, capacity=None):
    return smj.Table.from_numpy(rows, capacity=capacity, dtype=rows.dtype)


# --- filter -----------------------------------------------------------------


@pytest.mark.parametrize(
    "pred,capacity,dtype",
    [((0, ">", 9), None, np.int64), ((1, "<=", 0), 512, np.int64), ((0, ">", 10**9), 400, np.int64),
     ((2, "!=", 5), None, np.int32), ((0, ">=", 0), 300, np.int64)],
)
def test_apply_filter_whole_buffer_matches_reference(pred, capacity, dtype):
    rows = _dup_rows(np.random.default_rng(81), 300, dtype=dtype)
    jt = _jtable(rows, capacity)
    want = jfilter.apply_filter(jt, smj.Predicate(*pred))
    got = filter_ops.apply_filter(_port(jt), Predicate(*pred))
    _assert_same(got, want)


def test_compact_arbitrary_mask_matches_reference():
    rng = np.random.default_rng(82)
    jt = _jtable(_dup_rows(rng, 257), capacity=320)
    mask = rng.random(320) < 0.4
    want = jfilter.compact(jt, np.asarray(mask))
    _assert_same(filter_ops.compact(_port(jt), torch.from_numpy(mask)), want)


# --- sort_by_key -------------------------------------------------------------


@pytest.mark.parametrize("narrow", [False, True])
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_sort_by_key_matches_reference(algorithm, narrow):
    rng = np.random.default_rng(83)
    rows = _dup_rows(rng, 700, key_hi=90)
    rows[::5, 0] = rng.integers(-(2**31), 2**31 - 1, rows[::5, 0].shape)
    jt = _jtable(rows, capacity=900)
    want = jsort.sort_by_key(jt, 0, algorithm="xla", narrow=narrow)
    _assert_same(sort_ops.sort_by_key(_port(jt), 0, algorithm=algorithm, narrow=narrow), want)


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_sort_by_key_int32_table_and_other_column(algorithm):
    rows = _dup_rows(np.random.default_rng(84), 500, dtype=np.int32)
    jt = _jtable(rows, capacity=512)
    want = jsort.sort_by_key(jt, 2, algorithm="xla")
    _assert_same(sort_ops.sort_by_key(_port(jt), 2, algorithm=algorithm), want)


def _jax_bitonic_interpret(monkeypatch):
    """Run the JAX bitonic path with its Pallas kernel in interpret mode."""
    monkeypatch.setattr(
        jbitonic, "sort_pairs_pallas",
        functools.partial(jbitonic.sort_pairs_pallas, interpret=True),
    )


def test_pallas_bitonic_clips_wide_keys_like_the_reference(monkeypatch):
    """64-bit keys outside int32 sort on their values clipped to int32: the
    JAX package's behaviour (ops/sort.py, "pallas_bitonic"), copied."""
    _jax_bitonic_interpret(monkeypatch)
    rng = np.random.default_rng(85)
    rows = _dup_rows(rng, 300, key_hi=50)
    rows[:40, 0] = rng.integers(2**31, 2**40, 40)   # clip to INT32_MAX
    rows[40:80, 0] = rng.integers(-(2**40), -(2**31), 40)  # clip to INT32_MIN
    jt = _jtable(rows, capacity=384)
    want = jsort.sort_by_key(jt, 0, algorithm="pallas_bitonic")
    got = sort_ops.sort_by_key(_port(jt), 0, algorithm="pallas_bitonic")
    _assert_same(got, want)
    clipped = np.clip(rows[:, 0], -(2**31), 2**31 - 1)
    np.testing.assert_array_equal(got.to_numpy(), rows[np.argsort(clipped, kind="stable")])
    exact = sort_ops.sort_by_key(_port(jt), 0, algorithm="auto")
    assert not torch.equal(got.data, exact.data)


def test_pallas_bitonic_matches_reference_bitonic_interpret(monkeypatch):
    _jax_bitonic_interpret(monkeypatch)
    jt = _jtable(_dup_rows(np.random.default_rng(86), 600, key_hi=40), capacity=700)
    want = jsort.sort_by_key(jt, 0, algorithm="pallas_bitonic")
    _assert_same(sort_ops.sort_by_key(_port(jt), 0, algorithm="pallas_bitonic"), want)


def test_sorted_keys_and_unknown_algorithm():
    jt = _jtable(_dup_rows(np.random.default_rng(87), 50), capacity=64)
    s = jsort.sort_by_key(jt, 0, algorithm="xla")
    np.testing.assert_array_equal(
        sort_ops.sorted_keys(_port(s), 0).numpy(), np.asarray(jsort.sorted_keys(s, 0))
    )
    with pytest.raises(ValueError, match="unknown sort algorithm"):
        sort_ops.sort_by_key(_port(jt), 0, algorithm="bogus")


# --- inner join ----------------------------------------------------------------


def _sorted_pair(name, rng):
    """JAX tables (t1, t2), each sorted on its key, and key2."""
    if name == "duplicates":
        r1, r2, cap1, cap2, key2 = _dup_rows(rng, 300), _dup_rows(rng, 300), 384, 320, 0
    elif name == "cap1_lt_cap2":
        r1, r2, cap1, cap2, key2 = _dup_rows(rng, 100), _dup_rows(rng, 400), None, 512, 0
    elif name == "key2_col2":
        r1, r2 = _dup_rows(rng, 200), _dup_rows(rng, 250)
        r2[:, 2] = rng.integers(0, 20, 250)
        cap1, cap2, key2 = 256, None, 2
    elif name == "no_matches":
        r1, r2, cap1, cap2, key2 = _dup_rows(rng, 100), _dup_rows(rng, 100) + 100, None, None, 0
    elif name == "unique_keys":
        r1, r2 = make_reference_like_tables(rng, 400)
        cap1, cap2, key2 = 450, None, 0
    elif name == "int32":
        r1, r2 = _dup_rows(rng, 200, dtype=np.int32), _dup_rows(rng, 200, dtype=np.int32)
        cap1, cap2, key2 = None, 256, 0
    else:
        raise AssertionError(name)
    t1 = jsort.sort_by_key(_jtable(r1, cap1), 0, algorithm="xla")
    t2 = jsort.sort_by_key(_jtable(r2, cap2), key2, algorithm="xla")
    return t1, t2, key2


INNER_CASES = ["duplicates", "cap1_lt_cap2", "key2_col2", "no_matches", "unique_keys", "int32"]


@pytest.mark.parametrize("out_capacity", [None, 4096])
@pytest.mark.parametrize("name", INNER_CASES)
def test_merge_join_inner_matches_reference(name, out_capacity):
    t1, t2, key2 = _sorted_pair(name, np.random.default_rng(88))
    want = jjoin.merge_join_inner(t1, t2, 0, key2, out_capacity=out_capacity)
    got = join_ops.merge_join_inner(_port(t1), _port(t2), 0, key2, out_capacity=out_capacity)
    _assert_same(got, want)


@pytest.mark.parametrize("out_capacity", [0, 1, 16, 300])
def test_merge_join_inner_overflow_reports_true_count(out_capacity):
    t1, t2, _ = _sorted_pair("duplicates", np.random.default_rng(89))
    want = jjoin.merge_join_inner(t1, t2, 0, 0, out_capacity=out_capacity)
    got = join_ops.merge_join_inner(_port(t1), _port(t2), 0, 0, out_capacity=out_capacity)
    _assert_same(got, want)
    assert int(got.num_rows) > out_capacity == got.capacity


@pytest.mark.parametrize("name", ["duplicates", "key2_col2", "unique_keys"])
def test_match_info_and_run_starts_match_reference(name):
    t1, t2, key2 = _sorted_pair(name, np.random.default_rng(90))
    want = jjoin._match_info(t1, t2, 0, key2)
    got = join_ops._match_info(_port(t1), _port(t2), 0, key2)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    keys = np.array(t1.masked_keys(0))
    np.testing.assert_array_equal(
        join_ops._run_starts(torch.from_numpy(keys)).numpy(),
        np.asarray(jjoin._run_starts(keys)),
    )


def test_merge_join_dispatch_matches_reference():
    t1, t2, _ = _sorted_pair("duplicates", np.random.default_rng(91))
    p1, p2 = _port(t1), _port(t2)
    for kw in ({"mode": "inner", "out_capacity": 1000}, {"mode": "one_to_one"},
               {"mode": "one_to_one", "presorted": False}):
        _assert_same(join_ops.merge_join(p1, p2, 0, 0, **kw), jjoin.merge_join(t1, t2, 0, 0, **kw))
    with pytest.raises(ValueError, match="key-sorted"):
        join_ops.merge_join(p1, p2, 0, 0, mode="inner", presorted=False)
    with pytest.raises(ValueError, match="unknown join mode"):
        join_ops.merge_join(p1, p2, 0, 0, mode="outer")


# --- the staged query --------------------------------------------------------


def _inner_configs(port_sort, **kw):
    ref = smj.EngineConfig(join_mode="inner", sort_algorithm="xla", **kw)
    port = config_from_reference(ref)
    return ref, EngineConfig(**{**_fields(port), "sort_algorithm": port_sort})


def _fields(cfg):
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}


# Keys past int32 sort on clipped values under "pallas_bitonic" (see
# test_pallas_bitonic_clips_wide_keys_like_the_reference), so the wide-key
# query runs with the hbm_sort table sorts only.
RUN_TABLES_CASES = [
    (kind, port_sort)
    for kind in ["reference_like", "duplicates", "wide_keys", "narrow_off", "int32", "slack",
                 "wide_tables"]
    for port_sort in ["auto", "pallas_bitonic"]
    if (kind, port_sort) != ("wide_keys", "pallas_bitonic")
]


@pytest.mark.parametrize("kind,port_sort", RUN_TABLES_CASES)
def test_run_tables_inner_matches_reference(kind, port_sort):
    rng = np.random.default_rng(92)
    preds = dict(predicate1=smj.Predicate(0, ">", 40), predicate2=smj.Predicate(0, ">", 40))
    cap1 = cap2 = None
    if kind == "reference_like":
        r1, r2 = make_reference_like_tables(rng, 1000, key_range=700 * 3)
        kw, cap1 = preds, 1100
    elif kind == "duplicates":
        r1, r2 = _dup_rows(rng, 300, key_hi=400), _dup_rows(rng, 260, key_hi=400)
        kw, cap2 = dict(predicate1=smj.Predicate(1, ">", -500), predicate2=smj.Predicate(0, ">", 3)), 300
    elif kind == "wide_keys":
        r1, r2 = _dup_rows(rng, 300, key_hi=1000), _dup_rows(rng, 300, key_hi=1000)
        r1[:, 0] += 2**40
        r2[:, 0] += 2**40
        kw = dict(predicate1=smj.Predicate(0, ">", 2**40 + 10), predicate2=smj.Predicate(0, ">", 2**40))
    elif kind == "narrow_off":
        r1, r2 = _dup_rows(rng, 300, key_hi=1000), _dup_rows(rng, 300, key_hi=1000)
        kw = dict(preds, narrow_keys=False, narrow_data=False)
    elif kind == "int32":
        r1, r2 = _dup_rows(rng, 300, 1000, np.int32), _dup_rows(rng, 300, 1000, np.int32)
        kw = dict(preds, dtype="int32")
    elif kind == "wide_tables":  # rows of 80 and 136 bytes: past what one row-gather launch reads
        r1, r2 = _dup_rows(rng, 300, key_hi=400), _dup_rows(rng, 260, key_hi=400)
        r1 = np.column_stack([r1, rng.integers(-(2**40), 2**40, (300, 6))])
        r2 = np.column_stack([r2, rng.integers(-(2**40), 2**40, (260, 13))])
        kw = preds
    else:  # slack: the output capacity is join_slack x table-1 capacity
        r1, r2 = _dup_rows(rng, 200, key_hi=60), _dup_rows(rng, 200, key_hi=60)
        kw = dict(preds, join_slack=12.0)
    ref_cfg, port_cfg = _inner_configs(port_sort, **kw)
    jt1, jt2 = _jtable(r1, cap1), _jtable(r2, cap2)
    jpipe = smj.QueryPipeline(ref_cfg)
    want = jpipe.run_tables(jt1, jt2)
    pipe = QueryPipeline(port_cfg, device="cpu")
    got = pipe.run_tables(_port(jt1), _port(jt2))
    _assert_same(got, want)
    assert int(got.num_rows) > 0
    assert pipe.resolved_narrow_keys is jpipe.resolved_narrow_keys
    assert pipe.resolved_narrow_data is jpipe.resolved_narrow_data
    np.testing.assert_array_equal(
        got.to_numpy(),
        oracle.join_inner_oracle(
            oracle.sort_oracle(oracle.filter_oracle(r1, *_pred(port_cfg.predicate1)), 0),
            oracle.sort_oracle(oracle.filter_oracle(r2, *_pred(port_cfg.predicate2)), 0),
            0, 0,
        ).astype(r1.dtype),
    )


def _pred(p):
    return p.col, p.op, p.value


@pytest.mark.parametrize("port_sort", ["auto", "pallas_bitonic"])
@pytest.mark.parametrize("kind", ["all_filtered_out", "no_valid_rows"])
def test_run_tables_inner_empty_results_match_reference(kind, port_sort):
    rows = _dup_rows(np.random.default_rng(97), 50)
    if kind == "all_filtered_out":
        r1 = r2 = rows
        kw = dict(predicate1=smj.Predicate(0, ">", 10**9))
        cap = None
    else:  # capacity without rows; the narrow probe needs data, so it is off
        r1 = r2 = rows[:0]
        kw = dict(narrow_keys=False, narrow_data=False)
        cap = 8
    ref_cfg, port_cfg = _inner_configs(port_sort, **kw)
    jt1, jt2 = _jtable(r1, cap), _jtable(r2, cap)
    want = smj.QueryPipeline(ref_cfg).run_tables(jt1, jt2)
    got = QueryPipeline(port_cfg, device="cpu").run_tables(_port(jt1), _port(jt2))
    _assert_same(got, want)
    assert int(got.num_rows) == 0


def test_pipeline_core_inner_matches_reference():
    rng = np.random.default_rng(93)
    r1, r2 = _dup_rows(rng, 300, key_hi=100), _dup_rows(rng, 280, key_hi=100)
    ref_cfg, port_cfg = _inner_configs("auto", narrow_keys=True, narrow_data=False)
    jt1, jt2 = _jtable(r1, 320), _jtable(r2)
    want = jpipeline.pipeline_core(jt1, jt2, ref_cfg)
    _assert_same(pipeline_mod.pipeline_core(_port(jt1), _port(jt2), port_cfg), want)


@pytest.mark.parametrize("port_sort", ["auto", "pallas_bitonic"])
def test_run_csv_inner_byte_identical_to_reference(tmp_path, port_sort):
    rng = np.random.default_rng(94)
    r1, r2 = _dup_rows(rng, 2000, key_hi=5000), _dup_rows(rng, 1800, key_hi=5000)
    r1[:, 1:], r2[:, 1:] = np.abs(r1[:, 1:]), np.abs(r2[:, 1:])
    p1, p2 = str(tmp_path / "d1.csv"), str(tmp_path / "d2.csv")
    csv_io.write_csv(p1, r1)
    csv_io.write_csv(p2, r2)
    ref_cfg, port_cfg = _inner_configs(
        port_sort, predicate1=smj.Predicate(0, ">", 100), predicate2=smj.Predicate(0, ">", 100)
    )
    o_ref, o_port = str(tmp_path / "ref.csv"), str(tmp_path / "port.csv")
    smj.QueryPipeline(ref_cfg).run_csv(p1, p2, o_ref)
    res = QueryPipeline(port_cfg, device="cpu").run_csv(p1, p2, o_port)
    with open(o_ref, "rb") as f_ref, open(o_port, "rb") as f_port:
        assert f_port.read() == f_ref.read()
    assert int(res.num_rows) > 0


@pytest.mark.parametrize("join_slack", [0.5, 1.0])
def test_inner_overflow_raises_when_the_reference_does(join_slack):
    rng = np.random.default_rng(95)
    r1, r2 = _dup_rows(rng, 300), _dup_rows(rng, 300)
    ref_cfg, port_cfg = _inner_configs(
        "auto", join_slack=join_slack, predicate1=smj.Predicate(0, ">=", 0),
        predicate2=smj.Predicate(0, ">=", 0),
    )
    with pytest.raises(jerrors.JoinOverflowError) as ref_err:
        smj.QueryPipeline(ref_cfg).run_tables(_jtable(r1), _jtable(r2))
    with pytest.raises(JoinOverflowError) as port_err:
        QueryPipeline(port_cfg, device="cpu").run_tables(
            _port(_jtable(r1)), _port(_jtable(r2))
        )
    assert port_err.value.true_rows == ref_err.value.true_rows
    assert port_err.value.capacity == ref_err.value.capacity == int(300 * join_slack)


def test_staged_configs_construct_and_carry_across():
    for kw in ({"join_mode": "inner"}, {"sort_algorithm": "pallas_bitonic"},
               {"join_mode": "inner", "sort_algorithm": "pallas_bitonic", "join_slack": 2.5}):
        ref = smj.EngineConfig(**kw)
        cfg = config_from_reference(ref)
        assert cfg == EngineConfig(**kw)
        for name, value in kw.items():
            assert getattr(cfg, name) == value
    hashed = config_from_reference(smj.EngineConfig(join_algorithm="hash", join_mode="inner"))
    assert hashed == EngineConfig(join_algorithm="hash", join_mode="inner")
    assert (hashed.join_algorithm, hashed.join_mode) == ("hash", "inner")


def test_staged_plain_path_launches_no_kernel():
    rng = np.random.default_rng(96)
    kernels.reset_launch_counts()
    QueryPipeline(EngineConfig(join_mode="inner", sort_algorithm="pallas_bitonic"), device="cpu").run_tables(
        _port(_jtable(_dup_rows(rng, 100))), _port(_jtable(_dup_rows(rng, 100)))
    )
    assert all(n == 0 for n in kernels.launch_counts().values())
