"""Every table type of the JAX package through the port's plain path (CPU).

int32, int64, uint32, uint64, float32 and float64 tables: the JAX
package's `test_dtypes.py` cases through the port, every join path on every
type, the edge keys (±0.0, ±inf, NaN, subnormals, the uint64 extremes and
2**63 ± 1) through each function that compares keys, `hash_column` bit for
bit, `hash_aggregate`, `merge_sorted`, `run_csv`, `run_tables_resumable`
and checkpoints that resume across packages. The same seeded numpy inputs
go to both packages; results are compared whole (buffers with their
padding, `num_rows`, dtypes, bits) and exactly, except float sums of
`hash_aggregate` (within 1e-12 relative). Where the JAX package's result
differs and the port's is the right one, the test pins both (ROADMAP §3,
"Known behaviours").
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pim_sort_merge_join_tpu as smj
from pim_sort_merge_join_tpu.columnar import csv_io as jcsv
from pim_sort_merge_join_tpu.engine import checkpoint as jckpt
from pim_sort_merge_join_tpu.engine.errors import MalformedInputError as JMalformed
from pim_sort_merge_join_tpu.engine.pipeline import pipeline_core as jcore
from pim_sort_merge_join_tpu.ops import filter as jfilter
from pim_sort_merge_join_tpu.ops import hash_join as jhash
from pim_sort_merge_join_tpu.ops import merge as jmerge
from pim_sort_merge_join_tpu.ops import sort as jsort
from pim_sort_merge_join_tpu.ops.pallas import sort_kernel as jbitonic
from pim_sort_merge_join_tpu_torch import EngineConfig, Predicate, QueryPipeline, Table
from pim_sort_merge_join_tpu_torch.columnar import csv_io, dtypes
from pim_sort_merge_join_tpu_torch.columnar.generate import generate_table
from pim_sort_merge_join_tpu_torch.convert import config_from_reference, table_from_reference
from pim_sort_merge_join_tpu_torch.engine import checkpoint as pckpt
from pim_sort_merge_join_tpu_torch.engine.errors import MalformedInputError
from pim_sort_merge_join_tpu_torch.engine.pipeline import pipeline_core
from pim_sort_merge_join_tpu_torch.ops import filter as pfilter
from pim_sort_merge_join_tpu_torch.ops import hash_join as phash
from pim_sort_merge_join_tpu_torch.ops import merge as pmerge
from pim_sort_merge_join_tpu_torch.ops import oracle
from pim_sort_merge_join_tpu_torch.ops import sort as psort
from pim_sort_merge_join_tpu_torch.utils import validate
from tests.conftest import make_reference_like_tables

TYPES = ["int32", "int64", "uint32", "uint64", "float32", "float64"]
FLOATS = ["float32", "float64"]
PATHS = {
    "fused": {},
    "inner": {"join_mode": "inner", "join_slack": 4.0},
    "hash": {"join_algorithm": "hash"},
    "hash_inner": {"join_algorithm": "hash", "join_mode": "inner", "join_slack": 4.0},
}
HI = 2**63


def _port(jt):
    return table_from_reference(np.asarray(jt.data), int(jt.num_rows), jt.names, device="cpu")


def _bytes(a) -> bytes:
    return np.ascontiguousarray(np.asarray(a)).tobytes()


def _assert_same(got, want):
    """Whole buffers bit for bit (so -0.0 and NaN payloads count), `num_rows`, names."""
    want_data = np.asarray(want.data)
    assert got.data.numpy().dtype == want_data.dtype
    assert got.data.shape == want_data.shape
    assert _bytes(got.data.numpy()) == _bytes(want_data)
    assert got.num_rows.dtype == torch.int32 and int(got.num_rows) == int(want.num_rows)
    assert got.names == want.names


def _valid_rows(t):
    n = int(t.num_rows)
    return np.asarray(t.data)[:n] if not isinstance(t.data, torch.Tensor) else t.data.numpy()[:n]


def _typed(rows, dtype):
    """The reference tables in ``dtype``: uint64 keys pushed past 2**63, float
    keys off the integers (the JAX package's `test_dtypes.py` forms)."""
    if dtype == "uint64":
        u = rows.astype(np.uint64)
        u[:, 0] += np.uint64(HI)
        return u
    if dtype in FLOATS:
        return rows.astype(dtype) + np.dtype(dtype).type(0.5)
    return rows.astype(dtype)


def _threshold(dtype, value=100):
    return HI + value if dtype == "uint64" else value


def _jit_core(cfg):
    return jax.jit(functools.partial(jcore, config=cfg))


def _both(rows1, rows2, dtype, *, cap1=None):
    j1 = smj.Table.from_numpy(rows1, dtype=rows1.dtype, capacity=cap1)
    j2 = smj.Table.from_numpy(rows2, dtype=rows2.dtype)
    return j1, j2, _port(j1), _port(j2)


# --- the JAX package's test_dtypes.py cases -------------------------------------------


def test_int32_pipeline_matches_oracle(small_tables, tmp_path):
    r1, r2 = small_tables
    p1, p2 = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    csv_io.write_csv(p1, r1)
    csv_io.write_csv(p2, r2)
    cfg = EngineConfig(predicate1=Predicate(0, ">", 100), predicate2=Predicate(0, ">", 100),
                       dtype="int32")
    out = QueryPipeline(cfg, device="cpu").run_csv(p1, p2, str(tmp_path / "r.csv"))
    want = oracle.pipeline_oracle(r1, r2, pred1=(0, ">", 100), pred2=(0, ">", 100))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.to_numpy().astype(np.int64), want)
    np.testing.assert_array_equal(csv_io.load_csv_numpy(str(tmp_path / "r.csv")), want)


@pytest.mark.parametrize("dtype, bad", [("int32", 2**40), ("int32", -(2**31) - 1),
                                        ("uint32", -1), ("uint32", 2**32)])
def test_narrow_overflowing_input_raises_like_the_reference(tmp_path, dtype, bad):
    rows = np.array([[bad, 1], [5, 2]], dtype=np.int64)
    p = str(tmp_path / "big.csv")
    csv_io.write_csv(p, rows)
    with pytest.raises(MalformedInputError, match=dtype) as got:
        QueryPipeline(EngineConfig(dtype=dtype), device="cpu").run_csv(p, p)
    with pytest.raises(JMalformed, match=dtype) as want:
        smj.QueryPipeline(smj.EngineConfig(dtype=dtype)).run_csv(p, p)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("dtype", TYPES)
def test_pipeline_matches_oracle_and_reference(small_tables, dtype):
    """`test_float64_pipeline_matches_oracle` and
    `test_uint64_pipeline_matches_oracle` of the JAX package, for every type."""
    r1, r2 = (_typed(r, dtype) for r in small_tables)
    thr = _threshold(dtype)
    ref = smj.EngineConfig(predicate1=smj.Predicate(0, ">", thr),
                           predicate2=smj.Predicate(0, ">", thr), dtype=dtype)
    j1, j2, p1, p2 = _both(r1, r2, dtype)
    got = pipeline_core(p1, p2, config_from_reference(ref))
    want = oracle.pipeline_oracle(r1, r2, pred1=(0, ">", thr), pred2=(0, ">", thr))
    assert got.to_numpy().dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got.to_numpy(), want)
    _assert_same(got, _jit_core(ref)(j1, j2))


# --- every join path on every type --------------------------------------------------------


def _dup_typed(rng, n, dtype, key_hi=40):
    rows = np.column_stack([rng.integers(0, key_hi, n), rng.integers(1, 900, (n, 3))])
    return _typed(rows, dtype)


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("dtype", TYPES)
def test_every_path_on_every_type_matches_reference(dtype, path):
    rng = np.random.default_rng(TYPES.index(dtype) * 10 + sorted(PATHS).index(path))
    r1, r2 = _dup_typed(rng, 150, dtype), _dup_typed(rng, 130, dtype)
    thr = _threshold(dtype, 3)
    ref = smj.EngineConfig(predicate1=smj.Predicate(0, ">", thr),
                           predicate2=smj.Predicate(0, ">", thr), dtype=dtype, **PATHS[path])
    j1, j2, p1, p2 = _both(r1, r2, dtype, cap1=170)
    _assert_same(pipeline_core(p1, p2, config_from_reference(ref)), _jit_core(ref)(j1, j2))


@pytest.mark.parametrize("dtype", TYPES)
def test_run_csv_bytes_match_reference(tmp_path, dtype):
    """Both packages parse integers and cast (`atoi`), and write the same bytes."""
    rows = make_reference_like_tables(np.random.default_rng(5), 300)
    paths = [str(tmp_path / f"d{i}.csv") for i in (1, 2)]
    for p, r in zip(paths, rows):
        jcsv.write_csv(p, r)
    ref = smj.EngineConfig(predicate1=smj.Predicate(0, ">", 200),
                           predicate2=smj.Predicate(0, ">", 200), dtype=dtype)
    want = smj.QueryPipeline(ref).run_csv(*paths, str(tmp_path / "j.csv"))
    pipe = QueryPipeline(config_from_reference(ref), device="cpu")
    got = pipe.run_csv(*paths, str(tmp_path / "p.csv"))
    _assert_same(got, want)
    assert (tmp_path / "p.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    assert pipe.resolved_narrow_keys is (dtype in ("int64", "uint64"))


@pytest.mark.parametrize("dtype", ["int32", "uint32", "float32", "float64"])
def test_run_tables_on_tables_of_another_type_match_the_reference(dtype):
    """`EngineConfig()` (int64, narrow flags "auto") on tables of another
    type: the rows are the JAX package's. The flags differ and narrow
    nothing on either side: the JAX package probes the tables, the port
    resolves "auto" to False unprobed, as its `run_csv` does, since it
    narrows no type but int64 and uint64."""
    # Keys above the default predicate's 5000 for most rows.
    rows = [(generate_table(500, seed=s) + [4800, 0, 0, 0]).astype(dtype) for s in (1, 2)]
    jpipe = smj.QueryPipeline(smj.EngineConfig())
    want = jpipe.run_tables(*(smj.Table.from_numpy(r, dtype=r.dtype) for r in rows))
    pipe = QueryPipeline(EngineConfig(), device="cpu")
    got = pipe.run_tables(*(Table.from_numpy(r, dtype=r.dtype, device="cpu") for r in rows))
    _assert_same(got, want)
    assert int(got.num_rows) > 0
    assert (pipe.resolved_narrow_keys, pipe.resolved_narrow_data) == (False, False)
    assert (jpipe.resolved_narrow_keys, jpipe.resolved_narrow_data) == (True, True)


# --- the table model and config ----------------------------------------------------------


@pytest.mark.parametrize("dtype", TYPES)
def test_table_model_matches_reference(dtype):
    rows = _typed(make_reference_like_tables(np.random.default_rng(2), 40)[0], dtype)
    jt = smj.Table.from_numpy(rows, capacity=50, dtype=dtype)
    t = Table.from_numpy(rows, capacity=50, dtype=dtype, device="cpu")
    assert t.dtype == dtypes.TORCH_DTYPES[dtype]
    _assert_same(t, jt)
    assert _bytes(t.masked_keys(0).numpy()) == _bytes(jt.masked_keys(0))
    assert _bytes(t.to_numpy()) == _bytes(jt.to_numpy())
    assert t.to_numpy().dtype == np.dtype(dtype)
    e, je = Table.empty(3, 7, dtype=dtype, device="cpu"), smj.Table.empty(3, 7, dtype=dtype)
    _assert_same(e, je)
    assert _bytes(t.with_capacity(60).data.numpy()) == _bytes(jt.with_capacity(60).data)
    sent = dtypes.key_sentinel(t.dtype)
    assert np.array(sent, dtype=dtype) == np.asarray(smj.columnar.table.key_sentinel(dtype))
    assert int(dtypes.order_key(torch.tensor([sent], dtype=t.dtype))[0]) == dtypes.order_max(t.dtype)


@pytest.mark.parametrize("dtype", TYPES)
def test_config_dtype_and_narrowing_match_reference(dtype):
    ref = smj.EngineConfig(dtype=dtype)
    cfg = config_from_reference(ref)
    assert cfg.dtype == dtype and cfg.torch_dtype() == dtypes.TORCH_DTYPES[dtype]
    assert cfg.narrowable() is ref.narrowable()
    for name in ("narrow_keys", "narrow_data"):
        if dtype in FLOATS:
            with pytest.raises(ValueError, match=name) as got:
                EngineConfig(dtype=dtype, **{name: True})
            with pytest.raises(ValueError, match=name) as want:
                smj.EngineConfig(dtype=dtype, **{name: True})
            assert str(got.value) == str(want.value)
        else:
            assert getattr(EngineConfig(dtype=dtype, **{name: True}), name) is True


def test_unknown_dtype_raises():
    with pytest.raises(ValueError, match="int16"):
        EngineConfig(dtype="int16")


def test_order_key_orders_every_type_and_inverts():
    for dtype in TYPES:
        if dtype in FLOATS:
            info = np.finfo(dtype)
            vals = np.array([-np.inf, info.min, -1.5, -info.tiny, -0.0, 0.0, info.tiny, 2.5,
                             info.max], dtype)
        else:
            info = np.iinfo(dtype)
            vals = np.array(sorted({info.min, info.min + 1, 0, 1, info.max // 2, info.max - 1}),
                            dtype)
        t = torch.from_numpy(vals)
        k = dtypes.order_key(t)
        assert k.dtype == dtypes.signed_of(t.dtype)
        assert bool((k[1:] >= k[:-1]).all())
        back = dtypes.from_order_key(k, t.dtype).numpy()
        np.testing.assert_array_equal(back, vals)  # -0.0 comes back as 0.0, equal
    f = torch.tensor([np.nan, -np.nan, np.inf, -0.0, 0.0], dtype=torch.float64)
    k = dtypes.order_key(f).tolist()
    assert k[0] == k[1] == k[2] == dtypes.order_max(torch.float64) and k[3] == k[4] == 0


# --- filters -----------------------------------------------------------------------------


def _edge_floats(dtype):
    info = np.finfo(dtype)
    return np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.5, -1.5, 2.0, info.max, info.min,
                     info.tiny, -info.tiny], dtype)


def _edge_uint64():
    return np.array([0, 1, 2, HI - 1, HI, HI + 1, 2**64 - 2, 2**64 - 1, 12345], np.uint64)


@pytest.mark.parametrize("op", [">", ">=", "<", "<=", "==", "!="])
@pytest.mark.parametrize("dtype", FLOATS + ["uint64", "uint32"])
def test_predicate_mask_on_edge_values_matches_reference(dtype, op):
    if dtype in FLOATS:
        sub = np.nextafter(np.dtype(dtype).type(0), np.dtype(dtype).type(1))
        vals, values = np.append(_edge_floats(dtype), [sub, -sub]), [0, 2, -1]
    elif dtype == "uint64":
        vals, values = _edge_uint64(), [0, HI, HI + 1, 2**64 - 1, 2**63 + 100]
    else:
        vals, values = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], np.uint32), [0, 2**31]
    rows = np.column_stack([vals, vals])
    jt = smj.Table.from_numpy(rows, dtype=dtype, capacity=len(vals) + 2)
    for v in values:
        want = np.asarray(jfilter.predicate_mask(jt, smj.Predicate(0, op, v)))
        got = pfilter.predicate_mask(_port(jt), Predicate(0, op, v)).numpy()
        if dtype in FLOATS:
            # XLA on the CPU (and the TPU) takes subnormals as zero; the port
            # compares them as IEEE values, like numpy (ROADMAP §3). Every
            # other value, the smallest normal `tiny` included, agrees.
            sub = np.zeros(len(got), bool)
            sub[: len(vals)] = (vals != 0) & (np.abs(vals) < np.finfo(dtype).tiny)
            assert sub.sum() == 2
            np.testing.assert_array_equal(got[~sub], want[~sub])
            ieee = {">": np.greater, ">=": np.greater_equal, "<": np.less, "<=": np.less_equal,
                    "==": np.equal, "!=": np.not_equal}[op](vals, vals.dtype.type(v))
            np.testing.assert_array_equal(got[: len(vals)], ieee)
            if op == "==" and v == 0:  # the divergence itself, pinned
                assert want[sub].all() and not got[sub].any()
        else:
            np.testing.assert_array_equal(got, want)


def test_filter_and_compaction_keep_bits():
    vals = _edge_floats(np.float64)
    rows = np.column_stack([vals, -vals])
    jt = smj.Table.from_numpy(rows, dtype=np.float64, capacity=16)
    p = smj.Predicate(1, "!=", 7)
    want = jfilter.apply_filter(jt, p)
    got = pfilter.apply_filter(_port(jt), Predicate(1, "!=", 7))
    _assert_same(got, want)


# --- the sort seam ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", TYPES)
def test_stable_key_sort_matches_lax_sort_without_nan(dtype):
    rng = np.random.default_rng(7)
    if dtype in FLOATS:
        pool = _edge_floats(dtype)
        pool = pool[~np.isnan(pool)]
        keys = rng.choice(pool, 300)
    elif dtype == "uint64":
        keys = rng.choice(_edge_uint64(), 300)
    else:
        info = np.iinfo(dtype)
        keys = rng.choice(np.array([info.min, 0, 1, info.max - 1, info.max, 77], dtype), 300)
    payload = rng.integers(-9, 9, 300).astype(dtype if dtype in FLOATS else np.int64)
    want = jax.lax.sort((jnp.asarray(keys), jnp.asarray(payload)), num_keys=1, is_stable=True)
    got = psort.stable_key_sort((torch.from_numpy(keys), torch.from_numpy(payload)))
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        assert _bytes(g.numpy()) == _bytes(w)


@pytest.mark.parametrize("dtype", TYPES)
def test_stable_key_sort_rows_with_key_returns_the_keys_bits(dtype):
    """The row sort that also returns its key (the hash joins' sort) maps
    the key to its order key in the sort seam and gives back the key's own
    bits: -0.0 stays -0.0. Without NaN it is `jax.lax.sort` of the key with
    its position and the rows."""
    rng = np.random.default_rng(17)
    if dtype in FLOATS:
        pool = _edge_floats(dtype)
        pool = pool[~np.isnan(pool)]
    elif dtype == "uint64":
        pool = _edge_uint64()
    else:
        info = np.iinfo(dtype)
        pool = np.array([info.min, 0, 1, info.max - 1, info.max, 77], dtype)
    keys = rng.choice(pool, 200)
    rows = np.column_stack([keys, rng.integers(0, 9, (200, 2)).astype(keys.dtype)])
    skey, perm, got_rows = psort.stable_key_sort_rows_with_key(torch.from_numpy(keys),
                                                               torch.from_numpy(rows))
    pos = np.arange(200, dtype=np.int32)
    wk, wp = jax.lax.sort((jnp.asarray(keys), jnp.asarray(pos)), num_keys=1, is_stable=True)
    assert skey.dtype == torch.from_numpy(keys).dtype and perm.dtype == torch.int32
    assert _bytes(skey.numpy()) == _bytes(wk)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(wp))
    assert _bytes(got_rows.numpy()) == _bytes(rows[np.asarray(wp)])


@pytest.mark.parametrize("dtype", FLOATS)
def test_stable_key_sort_ties_nan_with_inf(dtype):
    """NaN keys order as +inf (the sentinel), by position; the JAX package
    puts them after +inf. The keys come back bit for bit (ROADMAP §3)."""
    keys = np.array([np.nan, 1.0, np.inf, -0.0, np.nan, 0.0, -np.inf], dtype)
    pos = np.arange(len(keys), dtype=np.int32)
    got_k, got_p = psort.stable_key_sort((torch.from_numpy(keys), torch.from_numpy(pos)))
    assert got_p.tolist() == [6, 3, 5, 1, 0, 2, 4]
    assert _bytes(got_k.numpy()) == _bytes(keys[got_p.numpy()])
    _, want_p = jax.lax.sort((jnp.asarray(keys), jnp.asarray(pos)), num_keys=1, is_stable=True)
    assert np.asarray(want_p).tolist() == [6, 3, 5, 1, 2, 0, 4]
    no_nan = np.where(np.isnan(keys), np.inf, keys)
    _, want_p = jax.lax.sort((jnp.asarray(no_nan), jnp.asarray(pos)), num_keys=1, is_stable=True)
    assert np.asarray(want_p).tolist() == got_p.tolist()


@pytest.mark.parametrize("dtype", TYPES)
def test_sort_by_key_matches_reference_without_nan(dtype):
    rng = np.random.default_rng(8)
    r = _dup_typed(rng, 90, dtype, key_hi=12)
    if dtype in FLOATS:
        r[:, 0] = rng.choice(_edge_floats(dtype)[[0, 1, 2, 3, 5, 6]], 90)
    jt = smj.Table.from_numpy(r, dtype=dtype, capacity=100)
    _assert_same(psort.sort_by_key(_port(jt), 0), jsort.sort_by_key(jt, 0, algorithm="xla"))


@pytest.mark.parametrize("dtype", FLOATS)
def test_sort_by_key_keeps_nan_rows_inside_the_table(dtype):
    """The JAX package sorts NaN after its +inf padding sentinel, so its
    sorted table holds padding rows below `num_rows` and its NaN rows past
    it; the port ties NaN with +inf, and the valid rows stay the valid
    rows (ROADMAP §3)."""
    rng = np.random.default_rng(9)
    r = np.column_stack([rng.choice(_edge_floats(dtype), 60), np.arange(60)]).astype(dtype)
    jt = smj.Table.from_numpy(r, dtype=dtype, capacity=70)
    got = psort.sort_by_key(_port(jt), 0)
    want = jsort.sort_by_key(jt, 0, algorithm="xla")
    n = int(got.num_rows)
    assert sorted(got.data.numpy()[:n, 1].tolist()) == list(range(60))
    assert sorted(np.asarray(want.data)[:n, 1].tolist()) != list(range(60))
    # Apart from the NaN rows the order is the JAX package's.
    rows = got.data.numpy()[:n]
    finite = r[~np.isnan(r[:, 0])]
    want_finite = jsort.sort_by_key(smj.Table.from_numpy(finite, dtype=dtype), 0, algorithm="xla")
    assert _bytes(rows[~np.isnan(rows[:, 0])]) == _bytes(_valid_rows(want_finite))


def test_pallas_bitonic_on_float_keys_clips_and_truncates_like_the_reference(monkeypatch):
    monkeypatch.setattr(jbitonic, "sort_pairs_pallas",
                        functools.partial(jbitonic.sort_pairs_pallas, interpret=True))
    rng = np.random.default_rng(10)
    for dtype in FLOATS:
        pool = np.concatenate([_edge_floats(dtype), np.array([2.7, -2.7, 3e9, -3e9], dtype)])
        r = np.column_stack([rng.choice(pool, 60), np.arange(60)]).astype(dtype)
        jt = smj.Table.from_numpy(r, dtype=dtype, capacity=64)
        want = jsort.sort_by_key(jt, 0, algorithm="pallas_bitonic")
        _assert_same(psort.sort_by_key(_port(jt), 0, algorithm="pallas_bitonic"), want)


@pytest.mark.parametrize("dtype", ["uint32", "uint64"])
def test_pallas_bitonic_on_unsigned_keys_sorts_where_the_reference_does_not(monkeypatch, dtype):
    """The JAX package clips unsigned keys with a negative lower bound that
    wraps, so every key becomes INT32_MAX and no row moves; the port clips
    by value and sorts (ROADMAP §3)."""
    monkeypatch.setattr(jbitonic, "sort_pairs_pallas",
                        functools.partial(jbitonic.sort_pairs_pallas, interpret=True))
    r = np.column_stack([np.array([9, 3, 2**31 + 5, 1, 0, 7]), np.arange(6)]).astype(dtype)
    jt = smj.Table.from_numpy(r, dtype=dtype, capacity=8)
    want = jsort.sort_by_key(jt, 0, algorithm="pallas_bitonic")
    got = psort.sort_by_key(_port(jt), 0, algorithm="pallas_bitonic")
    assert np.asarray(want.data)[:6, 1].tolist() == list(range(6))
    assert got.data.numpy()[:6, 1].tolist() == [4, 3, 1, 5, 0, 2]


# --- joins on edge keys -------------------------------------------------------------------


def _edge_table(rng, n, dtype, pool):
    rest = rng.integers(0 if np.dtype(dtype).kind == "u" else -5, 5, (n, 3)).astype(dtype)
    return np.column_stack([rng.choice(pool, n).astype(dtype), rest])


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("dtype", FLOATS)
@pytest.mark.parametrize("op", [">", "!="])
def test_float_edge_keys_join_like_the_reference(dtype, path, op):
    """±0.0 match each other, +inf and NaN match nothing: the rows equal the
    JAX package's. A `>` predicate drops NaN rows before the join; `!=`
    keeps them."""
    rng = np.random.default_rng(11 + FLOATS.index(dtype))
    pool = _edge_floats(dtype)
    pool = pool[np.abs(pool) != np.finfo(dtype).tiny]  # XLA flushes subnormals
    r1, r2 = _edge_table(rng, 40, dtype, pool), _edge_table(rng, 37, dtype, pool)
    pred = smj.Predicate(0, ">", -10**9) if op == ">" else smj.Predicate(1, "!=", 99)
    kw = {**PATHS[path], "join_slack": 30.0} if "inner" in path else PATHS[path]
    ref = smj.EngineConfig(predicate1=pred, predicate2=pred, dtype=dtype, **kw)
    j1, j2, p1, p2 = _both(r1, r2, dtype, cap1=45)
    got = pipeline_core(p1, p2, config_from_reference(ref))
    if path == "inner" and op == "!=":
        # The reference's staged table sort moves NaN rows past its padding
        # (see test_sort_by_key_keeps_nan_rows_inside_the_table), so padding
        # joins; without the NaN rows, which match nothing, it is right.
        no_nan = [np.where(np.isnan(r[:, 0])[:, None], np.float64(-7), r).astype(dtype)
                  for r in (r1, r2)]
        no_nan = [r[~np.isnan(o[:, 0])] for r, o in zip(no_nan, (r1, r2))]
        j1n, j2n = (smj.Table.from_numpy(r, dtype=dtype, capacity=45 if i == 0 else None)
                    for i, r in enumerate(no_nan))
        want = _jit_core(ref)(j1n, j2n)
        assert _bytes(_valid_rows(got)) == _bytes(_valid_rows(want))
        assert int(_jit_core(ref)(j1, j2).num_rows) != int(got.num_rows)
        return
    _assert_same(got, _jit_core(ref)(j1, j2))


@pytest.mark.parametrize("path", sorted(PATHS))
def test_uint64_extremes_join_like_the_reference(path):
    rng = np.random.default_rng(12)
    r1 = _edge_table(rng, 50, np.uint64, _edge_uint64())
    r2 = _edge_table(rng, 45, np.uint64, _edge_uint64())
    kw = {**PATHS[path], "join_slack": 30.0} if "inner" in path else PATHS[path]
    ref = smj.EngineConfig(predicate1=smj.Predicate(0, ">=", 0),
                           predicate2=smj.Predicate(0, "!=", 5), dtype="uint64", **kw)
    j1, j2, p1, p2 = _both(r1, r2, "uint64", cap1=52)
    _assert_same(pipeline_core(p1, p2, config_from_reference(ref)), _jit_core(ref)(j1, j2))


@pytest.mark.parametrize("dtype", ["uint64", "int64"])
def test_narrow_keys_on_8_byte_integers_resolve_and_match(dtype):
    r1, r2 = (r.astype(dtype) for r in make_reference_like_tables(np.random.default_rng(13), 120))
    ref = smj.EngineConfig(predicate1=smj.Predicate(0, ">", 30),
                           predicate2=smj.Predicate(0, ">", 30), dtype=dtype)
    j1, j2, p1, p2 = _both(r1, r2, dtype)
    jpipe, ppipe = smj.QueryPipeline(ref), QueryPipeline(config_from_reference(ref), device="cpu")
    want, got = jpipe.run_tables(j1, j2), ppipe.run_tables(p1, p2)
    _assert_same(got, want)
    assert ppipe.resolved_narrow_keys is jpipe.resolved_narrow_keys is True
    assert ppipe.resolved_narrow_data is jpipe.resolved_narrow_data is True
    if dtype == "uint64":
        r1[0, 0] = np.uint64(2**31 - 1)  # no longer below INT32_MAX
        j1, _, p1, _ = _both(r1, r2, dtype)
        jpipe.run_tables(j1, j2)
        ppipe.run_tables(p1, p2)
        assert ppipe.resolved_narrow_keys is jpipe.resolved_narrow_keys is False


# --- hashes ---------------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", TYPES)
def test_hash_column_bit_equal_to_reference(dtype):
    rng = np.random.default_rng(14)
    if dtype in FLOATS:
        vals = np.concatenate([_edge_floats(dtype), rng.standard_normal(2000).astype(dtype) * 1e6])
    else:
        info = np.iinfo(dtype)
        extremes = np.array([info.min, info.min + 1, 0, 1, info.max - 1, info.max], dtype)
        vals = np.concatenate([extremes, rng.integers(info.min, info.max, 2000, dtype=dtype,
                                                      endpoint=True)])
    want = np.asarray(jhash.hash_column(jnp.asarray(vals)))
    got = phash.hash_column(torch.from_numpy(vals))
    u = np.uint32 if want.dtype == np.uint32 else np.uint64
    sign = u(1) << u(8 * want.itemsize - 1)
    np.testing.assert_array_equal(got.numpy().view(u) ^ sign, want)
    assert phash.hash_column(torch.tensor([-0.0], dtype=torch.float64)).item() == \
        phash.hash_column(torch.tensor([0.0], dtype=torch.float64)).item()


def test_float32_hash_join_capacity_error_matches_reference():
    n = (1 << 24) + 1
    jt = smj.Table.empty(2, n, dtype=np.float32)
    pt = Table.empty(2, n, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="exact-integer") as want:
        jhash.hash_join(jt, jt, 0, 0)
    with pytest.raises(ValueError, match="exact-integer") as got:
        phash.hash_join(pt, pt, 0, 0)
    assert str(got.value) == str(want.value)


# --- hash_aggregate ------------------------------------------------------------------------


def _agg_rows(rng, n, dtype):
    keys = rng.integers(0, 25, n)
    vals = rng.standard_normal(n) * 1e3 if dtype in FLOATS else rng.integers(-900, 900, n)
    rows = np.column_stack([keys, vals])
    if dtype == "uint64":
        return (rows.astype(np.int64) + 1000).astype(np.uint64) + np.uint64(HI)
    if dtype == "uint32":
        return (rows.astype(np.int64) + 1000).astype(np.uint32)
    return rows.astype(dtype)


@pytest.mark.parametrize("agg", ["sum", "count", "min", "max"])
@pytest.mark.parametrize("dtype", TYPES)
def test_hash_aggregate_matches_reference(dtype, agg):
    rng = np.random.default_rng(15)
    rows = _agg_rows(rng, 400, dtype)
    jt = smj.Table.from_numpy(rows, dtype=dtype, capacity=420)
    got = phash.hash_aggregate(_port(jt), 0, 1, agg)
    validate.check_deterministic(lambda t: phash.hash_aggregate(t, 0, 1, agg), _port(jt))
    if dtype == "uint64":
        # The JAX package's aggregate cannot run on uint64: its `where` with
        # the Python int 2**64 - 1 overflows (ROADMAP §3). The numpy oracle.
        with pytest.raises(OverflowError):
            jhash.hash_aggregate(jt, 0, 1, agg)
        uniq, inv = np.unique(rows[:, 0], return_inverse=True)
        out = {"sum": np.zeros(len(uniq), np.uint64), "count": np.zeros(len(uniq), np.uint64),
               "min": np.full(len(uniq), 2**64 - 1, np.uint64),
               "max": np.zeros(len(uniq), np.uint64)}[agg]
        {"sum": np.add, "count": np.add, "min": np.minimum, "max": np.maximum}[agg].at(
            out, inv, np.uint64(1) if agg == "count" else rows[:, 1])
        n = len(uniq)
        assert int(got.num_rows) == n and got.dtype == torch.uint64
        np.testing.assert_array_equal(got.data.numpy()[:n], np.stack([uniq, out], axis=1))
        assert not got.data.numpy()[n:].any()
        return
    want = jhash.hash_aggregate(jt, 0, 1, agg)
    if dtype in FLOATS and agg == "sum":
        assert int(got.num_rows) == int(want.num_rows)
        np.testing.assert_array_equal(got.data.numpy()[:, 0], np.asarray(want.data)[:, 0])
        np.testing.assert_allclose(got.data.numpy()[:, 1], np.asarray(want.data)[:, 1],
                                   rtol=1e-12 if dtype == "float64" else 1e-6)
    else:
        _assert_same(got, want)


@pytest.mark.parametrize("dtype", FLOATS)
def test_hash_aggregate_keeps_inf_and_nan_groups(dtype):
    """±0.0 are one group, keyed as its last row's key, equal to the JAX
    package's. +inf and NaN groups: the JAX package gives its unused slots
    the largest finite key, so those groups sort behind them and their
    place below `num_rows` holds a zero row; the port keeps them
    (ROADMAP §3)."""
    keys = np.array([1.0, -0.0, np.inf, 0.0, np.nan, 1.0, -0.0, np.inf], dtype)
    rows = np.column_stack([keys, np.arange(1, 9)]).astype(dtype)
    jt = smj.Table.from_numpy(rows, dtype=dtype, capacity=12)
    want = jhash.hash_aggregate(jt, 0, 1, "sum")
    got = phash.hash_aggregate(_port(jt), 0, 1, "sum")
    n = int(got.num_rows)
    assert n == int(want.num_rows) == 4
    g = got.data.numpy()
    assert _bytes(g[:2]) == _bytes(np.asarray(want.data)[:2])  # -0.0 (2+4+7) and 1.0 (1+6)
    # The last two groups tie on the order key (the sentinel): hash order.
    tail = {("nan" if np.isnan(k) else k): v for k, v in g[2:4].tolist()}
    assert tail == {np.inf: 11.0, "nan": 5.0}
    assert np.asarray(want.data)[2:4].tolist() == [[0.0, 0.0], [0.0, 0.0]]


# --- merge ------------------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", TYPES)
def test_merge_sorted_matches_reference(dtype):
    rng = np.random.default_rng(16)
    runs = []
    for n in (30, 25):
        r = _dup_typed(rng, n, dtype, key_hi=15)
        if dtype in FLOATS:
            r[:, 0] = rng.choice(_edge_floats(dtype)[[0, 1, 2, 3, 5, 6, 7]], n)
        jt = jsort.sort_by_key(smj.Table.from_numpy(r, dtype=dtype, capacity=n + 3), 0,
                               algorithm="xla")
        runs.append(jt)
    want = jmerge.merge_sorted(*runs, 0)
    got = pmerge.merge_sorted(*(_port(t) for t in runs), 0)
    _assert_same(got, want)


def test_merge_int64_with_uint64_promotes_to_float64():
    a = smj.Table.from_numpy(np.array([[1, 2], [5, 6]], np.int64))
    b = smj.Table.from_numpy(np.array([[3, 4], [2**63 + 10, 8]], np.uint64), dtype=np.uint64)
    want = jmerge.merge_sorted(a, b, 0)
    got = pmerge.merge_sorted(_port(a), _port(b), 0)
    assert got.dtype == torch.float64
    _assert_same(got, want)


# --- checkpoints and the resumable run --------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float64", "uint64", "float32", "uint32"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_resume_across_packages(tmp_path, dtype, writer):
    r1, r2 = (_typed(r, dtype) for r in make_reference_like_tables(np.random.default_rng(17), 150))
    thr = _threshold(dtype)
    ref = smj.EngineConfig(predicate1=smj.Predicate(0, ">", thr),
                           predicate2=smj.Predicate(0, ">", thr), dtype=dtype,
                           checkpoint_dir=str(tmp_path))
    cfg = config_from_reference(ref)
    assert pckpt.config_fingerprint(cfg) == jckpt.config_fingerprint(ref)
    j1, j2, p1, p2 = _both(r1, r2, dtype)
    if writer == "jax":
        want = smj.QueryPipeline(ref).run_tables_resumable(j1, j2)
        zeros = Table.from_numpy(np.zeros_like(r1), dtype=dtype, device="cpu")
        got = QueryPipeline(cfg, device="cpu").run_tables_resumable(zeros, zeros)
    else:
        got = QueryPipeline(cfg, device="cpu").run_tables_resumable(p1, p2)
        zeros = smj.Table.from_numpy(np.zeros_like(r1), dtype=dtype)
        want = smj.QueryPipeline(ref).run_tables_resumable(zeros, zeros)
    _assert_same(got, want)
    assert got.dtype == dtypes.TORCH_DTYPES[dtype] and int(got.num_rows) > 0
