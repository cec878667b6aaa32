"""The port's table model, config, data generation and CSV I/O against the
JAX package: round-trips through `convert.py`, narrow-key resolution, and
identical bits from the same seed."""

import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pim_sort_merge_join_tpu.columnar import csv_io as jcsv
from pim_sort_merge_join_tpu.columnar import generate as jgen
from pim_sort_merge_join_tpu.columnar.table import Table as JTable
from pim_sort_merge_join_tpu.columnar.table import key_sentinel as jkey_sentinel
from pim_sort_merge_join_tpu.config import EngineConfig as JConfig
from pim_sort_merge_join_tpu.config import Predicate as JPredicate
from pim_sort_merge_join_tpu_torch import EngineConfig, Predicate, Table
from pim_sort_merge_join_tpu_torch.columnar import csv_io, generate
from pim_sort_merge_join_tpu_torch.columnar.table import key_sentinel
from pim_sort_merge_join_tpu_torch.convert import config_from_reference, table_from_reference


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("capacity", [None, 300])
def test_table_matches_reference(dtype, capacity):
    rng = np.random.default_rng(41)
    rows = rng.integers(-1000, 1000, size=(250, 4)).astype(dtype)
    jt = JTable.from_numpy(rows, capacity=capacity, dtype=dtype)
    t = Table.from_numpy(
        rows, capacity=capacity, dtype=torch.from_numpy(rows).dtype, device="cpu"
    )
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(jt.data))
    assert t.num_rows.dtype == torch.int32 and int(t.num_rows) == int(jt.num_rows)
    assert t.names == jt.names and t.capacity == jt.capacity and t.ncol == jt.ncol
    np.testing.assert_array_equal(t.valid_mask().numpy(), np.asarray(jt.valid_mask()))
    np.testing.assert_array_equal(t.masked_keys(0).numpy(), np.asarray(jt.masked_keys(0)))
    np.testing.assert_array_equal(t.to_numpy(), jt.to_numpy())
    for cap in (400, 250):
        np.testing.assert_array_equal(
            t.with_capacity(cap).data.numpy(), np.asarray(jt.with_capacity(cap).data)
        )
    back = table_from_reference(np.asarray(jt.data), int(jt.num_rows), jt.names, device="cpu")
    assert torch.equal(back.data, t.data) and int(back.num_rows) == int(t.num_rows)
    assert back.names == t.names


def test_empty_table_and_sentinels_match_reference():
    jt = JTable.empty(3, 16)
    t = Table.empty(3, 16, device="cpu")
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(jt.data))
    assert int(t.num_rows) == 0 and t.names == jt.names
    for tdt, jdt in ((torch.int32, jnp.int32), (torch.int64, jnp.int64)):
        assert key_sentinel(tdt) == int(jkey_sentinel(jdt))
    with pytest.raises(ValueError, match="capacity"):
        Table.from_numpy(np.zeros((5, 2), np.int64), capacity=4, device="cpu")


def test_config_from_reference_roundtrip():
    ref = JConfig(
        predicate1=JPredicate(1, "<=", 77), predicate2=JPredicate(2, "!=", -3),
        join_key1=1, join_key2=2, dtype="int32", narrow_keys=False, narrow_data=True,
        exchange_slack=3.0, collect_metrics=False,
    )
    cfg = config_from_reference(ref)
    for f in dataclasses.fields(EngineConfig):
        got, want = getattr(cfg, f.name), getattr(ref, f.name)
        if f.name.startswith("predicate"):
            assert (got.col, got.op, got.value) == (want.col, want.op, want.value)
            assert got.describe() == want.describe()
        else:
            assert got == want, f.name
    assert cfg.torch_dtype() == torch.int32 and not cfg.narrowable()
    assert {f.name for f in dataclasses.fields(EngineConfig)} == {
        f.name for f in dataclasses.fields(JConfig)
    }
    assert config_from_reference(JConfig()) == EngineConfig()


@pytest.mark.parametrize(
    "k1,k2",
    [
        ([1, 2, 3], [4, 5]),
        ([-(2**31), 0], [2**31 - 2]),
        ([2**31 - 1], [0]),  # INT32_MAX is the narrow sentinel: does not fit
        ([2**40], [1]),
        ([], [7]),
    ],
)
def test_resolve_narrow_matches_reference(k1, k2):
    a, b = np.array(k1, np.int64), np.array(k2, np.int64)
    ref = JConfig().resolve_narrow(a, b).narrow_keys
    assert EngineConfig().resolve_narrow(a, b).narrow_keys is ref
    ta, tb = a.reshape(-1, 1), b.reshape(-1, 1)
    ref_d = JConfig().resolve_narrow_data(ta, tb).narrow_data
    assert EngineConfig().resolve_narrow_data(ta, tb).narrow_data is ref_d
    assert EngineConfig(narrow_keys=True).resolve_narrow(a, b).narrow_keys is True
    assert EngineConfig(dtype="int32").resolve_narrow(a, b).narrow_keys is False


@pytest.mark.parametrize(
    "kw",
    [
        {"join_algorithm": "hash"},
        {"checkpoint_dir": "ckpt"},
        {"debug_log": True},
        {"dtype": "float64"},
    ],
)
def test_unported_config_values_raise(kw):
    """Every value of the JAX config is ported now (float dtypes since
    `columnar/dtypes`): each constructs and carries across from the JAX
    config unchanged."""
    cfg = EngineConfig(**kw)
    for name, value in kw.items():
        assert getattr(cfg, name) == value
    assert config_from_reference(JConfig(**kw)) == cfg


def test_invalid_narrow_value_raises():
    with pytest.raises(ValueError, match="narrow_keys"):
        EngineConfig(narrow_keys="yes")


@pytest.mark.parametrize("dist", ["unique", "uniform", "zipf"])
def test_generate_matches_reference(dist):
    got = generate.generate_table(1000, 5, seed=9, key_distribution=dist)
    want = jgen.generate_table(1000, 5, seed=9, key_distribution=dist)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_csv_io_matches_reference(tmp_path):
    rows = generate.generate_table(500, seed=3)
    rows[:5, 1] = [-1, 0, 2**40, -(2**40), 7]
    for empty in (False, True):
        arr = rows[:0] if empty else rows
        got, want = io.StringIO(), io.StringIO()
        csv_io.write_csv(got, arr)
        jcsv.write_csv(want, arr)
        assert got.getvalue() == want.getvalue()
    p1, p2 = tmp_path / "port.csv", tmp_path / "ref.csv"
    csv_io.write_csv(str(p1), rows, names=["a", "b", "c", "d"])
    jcsv.write_csv(str(p2), rows, names=["a", "b", "c", "d"])
    assert p1.read_bytes() == p2.read_bytes()
    np.testing.assert_array_equal(csv_io.load_csv_numpy(str(p1)), jcsv.load_csv_numpy(str(p2)))
    assert csv_io.probe_csv(str(p1)) == jcsv.probe_csv(str(p2))
    t = csv_io.load_csv(str(p1), capacity=512, device="cpu")
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(jcsv.load_csv(str(p2), capacity=512).data))
    (tmp_path / "ragged.csv").write_text("col1,col2\n1,2\n3\n")
    with pytest.raises(ValueError, match="ragged"):
        csv_io.load_csv_numpy(str(tmp_path / "ragged.csv"))


def test_predicate_describe_matches_reference():
    for op in (">", ">=", "<", "<=", "==", "!="):
        assert Predicate(2, op, 5).describe() == JPredicate(2, op, 5).describe()
