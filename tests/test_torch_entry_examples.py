"""The port's entry points, `concat_tables`, `reference_config` and the five
examples on the CPU against the JAX package on the same inputs.

`entry`'s step equals the JAX `entry()`'s `pipeline_core` output buffer;
`dryrun_multichip` on 3 and 4 Gloo ranks equals the oracle and the JAX dry
run (rows and its OK line); each example's `main(["--device", "cpu", ...])`
equals the JAX example's flow: the CSV bytes of `smj-tpu run` (01), the
JAX `DistributedQueryPipeline` on a mesh of as many CPU devices as ranks
(02, 05), the JAX hash join and aggregate (03), merge and resumable query
(04). Every result here is an integer table, compared exactly. Example 02
and the entry file also run as ``python -m`` subprocesses.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_dist_reference as ref
from pim_sort_merge_join_tpu import config as jconfig
from pim_sort_merge_join_tpu.columnar import table as jtable
from pim_sort_merge_join_tpu.engine.distributed import DistributedQueryPipeline as JDistributed
from pim_sort_merge_join_tpu.runner import cli as jcli
from pim_sort_merge_join_tpu_torch import EngineConfig
from pim_sort_merge_join_tpu_torch.columnar.generate import generate_table, write_table_pair
from pim_sort_merge_join_tpu_torch.columnar.table import Table, concat_tables
from pim_sort_merge_join_tpu_torch.config import reference_config
from pim_sort_merge_join_tpu_torch.convert import config_from_reference
from pim_sort_merge_join_tpu_torch.device import rank_device
from pim_sort_merge_join_tpu_torch.entry import dryrun_multichip, entry, entry_rows
from pim_sort_merge_join_tpu_torch.examples import (
    distributed,
    hash_join_aggregate,
    single_chip_pipeline,
    skew_and_profiling,
    streaming_merge_checkpoint,
)
from pim_sort_merge_join_tpu_torch.ops import oracle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = 4


def _graft_entry():
    """`__graft_entry__.py`, the JAX package's entry points, loaded by path."""
    spec = importlib.util.spec_from_file_location("graft_entry", os.path.join(REPO,
                                                                              "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same_table(got: Table, want) -> None:
    want_data = np.asarray(want.data)
    assert got.data.numpy().dtype == want_data.dtype
    np.testing.assert_array_equal(got.data.numpy(), want_data)
    assert got.num_rows.dtype == torch.int32 and got.num_rows.dim() == 0
    assert int(got.num_rows) == int(want.num_rows)
    assert got.names == tuple(want.names)


def _run_quiet(fn, *args):
    """``fn(*args)`` and what it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


# --- entry ------------------------------------------------------------------

def test_entry_equals_the_jax_entry():
    fn, (t1, t2) = entry(device="cpu")
    assert t1.device.type == "cpu" and fn.keywords["config"] == EngineConfig()
    jfn, jargs = _graft_entry().entry()
    _same_table(fn(t1, t2), jfn(*jargs))


@pytest.mark.parametrize("n", [1, 100, 4096, 20_000])
def test_entry_at_other_widths_equals_the_oracle(n):
    fn, args = entry(n, device="cpu")
    rows1, rows2 = entry_rows(n)
    np.testing.assert_array_equal(args[0].to_numpy(), rows1)
    np.testing.assert_array_equal(fn(*args).to_numpy(), oracle.pipeline_oracle(rows1, rows2))


# --- concat_tables, reference_config -----------------------------------------

DTYPES = [np.int64, np.uint64, np.float64]


def _concat_inputs(case: str, dtype, rng) -> list[tuple[np.ndarray, int]]:
    """(rows, capacity) of each table of a case."""
    def rows(n):
        if dtype == np.float64:
            return rng.normal(0, 1e6, size=(n, 3))
        if dtype == np.uint64:
            return rng.integers(0, 2**64, size=(n, 3), dtype=np.uint64)
        return rng.integers(-2**62, 2**62, size=(n, 3))

    return {
        "several": [(rows(5), 8), (rows(0), 4), (rows(7), 7), (rows(3), 16)],
        "single": [(rows(9), 12)],
        "all_empty": [(rows(0), 0), (rows(0), 5)],
        "empty_first": [(rows(0), 3), (rows(4), 4)],
    }[case]


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("case", ["several", "single", "all_empty", "empty_first"])
def test_concat_tables_equals_jax(case, dtype):
    rng = np.random.default_rng(len(case))
    inputs = _concat_inputs(case, dtype, rng)
    names = ("a", "b", "c")
    ours = concat_tables([Table.from_numpy(r, capacity=c, names=names, dtype=dtype, device="cpu")
                          for r, c in inputs])
    theirs = jtable.concat_tables([jtable.Table.from_numpy(r, capacity=c, names=names,
                                                           dtype=jnp.dtype(dtype))
                                   for r, c in inputs])
    _same_table(ours, theirs)
    assert ours.capacity == sum(c for _, c in inputs)


def test_concat_tables_of_nothing_raises_as_jax():
    with pytest.raises(ValueError) as ours:
        concat_tables([])
    with pytest.raises(ValueError) as theirs:
        jtable.concat_tables([])
    assert str(ours.value) == str(theirs.value)


def test_reference_config():
    assert reference_config() == EngineConfig()
    assert config_from_reference(jconfig.reference_config()) == reference_config()


# --- dryrun_multichip ---------------------------------------------------------

@pytest.fixture(scope="module", params=[3, 4], ids=lambda p: f"P{p}")
def dryrun(request):
    """One spawned group per P: the rows and the OK line."""
    return request.param, *_run_quiet(dryrun_multichip, request.param, "cpu")


def test_dryrun_multichip_equals_the_jax_dry_run(dryrun):
    p, rows, line = dryrun
    _, jax_line = _run_quiet(_graft_entry().dryrun_multichip, p)
    assert line == jax_line
    assert f"dryrun_multichip({p}): OK -- {rows.shape[0]} joined rows" in line
    assert rows.shape == (48 * p, 7)


def test_ranks_go_on_the_card_unless_named():
    assert rank_device("cpu") == "cpu"
    if torch.cuda.is_available():
        assert rank_device(None) == rank_device("cuda") == "cuda:0"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dryrun_multichip(2)


def test_entry_file_runs_as_a_module():
    out = subprocess.run([sys.executable, "-m", "pim_sort_merge_join_tpu_torch.entry",
                          "--device", "cpu", "--ranks", "2"],
                         cwd=REPO, capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    fn, args = entry(device="cpu")
    assert f"entry: compiled + ran, rows: {int(fn(*args).num_rows)}" in out.stdout
    assert "dryrun_multichip(2): OK" in out.stdout


# --- the examples ---------------------------------------------------------------

def test_example_single_chip_pipeline_writes_smj_tpu_bytes(tmp_path):
    ours = str(tmp_path / "ours.csv")
    got, printed = _run_quiet(single_chip_pipeline.main, ["--device", "cpu", "--output", ours])
    d1, d2 = str(tmp_path / "data1.csv"), str(tmp_path / "data2.csv")
    write_table_pair(d1, d2, single_chip_pipeline.REFERENCE_ROWS, seed=1)
    theirs = str(tmp_path / "theirs.csv")
    assert jcli.main(["run", d1, d2, "-o", theirs]) == 0
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    want = oracle.pipeline_oracle(generate_table(100_000, seed=1), generate_table(100_000, seed=2))
    assert got["rows"] == want.shape[0] and f"joined rows: {got['rows']}" in printed
    assert got["stages"] == ["ingest", "host_to_device", "execute", "materialize"]
    # The same files named on the command line: the same bytes.
    again = str(tmp_path / "again.csv")
    got2, _ = _run_quiet(single_chip_pipeline.main, [d1, d2, "--output", again, "--device", "cpu"])
    assert got2["csv_sha256"] == got["csv_sha256"]


def test_example_single_chip_pipeline_takes_two_files_or_none():
    with pytest.raises(SystemExit):
        single_chip_pipeline.main(["only_one.csv", "--device", "cpu"])


def test_example_distributed_equals_jax_mesh():
    got, printed = _run_quiet(distributed.main, ["--device", "cpu"])
    rows1, rows2 = generate_table(100_000, seed=1), generate_table(100_000, seed=2)
    cfg = jconfig.EngineConfig(predicate1=jconfig.Predicate(0, ">", 5000),
                               predicate2=jconfig.Predicate(0, ">", 5000))
    want = JDistributed(cfg, ref.mesh(P)).run_arrays(rows1, rows2).to_numpy()
    assert got["partitions"] == P and "mesh: 4 Gloo ranks on cpu" in printed
    np.testing.assert_array_equal(got["result"], want)
    np.testing.assert_array_equal(got["result"], oracle.pipeline_oracle(rows1, rows2))
    assert got["rows"] == want.shape[0]


def test_example_distributed_runs_as_a_module():
    out = subprocess.run([sys.executable, "-m", "pim_sort_merge_join_tpu_torch.examples.distributed",
                          "--simulator", "3"],
                         cwd=REPO, capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "mesh: 3 Gloo ranks on cpu" in out.stdout
    want = oracle.pipeline_oracle(generate_table(100_000, seed=1), generate_table(100_000, seed=2))
    assert f"joined rows: {want.shape[0]}" in out.stdout


def test_example_hash_join_aggregate_equals_jax():
    from pim_sort_merge_join_tpu.ops.hash_join import hash_aggregate, hash_join

    got, printed = _run_quiet(hash_join_aggregate.main, ["--device", "cpu"])
    orders, customers = hash_join_aggregate.tables()
    t_orders = jtable.Table.from_numpy(orders, names=("cust", "amount", "qty"))
    t_cust = jtable.Table.from_numpy(customers, names=("cust", "region"))
    joined = hash_join(t_orders, t_cust, 0, 0, mode="one_to_one")
    totals = hash_aggregate(t_orders, key=0, value=1, agg="sum").to_numpy()
    assert got["joined_rows"] == int(joined.num_rows) == 49
    np.testing.assert_array_equal(got["joined"], joined.to_numpy())
    np.testing.assert_array_equal(got["totals"], totals)
    np.testing.assert_array_equal(got["totals_first5"], totals[:5])
    assert str(totals[:5]) in printed


def test_example_streaming_merge_checkpoint_equals_jax(tmp_path):
    import pim_sort_merge_join_tpu as jsmj
    from pim_sort_merge_join_tpu.ops.merge import merge_sorted, merge_tree
    from pim_sort_merge_join_tpu.ops.sort import sort_by_key

    got, printed = _run_quiet(streaming_merge_checkpoint.main, ["--device", "cpu"])
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(4):
        rows = np.column_stack(
            [rng.integers(0, 10_000, 250), rng.integers(0, 100, (250, 3))]).astype(np.int64)
        batches.append(sort_by_key(jtable.Table.from_numpy(rows, capacity=256), 0))
    merged = merge_tree(batches, 0)
    acc = batches[0]
    for b in batches[1:]:
        acc = merge_sorted(acc, b, 0)
    cfg = jsmj.EngineConfig(predicate1=jsmj.Predicate(0, ">", 500),
                            predicate2=jsmj.Predicate(0, ">", 500), checkpoint_dir=str(tmp_path))
    n = 2_000
    r1, r2 = (np.column_stack([rng.permutation(np.arange(1, n + 1)), rng.integers(1, n, (n, 3))])
              .astype(np.int64) for _ in range(2))
    t1, t2 = jtable.Table.from_numpy(r1), jtable.Table.from_numpy(r2)
    jsmj.QueryPipeline(cfg).run_tables_resumable(t1, t2)
    resumed = jsmj.QueryPipeline(cfg).run_tables_resumable(t1, t2).to_numpy()

    assert (got["merged_rows"], got["merged_capacity"]) == (int(merged.num_rows), merged.capacity)
    np.testing.assert_array_equal(got["merged"], merged.to_numpy())
    np.testing.assert_array_equal(got["fold"], acc.to_numpy())
    assert got["fold_rows"] == int(acc.num_rows) == 1000
    np.testing.assert_array_equal(got["resumed"], resumed)
    assert got["resumed_rows"] == resumed.shape[0] > 0
    assert got["merged_sorted"] and got["resumed_matches"]
    # The resumed pipeline ran the join only.
    assert got["resumed_stages"] == ["join"]
    assert f"resumed query matches: {resumed.shape[0]} rows" in printed


def test_example_skew_and_profiling_equals_jax_mesh():
    got, printed = _run_quiet(skew_and_profiling.main, ["--device", "cpu"])
    rows1, rows2 = skew_and_profiling.tables()
    pred = jconfig.Predicate(*skew_and_profiling.PREDICATE)
    for key, extra in (("zipf", {"exchange_slack": 1.5}),
                       ("hash", {"partition_scheme": "hash", "exchange_slack": 4.0})):
        cfg = jconfig.EngineConfig(predicate1=pred, predicate2=pred, splitter_sample=2048, **extra)
        want = JDistributed(cfg, ref.mesh(P)).run_arrays(rows1, rows2).to_numpy()
        np.testing.assert_array_equal(got[key], want, err_msg=key)
    want = oracle.pipeline_oracle(rows1, rows2, pred1=skew_and_profiling.PREDICATE,
                                  pred2=skew_and_profiling.PREDICATE)
    assert got["partitions"] == P
    assert got["zipf_rows"] == got["hash_rows"] == want.shape[0]
    assert got["zipf_matches_oracle"] and got["hash_same_multiset"]
    assert got["trace_files"] == 1
    assert f"zipf a=1.3 join over {P} shards: {want.shape[0]} rows" in printed
