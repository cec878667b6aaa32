"""The port's multi-device engine on 4 Gloo CPU ranks against the JAX
package's `DistributedQueryPipeline` on a 4-device CPU mesh.

The flows of tests/test_distributed.py: every case runs on the port's
ranks in one spawned group (a module fixture, `spawn_simulator`, with a
time limit), then each test runs its case through the JAX package and
compares: every rank's whole block and row count, the diagnostics, the
resolved narrow flags and the checkpoint files, exactly (integer tables).
"""

from __future__ import annotations

import os

import numpy as np
import pytest

import jax_dist_reference as ref
import torch_dist_cases as cases
from pim_sort_merge_join_tpu_torch.engine.checkpoint import StageCheckpointer, config_fingerprint
from pim_sort_merge_join_tpu_torch.ops import oracle
from pim_sort_merge_join_tpu_torch.runner.simulator import spawn_simulator

P = 4


def _pred(value, col=0, op=">"):
    return {"predicate1": (col, op, value), "predicate2": (col, op, value)}


EVERY_ROW = _pred(0, col=1, op=">=")
CASES = [
    {"label": "range_64", "kind": "join", "tables": ("reference_like", 1, 64),
     "cfg": {**_pred(32), "splitter_sample": 128}},
    {"label": "range_1000", "kind": "join", "tables": ("reference_like", 2, 1000),
     "cfg": {**_pred(500), "splitter_sample": 128}},
    # Heavy duplication with rank spreading off: byte-equal to one device.
    {"label": "duplicate_keys", "kind": "join", "tables": ("duplicate_keys", 3, 0),
     "cfg": {**EVERY_ROW, "splitter_sample": 64, "exchange_slack": 16.0,
             "heavy_hitter_fraction": 1.0}},
    {"label": "empty_result", "kind": "join", "tables": ("reference_like", 4, 64),
     "cfg": {"predicate1": (0, ">", 10**9)}},
    {"label": "inner", "kind": "join", "tables": ("duplicate_keys", 5, 0),
     "cfg": {**EVERY_ROW, "join_mode": "inner", "join_slack": 16.0, "splitter_sample": 64,
             "exchange_slack": 2.0}},
    # Each rank's table sorts on the bitonic kernel (the JAX side's runs
    # interpreted).
    {"label": "inner_bitonic", "kind": "join", "tables": ("duplicate_keys", 21, 0),
     "cfg": {**EVERY_ROW, "join_mode": "inner", "join_slack": 16.0, "splitter_sample": 64,
             "exchange_slack": 2.0, "sort_algorithm": "pallas_bitonic"}},
    # The broadcast side's capacity (the bucket's, 416 rows) past table 2's
    # 75 rows a rank: the JAX package fails there (ROADMAP §3).
    {"label": "inner_wide_slack", "kind": "join", "tables": ("duplicate_keys", 5, 0),
     "cfg": {**EVERY_ROW, "join_mode": "inner", "join_slack": 8.0, "splitter_sample": 64,
             "exchange_slack": 16.0}},
    {"label": "hash_one_to_one", "kind": "join", "tables": ("reference_like", 6, 800),
     "cfg": {**_pred(200), "partition_scheme": "hash", "join_slack": 2.0,
             "exchange_slack": 4.0, "splitter_sample": 64}},
    {"label": "hash_inner", "kind": "join", "tables": ("reference_like", 6, 800),
     "cfg": {**_pred(200), "partition_scheme": "hash", "join_mode": "inner", "join_slack": 2.0,
             "exchange_slack": 3.0, "splitter_sample": 64}},
    {"label": "skew_one_to_one", "kind": "join", "tables": ("skewed", 9, 600),
     "cfg": {**EVERY_ROW, "exchange_slack": 1.3, "splitter_sample": 256,
             "heavy_hitter_fraction": 0.2}},
    {"label": "skew_inner_broadcast", "kind": "join", "tables": ("skewed_inner", 10, 600),
     "cfg": {**EVERY_ROW, "join_mode": "inner", "join_slack": 30.0, "exchange_slack": 1.5,
             "splitter_sample": 256, "heavy_hitter_fraction": 0.2}},
    # join_algorithm="hash" still sort-merges on each rank (ROADMAP §3):
    # rows in key order, not the single-device hash join's table-1 order.
    {"label": "hash_algorithm_sort_merges", "kind": "join", "tables": ("reference_like", 17, 600),
     "cfg": {**_pred(300), "join_algorithm": "hash", "splitter_sample": 128}},
    {"label": "chunked_pipeline", "kind": "join", "tables": ("reference_like", 15, 500),
     "cfg": {**_pred(250), "splitter_sample": 128, "exchange_chunks": 8}},
    {"label": "skew_disabled", "kind": "overflow", "tables": ("skewed", 11, 600),
     "cfg": {**EVERY_ROW, "exchange_slack": 1.3, "splitter_sample": 256,
             "heavy_hitter_fraction": 1.0}},
    {"label": "resumable", "kind": "resumable", "tables": ("reference_like", 12, 600),
     "cfg": {**_pred(300), "splitter_sample": 128}},
    # Wide keys checkpointed; the resume gets zero tables, which would
    # probe narrow: the probe must read the checkpoint.
    {"label": "resume_probe", "kind": "resumable", "tables": ("wide_keys", 13, 512),
     "cfg": {**_pred(0), "splitter_sample": 128}},
    {"label": "chunked_exchange", "kind": "exchange", "tables": ("exchange_rows", 14, (P * 16, P)),
     "bucket": 16, "recv": 64, "chunks": (1, 2, 4, 16)},
    {"label": "exchange_overflow", "kind": "exchange", "tables": ("exchange_rows", 16, (P * 16, 1)),
     "bucket": 4, "recv": 32, "chunks": (1,)},
    # The other element types: keys as order keys, rows as their bits.
    {"label": "uint64_range", "kind": "join", "tables": ("reference_like", 18, 600),
     "cfg": {**_pred(2**63 + 300), "dtype": "uint64", "splitter_sample": 128}},
    {"label": "float64_range", "kind": "join", "tables": ("reference_like", 19, 600),
     "cfg": {**_pred(-10), "dtype": "float64", "splitter_sample": 128}},
    {"label": "float64_hash_inner", "kind": "join", "tables": ("duplicate_keys", 20, 0),
     "cfg": {**EVERY_ROW, "dtype": "float64", "partition_scheme": "hash", "join_mode": "inner",
             "join_slack": 16.0, "exchange_slack": 2.0, "splitter_sample": 64}},
    {"label": "float64_aggregate_sum", "kind": "aggregate", "tables": ("grouped", 28, 500),
     "agg": "sum", "cfg": {"dtype": "float64", "exchange_slack": 8.0, "splitter_sample": 128}},
] + [
    {"label": f"aggregate_{agg}", "kind": "aggregate", "tables": ("grouped", 7, 500), "agg": agg,
     "cfg": {"exchange_slack": 8.0, "splitter_sample": 128}}
    for agg in ("sum", "count", "min", "max")
] + [
    {"label": "hash_aggregate", "kind": "aggregate", "tables": ("grouped", 8, 600), "agg": "sum",
     "cfg": {"partition_scheme": "hash", "exchange_slack": 8.0, "splitter_sample": 64}},
]
BY_LABEL = {c["label"]: c for c in CASES}


def _labels(kind):
    return [c["label"] for c in CASES if c["kind"] == kind]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Every case on 4 Gloo ranks, in one spawned group: rank 0's results."""
    d = tmp_path_factory.mktemp("port_ranks")
    return spawn_simulator(cases.run_cases, P, CASES, str(d), timeout=240)


@pytest.fixture(scope="module")
def jax_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("jax_mesh"))


JAX_FAILS = {"inner_wide_slack"}


@pytest.mark.parametrize("label", [x for x in _labels("join") if x not in JAX_FAILS])
def test_join_equals_jax_rank_by_rank(port, jax_dir, label):
    case = BY_LABEL[label]
    ref.check_join(port[label], ref.run(case, P, jax_dir), case)


def test_inner_join_with_a_broadcast_capacity_past_the_shard(port, jax_dir):
    case = BY_LABEL["inner_wide_slack"]
    got = port["inner_wide_slack"]["rows"]
    np.testing.assert_array_equal(ref.sorted_rows(got), ref.sorted_rows(ref.oracle_rows(case)))
    np.testing.assert_array_equal(got, port["inner"]["rows"])
    with pytest.raises(TypeError, match="cannot reshape"):
        ref.run(case, P, jax_dir)


def test_distributed_join_ignores_the_hash_algorithm(port):
    """As in the reference, ``join_algorithm="hash"`` only makes the ranks
    sort before the sort-merge join: the rows come in key order (the
    oracle's), where the single-device hash join keeps table-1 order."""
    from pim_sort_merge_join_tpu_torch import QueryPipeline, Table

    case = BY_LABEL["hash_algorithm_sort_merges"]
    got = port["hash_algorithm_sort_merges"]["rows"]
    np.testing.assert_array_equal(got, ref.oracle_rows(case))
    r1, r2 = cases.tables(case)
    single = QueryPipeline(cases.port_config(case), device="cpu").run_tables(
        Table.from_numpy(r1, device="cpu"), Table.from_numpy(r2, device="cpu")).to_numpy()
    np.testing.assert_array_equal(ref.sorted_rows(single), ref.sorted_rows(got))
    assert not np.array_equal(single, got)


def test_empty_result_has_the_joined_width(port):
    assert port["empty_result"]["rows"].shape == (0, 7)


def test_duplicate_keys_arrive_in_key_order(port):
    rows = port["duplicate_keys"]["rows"]
    assert rows.shape[0] > 0 and (np.diff(rows[:, 0]) >= 0).all()


@pytest.mark.parametrize("label", _labels("aggregate"))
def test_aggregate_equals_jax_rank_by_rank(port, jax_dir, label):
    case = BY_LABEL[label]
    got, want = port[label], ref.run(case, P, jax_dir)
    rows, _ = cases.tables(case)
    if case["cfg"].get("dtype") == "float64":
        # Each group's float sum within the rounding of an n-term sum of
        # the other order, n * eps * (the sum of its magnitudes); keys and
        # counts exact.
        np.testing.assert_array_equal(got["counts"], want["counts"])
        np.testing.assert_array_equal(got["data"][:, 0], want["data"][:, 0])
        magnitude = np.abs(rows)
        magnitude[:, 0] = rows[:, 0]
        n = oracle.hash_aggregate_oracle(rows, 0, 1, "count")[:, 1]
        bound = n * np.finfo(np.float64).eps * oracle.hash_aggregate_oracle(magnitude, 0, 1)[:, 1]
        g = got["rows"][np.argsort(got["rows"][:, 0], kind="stable")]
        w = want["rows"][np.argsort(want["rows"][:, 0], kind="stable")]
        np.testing.assert_array_equal(g[:, 0], w[:, 0])
        assert (np.abs(g[:, 1] - w[:, 1]) <= bound).all()
        return
    ref.same_global(got, want)
    expect = oracle.hash_aggregate_oracle(rows, 0, 1, case["agg"])
    if case["cfg"].get("partition_scheme") == "hash":
        got_rows = got["rows"][np.argsort(got["rows"][:, 0], kind="stable")]
        np.testing.assert_array_equal(got_rows, expect)
    else:
        np.testing.assert_array_equal(got["rows"], expect)


def test_skew_disabled_raises_on_every_rank(port, jax_dir):
    got, want = port["skew_disabled"], ref.run(BY_LABEL["skew_disabled"], P, jax_dir)
    assert got["raised_on"] == [1] * P
    assert want["raised_on"] == [1] * P
    assert got["message"] == want["message"]


@pytest.mark.parametrize("label", _labels("resumable"))
def test_resumable_run_and_resume_equal_jax(port, jax_dir, label):
    case = BY_LABEL[label]
    got, want = port[label], ref.run(case, P, jax_dir)
    ref.same_global(got["run"], want["run"])
    ref.same_global(got["resume"], want["resume"])
    np.testing.assert_array_equal(got["rows"], want["rows"])
    np.testing.assert_array_equal(got["rows"], ref.oracle_rows(case))
    assert got["stages"] == want["stages"] == ([], ["exchanged", "joined"])
    assert got["narrow"] == want["narrow"]


def test_resume_probe_reads_the_checkpoint(port):
    # Zero placeholder tables would probe narrow; the wide checkpoint must not.
    assert port["resume_probe"]["narrow"][1][0] is False
    assert port["resumable"]["narrow"] == [(True, True), (True, True)]


@pytest.mark.parametrize("label", _labels("resumable"))
def test_checkpoint_files_equal_jax(port, jax_dir, label):
    ref.run(BY_LABEL[label], P, jax_dir)
    ours, theirs = port[label]["checkpoint"], os.path.join(jax_dir, label)
    for stage in ("exchanged.t1", "exchanged.t2", "joined.result"):
        with np.load(os.path.join(ours, f"{stage}.npz")) as a, \
                np.load(os.path.join(theirs, f"{stage}.npz")) as b:
            assert sorted(a.files) == sorted(b.files) == ["counts", "data"]
            for k in a.files:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{stage} {k}")


def test_resume_on_another_partition_count_is_refused(port):
    case = BY_LABEL["resumable"]
    cfg = cases.port_config(case, checkpoint_dir=port["resumable"]["checkpoint"])
    ckpt = StageCheckpointer(cfg.checkpoint_dir, config_fingerprint(cfg) + f"|mesh={P}")
    assert ckpt.completed_stages() == ["exchanged", "joined"]
    with pytest.raises(ValueError, match="shards"):
        ckpt.load_sharded("exchanged", "t1", device="cpu")  # one process: P = 1


@pytest.mark.parametrize("label", _labels("exchange"))
def test_exchange_equals_jax_for_every_chunk_count(port, jax_dir, label):
    case = BY_LABEL[label]
    got, want = port[label], ref.run(case, P, jax_dir)
    for k in case["chunks"]:
        for field in ("data", "num_rows", "true_rows"):
            np.testing.assert_array_equal(got[k][field], want[k][field], err_msg=f"{k} {field}")
            np.testing.assert_array_equal(got[k][field], got[1][field])


def test_exchange_overflow_reports_the_true_counts(port):
    got = port["exchange_overflow"][1]
    # Every row goes to rank 0: 64 arrive where 4 per source fit.
    assert got["true_rows"].tolist() == [P * 16, 0, 0, 0]
    assert got["num_rows"].tolist() == [4 * P, 0, 0, 0]
