"""The port's multi-device engine on 3 and on 8 Gloo CPU ranks against the
JAX package on a mesh of as many CPU devices.

Three ranks: a partition count that is no power of two, where a wrong
unsigned remainder of the hash would show (a power of two hides it in
``& (P - 1)``), for both hash modes, the range query, an aggregate and the
skew path. Eight ranks: the reference's `dryrun_multichip(8)` query
(`__graft_entry__.py`: 64 rows a rank, unique keys, ``col1 > n / 4``) and
the chunked exchange. Each P's cases run in one spawned group with a time
limit; every comparison is exact.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax_dist_reference as ref
import torch_dist_cases as cases
from pim_sort_merge_join_tpu_torch.ops import oracle
from pim_sort_merge_join_tpu_torch.runner.simulator import spawn_simulator


def _pred(value, col=0, op=">"):
    return {"predicate1": (col, op, value), "predicate2": (col, op, value)}


CASES3 = [
    {"label": "range_1000", "kind": "join", "tables": ("reference_like", 21, 1000),
     "cfg": {**_pred(500), "splitter_sample": 128}},
    {"label": "hash_one_to_one", "kind": "join", "tables": ("reference_like", 22, 800),
     "cfg": {**_pred(200), "partition_scheme": "hash", "exchange_slack": 2.5,
             "splitter_sample": 64}},
    {"label": "hash_inner", "kind": "join", "tables": ("duplicate_keys", 23, 0),
     "cfg": {**_pred(0, col=1, op=">="), "partition_scheme": "hash", "join_mode": "inner",
             "join_slack": 16.0, "exchange_slack": 1.9, "splitter_sample": 64}},
    {"label": "skew_one_to_one", "kind": "join", "tables": ("skewed", 24, 600),
     "cfg": {**_pred(0, col=1, op=">="), "exchange_slack": 1.5, "splitter_sample": 256,
             "heavy_hitter_fraction": 0.2}},
    {"label": "aggregate_sum", "kind": "aggregate", "tables": ("grouped", 25, 500), "agg": "sum",
     "cfg": {"exchange_slack": 6.0, "splitter_sample": 128}},
    {"label": "hash_aggregate", "kind": "aggregate", "tables": ("grouped", 26, 500),
     "agg": "count", "cfg": {"partition_scheme": "hash", "exchange_slack": 6.0}},
]
CASES8 = [
    {"label": "dryrun_multichip", "kind": "join", "tables": ("unique_small", 0, 64 * 8),
     "cfg": {**_pred(64 * 8 // 4), "splitter_sample": 64}},
    {"label": "chunked_exchange", "kind": "exchange", "tables": ("exchange_rows", 27, (8 * 16, 8)),
     "bucket": 16, "recv": 64, "chunks": (1, 16)},
]
GROUPS = {3: CASES3, 8: CASES8}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Each P's cases on P Gloo ranks, one spawned group each."""
    out = {}
    for p, group in GROUPS.items():
        d = tmp_path_factory.mktemp(f"port_ranks{p}")
        out[p] = spawn_simulator(cases.run_cases, p, group, str(d), timeout=240)
    return out


def _params(kind):
    return [(p, c["label"]) for p, group in GROUPS.items() for c in group if c["kind"] == kind]


def _case(p, label):
    return next(c for c in GROUPS[p] if c["label"] == label)


@pytest.mark.parametrize("p,label", _params("join"))
def test_join_equals_jax_rank_by_rank(port, tmp_path, p, label):
    case = _case(p, label)
    ref.check_join(port[p][label], ref.run(case, p, str(tmp_path)), case)


@pytest.mark.parametrize("p,label", _params("aggregate"))
def test_aggregate_equals_jax_rank_by_rank(port, tmp_path, p, label):
    case = _case(p, label)
    got = port[p][label]
    ref.same_global(got, ref.run(case, p, str(tmp_path)))
    rows, _ = cases.tables(case)
    want = oracle.hash_aggregate_oracle(rows, 0, 1, case["agg"])
    np.testing.assert_array_equal(got["rows"][np.argsort(got["rows"][:, 0], kind="stable")], want)


@pytest.mark.parametrize("p,label", _params("exchange"))
def test_exchange_equals_jax_for_every_chunk_count(port, tmp_path, p, label):
    case = _case(p, label)
    got, want = port[p][label], ref.run(case, p, str(tmp_path))
    for k in case["chunks"]:
        for field in ("data", "num_rows", "true_rows"):
            np.testing.assert_array_equal(got[k][field], want[k][field], err_msg=f"{k} {field}")


def test_hash_destinations_at_three_ranks_are_not_a_mask(port):
    """With P = 3 a mask of the hash's low bits would send rows to rank 3
    (no such rank) or lose the co-location; every rank holds rows and the
    join is whole."""
    got = port[3]["hash_one_to_one"]
    assert (got["counts"] > 0).all()
    want = ref.oracle_rows(_case(3, "hash_one_to_one"))
    assert got["rows"].shape == want.shape
