"""The plain reference against a brute-force join, and the comparison."""

import numpy as np
import pytest
import torch

from benchmark.reference import relational


def brute(t1, t2, query):
    ops = {">": np.greater, "<": np.less, ">=": np.greater_equal}
    p1, p2 = query["predicate1"], query["predicate2"]
    k1, k2 = query["join_key1"], query["join_key2"]
    f1 = t1[ops[p1["op"]](t1[:, p1["col"]], p1["value"])]
    f2 = t2[ops[p2["op"]](t2[:, p2["col"]], p2["value"])]
    f1 = f1[np.argsort(f1[:, k1], kind="stable")]
    f2 = f2[np.argsort(f2[:, k2], kind="stable")]
    keep2 = [c for c in range(t2.shape[1]) if c != k2]
    out = []
    if query["join_mode"] == "inner":
        for r in f1:
            out += [np.concatenate([r, s[keep2]]) for s in f2 if s[k2] == r[k1]]
    else:  # the upstream's two cursors: both advance on equal keys
        i = j = 0
        while i < len(f1) and j < len(f2):
            a, b = f1[i, k1], f2[j, k2]
            if a == b:
                out.append(np.concatenate([f1[i], f2[j, keep2]]))
                i, j = i + 1, j + 1
            elif a < b:
                i += 1
            else:
                j += 1
    return np.array(out, dtype=np.int64).reshape(-1, t1.shape[1] + t2.shape[1] - 1)


@pytest.mark.parametrize("mode", ["one_to_one", "inner"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_equals_brute_force(mode, seed):
    rng = np.random.default_rng(seed)
    t1 = rng.integers(0, 40, size=(300, 3))
    t2 = rng.integers(0, 40, size=(200, 4))
    query = {"predicate1": {"col": 1, "op": ">", "value": 8},
             "predicate2": {"col": 2, "op": "<", "value": 30},
             "join_key1": 0, "join_key2": 1, "join_mode": mode}
    got = relational.run_query(torch.from_numpy(t1), torch.from_numpy(t2), query).numpy()
    want = brute(t1, t2, query)
    assert got.shape[0] > 0
    np.testing.assert_array_equal(got, want)


def test_compare_counts_rows_that_differ():
    a = np.arange(12).reshape(4, 3)
    assert relational.compare(a, a.copy()) == {"rows_count_gap": 0, "rows_differing": 0}
    b = a.copy()
    b[2, 1] += 1
    assert relational.compare(b, a) == {"rows_count_gap": 0, "rows_differing": 1}
    assert relational.compare(a[:3], a) == {"rows_count_gap": 1, "rows_differing": 1}
