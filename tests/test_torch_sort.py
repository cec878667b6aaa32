"""The port's sort seam (plain path, CPU) against the JAX package's sorts.

`stable_key_sort` on CPU tensors runs the plain version of the port's
`hbm_sort`; it must equal the JAX `hbm_sort` (Pallas, interpret mode, small
chunk and tile so that several merge passes run) and `jax.lax.sort`
exactly: integer data, tolerance 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pim_sort_merge_join_tpu.ops.pallas.hbm_sort import hbm_sort as jax_hbm_sort
from pim_sort_merge_join_tpu_torch.ops.kernels.hbm_sort import hbm_sort
from pim_sort_merge_join_tpu_torch.ops.sort import stable_key_sort

I32MAX = np.iinfo(np.int32).max
I64MAX = np.iinfo(np.int64).max


def _port(arrays, num_keys, unique_keys=False):
    ops = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)
    return [o.numpy() for o in stable_key_sort(ops, num_keys=num_keys, unique_keys=unique_keys)]


def _assert_all_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _interpret_case(name, rng):
    if name == "int32_key_int64_payload":
        return [rng.integers(-(1 << 30), 1 << 30, 2048).astype(np.int32),
                rng.integers(-(2**62), 2**62, 2048)], 1, False
    if name == "two_keys_int64_sentinels":
        k = rng.integers(-(2**60), 2**60, 1500)
        k[rng.choice(1500, 200, replace=False)] = I64MAX
        return [k, np.arange(1500, dtype=np.int32), rng.integers(0, 9, 1500).astype(np.int32)], 2, True
    raise AssertionError(name)


@pytest.mark.parametrize("name", ["int32_key_int64_payload", "two_keys_int64_sentinels"])
def test_plain_sort_matches_pallas_hbm_sort(name):
    arrays, num_keys, unique = _interpret_case(name, np.random.default_rng(11))
    want = jax_hbm_sort(
        tuple(jnp.asarray(a) for a in arrays), interpret=True, chunk=512, tile=256,
        num_keys=num_keys, unique_keys=unique,
    )
    _assert_all_equal(_port(arrays, num_keys, unique), want)


def _lax_case(name, rng):
    n = 3000
    if name == "padding_negative":
        return [rng.integers(-(1 << 30), 1 << 30, 1500).astype(np.int32),
                rng.integers(0, 100, 1500).astype(np.int32)], 1
    if name == "stability_dups":
        return [rng.integers(0, 7, n).astype(np.int32), np.arange(n, dtype=np.int32)], 1
    if name == "int64_sentinels":
        k = rng.integers(-(1 << 60), 1 << 60, n)
        k[rng.random(n) < 0.2] = I64MAX
        return [k, rng.integers(0, 9, n).astype(np.int32)], 1
    if name == "table_rows_4col":
        return [rng.integers(0, 1 << 40, n) for _ in range(4)], 1
    if name == "unique_perm_payload":
        return [rng.permutation(n).astype(np.int32), rng.integers(-(2**62), 2**62, n)], 1
    if name == "two_keys_payload":
        return [rng.integers(0, 9, n).astype(np.int32), rng.integers(-5, 5, n).astype(np.int32),
                rng.integers(0, 10**12, n)], 2
    if name == "two_keys_int64":
        return [rng.integers(0, 4, n), rng.integers(-(2**40), 2**40, n)], 2
    if name == "int64_keys_payload":
        return [rng.integers(-(1 << 60), 1 << 60, n), rng.integers(-(2**62), 2**62, n)], 1
    if name == "two_keys_sentinel_ties":
        k = rng.integers(0, 50, n).astype(np.int32)
        k[rng.choice(n, 300, replace=False)] = I32MAX
        return [k, np.arange(n, dtype=np.int32)], 2
    if name == "one_element":
        return [np.array([7], np.int32), np.array([3], np.int64)], 1
    if name == "empty":
        return [np.zeros(0, np.int32), np.zeros(0, np.int64)], 1
    raise AssertionError(name)


@pytest.mark.parametrize(
    "name",
    ["padding_negative", "stability_dups", "int64_sentinels", "table_rows_4col",
     "unique_perm_payload", "two_keys_payload", "two_keys_int64", "int64_keys_payload",
     "two_keys_sentinel_ties", "one_element", "empty"],
)
def test_plain_sort_matches_lax_sort(name):
    arrays, num_keys = _lax_case(name, np.random.default_rng(12))
    want = jax.lax.sort(tuple(jnp.asarray(a) for a in arrays), num_keys=num_keys, is_stable=True)
    _assert_all_equal(_port(arrays, num_keys), want)


def test_hbm_sort_rejects_bad_operands():
    a = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="equal length"):
        hbm_sort((a, torch.arange(3)))
    with pytest.raises(ValueError, match="num_keys"):
        hbm_sort((a,), num_keys=2)
    with pytest.raises(ValueError, match="unknown sort algorithm"):
        stable_key_sort((a,), algorithm="bogus")
    with pytest.raises(ValueError, match="devices"):
        hbm_sort((a.to("meta"),))
