"""The port's bitonic and radix sorts (plain path, CPU) against the JAX package.

`bitonic_sort_plain` must equal the JAX `bitonic_sort_xla` and `sort_pairs`
the JAX `sort_pairs_pallas` (Pallas, interpret mode); `radix_tile_sort`
must equal the JAX `radix_tile_sort` (interpret mode) on the cases of
tests/test_radix.py and more, and `xla_lsd_radix_sort` its JAX namesake.
Integer data: every comparison is exact.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pim_sort_merge_join_tpu.ops.pallas import radix_sort as jradix
from pim_sort_merge_join_tpu.ops.pallas import sort_kernel as jbitonic
from pim_sort_merge_join_tpu_torch.ops import kernels
from pim_sort_merge_join_tpu_torch.ops.kernels import bitonic_sort, radix_sort
from pim_sort_merge_join_tpu_torch.ops.kernels.hbm_sort import hbm_sort

I32 = np.iinfo(np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)


def _pairs(name, n, rng):
    if name == "random":
        return rng.integers(0, 1 << 30, n).astype(np.int32), np.arange(n, dtype=np.int32)
    if name == "few_distinct":
        return rng.integers(0, 8, n).astype(np.int32), np.arange(n, dtype=np.int32)
    if name == "extremes":
        k = rng.choice(np.array([I32.min, -1, 0, 1, I32.max], np.int32), n)
        return k, np.arange(n, dtype=np.int32)
    if name == "negative_random_vals":
        return (rng.integers(-(1 << 20), 0, n).astype(np.int32),
                rng.integers(-5, 5, n).astype(np.int32))
    raise AssertionError(name)


@pytest.mark.parametrize(
    "name,n",
    [("random", 256), ("random", 1024), ("random", 4096), ("few_distinct", 1024),
     ("extremes", 512), ("negative_random_vals", 256)],
)
def test_bitonic_plain_matches_xla_network(name, n):
    keys, vals = _pairs(name, n, np.random.default_rng(71))
    want = jbitonic.bitonic_sort_xla(jnp.asarray(keys), jnp.asarray(vals))
    _assert_equal(bitonic_sort.bitonic_sort_plain(_t(keys), _t(vals)), want)


@pytest.mark.parametrize("n", [256, 300, 1024, 5000])
def test_sort_pairs_matches_pallas_interpret(n):
    keys, vals = _pairs("random", n, np.random.default_rng(72))
    keys[::7] = I32.max  # real INT32_MAX keys tie the padding's
    want = jbitonic.sort_pairs_pallas(jnp.asarray(keys), jnp.asarray(vals), interpret=True)
    got = bitonic_sort.sort_pairs(_t(keys), _t(vals))
    _assert_equal(got, want)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(got[1].numpy(), order)


def test_sort_pairs_hands_off_to_hbm_sort_above_the_cap(monkeypatch):
    monkeypatch.setattr(bitonic_sort, "PALLAS_SORT_MAX", 512)
    rng = np.random.default_rng(73)
    keys, vals = _pairs("few_distinct", 600, rng)
    with pytest.warns(UserWarning, match="exceeds the bitonic cap"):
        got = bitonic_sort.sort_pairs(_t(keys), _t(vals))
    _assert_equal(got, hbm_sort((_t(keys), _t(vals))))
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(got[1].numpy(), order)
    keys, vals = _pairs("few_distinct", 512, rng)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = bitonic_sort.sort_pairs(_t(keys), _t(vals))
    np.testing.assert_array_equal(got[1].numpy(), np.argsort(keys, kind="stable"))


def test_bitonic_refuses_what_it_cannot_take():
    a = torch.arange(300, dtype=torch.int32)
    with pytest.raises(ValueError, match="power of two"):
        bitonic_sort.bitonic_sort_plain(a, a)
    m = torch.arange(256, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported devices"):
        bitonic_sort.sort_pairs(m, m)


def _radix_case(name, rng):
    """(operands, tile, digit_bits, key_bits) for one case."""
    def keys(n, hi):
        k = rng.integers(0, hi, size=n, dtype=np.int32)
        k[rng.random(n) < 0.1] = I32.max  # pad sentinels of masked key columns
        return k

    def payload(n):
        return rng.integers(I32.min, I32.max, size=n, dtype=np.int32)

    if name.startswith("tile"):  # tests/test_radix.py's grid
        tile, digit_bits = (int(x) for x in name[4:].split("_d"))
        n = 4 * tile
        return [keys(n, 3 * n), payload(n)], tile, digit_bits, 32
    if name == "reduced_key_bits":
        return [rng.integers(0, 1 << 20, 1024, dtype=np.int32),
                np.arange(1024, dtype=np.int32)], 256, 8, 20
    if name == "negative_keys":
        return [rng.integers(-1000, 1000, 1024, dtype=np.int32), payload(1024)], 256, 8, 32
    if name == "key_only":
        return [keys(768, 50)], 256, 4, 32
    if name == "three_operands":
        return [keys(1024, 10), payload(1024), np.arange(1024, dtype=np.int32)], 512, 8, 32
    if name == "odd_tile":
        return [keys(300, 40), payload(300)], 100, 4, 12
    raise AssertionError(name)


RADIX_CASES = ["tile256_d4", "tile256_d8", "tile512_d4", "tile512_d8", "reduced_key_bits",
               "negative_keys", "key_only", "three_operands", "odd_tile"]


@pytest.mark.parametrize("name", RADIX_CASES)
def test_radix_tile_sort_matches_pallas_interpret(name):
    arrays, tile, digit_bits, key_bits = _radix_case(name, np.random.default_rng(74))
    kw = dict(tile=tile, digit_bits=digit_bits, key_bits=key_bits)
    want = jradix.radix_tile_sort(tuple(jnp.asarray(a) for a in arrays), interpret=True, **kw)
    got = radix_sort.radix_tile_sort(tuple(_t(a) for a in arrays), **kw)
    _assert_equal(got, want)


@pytest.mark.parametrize("digit_bits", [4, 8])
def test_xla_lsd_radix_sort_matches_reference(digit_bits):
    rng = np.random.default_rng(75)
    n = 5000
    key = rng.integers(0, 3 * n, size=n, dtype=np.int32)
    payload = rng.integers(I32.min, I32.max, size=n, dtype=np.int32)
    want = jradix.xla_lsd_radix_sort(
        (jnp.asarray(key), jnp.asarray(payload)), digit_bits=digit_bits, key_bits=32
    )
    got = radix_sort.xla_lsd_radix_sort((_t(key), _t(payload)), digit_bits=digit_bits, key_bits=32)
    _assert_equal(got, want)
    np.testing.assert_array_equal(got[0].numpy(), np.sort(key, kind="stable"))


def test_radix_refuses_what_it_cannot_take():
    k = torch.arange(512, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of tile"):
        radix_sort.radix_tile_sort((k,), tile=300)
    with pytest.raises(ValueError, match="int32"):
        radix_sort.radix_tile_sort((k, k.long()), tile=256)
    with pytest.raises(ValueError, match="digit_bits"):
        radix_sort.radix_tile_sort((k,), tile=256, digit_bits=0)
    with pytest.raises(ValueError, match="unsupported devices"):
        radix_sort.radix_tile_sort((k.to("meta"),), tile=256)
    with pytest.raises(ValueError, match="int32 keys"):
        radix_sort.xla_lsd_radix_sort((k.long(),))


def test_plain_paths_launch_no_kernel():
    kernels.reset_launch_counts()
    counts = kernels.launch_counts()
    assert {"bitonic_local", "bitonic_strided", "radix_tile", "hbm_sort_chunk", "gather_rows"} <= set(counts)
    a = torch.arange(1024, dtype=torch.int32)
    bitonic_sort.sort_pairs(torch.flip(a, [0]), a)
    radix_sort.radix_tile_sort((torch.flip(a, [0]),), tile=256)
    assert all(n == 0 for n in kernels.launch_counts().values())
