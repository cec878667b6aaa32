"""What `hbm_sort`'s wrapper plans in Python, on the CPU.

The CUDA kernels run only on the card; which element they sort, how it is
packed and how many passes a length takes are plain functions of
`ops/kernels/hbm_sort.py`. They are held here against their contracts and,
for the card's adversarial cases at the run and tile edges
(`chip_smoke.element_edge_cases`), the plain sort against `jax.lax.sort`
and the JAX package's `hbm_sort` in interpret mode. Integer data,
tolerance 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pim_sort_merge_join_tpu.ops.pallas.hbm_sort import hbm_sort as jax_hbm_sort
from pim_sort_merge_join_tpu_torch.ops.kernels import hbm_sort as hs

I32 = np.iinfo(np.int32)
EXTREMES = np.array([I32.min, I32.min + 1, -1, 0, 1, I32.max - 1, I32.max], np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _operands(spec, n=16):
    """Tensors for a spec like ("i32", "i64", "arange32")."""
    rng = np.random.default_rng(7)
    make = {
        "i32": lambda: rng.integers(-50, 50, n).astype(np.int32),
        "i64": lambda: rng.integers(-(2**40), 2**40, n),
        "f32": lambda: rng.random(n).astype(np.float32),
        "arange32": lambda: np.arange(n, dtype=np.int32),
        "arange64": lambda: np.arange(n, dtype=np.int64),
    }
    return tuple(_t(make[s]()) for s in spec)


@pytest.mark.parametrize(
    "spec, num_keys, kind",
    [
        (("i32",), 1, hs.KIND_PACKED32),
        (("i32", "i64", "i32"), 1, hs.KIND_PACKED32),
        (("i32", "i32"), 2, hs.KIND_PAIR32),
        (("i32", "arange32"), 2, hs.KIND_PAIR32),
        (("i32", "i32", "i64"), 2, hs.KIND_WIDE_PAIR),
        (("i64",), 1, hs.KIND_WIDE_I64),
        (("i64", "i64", "i32"), 1, hs.KIND_WIDE_I64),
        (("i64", "arange32"), 2, hs.KIND_WIDE_I64),
        (("i64", "arange64", "i32"), 2, hs.KIND_WIDE_I64),
    ],
)
def test_element_kind_by_operands(spec, num_keys, kind):
    ops = _operands(spec)
    assert hs.element_kind(ops, num_keys) == kind
    k0, k1 = hs.key_operands(ops, kind)
    assert k0 is ops[0]
    assert k1 is (ops[1] if kind in (hs.KIND_PAIR32, hs.KIND_WIDE_PAIR) else ops[0])


@pytest.mark.parametrize(
    "spec, num_keys, match",
    [
        (("f32",), 1, "no CUDA kernel"),
        (("f32", "i32"), 2, "no CUDA kernel"),
        (("i32", "i64"), 2, "no CUDA kernel"),
        (("i64", "i32"), 2, "arange"),
        (("i64", "i64"), 2, "arange"),
        (("i32", "i32", "i32"), 3, "no CUDA kernel"),
    ],
)
def test_unsupported_operands_raise_naming_the_roadmap_item(spec, num_keys, match):
    with pytest.raises(ValueError, match=match) as err:
        hs.element_kind(_operands(spec), num_keys)
    assert "the kernels take one int32 or int64 key, two int32 keys" in str(err.value)


def _as_unsigned(bits):
    return bits.numpy().view(np.uint64)


def test_packed32_orders_by_key_then_index_and_unpacks():
    rng = np.random.default_rng(1)
    n = 4000
    key = rng.choice(np.concatenate([EXTREMES, rng.integers(-9, 9, 20).astype(np.int32)]), n)
    index = rng.permutation(n).astype(np.int32)
    bits = hs.pack_packed32(_t(key), _t(index))
    assert bits.dtype == torch.int64
    np.testing.assert_array_equal(np.argsort(_as_unsigned(bits), kind="stable"),
                                  np.lexsort((index, key)))
    got_key, got_index = hs.unpack_packed32(bits)
    np.testing.assert_array_equal(got_key.numpy(), key)
    np.testing.assert_array_equal(got_index.numpy(), index)
    # Padding (all ones) sorts after every real element, sentinel keys included.
    assert _as_unsigned(bits).max() < np.uint64(2**64 - 1)


def test_pair32_orders_by_both_keys_with_negative_second_keys_and_unpacks():
    rng = np.random.default_rng(2)
    n = 4000
    k0, k1 = rng.choice(EXTREMES, n), rng.choice(EXTREMES, n)
    bits = hs.pack_pair32(_t(k0), _t(k1))
    order = np.argsort(_as_unsigned(bits), kind="stable")
    want = np.lexsort((k1, k0))
    np.testing.assert_array_equal(k0[order], k0[want])
    np.testing.assert_array_equal(k1[order], k1[want])
    got0, got1 = hs.unpack_pair32(bits)
    np.testing.assert_array_equal(got0.numpy(), k0)
    np.testing.assert_array_equal(got1.numpy(), k1)
    # (INT32_MAX, INT32_MAX) is the padding's own value: it may tie, never exceed.
    both_max = hs.pack_pair32(_t(np.array([I32.max], np.int32)), _t(np.array([I32.max], np.int32)))
    assert _as_unsigned(both_max)[0] == np.uint64(2**64 - 1)


@pytest.mark.parametrize("kind", ["packed32", "pair32"])
def test_sorting_the_packed_elements_is_the_plain_sort(kind):
    rng = np.random.default_rng(3)
    n = 3000
    k0 = rng.choice(EXTREMES, n)
    if kind == "packed32":
        second = np.arange(n, dtype=np.int32)
        pack, unpack, num_keys = hs.pack_packed32, hs.unpack_packed32, 1
    else:
        second = rng.integers(I32.min, I32.max, n).astype(np.int32)
        pack, unpack, num_keys = hs.pack_pair32, hs.unpack_pair32, 2
    got = unpack(hs.sort_elements_plain(pack(_t(k0), _t(second))))
    want = hs.hbm_sort_plain((_t(k0), _t(second)), num_keys)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize(
    "n, npad, runs",
    [
        (1, hs.RUN, [hs.RUN]),
        (hs.TILE, hs.RUN, [hs.RUN]),
        (hs.RUN - 1, hs.RUN, [hs.RUN]),
        (hs.RUN, hs.RUN, [hs.RUN]),
        (hs.RUN + 1, 2 * hs.RUN, [hs.RUN]),
        (2 * hs.RUN, 2 * hs.RUN, [hs.RUN]),
        (2 * hs.RUN + 1, 3 * hs.RUN, [hs.RUN, 2 * hs.RUN]),
        (4 * hs.RUN + 1, 5 * hs.RUN, [hs.RUN, 2 * hs.RUN, 4 * hs.RUN]),
        (10_000_000, 1221 * hs.RUN, [hs.RUN << p for p in range(11)]),
        (20_000_000, 2442 * hs.RUN, [hs.RUN << p for p in range(12)]),
    ],
)
def test_pass_schedule(n, npad, runs):
    assert hs.pass_schedule(n) == (npad, runs)
    # Every pass's tiles are whole, and the last pass merges into one run.
    assert npad % hs.RUN == 0 and hs.RUN % hs.TILE == 0
    assert 2 * runs[-1] >= npad and (len(runs) == 1 or 2 * runs[-2] < npad)


@pytest.mark.parametrize("n", [0, -1, 2**31])
def test_pass_schedule_refuses_lengths_outside_the_index(n):
    with pytest.raises(ValueError, match="elements"):
        hs.pass_schedule(n)


_EDGE_CASES = {name: (arrays, num_keys) for name, arrays, num_keys in
               chip_smoke.element_edge_cases(np.random.default_rng(20241220))}


@pytest.mark.parametrize("name", sorted(_EDGE_CASES))
def test_edge_cases_plain_sort_matches_lax_sort(name):
    arrays, num_keys = _EDGE_CASES[name]
    got = hs.hbm_sort(tuple(_t(a) for a in arrays), num_keys)
    want = jax.lax.sort(tuple(jnp.asarray(a) for a in arrays), num_keys=num_keys, is_stable=True)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # On CPU tensors the wrapper plans the same element the card would sort.
    hs.element_kind(tuple(_t(a) for a in arrays), num_keys)


@pytest.mark.parametrize("name", ["packed32_extremes", "pair32_second_key_not_arange",
                                  "wide_pair_extremes"])
def test_edge_cases_plain_sort_matches_pallas_hbm_sort(name):
    arrays, num_keys = _EDGE_CASES[name]
    arrays = [a[:3000] for a in arrays]
    want = jax_hbm_sort(tuple(jnp.asarray(a) for a in arrays), interpret=True, chunk=512,
                        tile=256, num_keys=num_keys)
    got = hs.hbm_sort_plain(tuple(_t(a) for a in arrays), num_keys)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
