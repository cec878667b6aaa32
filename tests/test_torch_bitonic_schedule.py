"""What the bitonic sort's wrapper plans in Python, on the CPU.

`bitonic_schedule` cuts the network into the launches of
`csrc/bitonic_sort.cu`; `tile_indices` is the kernel's index arithmetic;
`bitonic_sort_blocked_plain` runs both as torch ops. Here: the schedule
covers every ``(k, j)`` of the network once and in order at several tile
sizes; every pass's tiles partition the array; the blocked version equals
the plain network and the JAX Pallas kernel in interpret mode; the 64-bit
element keeps the signed lexicographic order. Integer data, no tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pim_sort_merge_join_tpu.ops.pallas import sort_kernel as jbitonic
from pim_sort_merge_join_tpu_torch.ops.kernels import bitonic_sort as bs
from pim_sort_merge_join_tpu_torch.ops.kernels import build
from pim_sort_merge_join_tpu_torch.ops.kernels.hbm_sort import pack_pair32, unpack_pair32

I32 = np.iinfo(np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _min_chunk(log_tile):
    return min(bs.LOG_MIN_CHUNK, log_tile - 1)


@pytest.mark.parametrize("log_tile", [3, 6, 12])
@pytest.mark.parametrize("m", range(1, 17))
def test_schedule_covers_the_network_once_and_in_order(log_tile, m):
    n = 1 << m
    passes = bs.bitonic_schedule(n, log_tile, _min_chunk(log_tile))
    got = [kj for p in passes for kj in p.substeps()]
    assert got == list(bs._substeps(n))
    group = log_tile - _min_chunk(log_tile)
    for p in passes:
        assert all(kj for kj in p.substeps()), p  # no empty launch
        if p.strided:
            # Its substeps all lie at or above the tile, at most `group` of them.
            assert p.first_stage == p.last_stage and p.low_bit == p.lo >= log_tile
            assert 1 <= len(list(p.substeps())) == log_tile - p.chunk <= group
            assert all(j >= 1 << log_tile for _, j in p.substeps())
        else:
            assert p.chunk == p.lo == log_tile and p.low_bit == 0
            assert all(j < 1 << log_tile for _, j in p.substeps())
    # One local pass for the tiles' own sorts, then per stage above the tile
    # its strided passes and one local pass.
    stages_above = max(m - log_tile, 0)
    assert sum(not p.strided for p in passes) == 1 + stages_above
    assert sum(p.strided for p in passes) == sum(
        -(-(s - log_tile) // group) for s in range(log_tile + 1, m + 1))


@pytest.mark.parametrize("log_tile,m", [(3, 2), (3, 3), (3, 9), (6, 14), (12, 16), (13, 21)])
def test_every_pass_partitions_the_array_into_its_tiles(log_tile, m):
    n = 1 << m
    for p in bs.bitonic_schedule(n, log_tile, _min_chunk(log_tile)):
        idx = bs.tile_indices(p, n)
        assert idx.shape == (max(n >> log_tile, 1), min(n, 1 << log_tile))
        assert torch.equal(torch.sort(idx.reshape(-1)).values, torch.arange(n))
        # The partner of every substep lies in the same tile, at the tile
        # distance the blocked version and the kernel use.
        for _, j in p.substeps():
            b = j.bit_length() - 1
            tj = 1 << (b if b < p.chunk else b - p.lo + p.chunk)
            assert torch.equal(idx[:, tj:2 * tj] - idx[:, :tj], torch.full_like(idx[:, :tj], j))
        # Neighbouring tile elements are neighbours in memory in pieces of
        # 2^chunk: what the kernel's 128-bit accesses rely on.
        piece = idx[:, : 1 << min(p.chunk, log_tile, m)]
        assert torch.equal(piece - piece[:, :1], torch.arange(piece.shape[1]).expand_as(piece))


def test_the_shipped_schedule_at_the_cap():
    passes = bs.bitonic_schedule(bs.PALLAS_SORT_MAX)
    assert len(passes) == 17 <= 20
    assert [p.strided for p in passes] == [False] + [True, False] * 8
    assert len(bs.bitonic_schedule(bs.MIN_WIDTH)) == 1
    # One strided pass per stage up to 2^(2 * LOG_TILE - LOG_MIN_CHUNK); two beyond.
    wide = bs.bitonic_schedule(1 << 23)
    assert sum(p.strided for p in wide if p.first_stage == 22) == 1
    assert sum(p.strided for p in wide if p.first_stage == 23) == 2
    with pytest.raises(ValueError, match="power of two"):
        bs.bitonic_schedule(300)
    with pytest.raises(ValueError, match="chunk"):
        bs.bitonic_schedule(256, log_tile=4, log_min_chunk=4)


def test_sizes_mirror_the_cuda_source():
    text = (build.CSRC_DIR / "bitonic_sort.cu").read_text()
    assert f"#define SMJ_BITONIC_LOG_TILE {bs.LOG_TILE}\n" in text
    assert f"#define SMJ_BITONIC_LOG_MIN_CHUNK {bs.LOG_MIN_CHUNK}\n" in text


SMALL_CASES = [c for c in chip_smoke.bitonic_width_cases(np.random.default_rng(91), 6)
               if c[1].shape[0] <= 512]


@pytest.mark.parametrize("case", SMALL_CASES, ids=[c[0] for c in SMALL_CASES])
@pytest.mark.parametrize("log_tile", [3, 6])
def test_blocked_plain_equals_the_plain_network(case, log_tile):
    name, keys, vals = case
    want = bs.bitonic_sort_plain(_t(keys), _t(vals))
    got = bs.bitonic_sort_blocked_plain(_t(keys), _t(vals), log_tile, _min_chunk(log_tile))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and torch.equal(g, w)
    order = np.lexsort((vals, keys))
    np.testing.assert_array_equal(got[0].numpy(), keys[order])
    np.testing.assert_array_equal(got[1].numpy(), vals[order])


def _pallas_cases():
    rng = np.random.default_rng(92)
    extremes = np.array([I32.min, I32.min + 1, -1, 0, I32.max - 1, I32.max], np.int32)
    n = 1024
    iota = np.arange(n, dtype=np.int32)
    return [
        ("random_256", rng.integers(0, 1 << 30, 256).astype(np.int32), np.arange(256, dtype=np.int32)),
        ("few_distinct", rng.integers(0, 4, n).astype(np.int32), iota),
        ("extremes_and_sentinels", rng.choice(extremes, n), rng.choice(extremes, n)),
        ("descending", iota[::-1].copy(), iota),
        ("equal_pairs", rng.integers(0, 3, n).astype(np.int32), rng.integers(0, 3, n).astype(np.int32)),
    ]


PALLAS_CASES = _pallas_cases()


@pytest.mark.parametrize("case", PALLAS_CASES, ids=[c[0] for c in PALLAS_CASES])
def test_blocked_plain_equals_the_pallas_kernel_in_interpret_mode(case):
    name, keys, vals = case
    want = jbitonic._sort_pairs_pallas_p2(jnp.asarray(keys), jnp.asarray(vals), interpret=True)
    for log_tile in (4, 8):
        got = bs.bitonic_sort_blocked_plain(_t(keys), _t(vals), log_tile, _min_chunk(log_tile))
        for g, w in zip(got, want):
            assert g.numpy().dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_blocked_plain_at_the_shipped_tile():
    rng = np.random.default_rng(93)
    n = 1 << 15  # two stages above the shipped tile
    keys = rng.integers(-3, 3, n).astype(np.int32)
    vals = rng.integers(I32.min, I32.max, n).astype(np.int32)
    got = bs.bitonic_sort_blocked_plain(_t(keys), _t(vals))
    order = np.lexsort((vals, keys))
    np.testing.assert_array_equal(got[0].numpy(), keys[order])
    np.testing.assert_array_equal(got[1].numpy(), vals[order])


def test_the_packed_element_keeps_the_signed_lexicographic_order():
    extremes = np.array([I32.min, I32.min + 1, -1, 0, 1, I32.max - 1, I32.max], np.int32)
    keys, vals = (a.reshape(-1) for a in np.meshgrid(extremes, extremes, indexing="ij"))
    bits = pack_pair32(_t(keys), _t(vals))
    back = unpack_pair32(bits)
    np.testing.assert_array_equal(back[0].numpy(), keys)
    np.testing.assert_array_equal(back[1].numpy(), vals)
    # As unsigned 64-bit numbers the elements order as (key, val) do: the
    # grid above is already in that order.
    unsigned = bits.numpy().view(np.uint64)
    assert np.all(unsigned[1:] > unsigned[:-1])
    # The kernel pads with all ones: no pair sorts after it.
    assert unsigned[-1] == np.uint64(2**64 - 1)


def test_plain_versions_launch_no_kernel():
    from pim_sort_merge_join_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    a = torch.arange(512, dtype=torch.int32)
    bs.bitonic_sort_blocked_plain(torch.flip(a, [0]), a, 4, 2)
    with pytest.raises(ValueError, match="must share one CUDA device"):
        bs.bitonic_sort_cuda(a, a)
    assert all(n == 0 for n in kernels.launch_counts().values())
