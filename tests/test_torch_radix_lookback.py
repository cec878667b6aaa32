"""What the radix sorts' kernels plan, in plain Python on the CPU.

`lsd_radix_blocked_plain` is the global sort's dataflow at any tile size
(every pass's histogram from one read of the key, the exclusive fold over
the tiles in ticket order, the stable rank inside a tile, the scatter); it
must equal the JAX `xla_lsd_radix_sort`, the port's plain version and
numpy's stable sort at tiles of 1, 7, 64, 256 and n. `tile_rank_plain` and
`radix_tile_sort_blocked_plain` are the tile kernel's ranking (warp-striped
elements, the warps' running counts, their prefixes) and must equal a
stable sort by digit, the plain tile sort and the JAX Pallas kernel in
interpret mode. `digit_is_constant` is the rule by which a pass is skipped.
The block shapes, shared-memory sizes and state layout are held against
the constants of `csrc/radix_sort.cu`. Integer data: every comparison is
exact.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pim_sort_merge_join_tpu.ops.pallas import radix_sort as jradix
from pim_sort_merge_join_tpu_torch.ops import kernels
from pim_sort_merge_join_tpu_torch.ops.kernels import build
from pim_sort_merge_join_tpu_torch.ops.kernels import radix_sort as rs

I32 = np.iinfo(np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def lsd_cases():
    """name -> (operands as int32 numpy arrays, digit_bits, key_bits)."""
    rng = np.random.default_rng(81)

    def payload(n):
        return rng.integers(I32.min, I32.max, n, dtype=np.int32)

    def keys(n, hi):
        return rng.integers(0, hi, n, dtype=np.int32)

    n = 300
    sent = keys(n, 1 << 20)
    sent[rng.random(n) < 0.15] = I32.max
    one_digit = (keys(n, 256) | (0x5A << 8) | (keys(n, 64) << 16)).astype(np.int32)
    return {
        "all_equal": ([np.full(n, 7, np.int32), payload(n)], 8, 32),
        "one_digit_in_the_second_pass": ([one_digit, payload(n)], 8, 32),
        "sentinels_b31": ([sent, np.arange(n, dtype=np.int32)], 8, 31),
        "sentinels_b32_d4": ([sent, payload(n)], 4, 32),
        "negative_keys_b32": ([rng.integers(-1000, 1000, n, dtype=np.int32), payload(n)], 8, 32),
        "int32_extremes_b32": ([rng.choice(np.array([I32.min, I32.min + 1, -1, 0, 1, I32.max - 1,
                                                      I32.max], np.int32), n), payload(n)], 8, 32),
        "key_bits_12": ([keys(n, 1 << 12), payload(n)], 8, 12),
        "key_bits_12_wider_keys": ([keys(n, 1 << 20), payload(n)], 4, 12),
        "key_bits_25": ([rng.permutation(1 << 25)[:n].astype(np.int32), payload(n)], 8, 25),
        "key_bits_31_d7": ([keys(n, I32.max), payload(n)], 7, 31),
        "key_bits_32_d7": ([rng.integers(I32.min, I32.max, n, dtype=np.int32), payload(n)], 7, 32),
        "few_distinct_d4": ([keys(n, 5), np.arange(n, dtype=np.int32)], 4, 32),
        "key_only": ([sent.copy()], 8, 32),
        "three_operands": ([keys(n, 50), payload(n), np.arange(n, dtype=np.int32)], 8, 32),
        "four_operands_d7": ([keys(n, 1 << 14), payload(n), payload(n), payload(n)], 7, 14),
        "n_513": ([keys(513, 3 * 513), payload(513)], 8, 32),
        "n_0": ([np.zeros(0, np.int32), np.zeros(0, np.int32)], 8, 32),
        "n_1": ([np.array([-5], np.int32), np.array([9], np.int32)], 8, 32),
    }


LSD_CASES = lsd_cases()
_jax_results: dict = {}


def _numpy_sorted(arrays, digit_bits, key_bits):
    """The stable sort by the bits the passes read: the low
    ``npass * digit_bits`` of the key as an unsigned 32-bit value."""
    bits = -(-key_bits // digit_bits) * digit_bits
    seen = (arrays[0].astype(np.int64) & 0xFFFFFFFF) & ((1 << bits) - 1)
    order = np.argsort(seen, kind="stable")
    return [a[order] for a in arrays]


def _assert_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("tile", [1, 7, 64, 256, "n"])
@pytest.mark.parametrize("name", list(LSD_CASES))
def test_lsd_blocked_plain_matches_reference_plain_and_numpy(name, tile):
    arrays, digit_bits, key_bits = LSD_CASES[name]
    n = arrays[0].shape[0]
    kw = dict(digit_bits=digit_bits, key_bits=key_bits)
    ops = tuple(_t(a) for a in arrays)
    got = rs.lsd_radix_blocked_plain(ops, tile=max(n, 1) if tile == "n" else tile, **kw)
    _assert_equal(got, _numpy_sorted(arrays, digit_bits, key_bits))
    _assert_equal(got, [w.numpy() for w in rs.xla_lsd_radix_sort_plain(ops, **kw)])
    if n:  # the reference indexes the last row of an [n, v] prefix
        if name not in _jax_results:
            _jax_results[name] = jradix.xla_lsd_radix_sort(tuple(jnp.asarray(a) for a in arrays), **kw)
        _assert_equal(got, _jax_results[name])


def test_lsd_wrapper_takes_the_plain_version_on_cpu_tensors():
    arrays, digit_bits, key_bits = LSD_CASES["three_operands"]
    ops = tuple(_t(a) for a in arrays)
    before = kernels.launch_counts()
    got = rs.xla_lsd_radix_sort(ops, digit_bits=digit_bits, key_bits=key_bits)
    _assert_equal(got, _numpy_sorted(arrays, digit_bits, key_bits))
    assert kernels.launch_counts() == before
    with pytest.raises(ValueError, match="unsupported devices"):
        rs.xla_lsd_radix_sort((ops[0].to("meta"),))
    with pytest.raises(ValueError, match="tensors must share one CUDA device"):
        rs.xla_lsd_radix_sort_cuda(ops)  # never the plain version by another door


@pytest.mark.parametrize(
    "or_bits,and_bits,shift,digit_bits,want",
    [
        (7, 7, 0, 8, True),  # all keys equal
        (0x5AFF, 0x5A00, 0, 8, False),
        (0x5AFF, 0x5A00, 8, 8, True),  # the second digit is 0x5A everywhere
        (0x5AFF, 0x5A00, 16, 8, True),  # all zero above
        (0x01FFFFFF, 0, 24, 8, False),  # keys below 2^25: bit 24 still differs
        (0x00FFFFFF, 0, 24, 8, True),
        (-1, 0, 28, 7, False),  # negative and non-negative keys: bit 31 differs
        (-1, I32.min, 31, 1, True),  # all negative
        (I32.max, 5, 28, 7, False),
        (0x10, 0x10, 4, 4, True),
        (0x30, 0x10, 4, 4, False),
    ],
)
def test_digit_is_constant_is_the_pass_skip_rule(or_bits, and_bits, shift, digit_bits, want):
    assert rs.digit_is_constant(or_bits, and_bits, shift, digit_bits) is want


@pytest.mark.parametrize("digit_bits,key_bits", [(8, 32), (4, 20), (7, 31)])
def test_digit_is_constant_agrees_with_the_keys(digit_bits, key_bits):
    rng = np.random.default_rng(82)
    for _ in range(20):
        fixed = int(rng.integers(I32.min, I32.max))
        free = int(rng.integers(0, 1 << 32)) & int(rng.integers(0, 1 << 32))
        keys = ((rng.integers(0, 1 << 32, 40) & free) | (fixed & ~free & 0xFFFFFFFF))
        keys = keys.astype(np.uint32).view(np.int32)
        or_bits, and_bits = int(np.bitwise_or.reduce(keys)), int(np.bitwise_and.reduce(keys))
        for p in range(-(-key_bits // digit_bits)):
            shift = p * digit_bits
            digits = (keys >> shift) & ((1 << digit_bits) - 1)  # arithmetic, as the kernel
            assert rs.digit_is_constant(or_bits, and_bits, shift, digit_bits) == (
                len(set(digits.tolist())) == 1)


@pytest.mark.parametrize(
    "count,threads,items,v",
    [(512, 128, 4, 256), (100, 128, 4, 16), (1, 128, 4, 256), (2048, 256, 8, 256),
     (2047, 256, 8, 4), (300, 128, 4, 2), (8192, 512, 16, 256), (5000, 512, 16, 128),
     (33, 32, 2, 8)],
)
def test_tile_rank_is_the_stable_rank_by_digit(count, threads, items, v):
    rng = np.random.default_rng(83)
    digit = rng.integers(0, v, count)
    if count > 64:
        digit[10:60] = v - 1  # a run of one digit across two warps' items
    place = rs.tile_rank_plain(_t(digit), threads, items, v)
    want = np.empty(count, np.int64)
    want[np.argsort(digit, kind="stable")] = np.arange(count)
    np.testing.assert_array_equal(place.numpy(), want)


def _tile_case(name):
    rng = np.random.default_rng(84)

    def keys(n, hi):
        k = rng.integers(0, hi, n, dtype=np.int32)
        k[rng.random(n) < 0.1] = I32.max
        return k

    def payload(n):
        return rng.integers(I32.min, I32.max, n, dtype=np.int32)

    return {
        "odd_tile_d4_b12": ([keys(300, 40), payload(300)], 100, 4, 12),
        "tile256_d8": ([keys(768, 3 * 768), payload(768)], 256, 8, 32),
        "tile128_key_only": ([keys(384, 50)], 128, 4, 32),
        "tile256_three_operands": ([keys(512, 10), payload(512), np.arange(512, dtype=np.int32)],
                                   256, 8, 32),
        "tile512_negative": ([rng.integers(-1000, 1000, 1024, dtype=np.int32), payload(1024)],
                             512, 8, 32),
        "tile600_eight_operands": ([keys(1200, 1 << 16)] + [payload(1200) for _ in range(7)],
                                   600, 8, 20),
        "tile2048_one_digit": ([np.full(2048, 0x1234, np.int32), payload(2048)], 2048, 8, 32),
        "tile2048_d7": ([keys(4096, 1 << 24), payload(4096)], 2048, 7, 31),
        "tile4100": ([keys(4100, 1 << 24), payload(4100)], 4100, 8, 25),
    }[name]


TILE_CASES = ["odd_tile_d4_b12", "tile256_d8", "tile128_key_only", "tile256_three_operands",
              "tile512_negative", "tile600_eight_operands", "tile2048_one_digit", "tile2048_d7",
              "tile4100"]


@pytest.mark.parametrize("name", TILE_CASES)
def test_tile_sort_blocked_plain_matches_plain(name):
    arrays, tile, digit_bits, key_bits = _tile_case(name)
    kw = dict(tile=tile, digit_bits=digit_bits, key_bits=key_bits)
    ops = tuple(_t(a) for a in arrays)
    got = rs.radix_tile_sort_blocked_plain(ops, **kw)
    _assert_equal(got, [w.numpy() for w in rs.radix_tile_sort_plain(ops, **kw)])


@pytest.mark.parametrize("name", ["odd_tile_d4_b12", "tile256_d8", "tile128_key_only",
                                  "tile256_three_operands"])
def test_tile_sort_blocked_plain_matches_pallas_interpret(name):
    arrays, tile, digit_bits, key_bits = _tile_case(name)
    kw = dict(tile=tile, digit_bits=digit_bits, key_bits=key_bits)
    want = jradix.radix_tile_sort(tuple(jnp.asarray(a) for a in arrays), interpret=True, **kw)
    _assert_equal(rs.radix_tile_sort_blocked_plain(tuple(_t(a) for a in arrays), **kw), want)


@pytest.mark.parametrize("tile,want", [(1, (64, 8)), (100, (64, 8)), (512, (64, 8)),
                                       (513, (64, 16)), (1024, (64, 16)), (2048, (128, 16)),
                                       (2049, (256, 16)), (4096, (256, 16)), (8192, (512, 16)),
                                       (8193, (1024, 16)), (16384, (1024, 16))])
def test_tile_config_gives_the_block_that_holds_the_tile(tile, want):
    threads, items = rs.tile_config(tile)
    assert (threads, items) == want
    assert threads * items >= tile and threads % 32 == 0
    # The 16-bit rank inside a warp and the position in the tile both fit.
    assert 32 * items < 1 << 16 and tile <= 1 << 16
    smem = rs.tile_smem_bytes(tile, 8)
    assert smem == tile * 8 + (threads // 32 + 2) * 256 * 4 + 16 <= rs.MAX_SMEM


def test_tile_config_refuses_what_no_block_holds():
    with pytest.raises(ValueError, match="shared memory"):
        rs.tile_config(16385)
    with pytest.raises(ValueError, match="shared memory"):
        rs.tile_smem_bytes(1 << 16, 8)
    # 16-bit digits: the warps' counters alone outgrow a block.
    assert rs.tile_smem_bytes(256, 16) > rs.MAX_SMEM
    assert rs.lsd_smem_bytes(8) == 8192 * 8 + 19 * 256 * 4 <= rs.MAX_SMEM // 2  # two blocks per SM
    assert rs.lsd_smem_bytes(11) <= rs.MAX_SMEM < rs.lsd_smem_bytes(12)


def test_state_words_hold_tickets_histograms_and_records():
    tile = rs.LSD_THREADS * rs.LSD_ITEMS
    assert rs.lsd_state_words(1, 8, 4) == rs.LSD_HEADER + 4 * 256 * 2
    assert rs.lsd_state_words(tile, 8, 4) == rs.LSD_HEADER + 4 * 256 * 2
    assert rs.lsd_state_words(tile + 1, 8, 4) == rs.LSD_HEADER + 4 * 256 * 3
    assert rs.lsd_state_words(20_000_000, 8, 4) == rs.LSD_HEADER + 4 * 256 * (1 + 2442)
    assert rs.lsd_state_words(1000, 4, 8, tile=7) == rs.LSD_HEADER + 8 * 16 * (1 + 143)
    # A record's count shares its word with two status bits.
    assert rs.LSD_MAX_N == 1 << 30


def test_module_mirrors_the_constants_of_the_cuda_source():
    text = (build.CSRC_DIR / "radix_sort.cu").read_text()
    defined = text.split("#define SMJ_RADIX_CONFIGS(X)")[1].split("\n\n")[0]
    configs = tuple(tuple(int(x) for x in m)
                    for m in re.findall(r"X\((\d+), (\d+), (\d+)\)", defined))
    assert configs == rs.TILE_CONFIGS
    assert all(cap == threads * items for cap, threads, items in configs)
    assert list(configs) == sorted(configs)
    for name, value in (("SMJ_RADIX_MAX_OPS", rs.MAX_OPS), ("SMJ_RADIX_MAX_SMEM", rs.MAX_SMEM),
                        ("SMJ_LSD_THREADS", rs.LSD_THREADS), ("SMJ_LSD_ITEMS", rs.LSD_ITEMS),
                        ("SMJ_LSD_HEADER", rs.LSD_HEADER),
                        ("SMJ_LSD_HIST_MAX_SMEM", rs.LSD_HIST_MAX_SMEM)):
        assert re.search(rf"#define {name} {value}\b", text), name
    # The shared-memory formulas, as the source writes them.
    assert "tile * 8 + ((int64_t)(threads / 32 + 2) << digit_bits) * 4 + 16" in text
    assert "(int64_t)SMJ_LSD_TILE * 8 + ((int64_t)(SMJ_LSD_THREADS / 32 + 3) << digit_bits) * 4" in text
    assert "SMJ_LSD_HEADER + ((int64_t)npass << digit_bits) * (1 + tiles)" in text
