"""The join scan's look-back carry, in plain Python, against the JAX package.

The CUDA kernels of `csrc/join_scan.cu` scan in one pass: a block publishes
a summary of its own elements, folds the summaries of the blocks before it
and does its local work. `ops/kernels/join_scan.py` has that dataflow in
plain torch (`segment_summary`, `combine`, `join_scan_blocked_plain`), and
here it must equal the JAX Pallas kernel `join_scan_dest` (interpret mode,
256-element tiles) and the XLA scan block `_merged_dest_xla` exactly
(integer data: tolerance 0), for blocks of 1, 7, 64 and 256 elements and
one block of everything, on the adversarial cases of
tests/test_torch_join_scan.py plus one run across many blocks and a long
dead tail. `combine` must be associative, the fold of blocks must be the
summary of their union, and the two plain halves (one per kernel) must
compose to `_merged_dest_plain`. Inputs are made from a seed with numpy.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from pim_sort_merge_join_tpu.ops.join import _merged_dest_xla
from pim_sort_merge_join_tpu.ops.pallas.join_scan import join_scan_dest
from pim_sort_merge_join_tpu_torch.ops.kernels.join_scan import _merged_dest_plain
from pim_sort_merge_join_tpu_torch.ops.kernels import join_scan as js

TILE = 256
BLOCKS = (1, 7, 64, 256, None)  # None: one block of all n elements
CASES = ("mostly_unique", "long_runs", "wide_extremes", "int32_keys", "all_dead", "one_run",
         "side1_empty", "side2_empty", "one_run_many_blocks", "long_dead_tail")


def _merged(rng, n1, n2, pool, dtype=np.int64, sentinel_frac=0.1):
    k1 = rng.choice(pool, size=n1)
    k2 = rng.choice(pool, size=n2)
    sent = np.iinfo(dtype).max
    k1[rng.random(n1) < sentinel_frac] = sent
    k2[rng.random(n2) < sentinel_frac] = sent
    keys = np.concatenate([k1, k2]).astype(dtype)
    pos = np.arange(n1 + n2, dtype=np.int32)
    order = np.lexsort((pos, keys))
    return keys[order], pos[order], n1


@functools.lru_cache(maxsize=None)
def _case(name):
    rng = np.random.default_rng(41)
    if name == "mostly_unique":
        return _merged(rng, 700, 900, np.arange(1, 4000))
    if name == "long_runs":
        return _merged(rng, 700, 900, np.arange(1, 8))
    if name == "wide_extremes":
        return _merged(rng, 700, 900, np.array([-(2**40), -5, 0, 7, 2**40]))
    if name == "int32_keys":
        return _merged(rng, 512, 300, np.arange(1, 50), dtype=np.int32)
    if name == "all_dead":
        return np.full(400, np.iinfo(np.int64).max, np.int64), np.arange(400, dtype=np.int32), 200
    if name == "one_run":
        return np.full(1000, 42, np.int64), np.arange(1000, dtype=np.int32), 600
    if name == "side1_empty":
        return _merged(rng, 0, 700, np.arange(1, 30))
    if name == "side2_empty":
        return _merged(rng, 700, 0, np.arange(1, 30))
    if name == "one_run_many_blocks":  # 12 blocks of 256, both sides, side 2 the longer
        return np.full(3000, -7, np.int64), np.arange(3000, dtype=np.int32), 1300
    if name == "long_dead_tail":  # about 60% dead: the sentinel run spans many blocks
        return _merged(rng, 900, 1100, np.arange(1, 300), sentinel_frac=0.6)
    raise AssertionError(name)


def _torch_case(name):
    mkeys, mpos, cap1 = _case(name)
    return torch.from_numpy(mkeys), torch.from_numpy(mpos), cap1


@functools.lru_cache(maxsize=None)
def _pallas_reference(name):
    mkeys, mpos, cap1 = _case(name)
    dest, cnt = join_scan_dest(jnp.asarray(mkeys), jnp.asarray(mpos), cap1, interpret=True, tile=TILE)
    return np.asarray(dest), int(cnt)


@functools.lru_cache(maxsize=None)
def _xla_reference(name):
    mkeys, mpos, cap1 = _case(name)
    dest, cnt = _merged_dest_xla(jnp.asarray(mkeys), jnp.asarray(mpos), cap1)
    return np.asarray(dest), int(cnt)


def _blocked(name, block):
    mk, mp, cap1 = _torch_case(name)
    dest, num_out = js.join_scan_blocked_plain(mk, mp, cap1, block or mk.shape[0])
    assert dest.dtype == torch.int32 and num_out.dtype == torch.int32 and num_out.dim() == 0
    return dest.numpy(), int(num_out)


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("name", CASES)
def test_blocked_scan_matches_pallas_kernel(name, block):
    want_dest, want_cnt = _pallas_reference(name)
    got_dest, got_cnt = _blocked(name, block)
    np.testing.assert_array_equal(got_dest, want_dest)
    assert got_cnt == want_cnt


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("name", CASES)
def test_blocked_scan_matches_xla_scan(name, block):
    want_dest, want_cnt = _xla_reference(name)
    got_dest, got_cnt = _blocked(name, block)
    np.testing.assert_array_equal(got_dest, want_dest)
    assert got_cnt == want_cnt


@pytest.mark.parametrize("name", CASES)
def test_plain_halves_compose_to_the_plain_scan(name):
    mk, mp, cap1 = _torch_case(name)
    cand, m2cum = js.join_scan_forward_plain(mk, mp, cap1)
    assert cand.dtype == torch.int32 and m2cum.dtype == torch.int32
    dest, num_out = js.join_scan_backward_plain(mk, cand, m2cum)
    want_dest, want_num = _merged_dest_plain(mk, mp, cap1)
    assert dest.dtype == want_dest.dtype and num_out.dtype == want_num.dtype and num_out.dim() == 0
    assert torch.equal(dest, want_dest)
    assert int(num_out) == int(want_num)


@pytest.mark.parametrize("name", CASES)
def test_last_m2cum_is_num_out_and_the_whole_summary_counts_it(name):
    mk, mp, cap1 = _torch_case(name)
    _, m2cum = js.join_scan_forward_plain(mk, mp, cap1)
    want = int(_merged_dest_plain(mk, mp, cap1)[1])
    assert int(m2cum[-1]) == want == _xla_reference(name)[1]
    whole = js.segment_summary(mk, mp, cap1, 0, mk.shape[0])
    assert whole.has_head and (whole.p1, whole.p2) == (0, 0)  # element 0 starts a run
    assert whole.m2cum == want


@pytest.mark.parametrize("name", CASES)
def test_forward_candidates_encode_three_kinds(name):
    """`cand` is a slot below n for a matched side-2 element, a complement
    (negative) for a live side-1 element and n for everything else."""
    mk, mp, cap1 = _torch_case(name)
    n = mk.shape[0]
    cand, m2cum = js.join_scan_forward_plain(mk, mp, cap1)
    live = mk != torch.iinfo(mk.dtype).max
    side1 = mp < cap1
    assert bool((cand[live & side1] < 0).all())
    assert bool((cand[~live] == n).all())
    matched2 = ~side1 & (cand != n)
    assert torch.equal(cand[matched2], m2cum[matched2] - 1)
    assert int(matched2.sum()) == int(m2cum[-1])


def _summaries(name, block):
    mk, mp, cap1 = _torch_case(name)
    n = mk.shape[0]
    bounds = [(lo, min(lo + block, n)) for lo in range(0, n, block)]
    return bounds, [js.segment_summary(mk, mp, cap1, lo, hi) for lo, hi in bounds]


def _fold(parts, rng):
    """Combine ``parts`` in order under a random bracketing."""
    if len(parts) == 1:
        return parts[0]
    cut = int(rng.integers(1, len(parts)))
    return js.combine(_fold(parts[:cut], rng), _fold(parts[cut:], rng))


@settings(max_examples=40, deadline=None, database=None)
@given(name=st.sampled_from(CASES), block=st.sampled_from((1, 3, 7, 64, 256)),
       seed=st.integers(0, 2**32 - 1))
def test_combine_is_associative_over_random_bracketings(name, block, seed):
    _, parts = _summaries(name, block)
    left = functools.reduce(js.combine, parts)
    assert _fold(parts, np.random.default_rng(seed)) == left
    right = functools.reduce(lambda acc, s: js.combine(s, acc), reversed(parts))
    assert right == left


@settings(max_examples=40, deadline=None, database=None)
@given(name=st.sampled_from(CASES), block=st.sampled_from((1, 3, 7, 64, 256)),
       seed=st.integers(0, 2**32 - 1))
def test_fold_of_blocks_is_the_summary_of_their_union(name, block, seed):
    mk, mp, cap1 = _torch_case(name)
    bounds, parts = _summaries(name, block)
    rng = np.random.default_rng(seed)
    first = int(rng.integers(0, len(parts)))
    last = int(rng.integers(first, len(parts)))
    union = js.segment_summary(mk, mp, cap1, bounds[first][0], bounds[last][1])
    assert functools.reduce(js.combine, parts[first:last + 1]) == union


@pytest.mark.parametrize("name", CASES)
def test_empty_summary_is_the_identity_of_combine(name):
    mk, mp, cap1 = _torch_case(name)
    n = mk.shape[0]
    for lo, hi in ((0, n), (n // 3, 2 * n // 3), (n - 1, n)):
        s = js.segment_summary(mk, mp, cap1, lo, hi)
        assert js.combine(js.EMPTY, s) == s == js.combine(s, js.EMPTY)


def test_combine_closes_the_open_run_with_the_next_segments_lead():
    # A: a run of 3 side-1 and 1 side-2 still open; B: 2 more side-2 of it,
    # then a closed run with 1 match and an open run of 4 side-1.
    a = js.Summary(True, 0, 0, 5, 3, 1)
    b = js.Summary(True, 0, 2, 1, 4, 0)
    assert js.combine(a, b) == js.Summary(True, 0, 0, 5 + min(3, 3) + 1, 4, 0)
    # B without a head only lengthens A's open run; A without a head only
    # lengthens B's lead.
    assert js.combine(a, js.Summary(False, 2, 7, 0, 0, 0)) == js.Summary(True, 0, 0, 5, 5, 8)
    assert js.combine(js.Summary(False, 2, 7, 0, 0, 0), b) == js.Summary(True, 2, 9, 1, 4, 0)
    assert js.combine(js.Summary(False, 2, 7, 0, 0, 0), js.Summary(False, 1, 1, 0, 0, 0)) == \
        js.Summary(False, 3, 8, 0, 0, 0)


def test_blocked_scan_of_nothing():
    empty = torch.empty(0, dtype=torch.int64)
    dest, num_out = js.join_scan_blocked_plain(empty, empty.to(torch.int32), 0, 64)
    assert dest.shape == (0,) and dest.dtype == torch.int32 and int(num_out) == 0
