"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips. On a machine
with the card and no jax, run them without the JAX test harness:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

The cases are the adversarial ones `chip_smoke.py` runs (those of
tests/test_hbm_sort.py, tests/test_join_scan.py, tests/test_pallas_sort.py
and tests/test_radix.py, plus runs that cross the scan's blocks, every
width of the bitonic network, and the row and column gathers' windows,
edges and alignments, and the global radix sort around its tile, over many
tiles and twenty times over). Every comparison is exact.
"""

import numpy as np
import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_hbm_sort_kernel_matches_plain(cuda):
    import chip_smoke
    from pim_sort_merge_join_tpu_torch.ops.kernels import hbm_sort as hs

    for name, arrays, num_keys in chip_smoke.sort_cases(np.random.default_rng(61)):
        ops = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in arrays)
        got = hs.hbm_sort(ops, num_keys)
        want = hs.hbm_sort_plain(ops, num_keys)
        for g, w in zip(got, want):
            assert torch.equal(g, w), name


@pytest.mark.parametrize("kind", ["packed32", "pair32", "wide_pair", "wide_i64"])
def test_hbm_sort_element_kinds_at_run_and_tile_edges(cuda, kind):
    import chip_smoke
    from pim_sort_merge_join_tpu_torch.ops import kernels
    from pim_sort_merge_join_tpu_torch.ops.kernels import hbm_sort as hs

    cases = [c for c in chip_smoke.element_edge_cases(np.random.default_rng(65))
             if c[0].startswith(kind)]
    assert len(cases) >= 6
    for name, arrays, num_keys in cases:
        ops = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in arrays)
        kernels.reset_launch_counts()
        got = hs.hbm_sort(ops, num_keys)
        counts = kernels.launch_counts()
        # One run sort, one launch per pass of the schedule, and a gather
        # unless the last pass wrote every operand itself.
        assert counts["hbm_sort_chunk"] == 1, name
        assert counts["hbm_sort_merge"] == len(hs.pass_schedule(len(arrays[0]))[1]), name
        assert (counts["hbm_sort_gather"] == 0) == (kind == "pair32"), name
        for g, w in zip(got, hs.hbm_sort_plain(ops, num_keys)):
            assert g.dtype == w.dtype and torch.equal(g, w), name


def test_default_device_is_the_card(cuda):
    from pim_sort_merge_join_tpu_torch import QueryPipeline, Table
    from pim_sort_merge_join_tpu_torch.columnar import csv_io
    from pim_sort_merge_join_tpu_torch.convert import table_from_reference

    assert QueryPipeline().device.type == "cuda"
    rows = np.arange(12, dtype=np.int64).reshape(4, 3)
    assert Table.from_numpy(rows).device.type == "cuda"
    assert Table.empty(3, 8).num_rows.device.type == "cuda"
    assert table_from_reference(rows, 4, ("a", "b", "c")).device.type == "cuda"
    assert csv_io.load_csv.__kwdefaults__["device"] is None


def test_join_scan_kernel_matches_plain(cuda):
    import chip_smoke
    from pim_sort_merge_join_tpu_torch.ops.kernels.join_scan import _merged_dest_plain
    from pim_sort_merge_join_tpu_torch.ops.kernels import join_scan as js

    for name, mkeys, mpos, cap1 in chip_smoke.scan_cases(np.random.default_rng(62)):
        mk, mp = torch.from_numpy(mkeys).to(cuda), torch.from_numpy(mpos).to(cuda)
        dest, num_out = js.join_scan_cuda(mk, mp, cap1)
        want_dest, want_num = _merged_dest_plain(mk, mp, cap1)
        assert torch.equal(dest, want_dest), name
        assert int(num_out) == int(want_num), name


def _scan_inputs(cuda, mkeys, mpos, dtype):
    """The case's tensors on the card with ``dtype`` keys, or None where a
    live key does not fit."""
    import chip_smoke

    for keys in chip_smoke.key_widths(mkeys):
        if torch.from_numpy(keys).dtype == dtype:
            return torch.from_numpy(keys).to(cuda), torch.from_numpy(mpos).to(cuda)
    return None


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_join_scan_forward_matches_its_plain_half(cuda, dtype):
    import chip_smoke
    from pim_sort_merge_join_tpu_torch.ops.kernels import join_scan as js

    ran = 0
    for name, mkeys, mpos, cap1 in chip_smoke.scan_cases(np.random.default_rng(66)):
        inputs = _scan_inputs(cuda, mkeys, mpos, dtype)
        if inputs is None:
            continue
        ran += 1
        cand, m2cum = js.join_scan_forward(*inputs, cap1)
        want_cand, want_m2cum = js.join_scan_forward_plain(*inputs, cap1)
        assert torch.equal(cand, want_cand), name
        assert torch.equal(m2cum, want_m2cum), name
    assert ran >= 15


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_join_scan_backward_matches_its_plain_half(cuda, dtype):
    import chip_smoke
    from pim_sort_merge_join_tpu_torch.ops.kernels import join_scan as js

    ran = 0
    for name, mkeys, mpos, cap1 in chip_smoke.scan_cases(np.random.default_rng(67)):
        inputs = _scan_inputs(cuda, mkeys, mpos, dtype)
        if inputs is None:
            continue
        ran += 1
        cand, m2cum = js.join_scan_forward_plain(*inputs, cap1)
        dest, num_out = js.join_scan_backward(inputs[0], cand, m2cum)
        want_dest, want_num = js.join_scan_backward_plain(inputs[0], cand, m2cum)
        assert torch.equal(dest, want_dest), name
        assert int(num_out) == int(want_num), name
    assert ran >= 15


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_join_scan_at_the_block_edges(cuda, dtype):
    import chip_smoke
    from pim_sort_merge_join_tpu_torch.ops.kernels.join_scan import _merged_dest_plain
    from pim_sort_merge_join_tpu_torch.ops.kernels import join_scan as js

    block = js.block_size()
    rng = np.random.default_rng(68)
    mkeys, mpos, cap1 = chip_smoke.merged_case(rng, 17 * block, 17 * block, np.arange(1, 5 * block))
    mk, mp = _scan_inputs(cuda, mkeys, mpos, dtype)
    for n in (1, block - 1, block, block + 1, 2 * block, 33 * block + 5):
        # A prefix of a merged sequence is one too; an offset of one
        # element takes the kernels off their 16-byte alignment.
        for lo in (0, 1):
            k, p = mk[lo:lo + n], mp[lo:lo + n]
            dest, num_out = js.join_scan_cuda(k, p, cap1)
            want_dest, want_num = _merged_dest_plain(k, p, cap1)
            assert torch.equal(dest, want_dest), (n, lo)
            assert int(num_out) == int(want_num), (n, lo)


def test_join_scan_repeats_give_one_answer(cuda):
    """20 runs of a multi-block case, some blocks with no run head: an
    ordering fault in the look-back would show only sometimes."""
    import chip_smoke
    from pim_sort_merge_join_tpu_torch.ops.kernels.join_scan import _merged_dest_plain
    from pim_sort_merge_join_tpu_torch.ops.kernels import join_scan as js

    block = js.block_size()
    rng = np.random.default_rng(69)
    mkeys, mpos, cap1 = chip_smoke.merged_case(rng, 100 * block, 140 * block,
                                               np.arange(1, 40 * block), dtype=np.int32,
                                               sentinel_frac=0.3)
    mk, mp = torch.from_numpy(mkeys).to(cuda), torch.from_numpy(mpos).to(cuda)
    want_dest, want_num = _merged_dest_plain(mk, mp, cap1)
    for rep in range(20):
        dest, num_out = js.join_scan_cuda(mk, mp, cap1)
        assert torch.equal(dest, want_dest), rep
        assert int(num_out) == int(want_num), rep


def _placed(dest, num_out, mpos, cap1, place):
    """The first ``num_out`` slots of each output: the ones the placement fills."""
    live = int(num_out)
    return tuple(s[:live] for s in place(dest, mpos, cap1, cap1))


def test_place_sources_matches_plain(cuda):
    import chip_smoke
    from pim_sort_merge_join_tpu_torch.ops.kernels.join_scan import _merged_dest_plain
    from pim_sort_merge_join_tpu_torch.ops.kernels import join_scan as js

    for name, mkeys, mpos, cap1 in chip_smoke.scan_cases(np.random.default_rng(63)):
        mk, mp = torch.from_numpy(mkeys).to(cuda), torch.from_numpy(mpos).to(cuda)
        dest, num_out = _merged_dest_plain(mk, mp, cap1)
        want = _placed(dest, num_out, mp, cap1, js.place_sources_plain)
        # As they are, and one element off the 16-byte alignment.
        for d, p in ((dest, mp), (chip_smoke.one_element_in(dest), chip_smoke.one_element_in(mp))):
            got = _placed(d, num_out, p, cap1, js.place_sources)
            for g, w in zip(got, want):
                assert torch.equal(g, w), name


@pytest.mark.parametrize("n", [1, 3, 4, 5, 1023, 1024, 1025, 4095, 4097, 2**20 + 7])
def test_place_sources_at_its_vector_and_block_edges(cuda, n):
    """Lengths around the 4-element vectors and the 1024 elements a block
    takes in one step of its loop, each also offset by one element: a
    prefix of a merged sequence is one too."""
    import chip_smoke
    from pim_sort_merge_join_tpu_torch.ops import kernels
    from pim_sort_merge_join_tpu_torch.ops.kernels.join_scan import _merged_dest_plain
    from pim_sort_merge_join_tpu_torch.ops.kernels import join_scan as js

    rng = np.random.default_rng(70)
    half = n // 2 + 1
    mkeys, mpos, cap1 = chip_smoke.merged_case(rng, half, half, np.arange(1, max(2, n // 3)))
    mk, mp = torch.from_numpy(mkeys).to(cuda), torch.from_numpy(mpos).to(cuda)
    for lo in (0, 1):
        k, p = mk[lo:lo + n], mp[lo:lo + n]
        dest, num_out = _merged_dest_plain(k, p, cap1)
        want = _placed(dest, num_out, p, cap1, js.place_sources_plain)
        kernels.reset_launch_counts()
        got = _placed(dest, num_out, p, cap1, js.place_sources)
        assert kernels.launch_counts()["join_scan_place"] == 1
        for g, w in zip(got, want):
            assert torch.equal(g, w), (n, lo)


def test_bitonic_kernel_matches_plain(cuda):
    import chip_smoke
    from pim_sort_merge_join_tpu_torch.ops.kernels import bitonic_sort as bs

    for name, keys, vals in chip_smoke.bitonic_cases(np.random.default_rng(63)):
        k, v = torch.from_numpy(keys).to(cuda), torch.from_numpy(vals).to(cuda)
        got = bs.sort_pairs(k, v)
        want = chip_smoke.plain_sort_pairs(k, v)
        for g, w in zip(got, want):
            assert torch.equal(g, w), name


def test_bitonic_network_matches_plain_at_every_width(cuda):
    import chip_smoke
    from pim_sort_merge_join_tpu_torch.ops import kernels
    from pim_sort_merge_join_tpu_torch.ops.kernels import bitonic_sort as bs

    for name, keys, vals in chip_smoke.bitonic_width_cases(np.random.default_rng(70), bs.LOG_TILE):
        k, v = torch.from_numpy(keys).to(cuda), torch.from_numpy(vals).to(cuda)
        want = bs.bitonic_sort_plain(k, v)
        kernels.reset_launch_counts()
        got = bs.bitonic_sort_cuda(k, v)
        counts = kernels.launch_counts()
        passes = bs.bitonic_schedule(len(keys))
        assert counts["bitonic_strided"] == sum(p.strided for p in passes), name
        assert counts["bitonic_local"] == sum(not p.strided for p in passes), name
        # One element in: the arrays leave the kernel's 16-byte alignment.
        off = bs.bitonic_sort_cuda(torch.cat([k[:1], k])[1:], torch.cat([v[:1], v])[1:])
        for g, o, w in zip(got, off, want):
            assert torch.equal(g, w) and torch.equal(o, w), name


def test_bitonic_sort_at_the_cap_takes_at_most_20_launches(cuda):
    from pim_sort_merge_join_tpu_torch.ops import kernels
    from pim_sort_merge_join_tpu_torch.ops.kernels import bitonic_sort as bs

    n = 2_000_000  # pads to the 2^21 cap
    keys = torch.randint(0, 3 * n, (n,), dtype=torch.int32, device=cuda)
    vals = torch.arange(n, dtype=torch.int32, device=cuda)
    kernels.reset_launch_counts()
    got_k, got_v = bs.sort_pairs(keys, vals)
    counts = kernels.launch_counts()
    assert counts["bitonic_local"] + counts["bitonic_strided"] == 17 <= 20
    assert {name for name, c in counts.items() if c} == {"bitonic_local", "bitonic_strided"}
    want_k, order = torch.sort(keys, stable=True)
    assert torch.equal(got_k, want_k) and torch.equal(got_v, order.to(torch.int32))


@pytest.mark.parametrize("n", [1, 2, 255, 256, 257, 8191, 8193, 40_000])
def test_bitonic_kernels_pad_inside_the_passes(cuda, n):
    """`sort_pairs` on the card copies no padding: the first pass makes the
    largest pair past the input's end and the last pass writes only the
    input's length, pairs equal to the padding included."""
    from pim_sort_merge_join_tpu_torch.ops import kernels
    from pim_sort_merge_join_tpu_torch.ops.kernels import bitonic_sort as bs

    rng = np.random.default_rng(74)
    keys = rng.integers(-5, 5, n).astype(np.int32)
    vals = rng.integers(-(2**31), 2**31, n).astype(np.int32)
    keys[rng.random(n) < 0.2] = 2**31 - 1
    vals[rng.random(n) < 0.5] = 2**31 - 1
    k, v = torch.from_numpy(keys).to(cuda), torch.from_numpy(vals).to(cuda)
    kernels.reset_launch_counts()
    got = bs.sort_pairs(k, v)
    assert sum(kernels.launch_counts().values()) == len(bs.bitonic_schedule(max(bs._next_pow2(n), 256)))
    want = bs.sort_pairs(k.cpu(), v.cpu())
    assert got[0].shape == (n,) and torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    with pytest.raises(ValueError, match="holds the 257 pairs, got 256"):
        bs.bitonic_sort_cuda(torch.zeros(257, dtype=torch.int32, device=cuda),
                             torch.zeros(257, dtype=torch.int32, device=cuda), width=256)


def test_gather_rows_kernel_matches_plain(cuda):
    import chip_smoke
    from pim_sort_merge_join_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    cases = chip_smoke.gather_rows_cases(np.random.default_rng(71))
    for case in cases:
        assert chip_smoke.rows_err(case, device=cuda) == 0, case[0]
    # One launch for every two of a case's parts, a wide table counted by its slices.
    from pim_sort_merge_join_tpu_torch.ops.kernels import gather as gr

    launches = sum(
        -(-len(gr.row_slices([(torch.from_numpy(s), i, list(range(s.shape[1])) if c is None else c)
                              for s, i, c in case[1]])) // gr.MAX_PARTS)
        for case in cases
    )
    assert kernels.launch_counts()["gather_rows"] == launches > len(cases)


def test_column_gather_kernel_matches_indexing(cuda):
    import chip_smoke
    from pim_sort_merge_join_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    cases = chip_smoke.column_gather_cases(np.random.default_rng(72))
    for case in cases:
        assert chip_smoke.column_gather_err(case, device=cuda) == 0, case[0]
    # One launch per column, aligned and offset.
    assert kernels.launch_counts()["hbm_sort_gather"] == 2 * sum(len(c[2]) for c in cases)


def test_rows_move_through_the_row_gather_and_no_library_call(cuda, monkeypatch):
    """`sort_by_key`, the inner join's emit and the fused join's emit sorts
    launch `gather_rows` and never reach `index_select`."""
    import chip_smoke
    from pim_sort_merge_join_tpu_torch import Table
    from pim_sort_merge_join_tpu_torch.ops import join as join_ops
    from pim_sort_merge_join_tpu_torch.ops import kernels
    from pim_sort_merge_join_tpu_torch.ops import sort as sort_ops

    r1, r2, _ = chip_smoke.staged_inputs(20_000, "auto")
    t1, t2 = Table.from_numpy(r1, device=cuda), Table.from_numpy(r2, device=cuda)

    def refuse(*args, **kwargs):
        raise AssertionError("index_select reached on a CUDA path")

    monkeypatch.setattr(torch.Tensor, "index_select", refuse)
    monkeypatch.setattr(torch, "index_select", refuse)
    for algorithm, bitonic in (("auto", 0), ("pallas_bitonic", 1)):
        kernels.reset_launch_counts()
        s1 = sort_ops.sort_by_key(t1, 0, algorithm=algorithm)
        counts = kernels.launch_counts()
        assert counts["gather_rows"] == 1 and counts["hbm_sort_gather"] == 0
        assert (counts["bitonic_local"] > 0) == bool(bitonic)
        assert (counts["hbm_sort_chunk"] > 0) != bool(bitonic)
    s2 = sort_ops.sort_by_key(t2, 0)
    kernels.reset_launch_counts()
    out = join_ops.merge_join(s1, s2, 0, 0, mode="inner", out_capacity=40_000)
    assert kernels.launch_counts()["gather_rows"] == 1
    kernels.reset_launch_counts()
    fused = join_ops.merge_join(t1, t2, 0, 0, presorted=False)
    counts = kernels.launch_counts()
    assert counts["gather_rows"] == 1 and counts["hbm_sort_gather"] == 1  # the int64 key's
    monkeypatch.undo()
    s1c, s2c = (Table.from_numpy(r[np.argsort(r[:, 0], kind="stable")], device="cpu")
                for r in (r1, r2))
    want = join_ops.merge_join(s1c, s2c, 0, 0, mode="inner", out_capacity=40_000)
    assert torch.equal(out.data.cpu(), want.data) and int(out.num_rows) == int(want.num_rows) > 0
    want = join_ops.merge_join(Table.from_numpy(r1, device="cpu"), Table.from_numpy(r2, device="cpu"),
                               0, 0, presorted=False)
    assert torch.equal(fused.data.cpu(), want.data) and int(fused.num_rows) == int(want.num_rows)


def test_radix_kernel_matches_plain(cuda):
    import chip_smoke
    from pim_sort_merge_join_tpu_torch.ops import kernels
    from pim_sort_merge_join_tpu_torch.ops.kernels import radix_sort as rs

    cases = chip_smoke.radix_cases(np.random.default_rng(64))
    # Tiles from 100 to 16384 with 128 and 8192 among them, 8 operands, a
    # tile of one digit value.
    assert {128, 8192} <= {c[2] for c in cases} and max(len(c[1]) for c in cases) == 8
    kernels.reset_launch_counts()
    for name, arrays, tile, digit_bits, key_bits in cases:
        ops = tuple(torch.from_numpy(a).to(cuda) for a in arrays)
        kw = dict(tile=tile, digit_bits=digit_bits, key_bits=key_bits)
        want = rs.radix_tile_sort_plain(ops, **kw)
        # One element in: the arrays leave the 16-byte alignment.
        off = rs.radix_tile_sort(tuple(chip_smoke.one_element_in(o) for o in ops), **kw)
        for g, o, w in zip(rs.radix_tile_sort(ops, **kw), off, want):
            assert torch.equal(g, w) and torch.equal(o, w), name
    counts = kernels.launch_counts()
    assert {k for k, c in counts.items() if c} == {"radix_tile"}
    assert counts["radix_tile"] == 2 * len(cases)


def test_global_radix_sort_matches_plain(cuda):
    import chip_smoke
    from pim_sort_merge_join_tpu_torch.ops import kernels
    from pim_sort_merge_join_tpu_torch.ops.kernels import radix_sort as rs

    cases = chip_smoke.lsd_cases(np.random.default_rng(75))
    tile = rs.LSD_THREADS * rs.LSD_ITEMS
    assert {tile - 1, tile, tile + 1, 33 * tile + 5, 1 << 22} <= {len(c[1][0]) for c in cases}
    for name, arrays, digit_bits, key_bits in cases:
        ops = tuple(torch.from_numpy(a).to(cuda) for a in arrays)
        kw = dict(digit_bits=digit_bits, key_bits=key_bits)
        kernels.reset_launch_counts()
        got = rs.xla_lsd_radix_sort(ops, **kw)
        counts = {k: c for k, c in kernels.launch_counts().items() if c}
        want_counts = {"lsd_radix_histogram": 1, "lsd_radix_scan": 1,
                       "lsd_radix_pass": -(-key_bits // digit_bits)}
        if len(ops) > 2:  # more than one payload: gathered by the sorted index
            want_counts["hbm_sort_gather"] = len(ops) - 1
        assert counts == want_counts, name
        off = rs.xla_lsd_radix_sort(tuple(chip_smoke.one_element_in(o) for o in ops), **kw)
        for g, o, w in zip(got, off, chip_smoke.lsd_want(ops, **kw)):
            assert g.dtype == w.dtype and torch.equal(g, w) and torch.equal(o, w), name
    empty = torch.zeros(0, dtype=torch.int32, device=cuda)
    kernels.reset_launch_counts()
    assert [tuple(t.shape) for t in rs.xla_lsd_radix_sort((empty, empty))] == [(0,), (0,)]
    assert not any(kernels.launch_counts().values())


def test_global_radix_sort_repeats_give_one_answer(cuda):
    """20 runs over 300 tiles, few distinct digits in the top passes: an
    ordering fault in the look-back would show only sometimes."""
    from pim_sort_merge_join_tpu_torch.ops.kernels import radix_sort as rs

    n = 300 * rs.LSD_THREADS * rs.LSD_ITEMS + 77
    gen = torch.Generator(device=cuda).manual_seed(76)
    key = torch.randint(0, 1 << 18, (n,), generator=gen, device=cuda).to(torch.int32)
    key[torch.rand(n, generator=gen, device=cuda) < 0.2] = 2**31 - 1
    pos = torch.arange(n, dtype=torch.int32, device=cuda)
    want_key, order = torch.sort(key, stable=True)
    for rep in range(20):
        got_key, got_pos = rs.xla_lsd_radix_sort((key, pos), key_bits=31)
        assert torch.equal(got_key, want_key) and torch.equal(got_pos, order.to(torch.int32)), rep


def test_global_radix_sort_runs_its_own_kernels_and_no_library_call(cuda, monkeypatch):
    """On CUDA tensors the sort launches the port's kernels: no `torch.sort`,
    `cumsum`, `one_hot` or `index_copy_`, and nothing read back between the
    launches; the result equals `hbm_sort`'s."""
    from pim_sort_merge_join_tpu_torch.ops import kernels
    from pim_sort_merge_join_tpu_torch.ops.kernels import hbm_sort as hs
    from pim_sort_merge_join_tpu_torch.ops.kernels import radix_sort as rs

    n = 1_000_003
    key = torch.randint(0, 3 * n, (n,), dtype=torch.int32, device=cuda)
    pos = torch.arange(n, dtype=torch.int32, device=cuda)
    extra = torch.randint(-(2**31), 2**31 - 1, (n,), dtype=torch.int32, device=cuda)
    want = hs.hbm_sort((key, pos, extra))
    torch.cuda.synchronize()

    def refuse(*args, **kwargs):
        raise AssertionError("a library call or a readback on the global radix sort's CUDA path")

    for owner, name in ((torch, "sort"), (torch.Tensor, "sort"), (torch, "cumsum"),
                        (torch.Tensor, "cumsum"), (torch.nn.functional, "one_hot"),
                        (torch.Tensor, "index_copy_"), (torch, "argsort"),
                        (torch.Tensor, "item"), (torch.Tensor, "cpu"), (torch.Tensor, "tolist"),
                        (torch.Tensor, "__bool__"), (torch.Tensor, "__int__"),
                        (torch.cuda, "synchronize")):
        monkeypatch.setattr(owner, name, refuse)
    kernels.reset_launch_counts()
    two = rs.xla_lsd_radix_sort((key, pos), key_bits=31)
    three = rs.xla_lsd_radix_sort((key, pos, extra), key_bits=31)
    counts = kernels.launch_counts()
    monkeypatch.undo()
    assert counts["lsd_radix_histogram"] == counts["lsd_radix_scan"] == 2
    assert counts["lsd_radix_pass"] == 8 and counts["hbm_sort_gather"] == 2
    for g, w in zip(two, want[:2]):
        assert torch.equal(g, w)
    for g, w in zip(three, want):
        assert torch.equal(g, w)


def test_radix_runs_merge_into_the_hbm_sort_permutation(cuda):
    import chip_smoke
    from pim_sort_merge_join_tpu_torch.ops.kernels import hbm_sort as hs

    n = 100_003
    keys = torch.randint(0, 50_000, (n,), dtype=torch.int32, device=cuda)
    pos = torch.arange(n, dtype=torch.int32, device=cuda)
    npad, _ = hs.pass_schedule(n)
    kp = torch.cat([keys, torch.full((npad - n,), 2**31 - 1, dtype=torch.int32, device=cuda)])
    pp = torch.arange(npad, dtype=torch.int32, device=cuda)
    want = hs.sort_elements(keys, pos, hs.KIND_PAIR32)
    for g, w in zip(chip_smoke.radix_runs_merged(kp, pp, n), want):
        assert torch.equal(g, w)


def test_narrow_extremes_kernel_matches_plain(cuda):
    """The narrow probe's kernel against its plain version, exactly, on the
    adversarial cases (`chip_smoke.probe_cases`: int64 and uint64 with
    values from 2^63 on, INT64_MIN/MAX and the int32 window's edges, rows
    of 1, 3, 4 and 7 with key columns that differ between the tables, odd
    and unequal sizes, tables across many blocks) in every layout of
    `chip_smoke.probe_views`: one launch a call, each on the scratch the
    launch before it left."""
    cases = chip_smoke.probe_cases(np.random.default_rng(81))
    assert {c[1].shape[1] for c in cases} == {1, 3, 4, 7}
    assert any(c[1].dtype == np.uint64 for c in cases)
    for case in cases:
        assert chip_smoke.probe_err(case) == 0, case[0]


def test_narrow_extremes_kernel_repeats_across_many_blocks(cuda):
    """Tables of 3M and 2M + 1 rows (one wave of blocks, each thread many
    loads), probed 30 times: each launch finds the ticket the last one
    left at 0."""
    from pim_sort_merge_join_tpu_torch.ops.kernels.probe import narrow_extremes_plain
    from pim_sort_merge_join_tpu_torch.ops.kernels import probe

    g = torch.Generator(device=cuda).manual_seed(5)
    d1 = torch.randint(-(2**40), 2**40, (3_000_000, 4), generator=g, device=cuda)
    d2 = torch.randint(-(2**31), 2**31, (2_000_001, 4), generator=g, device=cuda)
    for k1, k2 in ((0, 0), (3, 1)):
        want = torch.cat(narrow_extremes_plain(d1, d2, k1, k2))
        got = [torch.cat(probe.narrow_extremes_cuda(d1, d2, k1, k2)) for _ in range(30)]
        assert all(torch.equal(x, want) for x in got)


@pytest.mark.parametrize("case", chip_smoke.probe_error_cases(), ids=lambda c: c[0])
def test_narrow_extremes_kernel_raises_the_plain_versions_errors(cuda, case):
    from pim_sort_merge_join_tpu_torch.ops import kernels

    before = kernels.launch_counts()["narrow_extremes"]
    got, want = chip_smoke.probe_error(case, cuda), chip_smoke.probe_error(case, "cpu")
    assert got == want
    assert kernels.launch_counts()["narrow_extremes"] == before + (want is None)


@pytest.mark.parametrize("run", ["auto", "given", "int32"])
def test_probe_stage_launches_on_card(cuda, run):
    """The ``probe`` stage launches the kernel once where a narrow flag is
    "auto" on int64 tables, and nothing where both are given or the type
    cannot narrow."""
    import dataclasses
    import json

    from pim_sort_merge_join_tpu_torch import QueryPipeline, Table

    r1, r2, cfg = chip_smoke.slice_inputs(30_000)
    dtype = torch.int32 if run == "int32" else torch.int64
    if run == "given":
        cfg = dataclasses.replace(cfg, narrow_keys=True, narrow_data=False)
    if run == "int32":
        cfg = dataclasses.replace(cfg, dtype="int32")
    pipe = QueryPipeline(cfg, device=cuda)
    out = pipe.run_tables(Table.from_numpy(r1, device=cuda, dtype=dtype),
                          Table.from_numpy(r2, device=cuda, dtype=dtype))
    (execute,) = json.loads(pipe.metrics_json())["stages"]
    probe_stage = execute["stages"][0]
    assert probe_stage["stage"] == "probe"
    assert probe_stage["launches"] == (run == "auto")
    assert int(out.num_rows) > 0


def test_join_keys_kernel_matches_plain(cuda):
    """The fused keys' kernel against its plain version on the CPU,
    exactly, narrow and wide, on the adversarial cases
    (`chip_smoke.keys_cases`: every pair of `chip_smoke.KEYS_TYPES` with
    edge values, odd and off-16 capacities, row counts 0, 1 and the
    capacity, rows of 1, 3, 4 and 7, every operator, tables across many
    blocks) in every layout of `chip_smoke.probe_views`: strided and
    misaligned views included."""
    cases = chip_smoke.keys_cases(np.random.default_rng(82))
    assert {c[1].shape[1] for c in cases} >= {1, 3, 4, 7}
    assert {c[3] for c in cases} >= {0, 1} and any(c[3] == c[1].shape[0] > 1 for c in cases)
    assert {(c[1].dtype.name, c[2].dtype.name) for c in cases} == set(chip_smoke.KEYS_TYPES)
    for case in cases:
        assert chip_smoke.keys_err(case) == 0, case[0]


@pytest.mark.parametrize("case", chip_smoke.keys_error_cases(), ids=lambda c: c[0])
def test_join_keys_kernel_raises_the_plain_versions_errors(cuda, case):
    from pim_sort_merge_join_tpu_torch.ops import kernels

    before = kernels.launch_counts()["join_keys"]
    got, want = chip_smoke.keys_error(case, cuda), chip_smoke.keys_error(case, "cpu")
    assert got == want
    assert kernels.launch_counts()["join_keys"] == before + (want is None)


@pytest.mark.parametrize("dtype", ["int64", "uint64", "float64"])
def test_keys_stage_launches_on_card(cuda, dtype):
    """The fused query's ``keys`` stage launches the kernel once, on int64
    (the 10M query), uint64 and float64 tables alike; the rows equal the
    CPU's."""
    import dataclasses
    import json

    from pim_sort_merge_join_tpu_torch import Predicate, QueryPipeline, Table

    n = 10_000_000 if dtype == "int64" else 30_000
    r1, r2, cfg = chip_smoke.slice_inputs(n)
    shift = 2**63 if dtype == "uint64" else 0
    r1, r2 = (chip_smoke.shifted_key(r, np.dtype(dtype), shift) for r in (r1, r2))
    p = Predicate(0, ">", shift + cfg.predicate1.value)
    cfg = dataclasses.replace(cfg, dtype=dtype, predicate1=p, predicate2=p)
    pipe = QueryPipeline(cfg, device=cuda)
    got = pipe.run_tables(*(Table.from_numpy(r, dtype=dtype, device=cuda) for r in (r1, r2)))
    (execute,) = json.loads(pipe.metrics_json())["stages"]
    (keys_stage,) = [s for s in execute["stages"] if s["stage"] == "keys"]
    assert keys_stage["launches"] == 1
    if n > 30_000:
        return
    want = QueryPipeline(cfg, device="cpu").run_tables(
        *(Table.from_numpy(r, dtype=dtype, device="cpu") for r in (r1, r2)))
    assert torch.equal(got.data.cpu().view(torch.int64), want.data.view(torch.int64))
    assert int(got.num_rows) == int(want.num_rows) > 0


@pytest.mark.parametrize("dtype", ["int32", "float64"])
def test_tables_of_another_type_than_the_config_match_cpu(cuda, dtype):
    """`EngineConfig()` (int64, narrow flags "auto") on int32 and float64
    tables, on one device and on one rank of a group: no probe runs, the
    flags resolve to False, and rows and flags are the CPU path's."""
    import torch.distributed as dist

    from pim_sort_merge_join_tpu_torch import EngineConfig, QueryPipeline, Table
    from pim_sort_merge_join_tpu_torch.columnar.generate import generate_table
    from pim_sort_merge_join_tpu_torch.engine.distributed import (
        DistributedQueryPipeline,
        ShardedTable,
    )
    from pim_sort_merge_join_tpu_torch.ops import kernels

    # Keys above the default predicate's 5000 for most rows.
    rows = [(generate_table(500, seed=s) + [4800, 0, 0, 0]).astype(dtype) for s in (1, 2)]
    tdtype = getattr(torch, dtype)
    cpu = QueryPipeline(EngineConfig(), device="cpu")
    want = cpu.run_tables(*(Table.from_numpy(r, dtype=tdtype, device="cpu") for r in rows))
    flags = (cpu.resolved_narrow_keys, cpu.resolved_narrow_data)
    assert flags == (False, False)
    pipe = QueryPipeline(EngineConfig(), device=cuda)
    kernels.reset_launch_counts()
    got = pipe.run_tables(*(Table.from_numpy(r, dtype=tdtype, device=cuda) for r in rows))
    assert kernels.launch_counts()["narrow_extremes"] == 0
    assert torch.equal(got.data.cpu(), want.data)
    assert int(got.num_rows) == int(want.num_rows) > 0
    assert (pipe.resolved_narrow_keys, pipe.resolved_narrow_data) == flags
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        dpipe = DistributedQueryPipeline(EngineConfig(), device=cuda)
        out = dpipe.run_tables(*(ShardedTable.from_numpy(r, dtype=tdtype, device=cuda)
                                 for r in rows))
        np.testing.assert_array_equal(out.to_numpy(), want.to_numpy())
        assert (dpipe.resolved_narrow_keys, dpipe.resolved_narrow_data) == flags
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("key_offset", [0, 2**40])
def test_pipeline_on_card_matches_cpu(cuda, key_offset):
    import chip_smoke
    from pim_sort_merge_join_tpu_torch import QueryPipeline, Table
    from pim_sort_merge_join_tpu_torch.ops import kernels

    r1, r2, cfg = chip_smoke.slice_inputs(30_000, key_offset=key_offset)
    kernels.reset_launch_counts()
    got = QueryPipeline(cfg, device=cuda).run_tables(
        Table.from_numpy(r1, device=cuda), Table.from_numpy(r2, device=cuda)
    )
    counts = kernels.launch_counts()
    ran = {name for name, n in counts.items() if n > 0}
    # Narrow keys: every sort carries its operands in the element or moves
    # rows; 64-bit keys: the merge sort gathers its two operands. The
    # "auto" narrow keys: one probe launch.
    assert ran == (chip_smoke.FUSED_WIDE_KERNELS if key_offset
                   else chip_smoke.FUSED_KERNELS) | chip_smoke.PROBE_KERNELS | chip_smoke.KEYS_KERNELS
    assert counts["narrow_extremes"] == 1
    assert counts["join_keys"] == 1
    # One sort, the merge; the placement and one row gather in its place
    # of the un-merge and emit sorts.
    assert counts["hbm_sort_chunk"] == 1
    assert counts["join_scan_place"] == 1
    assert counts["gather_rows"] == 1
    want = QueryPipeline(cfg, device="cpu").run_tables(
        Table.from_numpy(r1, device="cpu"), Table.from_numpy(r2, device="cpu")
    )
    assert torch.equal(got.data.cpu(), want.data)
    assert int(got.num_rows) == int(want.num_rows) > 0


@pytest.mark.parametrize("sort_algorithm", ["auto", "pallas_bitonic"])
def test_staged_pipeline_on_card_matches_cpu(cuda, sort_algorithm):
    import chip_smoke
    from pim_sort_merge_join_tpu_torch import QueryPipeline, Table
    from pim_sort_merge_join_tpu_torch.ops import kernels

    r1, r2, cfg = chip_smoke.staged_inputs(30_000, sort_algorithm)
    kernels.reset_launch_counts()
    got = QueryPipeline(cfg, device=cuda).run_tables(
        Table.from_numpy(r1, device=cuda), Table.from_numpy(r2, device=cuda)
    )
    counts = kernels.launch_counts()
    ran = {name for name, n in counts.items() if n > 0}
    want_ran = chip_smoke.STAGED_KERNELS
    if sort_algorithm == "pallas_bitonic":
        want_ran = chip_smoke.STAGED_BITONIC_KERNELS
    assert ran == want_ran | chip_smoke.PROBE_KERNELS
    assert counts["gather_rows"] == 3  # two table sorts and the join's emit
    want = QueryPipeline(cfg, device="cpu").run_tables(
        Table.from_numpy(r1, device="cpu"), Table.from_numpy(r2, device="cpu")
    )
    assert torch.equal(got.data.cpu(), want.data)
    assert int(got.num_rows) == int(want.num_rows) > 0


@pytest.mark.parametrize("join_mode", ["one_to_one", "inner"])
def test_tables_wider_than_one_launch_reads_match_cpu(cuda, join_mode):
    """Rows of 88 and 136 bytes: the row gather goes in column slices, the
    query's buffer stays equal to the plain path's."""
    import chip_smoke
    from pim_sort_merge_join_tpu_torch import QueryPipeline, Table
    from pim_sort_merge_join_tpu_torch.ops import kernels

    if join_mode == "inner":
        r1, r2, cfg = chip_smoke.staged_inputs(20_000, "auto")
    else:
        r1, r2, cfg = chip_smoke.slice_inputs(20_000)
    rng = np.random.default_rng(73)
    r1 = np.column_stack([r1, rng.integers(-(2**40), 2**40, (r1.shape[0], 7))])
    r2 = np.column_stack([r2, rng.integers(-(2**40), 2**40, (r2.shape[0], 13))])
    kernels.reset_launch_counts()
    got = QueryPipeline(cfg, device=cuda).run_tables(
        Table.from_numpy(r1, device=cuda), Table.from_numpy(r2, device=cuda)
    )
    # Table 1 is two slices, table 2's kept columns three: more than one launch.
    assert kernels.launch_counts()["gather_rows"] >= 3
    want = QueryPipeline(cfg, device="cpu").run_tables(
        Table.from_numpy(r1, device="cpu"), Table.from_numpy(r2, device="cpu")
    )
    assert torch.equal(got.data.cpu(), want.data)
    assert int(got.num_rows) == int(want.num_rows) > 0


def test_kernels_refuse_what_they_cannot_take(cuda):
    from pim_sort_merge_join_tpu_torch.ops.kernels import hbm_sort as hs
    from pim_sort_merge_join_tpu_torch.ops.kernels import join_scan as js

    f = torch.rand(16, device=cuda)
    with pytest.raises(ValueError, match="no CUDA kernel"):
        hs.hbm_sort((f,))
    k = torch.arange(16, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="arange"):
        hs.hbm_sort((k, torch.flip(k, [0]).to(torch.int32)), num_keys=2)
    strided = torch.arange(32, dtype=torch.int32, device=cuda)[::2]
    with pytest.raises(ValueError, match="contiguous"):
        hs.hbm_sort((strided,))
    with pytest.raises(ValueError, match="int32"):
        js.join_scan_cuda(k, k, 8)

    from pim_sort_merge_join_tpu_torch.ops.kernels import bitonic_sort as bs
    from pim_sort_merge_join_tpu_torch.ops.kernels import radix_sort as rs

    with pytest.raises(ValueError, match="power of two"):
        bs.bitonic_sort_cuda(k[:12].int(), k[:12].int())
    with pytest.raises(ValueError, match="int32"):
        bs.bitonic_sort_cuda(k, k)
    with pytest.raises(ValueError, match="contiguous"):
        rs.radix_tile_sort((strided,), tile=16)
    k32 = torch.zeros(1 << 16, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        rs.radix_tile_sort((k32,), tile=1 << 16)
    with pytest.raises(ValueError, match="at most"):
        rs.radix_tile_sort((k32,) * 9, tile=256)
    with pytest.raises(ValueError, match="shared memory"):
        rs.radix_tile_sort((k32,), tile=256, digit_bits=16)
    with pytest.raises(ValueError, match="contiguous"):
        rs.xla_lsd_radix_sort((strided,))
    with pytest.raises(ValueError, match="at most"):
        rs.xla_lsd_radix_sort((k32,) * 9)
    with pytest.raises(ValueError, match="shared memory"):
        rs.xla_lsd_radix_sort((k32,), digit_bits=12)
    with pytest.raises(ValueError, match="int32"):
        rs.xla_lsd_radix_sort((k32, k32.long()))

    from pim_sort_merge_join_tpu_torch.ops.kernels import gather as gr

    idx = torch.arange(16, dtype=torch.int32, device=cuda)
    wide = torch.arange(16 * 9, dtype=torch.int64, device=cuda).reshape(16, 9)
    assert torch.equal(gr.gather_rows([(wide, torch.flip(idx, [0]))]), torch.flip(wide, [0]))
    with pytest.raises(ValueError, match="contiguous"):
        gr.gather_rows([(torch.zeros((16, 8), dtype=torch.int64, device=cuda)[:, ::2], idx)])
    with pytest.raises(ValueError, match="unsupported devices"):
        gr.gather_rows([(torch.zeros((16, 4), dtype=torch.int64, device=cuda), idx.cpu())])
    with pytest.raises(ValueError, match="shape"):
        hs.gather(idx, (k,)[:1] + (k[:8],))


@pytest.mark.parametrize("join_mode", ["one_to_one", "inner"])
@pytest.mark.parametrize("dtype", ["int64", "int32"])
def test_hash_join_paths_on_card_match_cpu(cuda, monkeypatch, join_mode, dtype):
    """`join_algorithm="hash"` through `run_tables`: each mode launches
    exactly its kernel set, never reaches `cummax`, and equals the plain
    path's buffer."""
    import dataclasses

    import chip_smoke
    from pim_sort_merge_join_tpu_torch import QueryPipeline, Table
    from pim_sort_merge_join_tpu_torch.ops import kernels

    if join_mode == "inner":
        r1, r2, cfg = chip_smoke.staged_inputs(30_000, "auto")
    else:
        r1, r2, cfg = chip_smoke.slice_inputs(30_000)
    cfg = dataclasses.replace(chip_smoke.hash_config(cfg), dtype=dtype)
    tdt = torch.int32 if dtype == "int32" else torch.int64

    def refuse(*args, **kwargs):
        raise AssertionError("cummax/cummin reached on a CUDA hash path")

    monkeypatch.setattr(torch, "cummax", refuse)
    monkeypatch.setattr(torch, "cummin", refuse)
    kernels.reset_launch_counts()
    got = QueryPipeline(cfg, device=cuda).run_tables(
        Table.from_numpy(r1, device=cuda, dtype=tdt), Table.from_numpy(r2, device=cuda, dtype=tdt))
    ran = {name for name, n in kernels.launch_counts().items() if n > 0}
    # Only int64 (and uint64) tables are probed for narrow keys.
    probe = chip_smoke.PROBE_KERNELS if dtype == "int64" else set()
    if join_mode == "inner":
        assert ran == chip_smoke.HASH_INNER_KERNELS | probe
    elif dtype == "int64":
        assert ran == chip_smoke.HASH_ONE_TO_ONE_KERNELS | probe
    else:  # int32 hashes: the merge sort carries both operands in its element
        assert ran == chip_smoke.FUSED_KERNELS
    monkeypatch.undo()
    want = QueryPipeline(cfg, device="cpu").run_tables(
        Table.from_numpy(r1, device="cpu", dtype=tdt), Table.from_numpy(r2, device="cpu", dtype=tdt))
    assert got.data.dtype == want.data.dtype == tdt
    assert torch.equal(got.data.cpu(), want.data)
    assert int(got.num_rows) == int(want.num_rows) > 0


@pytest.mark.parametrize("agg", ["sum", "count", "min", "max"])
def test_hash_aggregate_on_card_matches_cpu(cuda, agg):
    import chip_smoke
    from pim_sort_merge_join_tpu_torch import Table
    from pim_sort_merge_join_tpu_torch.columnar.generate import generate_table
    from pim_sort_merge_join_tpu_torch.ops import hash_join as hj
    from pim_sort_merge_join_tpu_torch.ops import kernels

    rows = generate_table(50_000, seed=3, key_distribution="zipf")
    rows[::7, 1] = np.iinfo(np.int64).max - rows[::7, 1]  # sums that wrap
    kernels.reset_launch_counts()
    got = hj.hash_aggregate(Table.from_numpy(rows, capacity=50_100, device=cuda), 0, 1, agg)
    assert {n for n, c in kernels.launch_counts().items() if c} == chip_smoke.HASH_AGGREGATE_KERNELS
    want = hj.hash_aggregate(Table.from_numpy(rows, capacity=50_100, device="cpu"), 0, 1, agg)
    assert torch.equal(got.data.cpu(), want.data) and int(got.num_rows) == int(want.num_rows) > 0


def test_merge_tree_on_card_matches_cpu(cuda):
    import chip_smoke
    from pim_sort_merge_join_tpu_torch import Table
    from pim_sort_merge_join_tpu_torch.ops import kernels
    from pim_sort_merge_join_tpu_torch.ops import merge as merge_ops

    rng = np.random.default_rng(77)
    runs = []
    for i in range(9):
        r = rng.integers(0, 500, (3000 + 1000 * i, 4))
        runs.append(r[np.argsort(r[:, 0], kind="stable")])
    for count in (1, 2, 8, 9):
        kernels.reset_launch_counts()
        got = merge_ops.merge_tree([Table.from_numpy(r, capacity=len(r) + 5, device=cuda)
                                    for r in runs[:count]], 0)
        ran = {n for n, c in kernels.launch_counts().items() if c}
        assert ran == (set() if count == 1 else chip_smoke.MERGE_KERNELS)
        want = merge_ops.merge_tree([Table.from_numpy(r, capacity=len(r) + 5, device="cpu")
                                     for r in runs[:count]], 0)
        assert torch.equal(got.data.cpu(), want.data) and int(got.num_rows) == int(want.num_rows)


def test_resumable_on_card_matches_cpu(cuda, tmp_path):
    import dataclasses

    import chip_smoke
    from pim_sort_merge_join_tpu_torch import QueryPipeline, Table
    from pim_sort_merge_join_tpu_torch.ops import kernels

    r1, r2, cfg = chip_smoke.slice_inputs(40_000)
    gcfg = dataclasses.replace(cfg, checkpoint_dir=str(tmp_path / "card"))
    ccfg = dataclasses.replace(cfg, checkpoint_dir=str(tmp_path / "cpu"))
    want = QueryPipeline(ccfg, device="cpu").run_tables_resumable(
        Table.from_numpy(r1, device="cpu"), Table.from_numpy(r2, device="cpu"))
    zeros = Table.from_numpy(np.zeros_like(r1), device=cuda)
    for t1, t2 in ((Table.from_numpy(r1, device=cuda), Table.from_numpy(r2, device=cuda)),
                   (zeros, zeros)):
        kernels.reset_launch_counts()
        got = QueryPipeline(gcfg, device=cuda).run_tables_resumable(t1, t2)
        assert {n for n, c in kernels.launch_counts().items() if c} == chip_smoke.RESUMABLE_KERNELS
        assert got.data.device.type == "cuda"
        assert torch.equal(got.data.cpu(), want.data) and int(got.num_rows) == int(want.num_rows) > 0


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_sort_key_permutation_on_card_matches_cpu(cuda, dtype):
    from pim_sort_merge_join_tpu_torch.ops.kernels import hbm_sort as hs

    rng = np.random.default_rng(78)
    info = torch.iinfo(dtype)
    for n in (0, 1, 8191, 8193, 100_003):
        key = torch.from_numpy(rng.integers(info.min, info.max, n, endpoint=True)).to(dtype)
        if n > 3:
            key[: n // 3] = key[n // 2: n // 2 + n // 3]  # repeated keys
        got = hs.sort_key_permutation(key.to(cuda))
        want = hs.sort_key_permutation(key)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g.cpu(), w)


# --- the other element types: order keys on the kernels ---------------------------


def _typed_tables(dtype, join_mode):
    import chip_smoke

    if join_mode == "inner":
        r1, r2, cfg = chip_smoke.staged_inputs(30_000, "auto")
    else:
        r1, r2, cfg = chip_smoke.slice_inputs(30_000)
    shift = 2**63 if dtype == "uint64" else 0
    r1, r2 = (chip_smoke.shifted_key(r, np.dtype(dtype), shift) for r in (r1, r2))
    if dtype.startswith("float"):
        r1, r2 = r1 + np.dtype(dtype).type(0.5), r2 + np.dtype(dtype).type(0.5)
    return r1, r2, cfg, shift


@pytest.mark.parametrize("algorithm", ["sort_merge", "hash"])
@pytest.mark.parametrize("join_mode", ["one_to_one", "inner"])
@pytest.mark.parametrize("dtype", ["uint64", "float64", "float32", "uint32"])
def test_typed_pipelines_on_card_match_cpu(cuda, monkeypatch, dtype, join_mode, algorithm):
    """Every join path on every other element type: the kernels sort and
    scan order keys and move the rows' bits; the buffer equals the plain
    path's bit for bit, and no 2-key sort proves its second key with
    `torch.equal`."""
    import dataclasses

    from pim_sort_merge_join_tpu_torch import Predicate, QueryPipeline, Table
    from pim_sort_merge_join_tpu_torch.columnar import dtypes
    from pim_sort_merge_join_tpu_torch.ops import kernels

    r1, r2, cfg, shift = _typed_tables(dtype, join_mode)
    p = Predicate(0, ">", shift + cfg.predicate1.value)
    cfg = dataclasses.replace(cfg, dtype=dtype, predicate1=p, predicate2=p, join_algorithm=algorithm)

    def refuse(*args, **kwargs):
        raise AssertionError("torch.equal reached on a CUDA query path")

    monkeypatch.setattr(torch, "equal", refuse)
    kernels.reset_launch_counts()
    got = QueryPipeline(cfg, device=cuda).run_tables(
        Table.from_numpy(r1, dtype=dtype, device=cuda), Table.from_numpy(r2, dtype=dtype, device=cuda))
    assert sum(kernels.launch_counts().values()) > 0
    monkeypatch.undo()
    want = QueryPipeline(cfg, device="cpu").run_tables(
        Table.from_numpy(r1, dtype=dtype, device="cpu"), Table.from_numpy(r2, dtype=dtype, device="cpu"))
    assert got.data.dtype == want.data.dtype == dtypes.TORCH_DTYPES[dtype]
    assert torch.equal(dtypes.bits(got.data).cpu(), dtypes.bits(want.data))
    assert int(got.num_rows) == int(want.num_rows) > 0


@pytest.mark.parametrize("dtype", ["float64", "float32", "uint64", "uint32"])
def test_stable_key_sort_of_typed_keys_on_card_matches_cpu(cuda, dtype):
    import chip_smoke
    from pim_sort_merge_join_tpu_torch.columnar import dtypes
    from pim_sort_merge_join_tpu_torch.ops import sort as sort_ops
    from pim_sort_merge_join_tpu_torch.ops.kernels.hbm_sort import RUN

    rng = np.random.default_rng(90)
    pool = chip_smoke.edge_key_pools()[dtype]
    for n in (1, RUN - 1, RUN + 1, 3 * RUN + 5):
        keys = torch.from_numpy(rng.choice(pool, n))
        payload = torch.from_numpy(rng.integers(-9, 9, n))
        got = sort_ops.stable_key_sort((keys.to(cuda), payload.to(cuda)))
        want = sort_ops.stable_key_sort((keys, payload))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(dtypes.bits(g).cpu(), dtypes.bits(w))
        rows = torch.stack([keys, keys], dim=1)
        got = sort_ops.stable_key_sort_rows_with_key(keys.to(cuda), rows.to(cuda))
        want = sort_ops.stable_key_sort_rows_with_key(keys, rows)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(dtypes.bits(g).cpu(), dtypes.bits(w))


def test_edge_keys_on_card_match_cpu(cuda):
    import chip_smoke

    assert chip_smoke.phase_edge_keys(np.random.default_rng(91))["checked"] > 0


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_float_hash_aggregate_on_card_is_deterministic(cuda, dtype):
    """Float sums on the card (`torch.segment_reduce`) add each group in a
    fixed order: two runs give the same bytes. That order is not the plain
    path's row order, so a group's sum may differ from it by the rounding
    of a sum of n terms, n * eps * (the sum of their magnitudes), and for
    float64 by at most 1e-12 of the sum here; count, min and max are
    exact."""
    from pim_sort_merge_join_tpu_torch import Table
    from pim_sort_merge_join_tpu_torch.ops import hash_join as hj
    from pim_sort_merge_join_tpu_torch.utils import validate

    rng = np.random.default_rng(92)
    rows = np.column_stack([rng.integers(0, 300, 60_000), rng.standard_normal(60_000) * 1e3])
    rows = rows.astype(dtype)
    card, host = Table.from_numpy(rows, device=cuda, dtype=dtype), Table.from_numpy(rows, device="cpu", dtype=dtype)
    magnitude = np.abs(rows)
    magnitude[:, 0] = rows[:, 0]
    abs_sum = hj.hash_aggregate(Table.from_numpy(magnitude, device="cpu", dtype=dtype), 0, 1, "sum")
    counts = hj.hash_aggregate(host, 0, 1, "count").data[:, 1].double().numpy()
    bound = counts * np.finfo(dtype).eps * abs_sum.data[:, 1].double().numpy()
    for agg in ("sum", "count", "min", "max"):
        validate.check_deterministic(lambda t: hj.hash_aggregate(t, 0, 1, agg), card)
        got, want = hj.hash_aggregate(card, 0, 1, agg), hj.hash_aggregate(host, 0, 1, agg)
        assert int(got.num_rows) == int(want.num_rows) == 300
        g, w = got.data.cpu().double().numpy(), want.data.double().numpy()
        np.testing.assert_array_equal(g[:, 0], w[:, 0])
        if agg == "sum":
            assert (np.abs(g[:, 1] - w[:, 1]) <= bound).all()
            if dtype == "float64":
                np.testing.assert_allclose(g[:, 1], w[:, 1], rtol=1e-12)
        else:
            np.testing.assert_array_equal(g[:, 1], w[:, 1])
