"""The port's row gather and row sorts (plain path, CPU) against numpy and JAX.

`gather_rows` on CPU tensors (its plain version) must equal numpy's `take`
on the adversarial cases that `chip_smoke.py` runs on the card;
`hbm_sort_rows` and `stable_key_sort_rows` must equal `jax.lax.sort` of the
key with the table's columns as operands; the `unique_keys` form of
`stable_key_sort` must equal the one-key sort. The wrapper's refusals are
checked by message. Integer data: every comparison is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import pim_sort_merge_join_tpu  # noqa: F401  (switches JAX to 64-bit integers)
from pim_sort_merge_join_tpu_torch.ops import kernels
from pim_sort_merge_join_tpu_torch.ops import sort as sort_ops
from pim_sort_merge_join_tpu_torch.ops.kernels import gather as gr
from pim_sort_merge_join_tpu_torch.ops.kernels import hbm_sort as hs

CASES = chip_smoke.gather_rows_cases(np.random.default_rng(81))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _numpy_gather(parts, out_w, m, live, fill):
    """The contract, with numpy: each part's kept columns of the taken rows
    in its window, zeros from min(len(idx), live) on, `fill` elsewhere."""
    want = np.full((m, out_w), fill, parts[0][0].dtype)
    out_col = 0
    for src, idx, cols in parts:
        cols = list(range(src.shape[1])) if cols is None else cols
        lim = min(m, len(idx)) if live is None else min(m, len(idx), live)
        want[:, out_col:out_col + len(cols)] = 0
        want[:lim, out_col:out_col + len(cols)] = np.take(src, idx[:lim], axis=0)[:, cols]
        out_col += len(cols)
    return want


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_gather_rows_plain_matches_numpy_take(case):
    name, parts, out_w, m, live = case
    out = torch.full((m, out_w), -7, dtype=_t(parts[0][0]).dtype)
    live_t = None if live is None else torch.tensor(live, dtype=torch.int32)
    got = gr.gather_rows([(_t(s), _t(i), c) for s, i, c in parts], out=out, live=live_t)
    assert got is out
    np.testing.assert_array_equal(out.numpy(), _numpy_gather(parts, out_w, m, live, -7))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_row_slices_are_what_a_launch_reads_and_gather_the_same(case):
    """The kernel's wrapper cuts wide tables with `row_slices`: every slice is
    a view of at most `MAX_ROW_BYTES` of the table's columns with the table's
    row pitch, narrow tables pass as they are, and the slices gather the
    same output as the parts they came from."""
    name, parts, out_w, m, live = case
    parts_t = [(_t(s), _t(i), list(range(s.shape[1])) if c is None else c) for s, i, c in parts]
    slices = gr.row_slices(parts_t)
    by_table = {}
    for src, idx, cols in slices:
        assert src.shape[1] * src.element_size() <= gr.MAX_ROW_BYTES and src.stride(1) == 1
        whole = next(t for t, i, _ in parts_t if i is idx and t.untyped_storage().data_ptr()
                     == src.untyped_storage().data_ptr())
        assert src.stride(0) == whole.stride(0)
        first = src.storage_offset() - whole.storage_offset()
        assert first % (gr.MAX_ROW_BYTES // src.element_size()) == 0
        by_table.setdefault(id(whole), []).extend(first + c for c in cols)
    narrow = all(s.shape[1] * s.element_size() <= gr.MAX_ROW_BYTES for s, _, _ in parts_t)
    assert (len(slices) == len(parts_t)) == narrow
    live_t = None if live is None else torch.tensor(live, dtype=torch.int32)
    outs = [gr.gather_rows_plain(p, out=torch.full((m, out_w), -7, dtype=parts_t[0][0].dtype),
                                 live=live_t) for p in (parts_t, slices)]
    assert torch.equal(*outs)


def test_gather_rows_allocates_its_output_and_reads_no_index_past_live():
    rng = np.random.default_rng(82)
    src = rng.integers(-(2**62), 2**62, (50, 4))
    idx = rng.integers(0, 50, 70).astype(np.int32)
    got = gr.gather_rows([(_t(src), _t(idx), [3, 1])])
    assert got.shape == (70, 2) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), src[idx][:, [3, 1]])
    wild = idx.copy()
    wild[20:] = 10**6  # out of range, but past the live count
    got = gr.gather_rows([(_t(src), _t(wild))], live=torch.tensor(20, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy()[:20], src[idx[:20]])
    assert not got.numpy()[20:].any()
    empty = gr.gather_rows([(_t(src[:0]), _t(idx[:0]))])
    assert empty.shape == (0, 4)


def _lax_sort_rows(key, rows, cols):
    ops = jax.lax.sort((jnp.asarray(key),) + tuple(jnp.asarray(rows[:, c]) for c in cols),
                       num_keys=1, is_stable=True)
    return np.stack([np.asarray(o) for o in ops[1:]], axis=1)


def _sort_rows_case(name, rng):
    n = 700
    if name == "int32_key_duplicates":
        return rng.integers(0, 9, n).astype(np.int32), rng.integers(0, 2**40, (n, 4)), None
    if name == "int64_key_sentinels":
        key = rng.integers(-(2**60), 2**60, n)
        key[rng.random(n) < 0.2] = np.iinfo(np.int64).max
        return key, rng.integers(-(2**62), 2**62, (n, 3)), [2, 0]
    if name == "unique_slots_int32_table":
        return (rng.permutation(n).astype(np.int32),
                rng.integers(-(2**31), 2**31, (n, 7)).astype(np.int32), list(range(1, 7)))
    if name == "one_column":
        return rng.integers(-5, 5, n).astype(np.int32), rng.integers(0, 100, (n, 1)), None
    raise AssertionError(name)


SORT_ROWS_CASES = ["int32_key_duplicates", "int64_key_sentinels", "unique_slots_int32_table",
                   "one_column"]


@pytest.mark.parametrize("name", SORT_ROWS_CASES)
@pytest.mark.parametrize("seam", ["hbm_sort_rows", "stable_key_sort_rows"])
def test_sort_rows_matches_lax_sort_of_key_and_columns(name, seam):
    key, rows, cols = _sort_rows_case(name, np.random.default_rng(83))
    want = _lax_sort_rows(key, rows, list(range(rows.shape[1])) if cols is None else cols)
    fn = hs.hbm_sort_rows if seam == "hbm_sort_rows" else sort_ops.stable_key_sort_rows
    got = fn([(_t(key), _t(rows), cols)])
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_sort_rows_of_two_tables_fills_one_output_with_a_zero_tail():
    rng = np.random.default_rng(84)
    k1, r1, _ = _sort_rows_case("int32_key_duplicates", rng)
    k2 = rng.permutation(500).astype(np.int32)
    r2 = rng.integers(0, 2**40, (500, 4))
    out = torch.full((700, 9), -7, dtype=torch.int64)
    live = torch.tensor(450, dtype=torch.int32)
    sort_ops.stable_key_sort_rows([(_t(k1), _t(r1)), (_t(k2), _t(r2), [1, 2, 3])],
                                  algorithm="hbm_pallas", out=out, live=live)
    want = np.full((700, 9), -7, np.int64)
    want[:, :7] = 0
    want[:450, :4] = _lax_sort_rows(k1, r1, [0, 1, 2, 3])[:450]
    want[:450, 4:7] = _lax_sort_rows(k2, r2, [1, 2, 3])[:450]
    np.testing.assert_array_equal(out.numpy(), want)


def test_sort_permutation_is_the_stable_argsort():
    rng = np.random.default_rng(85)
    for key in (rng.integers(0, 5, 300).astype(np.int32), rng.integers(-(2**60), 2**60, 300)):
        perm = hs.sort_permutation(_t(key))
        assert perm.dtype == torch.int32
        np.testing.assert_array_equal(perm.numpy(), np.argsort(key, kind="stable"))
    assert hs.sort_permutation(torch.empty(0, dtype=torch.int32)).shape == (0,)


def test_unique_keys_pair_sort_equals_the_one_key_sort():
    """`stable_key_sort` sorts a unique int32 key with one int32 payload as
    two keys (the kernels then need no gather): the same result."""
    rng = np.random.default_rng(86)
    key = rng.permutation(2000).astype(np.int32)
    payload = rng.integers(-(2**31), 2**31, 2000).astype(np.int32)
    want = jax.lax.sort((jnp.asarray(key), jnp.asarray(payload)), num_keys=1, is_stable=True)
    got = sort_ops.stable_key_sort((_t(key), _t(payload)), unique_keys=True)
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # Without the promise, ties keep their input order whatever the payload.
    dup = rng.integers(0, 4, 2000).astype(np.int32)
    want = jax.lax.sort((jnp.asarray(dup), jnp.asarray(payload)), num_keys=1, is_stable=True)
    got = sort_ops.stable_key_sort((_t(dup), _t(payload)))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_gather_rows_refuses_what_it_cannot_take():
    src = torch.arange(40, dtype=torch.int64).reshape(10, 4)
    idx = torch.arange(10, dtype=torch.int32)
    with pytest.raises(ValueError, match="2D int32/int64 table"):
        gr.gather_rows([(src.double(), idx)])
    with pytest.raises(ValueError, match="2D int32/int64 table"):
        gr.gather_rows([(src[:, 0], idx)])
    with pytest.raises(ValueError, match="idx must be 1D int32"):
        gr.gather_rows([(src, idx.long())])
    with pytest.raises(ValueError, match="must name columns of a table of 4"):
        gr.gather_rows([(src, idx, [0, 4])])
    with pytest.raises(ValueError, match="must name columns"):
        gr.gather_rows([(src, idx, [])])
    with pytest.raises(ValueError, match="no part"):
        gr.gather_rows([])
    with pytest.raises(ValueError, match="4 kept columns are no window of an output of 3"):
        gr.gather_rows([(src, idx)], out=torch.zeros((10, 3), dtype=torch.int64))
    with pytest.raises(ValueError, match="contiguous 2D tensor of the tables' type"):
        gr.gather_rows([(src, idx)], out=torch.zeros((10, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous 2D tensor"):
        gr.gather_rows([(src, idx)], out=torch.zeros((10, 8), dtype=torch.int64)[:, ::2])
    with pytest.raises(ValueError, match="live must be one int32"):
        gr.gather_rows([(src, idx)], live=torch.tensor(3))
    with pytest.raises(ValueError, match="unsupported devices"):
        gr.gather_rows([(src, idx.to("meta"))])
    with pytest.raises(ValueError, match="no source rows"):
        gr.gather_rows([(src[:0], idx)])
    with pytest.raises(ValueError, match="as many rows"):
        hs.hbm_sort_rows([(idx[:5], src)])
    with pytest.raises(ValueError, match="unknown sort algorithm"):
        sort_ops.stable_key_sort_rows([(idx, src)], algorithm="quick")


def test_the_kernel_entry_refuses_by_message_before_it_touches_the_card():
    """`gather_rows_cuda` checks what only the kernel cannot take (layout) and
    then the device: a CPU tensor never reaches a launch, whatever its width
    and however many parts."""
    idx = torch.arange(10, dtype=torch.int32)
    src = torch.arange(80, dtype=torch.int64).reshape(10, 8)
    with pytest.raises(ValueError, match=r"src must be contiguous \(row-major\)"):
        gr.gather_rows_cuda([(src[:, ::2], idx)])
    wide = torch.zeros((10, 9), dtype=torch.int64)
    for parts in ([(src, idx)], [(wide, idx)], [(src, idx)] * 3):
        with pytest.raises(ValueError, match="must share one CUDA device"):
            gr.gather_rows_cuda(parts)
    assert kernels.launch_counts()["gather_rows"] == 0


def test_sizes_mirror_the_cuda_source():
    from pim_sort_merge_join_tpu_torch.ops.kernels import build

    text = (build.CSRC_DIR / "gather.cu").read_text()
    assert f"#define SMJ_ROWS_MAX_BYTES {gr.MAX_ROW_BYTES}\n" in text
    assert f"#define SMJ_ROWS_MAX_PARTS {gr.MAX_PARTS}\n" in text
