"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips. On a machine
with the card and no jax, run them without the JAX test harness:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

The cases are the adversarial ones `chip_smoke.py` runs (those of
tests/test_hbm_sort.py and tests/test_join_scan.py, plus runs that cross
the scan's blocks). Every comparison is exact.
"""

import numpy as np
import pytest
import torch

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


def test_join_scan_kernel_matches_plain(cuda):
    import chip_smoke
    from pim_sort_merge_join_tpu_torch.ops.join import _merged_dest_plain
    from pim_sort_merge_join_tpu_torch.ops.kernels import join_scan as js

    for name, mkeys, mpos, cap1 in chip_smoke.scan_cases(np.random.default_rng(62)):
        mk, mp = torch.from_numpy(mkeys).to(cuda), torch.from_numpy(mpos).to(cuda)
        dest, num_out = js.join_scan_cuda(mk, mp, cap1)
        want_dest, want_num = _merged_dest_plain(mk, mp, cap1)
        assert torch.equal(dest, want_dest), name
        assert int(num_out) == int(want_num), name


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
    assert all(n > 0 for n in kernels.launch_counts().values())
    want = QueryPipeline(cfg).run_tables(Table.from_numpy(r1), Table.from_numpy(r2))
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
