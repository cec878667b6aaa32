"""The port's join-rank scan (plain path, CPU) against the JAX package.

`_merged_dest_plain` must equal the JAX Pallas kernel `join_scan_dest`
(interpret mode, 256-element tiles so runs cross tiles) and the XLA scan
block `_merged_dest_xla` exactly, on the adversarial cases of
tests/test_join_scan.py: runs across tiles, dead (sentinel) keys, 64-bit
extremes, int32 keys, every key dead, one run spanning everything, and
one side empty.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pim_sort_merge_join_tpu.ops.join import _merged_dest_xla
from pim_sort_merge_join_tpu.ops.pallas.join_scan import join_scan_dest
from pim_sort_merge_join_tpu_torch.ops.join import _merged_dest
from pim_sort_merge_join_tpu_torch.ops.kernels.join_scan import _merged_dest_plain

TILE = 256


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


def _case(name, rng):
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
    raise AssertionError(name)


def _port(mkeys, mpos, cap1):
    dest, num_out = _merged_dest_plain(torch.from_numpy(mkeys), torch.from_numpy(mpos), cap1)
    assert dest.dtype == torch.int32 and num_out.dtype == torch.int32 and num_out.dim() == 0
    return dest.numpy(), int(num_out)


@pytest.mark.parametrize(
    "name", ["mostly_unique", "long_runs", "wide_extremes", "int32_keys", "all_dead", "one_run"]
)
def test_plain_scan_matches_pallas_kernel(name):
    mkeys, mpos, cap1 = _case(name, np.random.default_rng(21))
    want_dest, want_cnt = join_scan_dest(
        jnp.asarray(mkeys), jnp.asarray(mpos), cap1, interpret=True, tile=TILE
    )
    got_dest, got_cnt = _port(mkeys, mpos, cap1)
    np.testing.assert_array_equal(got_dest, np.asarray(want_dest))
    assert got_cnt == int(want_cnt)


@pytest.mark.parametrize(
    "name",
    ["mostly_unique", "long_runs", "wide_extremes", "int32_keys", "all_dead", "one_run",
     "side1_empty", "side2_empty"],
)
def test_plain_scan_matches_xla_scan(name):
    mkeys, mpos, cap1 = _case(name, np.random.default_rng(22))
    want_dest, want_cnt = _merged_dest_xla(jnp.asarray(mkeys), jnp.asarray(mpos), cap1)
    got_dest, got_cnt = _port(mkeys, mpos, cap1)
    np.testing.assert_array_equal(got_dest, np.asarray(want_dest))
    assert got_cnt == int(want_cnt)


def test_dispatch_takes_plain_on_cpu_and_rejects_other_devices():
    mkeys, mpos, cap1 = _case("long_runs", np.random.default_rng(23))
    mk, mp = torch.from_numpy(mkeys), torch.from_numpy(mpos)
    got = _merged_dest(mk, mp, cap1)
    want = _merged_dest_plain(mk, mp, cap1)
    assert torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])
    with pytest.raises(ValueError, match="device"):
        _merged_dest(mk.to("meta"), mp.to("meta"), cap1)
