"""Bitonic sort of int32 (key, val) pairs: CUDA kernels for Hopper, and the plain version.

Replaces the TPU kernel of `pim_sort_merge_join_tpu/ops/pallas/sort_kernel.py`
(`_sort_kernel`, launched by `_sort_pairs_pallas_p2`). The contract is the
same: the pairs of a power-of-two array sorted lexicographically on
``(key, val)`` by the network of `_substeps` / `_compare_exchange`, which
with ``val = arange(n)`` is a stable sort by key. `sort_pairs` pads any
length to a power of two, and above ``PALLAS_SORT_MAX`` hands the work to
`hbm_sort` with a warning, as `sort_pairs_pallas` does.

The TPU held the whole array in VMEM; a block on the card holds at most
227 KB, so `csrc/bitonic_sort.cu` splits the network: substeps with
``j < TILE`` run in shared memory per tile (`bitonic_local_kernel`), the
others one per launch over device memory (`bitonic_global_kernel`).
"""

from __future__ import annotations

import ctypes
import warnings

import torch

from pim_sort_merge_join_tpu_torch.ops.kernels import build
from pim_sort_merge_join_tpu_torch.ops.kernels.hbm_sort import hbm_sort

# Above this width the reference's VMEM-resident kernel hands off to the
# HBM-scale sort (`sort_kernel.py` PALLAS_SORT_MAX); the port keeps the cap.
PALLAS_SORT_MAX = 1 << 21
MIN_WIDTH = 256
# The kernels index pairs with 32-bit integers.
MAX_WIDTH = 1 << 30

# Kernel launches by this module's wrappers, for showing which path ran.
LAUNCHES = {"bitonic_local": 0, "bitonic_global": 0}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_fns: dict = {}


def _fn(name: str):
    if name not in _fns:
        argtypes = {
            "smj_bitonic_tile_size": [],
            "smj_bitonic_local": [_P, _P, _I64, ctypes.c_int, _I64, _P],
            "smj_bitonic_global": [_P, _P, _I64, _I64, _I64, _P],
        }[name]
        _fns[name] = build.c_function(name, argtypes)
    return _fns[name]


def _substeps(n: int):
    """The (k, j) schedule of a bitonic network of width n (`_substeps`)."""
    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            yield k, j
            j //= 2
        k *= 2


def _compare_exchange(keys, vals, n: int, k: int, j: int):
    """One substep on flat ``[n]`` tensors: the pairs (i, i + j) of each
    ``2j`` block, ascending iff ``(i & k) == 0`` (`_compare_exchange`)."""
    m = n // (2 * j)
    ka, va = keys.view(m, 2, j), vals.view(m, 2, j)
    lo_k, hi_k = ka[:, 0, :], ka[:, 1, :]
    lo_v, hi_v = va[:, 0, :], va[:, 1, :]
    blk = torch.arange(m, dtype=torch.int64, device=keys.device)[:, None]
    up = ((blk * (2 * j)) & k) == 0
    gt = (lo_k > hi_k) | ((lo_k == hi_k) & (lo_v > hi_v))
    swap = torch.where(up, gt, ~gt)
    keys = torch.stack([torch.where(swap, hi_k, lo_k), torch.where(swap, lo_k, hi_k)], dim=1)
    vals = torch.stack([torch.where(swap, hi_v, lo_v), torch.where(swap, lo_v, hi_v)], dim=1)
    return keys.reshape(n), vals.reshape(n)


def bitonic_sort_plain(keys: torch.Tensor, vals: torch.Tensor):
    """Plain torch version (`bitonic_sort_xla`): the same network as torch ops."""
    n = keys.shape[0]
    if n & (n - 1):
        raise ValueError(f"bitonic width must be a power of two, got {n}")
    keys, vals = keys.contiguous(), vals.contiguous()
    for k, j in _substeps(n):
        keys, vals = _compare_exchange(keys, vals, n, k, j)
    return keys, vals


def bitonic_sort_cuda(keys: torch.Tensor, vals: torch.Tensor):
    """The network on the card; returns new sorted ``(keys, vals)``."""
    build.require_cuda("bitonic_sort", keys, vals)
    n = keys.shape[0]
    if keys.dtype != torch.int32 or vals.dtype != torch.int32:
        raise ValueError(f"bitonic_sort: int32 keys and vals only, got {keys.dtype}, {vals.dtype}")
    if keys.dim() != 1 or vals.shape != keys.shape:
        raise ValueError(
            f"bitonic_sort: keys and vals must be 1D of one length, got "
            f"{tuple(keys.shape)}, {tuple(vals.shape)}"
        )
    if n & (n - 1) or not 2 <= n <= MAX_WIDTH:
        raise ValueError(f"bitonic_sort: width must be a power of two in [2, 2^30], got {n}")
    keys, vals = keys.clone(), vals.clone()
    stream = build.stream_ptr(keys)
    tile = min(n, _fn("smj_bitonic_tile_size")())

    def local(k: int) -> None:
        err = _fn("smj_bitonic_local")(keys.data_ptr(), vals.data_ptr(), n, tile, k, stream)
        build.check(err, "bitonic_sort local")
        LAUNCHES["bitonic_local"] += 1

    local(0)  # stages k = 2..tile, inside each tile
    k = 2 * tile
    while k <= n:
        j = k // 2
        while j >= tile:
            err = _fn("smj_bitonic_global")(keys.data_ptr(), vals.data_ptr(), n, k, j, stream)
            build.check(err, "bitonic_sort global")
            LAUNCHES["bitonic_global"] += 1
            j //= 2
        local(k)  # substeps j < tile of stage k
        k *= 2
    return keys, vals


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def sort_pairs(keys: torch.Tensor, vals: torch.Tensor):
    """Sort int32 ``(keys, vals)`` by ``(key, val)`` ascending; any length.

    Port of `sort_pairs_pallas`: pads to ``max(next_pow2(n), 256)`` with
    the dtype's max as key and val and returns the first n pairs. Past
    ``PALLAS_SORT_MAX`` it warns and runs `hbm_sort((keys, vals))`, a
    stable sort by key, which is the same result wherever vals increase
    with the index (every engine call passes an arange).

    CUDA tensors run the kernels, CPU tensors the plain version; any other
    device raises.
    """
    devices = {keys.device.type, vals.device.type}
    if devices not in ({"cpu"}, {"cuda"}):
        raise ValueError(f"sort_pairs: unsupported devices {sorted(devices)}")
    n = keys.shape[0]
    n2 = max(_next_pow2(n), MIN_WIDTH)
    if n2 > PALLAS_SORT_MAX:
        warnings.warn(
            f"sort_pairs: n={n} exceeds the bitonic cap ({PALLAS_SORT_MAX}); "
            "running the hbm_sort kernels (ops/kernels/hbm_sort.py) instead",
            stacklevel=2,
        )
        return hbm_sort((keys, vals))
    if n2 != n:
        keys = torch.cat([keys, keys.new_full((n2 - n,), torch.iinfo(keys.dtype).max)])
        vals = torch.cat([vals, vals.new_full((n2 - n,), torch.iinfo(vals.dtype).max)])
    sort = bitonic_sort_cuda if devices == {"cuda"} else bitonic_sort_plain
    out_k, out_v = sort(keys, vals)
    return out_k[:n], out_v[:n]
