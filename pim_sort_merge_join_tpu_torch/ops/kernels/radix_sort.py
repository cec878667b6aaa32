"""Per-tile LSD radix sort: the CUDA kernel for Hopper, and the plain versions.

Replaces the TPU kernel of `pim_sort_merge_join_tpu/ops/pallas/radix_sort.py`
(`_radix_tile_kernel`, launched by `radix_tile_sort`), the run-formation
experiment of `bench/radix_bench.py`: every ``tile`` elements of the int32
operands are sorted stably by ``operands[0]``, one ``digit_bits`` digit per
pass for ``ceil(key_bits / digit_bits)`` passes, least significant first.
The digit is ``(key >> shift) & (2^digit_bits - 1)``, so keys order by
their low bits read as unsigned: with ``key_bits=32`` a negative key sorts
after the non-negative ones, as on the TPU. The output tiles are sorted
runs, the contract of `hbm_sort.chunk_sort` at ``chunk = tile``.

The TPU had no vector scatter and permuted each tile through one-hot
matmuls; `csrc/radix_sort.cu` scatters in shared memory instead, ranking
equal digits within a warp. `xla_lsd_radix_sort`, the reference's global
counting sort, is plain torch here as it was plain XLA there.
"""

from __future__ import annotations

import ctypes
import math

import torch

from pim_sort_merge_join_tpu_torch.ops.kernels import build

# Kernel launches by this module's wrapper, for showing which path ran.
LAUNCHES = {"radix_tile": 0}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_fns: dict = {}


def _fn(name: str):
    if name not in _fns:
        argtypes = {
            "smj_radix_max_ops": [],
            "smj_radix_max_smem": [],
            "smj_radix_smem_bytes": [_I64, ctypes.c_int],
            "smj_radix_tile_sort": [
                _P, _P, ctypes.c_int, _I64, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P,
            ],
        }[name]
        fn = build.c_function(name, argtypes)
        if name in ("smj_radix_max_smem", "smj_radix_smem_bytes"):
            fn.restype = ctypes.c_int64
        _fns[name] = fn
    return _fns[name]


def _num_passes(digit_bits: int, key_bits: int) -> int:
    if not 1 <= digit_bits <= 16 or not 1 <= key_bits <= 32:
        raise ValueError(
            f"radix sort: digit_bits must be in [1, 16] and key_bits in [1, 32], "
            f"got {digit_bits}, {key_bits}"
        )
    return math.ceil(key_bits / digit_bits)


def _check_operands(operands, tile: int) -> int:
    n = operands[0].shape[0]
    for op in operands:
        if op.dtype != torch.int32 or op.shape != (n,):
            raise ValueError(
                "radix_tile_sort: operands must be 1D int32 of one length, got "
                f"{[(o.dtype, tuple(o.shape)) for o in operands]}"
            )
    if tile < 1 or n % tile != 0:
        raise ValueError(f"n={n} must be a multiple of tile={tile}")
    return n


def radix_tile_sort_plain(
    operands: tuple[torch.Tensor, ...], *, tile: int = 512, digit_bits: int = 8,
    key_bits: int = 32,
) -> tuple[torch.Tensor, ...]:
    """Plain torch version: the same LSD passes, each a stable `torch.sort`
    of every tile's digits."""
    n = _check_operands(operands, tile)
    mask = (1 << digit_bits) - 1
    ops = [op.reshape(n // tile, tile) for op in operands]
    for p in range(_num_passes(digit_bits, key_bits)):
        digit = (ops[0] >> (p * digit_bits)) & mask
        order = torch.sort(digit, dim=1, stable=True).indices
        ops = [torch.gather(op, 1, order) for op in ops]
    return tuple(op.reshape(n) for op in ops)


def radix_tile_sort_cuda(
    operands: tuple[torch.Tensor, ...], *, tile: int = 512, digit_bits: int = 8,
    key_bits: int = 32,
) -> tuple[torch.Tensor, ...]:
    """The kernel: one block per tile, one launch for all passes."""
    build.require_cuda("radix_tile_sort", *operands)
    n = _check_operands(operands, tile)
    npass = _num_passes(digit_bits, key_bits)
    max_ops = _fn("smj_radix_max_ops")()
    if len(operands) > max_ops:
        raise ValueError(f"radix_tile_sort: at most {max_ops} operands, got {len(operands)}")
    smem, limit = _fn("smj_radix_smem_bytes")(tile, digit_bits), _fn("smj_radix_max_smem")()
    if smem > limit:
        raise ValueError(
            f"radix_tile_sort: tile={tile} with digit_bits={digit_bits} needs {smem} "
            f"bytes of shared memory, more than a block's {limit}"
        )
    outs = tuple(torch.empty_like(op) for op in operands)
    k = len(operands)
    srcs = (ctypes.c_void_p * k)(*(op.data_ptr() for op in operands))
    dsts = (ctypes.c_void_p * k)(*(o.data_ptr() for o in outs))
    err = _fn("smj_radix_tile_sort")(
        ctypes.cast(srcs, _P), ctypes.cast(dsts, _P), k, n, tile, digit_bits, npass,
        build.stream_ptr(operands[0]),
    )
    build.check(err, "radix_tile_sort")
    LAUNCHES["radix_tile"] += 1
    return outs


def radix_tile_sort(
    operands: tuple[torch.Tensor, ...], *, tile: int = 512, digit_bits: int = 8,
    key_bits: int = 32,
) -> tuple[torch.Tensor, ...]:
    """Sort each ``tile``-element tile of the operands by ``operands[0]``.

    The kernel for CUDA tensors, the plain version for CPU tensors; any
    other device raises.
    """
    operands = tuple(operands)
    devices = {o.device.type for o in operands}
    kw = dict(tile=tile, digit_bits=digit_bits, key_bits=key_bits)
    if devices == {"cpu"}:
        return radix_tile_sort_plain(operands, **kw)
    if devices == {"cuda"}:
        return radix_tile_sort_cuda(operands, **kw)
    raise ValueError(f"radix_tile_sort: unsupported devices {sorted(devices)}")


def xla_lsd_radix_sort(
    operands: tuple[torch.Tensor, ...], *, digit_bits: int = 8, key_bits: int = 32,
) -> tuple[torch.Tensor, ...]:
    """Global LSD radix sort as plain torch (the reference's XLA route).

    Per pass a whole-array stable counting sort: the digits' one-hot prefix
    sums give each element its rank among equal digits, the histogram's
    exclusive prefix the digits' bases, and a scatter applies the result.
    """
    if operands[0].dtype != torch.int32:
        raise ValueError("xla_lsd_radix_sort: int32 keys only")
    v = 1 << digit_bits
    ops = tuple(operands)
    for p in range(_num_passes(digit_bits, key_bits)):
        digit = ((ops[0] >> (p * digit_bits)) & (v - 1)).long()
        pre = torch.cumsum(torch.nn.functional.one_hot(digit, v), dim=0)
        hist = pre[-1]
        base = torch.cumsum(hist, 0) - hist
        rank = pre.gather(1, digit[:, None])[:, 0] - 1
        dest = base[digit] + rank
        ops = tuple(torch.zeros_like(x).index_copy_(0, dest, x) for x in ops)
    return ops
