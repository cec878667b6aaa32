"""Stable multi-operand sort: CUDA kernels for Hopper, and the plain version.

Replaces the TPU kernels of `pim_sort_merge_join_tpu/ops/pallas/hbm_sort.py`
(`_chunk_sort_kernel`, `_merge_path_meta` + `_merge_kernel`). The contract
is the same: the result equals a stable sort of ``operands`` by
``operands[:num_keys]`` (``jax.lax.sort(..., is_stable=True)``).

The card sorts one element type: a ``(uint64 key, uint32 index)`` pair
(`csrc/hbm_sort.cu`). The index is the element's position, which makes the
sort stable and every element unique. The kernels return the permutation,
and one gather kernel applies it to every operand. What the 64-bit key can
hold decides which sorts run on the card:

- one int32 or int64 key;
- two int32 keys, packed into one 64-bit key;
- an int64 key and a second key equal to ``arange(n)``: exactly the
  stable sort of the first key.

Any other combination raises on CUDA tensors (ROADMAP: "Float keys and
general num_keys=2 on CUDA").
"""

from __future__ import annotations

import ctypes

import torch

from pim_sort_merge_join_tpu_torch.ops.kernels import build

KIND_I32, KIND_I64, KIND_I32_PAIR = 0, 1, 2
GATHER_MAX_COLS = 8  # SMJ_GATHER_MAX_COLS in csrc/hbm_sort.cu

# Kernel launches by this module's wrappers, for showing which path ran.
LAUNCHES = {"hbm_sort_chunk": 0, "hbm_sort_merge": 0, "hbm_sort_gather": 0}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_fns: dict = {}


def _fn(name: str):
    if name not in _fns:
        argtypes = {
            "smj_hbm_sort_chunk_size": [],
            "smj_hbm_sort_tile_size": [],
            "smj_chunk_sort": [_P, _P, ctypes.c_int, _I64, _P, _P, _P],
            "smj_merge_pass": [_P, _P, _P, _P, _P, _I64, _I64, _P],
            "smj_gather": [_P, _P, _P, ctypes.c_int, _P, _I64, _P],
        }[name]
        _fns[name] = build.c_function(name, argtypes)
    return _fns[name]


def hbm_sort_plain(
    operands: tuple[torch.Tensor, ...], num_keys: int = 1
) -> tuple[torch.Tensor, ...]:
    """Plain torch version: one stable `torch.sort` per key, from the last
    key to the first, then a gather of every operand."""
    n = operands[0].shape[0]
    perm = torch.arange(n, device=operands[0].device)
    for key in reversed(operands[:num_keys]):
        _, order = torch.sort(key[perm], stable=True)
        perm = perm[order]
    return tuple(op[perm] for op in operands)


def _key_kind(operands, num_keys: int):
    """(k0, k1, kind) for the kernel, or raise for what it cannot take."""
    k0 = operands[0]
    if num_keys == 1 and k0.dtype in (torch.int32, torch.int64):
        return k0, k0, KIND_I32 if k0.dtype == torch.int32 else KIND_I64
    if num_keys == 2:
        k1 = operands[1]
        if k0.dtype == torch.int32 and k1.dtype == torch.int32:
            return k0, k1, KIND_I32_PAIR
        if k0.dtype == torch.int64 and k1.dtype in (torch.int32, torch.int64):
            iota = torch.arange(k1.shape[0], dtype=k1.dtype, device=k1.device)
            if torch.equal(k1, iota):
                return k0, k0, KIND_I64
            raise ValueError(
                "hbm_sort: a 2-key sort with an int64 first key needs a second "
                "key equal to arange(n) (ROADMAP: 'Float keys and general "
                "num_keys=2 on CUDA')"
            )
    raise ValueError(
        f"hbm_sort: no CUDA kernel for num_keys={num_keys} with key dtypes "
        f"{[o.dtype for o in operands[:num_keys]]} (ROADMAP: 'Float keys and "
        "general num_keys=2 on CUDA')"
    )


def chunk_sort(k0: torch.Tensor, k1: torch.Tensor, kind: int):
    """Phase A (kernel 1): sorted runs of CHUNK elements.

    Returns ``(keys, idx)``: biased uint64 keys (held in an int64 tensor)
    and int32 indices, padded to a multiple of the chunk size.
    """
    build.require_cuda("hbm_sort", k0, k1)
    n = k0.shape[0]
    if n >= 2**31:
        raise ValueError(f"hbm_sort: {n} elements exceed the 32-bit index")
    chunk = _fn("smj_hbm_sort_chunk_size")()
    npad = -(-n // chunk) * chunk
    keys = torch.empty(npad, dtype=torch.int64, device=k0.device)
    idx = torch.empty(npad, dtype=torch.int32, device=k0.device)
    err = _fn("smj_chunk_sort")(
        k0.data_ptr(), k1.data_ptr(), kind, n, keys.data_ptr(), idx.data_ptr(),
        build.stream_ptr(k0),
    )
    build.check(err, "hbm_sort chunk sort")
    LAUNCHES["hbm_sort_chunk"] += 1
    return keys, idx


def merge_passes(keys: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Phase B (kernel 2): merge the chunk runs pairwise until one is left.

    Ping-pongs between the given buffers and a second pair, so the inputs
    are overwritten. Returns the sorted indices, padding at the tail.
    """
    build.require_cuda("hbm_sort", keys, idx)
    npad = keys.shape[0]
    bufs = [(keys, idx), (torch.empty_like(keys), torch.empty_like(idx))]
    a_start = torch.empty(
        npad // _fn("smj_hbm_sort_tile_size")(), dtype=torch.int32, device=keys.device
    )
    stream = build.stream_ptr(keys)
    src, run = 0, _fn("smj_hbm_sort_chunk_size")()
    while run < npad:
        (sk, si), (dk, di) = bufs[src], bufs[1 - src]
        err = _fn("smj_merge_pass")(
            sk.data_ptr(), si.data_ptr(), dk.data_ptr(), di.data_ptr(),
            a_start.data_ptr(), npad, run, stream,
        )
        build.check(err, "hbm_sort merge pass")
        LAUNCHES["hbm_sort_merge"] += 1
        src, run = 1 - src, run * 2
    return bufs[src][1]


def sort_permutation(k0: torch.Tensor, k1: torch.Tensor, kind: int) -> torch.Tensor:
    """int32 ``[n]`` permutation that stably sorts the key (kernels 1 + 2)."""
    return merge_passes(*chunk_sort(k0, k1, kind))[: k0.shape[0]]


def gather(perm: torch.Tensor, operands: tuple[torch.Tensor, ...]) -> tuple[torch.Tensor, ...]:
    """``out[i] = op[perm[i]]`` for every operand, in one launch per 8 columns."""
    build.require_cuda("hbm_sort gather", perm, *operands)
    for op in operands:
        if op.dtype not in (torch.int32, torch.int64) or op.shape != perm.shape:
            raise ValueError(
                f"hbm_sort gather: operands must be int32/int64 of shape "
                f"{tuple(perm.shape)}, got {op.dtype} {tuple(op.shape)}"
            )
    outs = tuple(torch.empty_like(op) for op in operands)
    n = perm.shape[0]
    for lo in range(0, len(operands), GATHER_MAX_COLS):
        group = range(lo, min(lo + GATHER_MAX_COLS, len(operands)))
        k = len(group)
        srcs = (ctypes.c_void_p * k)(*(operands[c].data_ptr() for c in group))
        dsts = (ctypes.c_void_p * k)(*(outs[c].data_ptr() for c in group))
        sizes = (ctypes.c_int * k)(*(operands[c].element_size() for c in group))
        err = _fn("smj_gather")(
            ctypes.cast(srcs, _P), ctypes.cast(dsts, _P), ctypes.cast(sizes, _P),
            k, perm.data_ptr(), n, build.stream_ptr(perm),
        )
        build.check(err, "hbm_sort gather")
        LAUNCHES["hbm_sort_gather"] += 1
    return outs


def hbm_sort(
    operands: tuple[torch.Tensor, ...], num_keys: int = 1
) -> tuple[torch.Tensor, ...]:
    """Stable sort of 1D ``operands`` by ``operands[:num_keys]``.

    CUDA tensors go through the kernels at every size; CPU tensors through
    `hbm_sort_plain`; any other device raises.
    """
    operands = tuple(operands)
    n = operands[0].shape[0]
    if any(o.shape != (n,) for o in operands):
        raise ValueError("hbm_sort operands must be 1D of equal length")
    if not 1 <= num_keys <= len(operands):
        raise ValueError(f"num_keys={num_keys} out of range")
    devices = {o.device.type for o in operands}
    if devices == {"cpu"}:
        return hbm_sort_plain(operands, num_keys)
    if devices != {"cuda"}:
        raise ValueError(f"hbm_sort: unsupported devices {sorted(devices)}")
    k0, k1, kind = _key_kind(operands, num_keys)
    if n == 0:
        return operands
    return gather(sort_permutation(k0, k1, kind), operands)
