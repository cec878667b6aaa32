"""The narrow probe's extremes: a CUDA kernel for Hopper, and the plain version.

``narrow_extremes(d1, d2, k1, k2)`` is what the narrow probe reads: over the
raw buffers of two tables, padding included, ``lo = [min key, min value]``
and ``hi = [max key, max value]`` as order keys, the keys being column
``k1`` of ``d1`` and ``k2`` of ``d2``. Its plain version,
`narrow_extremes_plain`, takes eight torch reductions; on int64 and uint64
CUDA buffers `narrow_extremes_cuda` reads each buffer once in one launch
of `csrc/probe.cu` (its note says how). The result equals the plain
version's exactly, errors included: an out-of-range key column raises
`IndexError` and an empty buffer `RuntimeError`, with torch's messages
(`_checked`).
`narrow_extremes_blocked_plain` walks the kernel's loads thread by thread
(each 16-byte pair's columns carried from the one before, the odd tail,
the row-by-row path of other layouts), so the CPU tests reach its index
arithmetic.
"""

from __future__ import annotations

import ctypes

import torch

from pim_sort_merge_join_tpu_torch.columnar import dtypes
from pim_sort_merge_join_tpu_torch.ops.kernels import build

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_BUF = [_P, _I64, _INT, _I64, _I64, _INT, _INT, _INT]
# The zeroed ticket and block records of each (device, stream): the kernel
# sets the ticket back to 0, and launches on one stream run one at a time.
_scratch: dict[tuple[int, int], torch.Tensor] = {}

_KERNEL_TYPES = (torch.int64, torch.uint64)  # what the kernel reads

build.declare(
    {"smj_probe_max_blocks": [], "smj_narrow_extremes": [*_BUF, *_BUF, _P, _P, _P]},
    ("narrow_extremes",),
)


def narrow_extremes(d1: torch.Tensor, d2: torch.Tensor, k1: int, k2: int):
    """``(lo, hi)``, int64 ``[2]`` each on the buffers' device: the
    order-key extremes of the key columns and of every value (order keys,
    since torch has no ``min`` for uint64; padding zeros keep the range
    inside int32, never push a valid value out). CPU buffers take
    `narrow_extremes_plain`; the rest launch the kernel, which raises on
    mixed or other devices and on types other than int64 and uint64."""
    if d1.device.type == "cpu" and d2.device.type == "cpu":
        return narrow_extremes_plain(d1, d2, k1, k2)
    return narrow_extremes_cuda(d1, d2, k1, k2)


def narrow_extremes_plain(d1: torch.Tensor, d2: torch.Tensor, k1: int, k2: int):
    """`narrow_extremes` as torch reductions, on any device and any type."""
    ok1, ok2 = dtypes.order_key(d1), dtypes.order_key(d2)
    lo = torch.stack([torch.minimum(ok1[:, k1].min(), ok2[:, k2].min()),
                      torch.minimum(ok1.min(), ok2.min())])
    hi = torch.stack([torch.maximum(ok1[:, k1].max(), ok2[:, k2].max()),
                      torch.maximum(ok1.max(), ok2.max())])
    return lo, hi


def _scratch_for(device: torch.device, stream: int) -> torch.Tensor:
    key = (device.index, stream)
    if key not in _scratch:
        words = 2 + 4 * build.entry("smj_probe_max_blocks")()
        _scratch[key] = torch.zeros(words, dtype=torch.int64, device=device)
    return _scratch[key]


def _checked(d1: torch.Tensor, d2: torch.Tensor, k1: int, k2: int) -> tuple[int, int]:
    """The key columns as torch's ``d[:, k]`` reads them (``-1`` is the
    last); the plain version's error where it raises one, in its order."""
    for d in (d1, d2):
        if d.dim() != 2 or d.dtype not in _KERNEL_TYPES:
            raise ValueError(
                f"narrow_extremes: buffers must be 2D int64/uint64, got {d.dtype} {tuple(d.shape)}"
            )
    keys = []
    for d, k in ((d1, k1), (d2, k2)):
        ncol = d.shape[1]
        if not -ncol <= k < ncol:
            raise IndexError(f"index {k} is out of bounds for dimension 1 with size {ncol}")
        if d.shape[0] == 0:
            raise RuntimeError(
                "min(): Expected reduction dim to be specified for input.numel() == 0. "
                "Specify the reduction dim with the 'dim' argument."
            )
        keys.append(k % ncol)
    return keys[0], keys[1]


def _vec(d: torch.Tensor) -> bool:
    """Whether the kernel reads ``d`` 16 bytes a load: contiguous from a
    16-byte aligned start (`csrc/probe.cu`'s ``vec``)."""
    return d.is_contiguous() and d.data_ptr() % 16 == 0


def _buf_args(d: torch.Tensor, k: int) -> list:
    return [d.data_ptr(), d.shape[0], d.shape[1], d.stride(0), d.stride(1), k,
            int(d.dtype == torch.uint64), int(d.is_contiguous())]


def narrow_extremes_cuda(d1: torch.Tensor, d2: torch.Tensor, k1: int, k2: int):
    """``(lo, hi)``, int64 ``[2]`` each on the buffers' device, from one
    launch; any 2D int64/uint64 view of either table is taken by its
    strides."""
    for d in (d1, d2):
        if d.device.type != "cuda" or d.device != d1.device:
            raise ValueError(
                f"narrow_extremes: buffers must share one CUDA device, got {d1.device}, {d2.device}"
            )
    k1, k2 = _checked(d1, d2, k1, k2)
    out = torch.empty((2, 2), dtype=torch.int64, device=d1.device)
    stream = build.stream_ptr(d1)
    err = build.entry("smj_narrow_extremes")(
        *_buf_args(d1, k1), *_buf_args(d2, k2), out.data_ptr(),
        _scratch_for(d1.device, stream).data_ptr(), stream,
    )
    build.check(err, "narrow_extremes")
    build.launched("narrow_extremes")
    return out[0], out[1]


def narrow_extremes_blocked_plain(d1: torch.Tensor, d2: torch.Tensor, k1: int, k2: int,
                                  *, threads: int):
    """`narrow_extremes` as the kernel's ``threads`` threads read it, on any
    device: in a buffer read 16 bytes a load, thread ``t`` takes pairs
    ``t, t + threads, ...``, its column carried from pair to pair by adding
    ``2 * threads % ncol``, the pair's second element a key where the first
    lies in the column before the key; thread 0 takes an odd count's last
    element; a buffer of any other layout goes row by row. Each thread's
    extremes fold into the grid's, as the blocks' records do."""
    k1, k2 = _checked(d1, d2, k1, k2)
    lo = [None, None]
    hi = [None, None]

    def take(values: torch.Tensor, is_key: torch.Tensor) -> None:
        for slot, v in ((0, values[is_key]), (1, values)):
            if v.numel():
                lo[slot] = v.min() if lo[slot] is None else torch.minimum(lo[slot], v.min())
                hi[slot] = v.max() if hi[slot] is None else torch.maximum(hi[slot], v.max())

    for d, key in ((d1, k1), (d2, k2)):
        ok = d.view(torch.int64) ^ (-(2**63) if d.dtype == torch.uint64 else 0)
        ncol = d.shape[1]
        if not _vec(d):
            for t in range(threads):
                rows = ok[t::threads]
                cols = torch.arange(ncol, device=d.device).expand(rows.shape[0], ncol)
                take(rows.reshape(-1), (cols == key).reshape(-1))
            continue
        flat = ok.reshape(-1)
        n = flat.shape[0]
        kprev = (key - 1) % ncol
        adv = 2 * threads % ncol
        every = torch.arange(n // 2, device=d.device)
        for t in range(threads):
            pairs = every[t::threads]
            c = torch.remainder(2 * t + adv * torch.arange(pairs.shape[0], device=d.device), ncol)
            take(flat[2 * pairs], c == key)
            take(flat[2 * pairs + 1], c == kprev)
        if n % 2:
            take(flat[n - 1:], torch.tensor([(n - 1) % ncol == key], device=d.device))
    return torch.stack(lo), torch.stack(hi)
