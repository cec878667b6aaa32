"""Bitonic sort of int32 (key, val) pairs: CUDA kernels for Hopper, and the plain version.

Replaces the TPU kernel of `pim_sort_merge_join_tpu/ops/pallas/sort_kernel.py`
(`_sort_kernel`, launched by `_sort_pairs_pallas_p2`). The contract is the
same: the pairs of a power-of-two array sorted lexicographically on
``(key, val)`` by the network of `_substeps` / `_compare_exchange`, which
with ``val = arange(n)`` is a stable sort by key. `sort_pairs` pads any
length to a power of two, and above ``PALLAS_SORT_MAX`` hands the work to
`hbm_sort` with a warning, as `sort_pairs_pallas` does.

The TPU held the whole array in VMEM; a block on the card holds at most
227 KB, so `csrc/bitonic_sort.cu` cuts the network into passes over tiles
of ``2^LOG_TILE`` elements in shared memory (`bitonic_schedule`): a *local*
pass runs the substeps with ``j < tile`` on contiguous tiles, a *strided*
pass up to ``LOG_TILE - LOG_MIN_CHUNK`` substeps with ``j >= tile`` on tiles
gathered by index bits. A pair travels as one 64-bit element
(`hbm_sort.pack_pair32`). The schedule and the tiles' index arithmetic are
plain Python here, and `bitonic_sort_blocked_plain` runs them as torch ops
at any tile size, which the CPU tests reach.
"""

from __future__ import annotations

import ctypes
import warnings
from typing import NamedTuple

import torch

from pim_sort_merge_join_tpu_torch.ops.kernels import build
from pim_sort_merge_join_tpu_torch.ops.kernels.hbm_sort import (
    hbm_sort,
    pack_pair32,
    unpack_pair32,
)

# Above this width the reference's VMEM-resident kernel hands off to the
# HBM-scale sort (`sort_kernel.py` PALLAS_SORT_MAX); the port keeps the cap.
PALLAS_SORT_MAX = 1 << 21
MIN_WIDTH = 256
# The kernels index pairs with 32-bit integers.
MAX_WIDTH = 1 << 30

LOG_TILE = 13  # SMJ_BITONIC_LOG_TILE in csrc/bitonic_sort.cu: elements of a tile
LOG_MIN_CHUNK = 4  # SMJ_BITONIC_LOG_MIN_CHUNK: the shortest contiguous piece of a strided tile

_MIN64 = -(2**63)
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int


def _check_sizes() -> None:
    sizes = tuple(
        build.c_function(f, [])() for f in ("smj_bitonic_log_tile", "smj_bitonic_log_min_chunk")
    )
    if sizes != (LOG_TILE, LOG_MIN_CHUNK):
        raise RuntimeError(
            f"bitonic_sort: the library was built with (LOG_TILE, LOG_MIN_CHUNK) = "
            f"{sizes}, this module plans for {(LOG_TILE, LOG_MIN_CHUNK)}"
        )


build.declare(
    {"smj_bitonic_passes": [_P, _P, _P, _P, _P, _I64, _I64, _P, _INT, _INT, _INT, _P]},
    ("bitonic_local", "bitonic_strided"),
    _check_sizes,
)


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


class BitonicPass(NamedTuple):
    """One launch: stages ``k = 2^first_stage .. 2^last_stage`` on tiles of
    ``2^log_tile`` elements.

    A tile holds the index bits below ``chunk`` and the ``log_tile - chunk``
    bits from ``lo`` up; of each stage the pass runs the substeps on the
    tile's bits from ``stage - 1`` down to ``low_bit``. A local pass has
    ``chunk == lo == log_tile`` (a contiguous tile) and ``low_bit == 0``; a
    strided pass ``chunk < log_tile <= lo`` and ``low_bit == lo``.
    """

    first_stage: int
    last_stage: int
    lo: int
    chunk: int
    low_bit: int
    log_tile: int

    @property
    def strided(self) -> bool:
        return self.chunk != self.log_tile

    def substeps(self):
        """The ``(k, j)`` this pass runs, in order."""
        top = self.lo + self.log_tile - self.chunk - 1  # the tile's highest index bit
        for s in range(self.first_stage, self.last_stage + 1):
            for b in range(min(s - 1, top), self.low_bit - 1, -1):
                yield 1 << s, 1 << b


def _log2(n: int) -> int:
    if n < 2 or n & (n - 1):
        raise ValueError(f"bitonic width must be a power of two, at least 2, got {n}")
    return n.bit_length() - 1


def bitonic_schedule(
    n: int, log_tile: int = LOG_TILE, log_min_chunk: int = LOG_MIN_CHUNK
) -> list[BitonicPass]:
    """The launches of a bitonic network of width ``n``, in order.

    First every tile's own sort (stages up to the tile in one local pass).
    Then, stage by stage, the substeps with ``j >= tile`` in strided passes
    of at most ``log_tile - log_min_chunk`` substeps each (one pass up to
    ``n = 2^(2 * log_tile - log_min_chunk)``), and the rest in a local pass.
    """
    m = _log2(n)
    if not 0 <= log_min_chunk < log_tile:
        raise ValueError(f"bitonic_schedule: chunk 2^{log_min_chunk} and tile 2^{log_tile}")
    passes = [BitonicPass(1, min(m, log_tile), log_tile, log_tile, 0, log_tile)]
    group = log_tile - log_min_chunk
    for s in range(log_tile + 1, m + 1):
        hi = s - 1
        while hi >= log_tile:
            bits = min(group, hi - log_tile + 1)
            lo = hi - bits + 1
            passes.append(BitonicPass(s, s, lo, log_tile - bits, lo, log_tile))
            hi = lo - 1
        passes.append(BitonicPass(s, s, log_tile, log_tile, 0, log_tile))
    return passes


def tile_indices(p: BitonicPass, n: int) -> torch.Tensor:
    """``[blocks, tile]`` int64: the global index of tile element ``l`` of
    each block of pass ``p`` over ``n`` elements; every index once. Mirrors
    `bitonic_pass_kernel`: ``base | (l & (2^c - 1)) | ((l >> c) << lo)``,
    the block index's low bits at ``[c, lo)`` and the others above the
    tile's. A width below the tile is one block of ``n``."""
    tile = min(1 << p.log_tile, n)
    c, span = p.chunk, p.log_tile - p.chunk
    elem = torch.arange(tile, dtype=torch.int64)
    local = (elem & ((1 << c) - 1)) | ((elem >> c) << p.lo)
    b = torch.arange(n // tile, dtype=torch.int64)
    base = ((b & ((1 << (p.lo - c)) - 1)) << c) | ((b >> (p.lo - c)) << (p.lo + span))
    return base[:, None] | local[None, :]


def bitonic_sort_blocked_plain(
    keys: torch.Tensor,
    vals: torch.Tensor,
    log_tile: int = LOG_TILE,
    log_min_chunk: int = LOG_MIN_CHUNK,
):
    """Plain torch version that follows the schedule: every pass gathers its
    tiles by `tile_indices`, runs its substeps on the packed elements inside
    the tiles, the direction from the global index, and scatters them back."""
    n = keys.shape[0]
    bits = pack_pair32(keys, vals) ^ _MIN64  # signed order == the element's unsigned order
    for p in bitonic_schedule(n, log_tile, log_min_chunk):
        idx = tile_indices(p, n).to(bits.device)
        blocks, tile = idx.shape
        elems = bits[idx]
        for k, j in p.substeps():
            b = j.bit_length() - 1
            tj = 1 << (b if b < p.chunk else b - p.lo + p.chunk)  # j as a tile distance
            e = elems.view(blocks, tile // (2 * tj), 2, tj)
            lo_e, hi_e = e[:, :, 0, :], e[:, :, 1, :]
            up = (idx.view(blocks, tile // (2 * tj), 2, tj)[:, :, 0, :] & k) == 0
            swap = (lo_e > hi_e) == up
            elems = torch.stack(
                [torch.where(swap, hi_e, lo_e), torch.where(swap, lo_e, hi_e)], dim=2
            ).reshape(blocks, tile)
        bits = bits.index_put((idx,), elems)
    return unpack_pair32(bits ^ _MIN64)


def launch_passes(
    passes, keys, vals, buf, out_k, out_v, *, pack_first: bool, unpack_last: bool, width=None
):
    """Launch ``passes`` over a network of ``width`` elements (``len(keys)``
    by default), all from one call into the library. The first reads
    ``(keys, vals)`` if ``pack_first``, the last writes ``(out_k, out_v)`` if
    ``unpack_last``; the others, and the elements between passes, use
    ``buf`` (int64 ``[width]``). Where ``keys`` is shorter than ``width`` the
    network's other elements are the largest pair, never written out."""
    flat = [x for p in passes for x in (p.first_stage, p.last_stage, p.lo, p.chunk, p.low_bit)]
    err = build.entry("smj_bitonic_passes")(
        keys.data_ptr(), vals.data_ptr(), buf.data_ptr(), out_k.data_ptr(), out_v.data_ptr(),
        keys.shape[0] if width is None else width, keys.shape[0],
        ctypes.cast((_INT * len(flat))(*flat), _P), len(passes),
        int(pack_first), int(unpack_last), build.stream_ptr(keys),
    )
    build.check(err, f"bitonic_sort, {len(passes)} passes")
    for p in passes:
        build.launched("bitonic_strided" if p.strided else "bitonic_local")


def bitonic_sort_cuda(keys: torch.Tensor, vals: torch.Tensor, width: int | None = None):
    """The network on the card, one launch per pass of `bitonic_schedule`;
    returns new sorted ``(keys, vals)``. With ``width`` (a power of two, at
    least ``len(keys)``) the pairs sort as the first of a network of that
    width whose other elements are the largest pair ``(INT32_MAX,
    INT32_MAX)``: the padding of `sort_pairs`, made inside the first pass
    and dropped by the last."""
    build.require_cuda("bitonic_sort", keys, vals)
    n = keys.shape[0]
    width = n if width is None else width
    if keys.dtype != torch.int32 or vals.dtype != torch.int32:
        raise ValueError(f"bitonic_sort: int32 keys and vals only, got {keys.dtype}, {vals.dtype}")
    if keys.dim() != 1 or vals.shape != keys.shape:
        raise ValueError(
            f"bitonic_sort: keys and vals must be 1D of one length, got "
            f"{tuple(keys.shape)}, {tuple(vals.shape)}"
        )
    if width & (width - 1) or not 2 <= width <= MAX_WIDTH or not 1 <= n <= width:
        raise ValueError(
            f"bitonic_sort: width must be a power of two in [2, 2^30] that holds the "
            f"{n} pairs, got {width}"
        )
    keys, vals = keys.contiguous(), vals.contiguous()
    out_k, out_v = torch.empty_like(keys), torch.empty_like(vals)
    passes = bitonic_schedule(width, LOG_TILE, LOG_MIN_CHUNK)
    buf = torch.empty(width if len(passes) > 1 else 0, dtype=torch.int64, device=keys.device)
    launch_passes(
        passes, keys, vals, buf, out_k, out_v, pack_first=True, unpack_last=True, width=width
    )
    return out_k, out_v


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
    if n:
        build.count(elements=n, passes=len(bitonic_schedule(n2)))
    if devices == {"cuda"}:
        # The kernels pad on the way in and drop the padding on the way out.
        return bitonic_sort_cuda(keys, vals, width=n2) if n else (keys.clone(), vals.clone())
    if n2 != n:
        keys = torch.cat([keys, keys.new_full((n2 - n,), torch.iinfo(keys.dtype).max)])
        vals = torch.cat([vals, vals.new_full((n2 - n,), torch.iinfo(vals.dtype).max)])
    out_k, out_v = bitonic_sort_plain(keys, vals)
    return out_k[:n], out_v[:n]
