"""LSD radix sorts: the CUDA kernels for Hopper, and the plain versions.

Both functions of `pim_sort_merge_join_tpu/ops/pallas/radix_sort.py`:

- `radix_tile_sort` replaces the TPU kernel `_radix_tile_kernel`, the
  run-formation experiment of `bench/radix_bench.py`: every ``tile``
  elements of the int32 operands are sorted stably by ``operands[0]``, one
  ``digit_bits`` digit per pass for ``ceil(key_bits / digit_bits)`` passes,
  least significant first. The output tiles are sorted runs, the contract
  of `hbm_sort.chunk_sort` at ``chunk = tile``.
- `xla_lsd_radix_sort` is the reference's global sort, a whole-array stable
  counting sort per digit. There it is plain XLA whose scatter the TPU
  serializes; here CUDA tensors run it as kernels of the port's own (one
  histogram launch, one launch per digit with a decoupled look-back over
  the tiles).

The digit is ``(key >> shift) & (2^digit_bits - 1)``, so keys order by
their low bits read as unsigned: with ``key_bits=32`` a negative key sorts
after the non-negative ones, as on the TPU.

The TPU had no vector scatter and permuted each tile through one-hot
matmuls; `csrc/radix_sort.cu` ranks a tile's digits warp by warp and
scatters through shared memory. What the kernels plan is plain Python here,
which the CPU tests reach: the block that sorts a tile (`tile_config`), its
shared memory, the rule by which a pass is skipped (`digit_is_constant`),
the ranking itself (`tile_rank_plain`, `radix_tile_sort_blocked_plain`) and
the global sort's fold over the tiles (`lsd_radix_blocked_plain`).
"""

from __future__ import annotations

import ctypes
import math

import torch

from pim_sort_merge_join_tpu_torch.ops.kernels import build

MAX_OPS = 8  # SMJ_RADIX_MAX_OPS in csrc/radix_sort.cu
MAX_SMEM = 232448  # SMJ_RADIX_MAX_SMEM: the H100's shared memory per block
# SMJ_RADIX_CONFIGS: (largest tile, threads, items per thread) of the tile
# kernel's blocks; a tile takes the first that holds it.
TILE_CONFIGS = (
    (512, 64, 8),
    (1024, 64, 16),
    (2048, 128, 16),
    (4096, 256, 16),
    (8192, 512, 16),
    (16384, 1024, 16),
)
LSD_THREADS = 512  # SMJ_LSD_THREADS: the global sort's block
LSD_ITEMS = 16  # SMJ_LSD_ITEMS: elements per thread; a tile is their product
LSD_HEADER = 32  # SMJ_LSD_HEADER: state words before the histograms
LSD_HIST_MAX_SMEM = 49152  # SMJ_LSD_HIST_MAX_SMEM: the histogram kernel's counters
LSD_MAX_N = 1 << 30  # a look-back record keeps its status in the top two bits

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int


def _check_library() -> None:
    """Refuse a library whose compile-time shapes differ from this module's."""
    def call(name, *args, argtypes=(), restype=ctypes.c_int):
        fn = build.c_function(name, list(argtypes))
        fn.restype = restype
        return fn(*args)

    built = (
        call("smj_radix_max_ops"), call("smj_radix_max_smem", restype=_I64),
        tuple((cap, call("smj_radix_tile_threads", cap, argtypes=[_INT]),
               call("smj_radix_tile_items", cap, argtypes=[_INT])) for cap, _, _ in TILE_CONFIGS),
        call("smj_radix_tile_threads", TILE_CONFIGS[-1][0] + 1, argtypes=[_INT]),
        call("smj_lsd_threads"), call("smj_lsd_items"),
    )
    planned = (MAX_OPS, MAX_SMEM, TILE_CONFIGS, 0, LSD_THREADS, LSD_ITEMS)
    if built != planned:
        raise RuntimeError(
            f"radix_sort: the library was built with (max operands, shared memory, tile "
            f"blocks, threads past the largest tile, global sort threads and items) = {built}, "
            f"this module plans for {planned}"
        )
    tile = TILE_CONFIGS[-1][0]
    sizes = (
        call("smj_radix_smem_bytes", tile, 8, argtypes=[_I64, _INT], restype=_I64),
        call("smj_lsd_smem_bytes", 8, argtypes=[_INT], restype=_I64),
        call("smj_lsd_state_words", 10**7, 8, 4, argtypes=[_I64, _INT, _INT], restype=_I64),
    )
    planned = (tile_smem_bytes(tile, 8), lsd_smem_bytes(8), lsd_state_words(10**7, 8, 4))
    if sizes != planned:
        raise RuntimeError(
            f"radix_sort: the library sizes (a tile's shared memory, the global sort's, its "
            f"state words) as {sizes}, this module as {planned}"
        )


build.declare(
    {
        "smj_radix_tile_sort": [_P, _P, _INT, _I64, _INT, _INT, _INT, _P],
        "smj_lsd_radix_sort": [_P, _P, _P, _P, _P, _P, _P, _I64, _INT, _INT, _INT, _INT, _P],
    },
    ("radix_tile", "lsd_radix_histogram", "lsd_radix_scan", "lsd_radix_pass"),
    _check_library,
)


def _num_passes(digit_bits: int, key_bits: int) -> int:
    if not 1 <= digit_bits <= 16 or not 1 <= key_bits <= 32:
        raise ValueError(
            f"radix sort: digit_bits must be in [1, 16] and key_bits in [1, 32], "
            f"got {digit_bits}, {key_bits}"
        )
    return math.ceil(key_bits / digit_bits)


def _check_operands(operands, tile: int | None, name: str = "radix_tile_sort") -> int:
    n = operands[0].shape[0]
    for op in operands:
        if op.dtype != torch.int32 or op.shape != (n,):
            raise ValueError(
                f"{name}: operands must be 1D int32 of one length, got "
                f"{[(o.dtype, tuple(o.shape)) for o in operands]}"
            )
    if tile is not None and (tile < 1 or n % tile != 0):
        raise ValueError(f"n={n} must be a multiple of tile={tile}")
    return n


# --- what the kernels plan, as plain functions -------------------------------------


def tile_config(tile: int) -> tuple[int, int]:
    """``(threads, items per thread)`` of the block that sorts a tile."""
    for cap, threads, items in TILE_CONFIGS:
        if tile <= cap:
            return threads, items
    raise ValueError(
        f"radix_tile_sort: tile={tile} is more than a block's shared memory and registers "
        f"hold (at most {TILE_CONFIGS[-1][0]})"
    )


def tile_smem_bytes(tile: int, digit_bits: int) -> int:
    """The tile kernel's shared memory: the 8-byte elements, every warp's
    digit counts, the tile's histogram and its scan, the keys' OR and AND."""
    threads, _ = tile_config(tile)
    return tile * 8 + ((threads // 32 + 2) << digit_bits) * 4 + 16


def lsd_smem_bytes(digit_bits: int) -> int:
    """The global sort's pass kernel: as the tile kernel's at its own tile,
    and where each digit's run goes."""
    return LSD_THREADS * LSD_ITEMS * 8 + ((LSD_THREADS // 32 + 3) << digit_bits) * 4


def lsd_state_words(n: int, digit_bits: int, npass: int, tile: int | None = None) -> int:
    """Zeroed int32 words of one global sort: a ticket per pass, the passes'
    histograms, and one look-back record per pass, tile and digit."""
    tile = LSD_THREADS * LSD_ITEMS if tile is None else tile
    return LSD_HEADER + (npass << digit_bits) * (1 + -(-n // tile))


def digit_is_constant(or_bits: int, and_bits: int, shift: int, digit_bits: int) -> bool:
    """The rule by which the tile kernel skips a pass: given the OR and the
    AND of a tile's keys (as int32 values), whether every key has the same
    digit at ``shift``. A stable pass over one digit is the identity."""
    differ = (or_bits ^ and_bits) & 0xFFFFFFFF
    return (differ >> shift) & ((1 << digit_bits) - 1) == 0


def tile_rank_plain(digit: torch.Tensor, threads: int, items: int, v: int) -> torch.Tensor:
    """Each element's place in its tile ordered stably by digit, computed as
    `rank_tile` of the kernel computes it: element ``e`` is item
    ``e % (32 * items) // 32`` of lane ``e % 32`` of warp ``e // (32 * items)``;
    a warp walks its items in order, the lanes of one digit share the warp's
    running count; then the warps' prefixes per digit and the digits' scan."""
    count = digit.shape[0]
    warps = threads // 32
    if count > threads * items:
        raise ValueError(f"{count} elements, the block holds {threads * items}")
    digits = digit.tolist()
    wc = [[0] * v for _ in range(warps)]
    in_warp = [0] * count
    for w in range(warps):
        for i in range(items):
            lo = (w * items + i) * 32
            group: dict = {}
            for e in range(lo, min(lo + 32, count)):
                d = digits[e]
                in_warp[e] = wc[w][d] + group.get(d, 0)  # the leader's read + lower peers
                group[d] = group.get(d, 0) + 1
            for d, c in group.items():
                wc[w][d] += c
    tot = [0] * v
    for d in range(v):
        for w in range(warps):
            wc[w][d], tot[d] = tot[d], tot[d] + wc[w][d]
    base, run = [0] * v, 0
    for d in range(v):
        base[d], run = run, run + tot[d]
    place = [base[d] + wc[e // (32 * items)][d] + in_warp[e] for e, d in enumerate(digits)]
    return torch.tensor(place, dtype=torch.int64)


def radix_tile_sort_blocked_plain(
    operands: tuple[torch.Tensor, ...], *, tile: int = 512, digit_bits: int = 8,
    key_bits: int = 32,
) -> tuple[torch.Tensor, ...]:
    """`radix_tile_sort` with the kernel's dataflow in plain Python: per tile
    the block of `tile_config`, the (key, second word) element, the passes
    that `digit_is_constant` skips, `tile_rank_plain` and a scatter, and the
    payloads by the position in the tile when there is more than one."""
    n = _check_operands(operands, tile)
    npass = _num_passes(digit_bits, key_bits)
    threads, items = tile_config(tile)
    v = 1 << digit_bits
    carry = len(operands) == 2
    outs = [torch.empty_like(op) for op in operands]
    for lo in range(0, n, tile):
        key = operands[0][lo:lo + tile].clone()
        second = operands[1][lo:lo + tile].clone() if carry else torch.arange(tile, dtype=torch.int32)
        or_bits = and_bits = int(key[0])
        for k in key.tolist():
            or_bits, and_bits = or_bits | k, and_bits & k
        for p in range(npass):
            shift = p * digit_bits
            if digit_is_constant(or_bits, and_bits, shift, digit_bits):
                continue
            place = tile_rank_plain((key >> shift) & (v - 1), threads, items, v)
            key = torch.empty_like(key).index_copy_(0, place, key)
            second = torch.empty_like(second).index_copy_(0, place, second)
        outs[0][lo:lo + tile] = key
        if carry:
            outs[1][lo:lo + tile] = second
        else:
            for op, out in zip(operands[1:], outs[1:]):
                out[lo:lo + tile] = op[lo:lo + tile][second.long()]
    return tuple(outs)


def lsd_radix_blocked_plain(
    operands: tuple[torch.Tensor, ...], *, tile: int, digit_bits: int = 8, key_bits: int = 32,
) -> tuple[torch.Tensor, ...]:
    """`xla_lsd_radix_sort` with the kernels' dataflow at any tile size:
    every pass's histogram from one read of the key, its exclusive scan, and
    per pass the tiles in ticket order: the tile's histogram, each digit's
    count over the earlier tiles (the look-back's fold), the stable rank
    inside the tile, and the scatter to ``base[digit] + before[digit] +
    rank``. More than one payload rides as the element's index and is
    gathered at the end."""
    n = _check_operands(operands, None, "xla_lsd_radix_sort")
    npass = _num_passes(digit_bits, key_bits)
    if tile < 1:
        raise ValueError(f"tile={tile} must be positive")
    v = 1 << digit_bits
    key = operands[0]
    gen_pos = len(operands) > 2
    second = (torch.arange(n, dtype=torch.int32) if gen_pos or len(operands) == 1
              else operands[1])
    hists = [torch.bincount((key >> (p * digit_bits)) & (v - 1), minlength=v) for p in range(npass)]
    for p in range(npass):
        digit_base = torch.cumsum(hists[p], 0) - hists[p]
        before = torch.zeros(v, dtype=torch.int64)  # what a tile's look-back adds up
        out_key, out_second = torch.empty_like(key), torch.empty_like(second)
        for lo in range(0, n, tile):
            k, s = key[lo:lo + tile], second[lo:lo + tile]
            digit = ((k >> (p * digit_bits)) & (v - 1)).long()
            tot = torch.bincount(digit, minlength=v)
            base = torch.cumsum(tot, 0) - tot
            order = torch.sort(digit, stable=True).indices  # the tile in digit order
            sorted_digit = digit[order]
            first_out = digit_base + before - base
            dest = first_out[sorted_digit] + torch.arange(k.shape[0])
            out_key[dest] = k[order]
            out_second[dest] = s[order]
            before = before + tot
        key, second = out_key, out_second
    if len(operands) == 1:
        return (key,)
    if gen_pos:
        return (key,) + tuple(op[second.long()] for op in operands[1:])
    return key, second


# --- the tile sort --------------------------------------------------------------------


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
    if len(operands) > MAX_OPS:
        raise ValueError(f"radix_tile_sort: at most {MAX_OPS} operands, got {len(operands)}")
    smem = tile_smem_bytes(tile, digit_bits)
    if smem > MAX_SMEM:
        raise ValueError(
            f"radix_tile_sort: tile={tile} with digit_bits={digit_bits} needs {smem} "
            f"bytes of shared memory, more than a block's {MAX_SMEM}"
        )
    outs = tuple(torch.empty_like(op) for op in operands)
    k = len(operands)
    srcs = (ctypes.c_void_p * k)(*(op.data_ptr() for op in operands))
    dsts = (ctypes.c_void_p * k)(*(o.data_ptr() for o in outs))
    err = build.entry("smj_radix_tile_sort")(
        ctypes.cast(srcs, _P), ctypes.cast(dsts, _P), k, n, tile, digit_bits, npass,
        build.stream_ptr(operands[0]),
    )
    build.check(err, "radix_tile_sort")
    build.launched("radix_tile")
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


# --- the global sort ------------------------------------------------------------------


def xla_lsd_radix_sort_plain(
    operands: tuple[torch.Tensor, ...], *, digit_bits: int = 8, key_bits: int = 32,
) -> tuple[torch.Tensor, ...]:
    """Global LSD radix sort as plain torch (the reference's XLA route).

    Per pass a whole-array stable counting sort: the digits' one-hot prefix
    sums give each element its rank among equal digits, the histogram's
    exclusive prefix the digits' bases, and a scatter applies the result.
    The ``[n, 2^digit_bits]`` one-hot bounds the size it can hold.
    """
    if operands[0].dtype != torch.int32:
        raise ValueError("xla_lsd_radix_sort: int32 keys only")
    v = 1 << digit_bits
    ops = tuple(operands)
    for p in range(_num_passes(digit_bits, key_bits)):
        digit = ((ops[0] >> (p * digit_bits)) & (v - 1)).long()
        pre = torch.cumsum(torch.nn.functional.one_hot(digit, v), dim=0)
        hist = pre[-1] if pre.shape[0] else pre.sum(0)
        base = torch.cumsum(hist, 0) - hist
        rank = pre.gather(1, digit[:, None])[:, 0] - 1
        dest = base[digit] + rank
        ops = tuple(torch.zeros_like(x).index_copy_(0, dest, x) for x in ops)
    return ops


def xla_lsd_radix_sort_cuda(
    operands: tuple[torch.Tensor, ...], *, digit_bits: int = 8, key_bits: int = 32,
) -> tuple[torch.Tensor, ...]:
    """The kernels: a histogram of every digit, its scan, one launch per
    pass, all from one call into the library and with no readback between
    them. One payload travels with its key; more travel as the element's
    index and are gathered once at the end (`hbm_sort.gather`)."""
    from pim_sort_merge_join_tpu_torch.ops.kernels.hbm_sort import gather

    build.require_cuda("xla_lsd_radix_sort", *operands)
    n = _check_operands(operands, None, "xla_lsd_radix_sort")
    npass = _num_passes(digit_bits, key_bits)
    if len(operands) > MAX_OPS:
        raise ValueError(f"xla_lsd_radix_sort: at most {MAX_OPS} operands, got {len(operands)}")
    if n >= LSD_MAX_N:
        raise ValueError(f"xla_lsd_radix_sort: {n} elements, the kernels take fewer than 2^30")
    smem, counters = lsd_smem_bytes(digit_bits), (npass << digit_bits) * 4
    if smem > MAX_SMEM or counters > LSD_HIST_MAX_SMEM or npass > LSD_HEADER:
        raise ValueError(
            f"xla_lsd_radix_sort: digit_bits={digit_bits} with {npass} passes needs {smem} bytes "
            f"of shared memory per block (at most {MAX_SMEM}) and {counters} for the "
            f"histogram's counters (at most {LSD_HIST_MAX_SMEM})"
        )
    key, dev = operands[0], operands[0].device
    if n == 0:
        return tuple(torch.empty_like(op) for op in operands)
    has_val, gen_pos = len(operands) > 1, len(operands) > 2
    out_key = torch.empty_like(key)
    out_val = torch.empty_like(key) if has_val else None
    tmp = torch.empty((min(npass - 1, 2), n), dtype=torch.int64 if has_val else torch.int32,
                      device=dev)
    state = torch.zeros(lsd_state_words(n, digit_bits, npass), dtype=torch.int32, device=dev)
    err = build.entry("smj_lsd_radix_sort")(
        key.data_ptr(), operands[1].data_ptr() if has_val and not gen_pos else None,
        out_key.data_ptr(), None if out_val is None else out_val.data_ptr(),
        tmp[0].data_ptr() if npass > 1 else None, tmp[1].data_ptr() if npass > 2 else None,
        state.data_ptr(), n, digit_bits, npass, int(has_val), int(gen_pos), build.stream_ptr(key),
    )
    build.check(err, "xla_lsd_radix_sort")
    build.launched("lsd_radix_histogram")
    build.launched("lsd_radix_scan")
    build.launched("lsd_radix_pass", npass)
    if not has_val:
        return (out_key,)
    if gen_pos:
        return (out_key,) + gather(out_val, operands[1:])
    return out_key, out_val


def xla_lsd_radix_sort(
    operands: tuple[torch.Tensor, ...], *, digit_bits: int = 8, key_bits: int = 32,
) -> tuple[torch.Tensor, ...]:
    """Stable sort of the int32 operands by the low ``key_bits`` bits of
    ``operands[0]``, one whole-array counting sort per digit.

    The kernels for CUDA tensors, the plain version for CPU tensors; any
    other device raises.
    """
    operands = tuple(operands)
    if operands[0].dtype != torch.int32:
        raise ValueError("xla_lsd_radix_sort: int32 keys only")
    devices = {o.device.type for o in operands}
    kw = dict(digit_bits=digit_bits, key_bits=key_bits)
    if devices == {"cpu"}:
        return xla_lsd_radix_sort_plain(operands, **kw)
    if devices == {"cuda"}:
        return xla_lsd_radix_sort_cuda(operands, **kw)
    raise ValueError(f"xla_lsd_radix_sort: unsupported devices {sorted(devices)}")
