"""Stable multi-operand sort: CUDA kernels for Hopper, and the plain version.

Replaces the TPU kernels of `pim_sort_merge_join_tpu/ops/pallas/hbm_sort.py`
(`_chunk_sort_kernel`, `_merge_path_meta` + `_merge_kernel`). The contract
is the same: the result equals a stable sort of ``operands`` by
``operands[:num_keys]`` (``jax.lax.sort(..., is_stable=True)``).

It is a merge sort (`csrc/hbm_sort.cu`): one block sorts each run of `RUN`
elements, then passes merge neighbouring runs until one is left, and the
last pass unpacks the elements. `element_kind` picks the element from the
operands' types:

- *packed-32*, one 64-bit word: an int32 key in the high half and the
  element's position in the low half. The last pass writes the sorted key
  and the permutation, and one gather kernel applies it to the payloads.
- *pair-32*, one 64-bit word: two int32 keys and no other operand. No
  position and no gather: the last pass writes both sorted keys.
- *wide*, a ``(uint64 key, uint32 position)`` pair: an int64 key (alone, or
  with a second key equal to ``arange(n)``, which is exactly the stable
  sort of the first), or two int32 keys with payloads. The last pass writes
  the permutation and the gather applies it to every operand.

Operands that share no row go through the column gather (`gather`). A sort
whose payload is the rows of a table is `hbm_sort_rows`: kernels 1 and 2 on
the key, then one row gather (`ops/kernels/gather.py`), which reads each
row once and not once per column.

Signed keys are biased to unsigned order (``x ^ sign bit``). Any other
combination raises on CUDA tensors: the callers sort order keys
(`columnar/dtypes.order_key`), which are int32 or int64. What the element
looks like and how many passes a length takes are plain functions here
(`pack_packed32`, `pack_pair32`, `pass_schedule`), which the CPU tests
reach.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pim_sort_merge_join_tpu_torch.ops.kernels import build
from pim_sort_merge_join_tpu_torch.ops.kernels.gather import gather_rows

KIND_PACKED32, KIND_PAIR32, KIND_WIDE_I64, KIND_WIDE_PAIR = 0, 1, 2, 3
WIDE_KINDS = (KIND_WIDE_I64, KIND_WIDE_PAIR)
RUN = 8192  # SMJ_RUN in csrc/hbm_sort.cu: elements per phase-A run
TILE = 4096  # SMJ_TILE: outputs of one merge block

_TAKES = ("the kernels take one int32 or int64 key, two int32 keys, or an int64 key "
          "with arange(n) as its second")
_MIN64 = -(2**63)
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int


def _check_sizes() -> None:
    sizes = tuple(
        build.c_function(f, [])() for f in ("smj_hbm_sort_run_size", "smj_hbm_sort_tile_size")
    )
    if sizes != (RUN, TILE):
        raise RuntimeError(
            f"hbm_sort: the library was built with (RUN, TILE) = {sizes}, "
            f"this module plans for {(RUN, TILE)}"
        )


build.declare(
    {
        "smj_chunk_sort": [_P, _P, _INT, _I64, _P, _P, _P],
        "smj_merge_pass": [_P, _P, _P, _P, _INT, _I64, _I64, _P],
        "smj_merge_pass_final": [_P, _P, _INT, _I64, _I64, _I64, _P, _P, _INT, _P],
        "smj_gather": [_P, _P, _INT, _P, _I64, _P],
    },
    ("hbm_sort_chunk", "hbm_sort_merge", "hbm_sort_gather"),
    _check_sizes,
)


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def hbm_sort_plain(
    operands: tuple[torch.Tensor, ...], num_keys: int = 1
) -> tuple[torch.Tensor, ...]:
    """Plain torch version: one stable `torch.sort` per key, from the last
    key to the first, then a gather of every operand."""
    n = operands[0].shape[0]
    _count_sort(n)
    perm = torch.arange(n, device=operands[0].device)
    for key in reversed(operands[:num_keys]):
        _, order = torch.sort(key[perm], stable=True)
        perm = perm[order]
    return tuple(op[perm] for op in operands)


def element_kind(operands, num_keys: int) -> int:
    """The element the kernels sort for these operands, or raise for what
    they cannot take. Reads only dtypes, the operand count and, for an
    int64 first key with a second key, whether that key is ``arange(n)``."""
    k0 = operands[0]
    if num_keys == 1 and k0.dtype == torch.int32:
        return KIND_PACKED32
    if num_keys == 1 and k0.dtype == torch.int64:
        return KIND_WIDE_I64
    if num_keys == 2:
        k1 = operands[1]
        if k0.dtype == torch.int32 and k1.dtype == torch.int32:
            return KIND_PAIR32 if len(operands) == 2 else KIND_WIDE_PAIR
        if k0.dtype == torch.int64 and k1.dtype in (torch.int32, torch.int64):
            iota = torch.arange(k1.shape[0], dtype=k1.dtype, device=k1.device)
            if torch.equal(k1, iota):
                return KIND_WIDE_I64
            raise ValueError(
                f"hbm_sort: a 2-key sort with an int64 first key needs a second key equal "
                f"to arange(n): {_TAKES}"
            )
    raise ValueError(
        f"hbm_sort: no CUDA kernel for num_keys={num_keys} with key dtypes "
        f"{[o.dtype for o in operands[:num_keys]]}: {_TAKES}"
    )


def pack_packed32(key: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """The packed-32 element as the kernel builds it: the bits of
    ``(key ^ sign bit) << 32 | index`` in an int64 tensor. Read as uint64,
    the elements order by ``(key, index)``."""
    return ((key.long() * 2**32) ^ _MIN64) | index.long()


def unpack_packed32(bits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(key, index)`` as int32, the inverse of `pack_packed32`."""
    key = (bits ^ _MIN64) >> 32
    return key.to(torch.int32), (bits & 0xFFFFFFFF).to(torch.int32)


def pack_pair32(k0: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    """The pair-32 element: both int32 keys biased to unsigned order, the
    first in the high half. Read as uint64, the elements order by
    ``(k0, k1)``."""
    return ((k0.long() * 2**32) ^ _MIN64) | (k1.long() + 2**31)


def unpack_pair32(bits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(k0, k1)`` as int32, the inverse of `pack_pair32`."""
    k0 = (bits ^ _MIN64) >> 32
    return k0.to(torch.int32), ((bits & 0xFFFFFFFF) - 2**31).to(torch.int32)


def sort_elements_plain(bits: torch.Tensor) -> torch.Tensor:
    """Sort 64-bit elements held in an int64 tensor by their unsigned value."""
    return torch.sort(bits ^ _MIN64).values ^ _MIN64


def pass_schedule(n: int) -> tuple[int, list[int]]:
    """``(npad, runs)`` for ``n >= 1`` elements: the padded length, a
    multiple of `RUN`, and the run length each merge pass takes as input.
    There is always a last pass (it unpacks), also for a single run."""
    if not 1 <= n < 2**31:
        raise ValueError(f"hbm_sort: {n} elements, the kernels take 1 to 2^31 - 1")
    npad = -(-n // RUN) * RUN
    runs = [RUN]
    while 2 * runs[-1] < npad:
        runs.append(2 * runs[-1])
    return npad, runs


@functools.lru_cache(maxsize=64)
def _sort_passes(n: int) -> int:
    """The launches of kernels 1 and 2 that sort ``n >= 1`` elements: the
    chunk sort and each merge pass of `pass_schedule`."""
    return 1 + len(pass_schedule(n)[1])


def _count_sort(n: int) -> None:
    """Count a sort of ``n`` elements (`build.count`): ``elements`` and
    `_sort_passes`."""
    if n:
        build.count(elements=n, passes=_sort_passes(n))


def key_operands(operands, kind: int):
    """The two key pointers' tensors for `chunk_sort` (the second is unused
    by the one-key kinds)."""
    if kind in (KIND_PAIR32, KIND_WIDE_PAIR):
        return operands[0], operands[1]
    return operands[0], operands[0]


def chunk_sort(k0: torch.Tensor, k1: torch.Tensor, kind: int):
    """Phase A (kernel 1): the elements of ``kind``, in sorted runs of `RUN`.

    Returns ``(keys, idx)``: the 64-bit words in an int64 tensor and, for a
    wide kind, the int32 positions (else None), padded to a multiple of
    `RUN`.
    """
    build.require_cuda("hbm_sort", k0, k1)
    n = k0.shape[0]
    npad, _ = pass_schedule(n)
    keys = torch.empty(npad, dtype=torch.int64, device=k0.device)
    idx = None
    if kind in WIDE_KINDS:
        idx = torch.empty(npad, dtype=torch.int32, device=k0.device)
    err = build.entry("smj_chunk_sort")(
        k0.data_ptr(), k1.data_ptr(), kind, n, keys.data_ptr(), _ptr(idx), build.stream_ptr(k0),
    )
    build.check(err, "hbm_sort chunk sort")
    build.launched("hbm_sort_chunk")
    return keys, idx


def merge_passes(keys: torch.Tensor, idx: torch.Tensor | None, kind: int, n: int):
    """Phase B (kernel 2): merge the runs pairwise until one is left, and
    unpack its first ``n`` elements in the last pass.

    Ping-pongs between the given buffers and a second pair, so the inputs
    are overwritten. Returns two int32 ``[n]`` tensors ``(first, second)``:
    packed-32 the sorted key and the permutation, pair-32 the two sorted
    keys, wide ``None`` and the permutation.
    """
    wide = kind in WIDE_KINDS
    build.require_cuda("hbm_sort", keys, *((idx,) if wide else ()))
    npad, runs = pass_schedule(n)
    if keys.shape != (npad,) or (wide and idx.shape != (npad,)):
        raise ValueError(f"hbm_sort: {n} elements need run buffers of {npad}")
    dev, stream = keys.device, build.stream_ptr(keys)
    src = (keys, idx if wide else None)
    if len(runs) > 1:
        dst = (torch.empty_like(keys), torch.empty_like(idx) if wide else None)
    for run in runs[:-1]:
        err = build.entry("smj_merge_pass")(
            _ptr(src[0]), _ptr(src[1]), _ptr(dst[0]), _ptr(dst[1]), int(wide), npad, run, stream,
        )
        build.check(err, "hbm_sort merge pass")
        build.launched("hbm_sort_merge")
        src, dst = dst, src
    first = None if wide else torch.empty(n, dtype=torch.int32, device=dev)
    second = torch.empty(n, dtype=torch.int32, device=dev)
    err = build.entry("smj_merge_pass_final")(
        _ptr(src[0]), _ptr(src[1]), int(wide), npad, runs[-1], n, _ptr(first), _ptr(second),
        int(kind == KIND_PAIR32), stream,
    )
    build.check(err, "hbm_sort last merge pass")
    build.launched("hbm_sort_merge")
    return first, second


def sort_elements(k0: torch.Tensor, k1: torch.Tensor, kind: int):
    """Kernels 1 + 2 on the key operand(s): `merge_passes` of `chunk_sort`."""
    _count_sort(k0.shape[0])
    return merge_passes(*chunk_sort(k0, k1, kind), kind, k0.shape[0])


def gather(perm: torch.Tensor, operands: tuple[torch.Tensor, ...]) -> tuple[torch.Tensor, ...]:
    """``out[i] = op[perm[i]]`` for every operand, one launch per operand:
    reading several arrays at random in one launch is slower than one after
    the other (`csrc/hbm_sort.cu`, `gather_kernel`)."""
    build.require_cuda("hbm_sort gather", perm, *operands)
    for op in operands:
        if op.dtype not in (torch.int32, torch.int64) or op.shape != perm.shape:
            raise ValueError(
                f"hbm_sort gather: operands must be int32/int64 of shape "
                f"{tuple(perm.shape)}, got {op.dtype} {tuple(op.shape)}"
            )
    outs = tuple(torch.empty_like(op) for op in operands)
    if perm.shape[0] == 0:
        return outs
    for op, out in zip(operands, outs):
        err = build.entry("smj_gather")(
            op.data_ptr(), out.data_ptr(), op.element_size(), perm.data_ptr(), perm.shape[0],
            build.stream_ptr(perm),
        )
        build.check(err, "hbm_sort gather")
        build.launched("hbm_sort_gather")
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
    kind = element_kind(operands, num_keys)
    if n == 0:
        return operands
    first, second = sort_elements(*key_operands(operands, kind), kind)
    if kind == KIND_PAIR32:
        return first, second
    if kind == KIND_PACKED32:
        return (first,) + (gather(second, operands[1:]) if len(operands) > 1 else ())
    return gather(second, operands)


def sort_permutation(key: torch.Tensor) -> torch.Tensor:
    """The stable sorting permutation of a 1D int32/int64 ``key``, int32:
    kernels 1 and 2 on a CUDA tensor, `hbm_sort_plain` on a CPU tensor."""
    n = key.shape[0]
    if key.shape != (n,):
        raise ValueError(f"hbm_sort: a 1D key, got {tuple(key.shape)}")
    if key.device.type == "cpu":
        return hbm_sort_plain((key, torch.arange(n, dtype=torch.int32)))[1]
    if key.device.type != "cuda":
        raise ValueError(f"hbm_sort: unsupported device {key.device}")
    kind = element_kind((key,), 1)
    if n == 0:
        return torch.empty(0, dtype=torch.int32, device=key.device)
    return sort_elements(key, key, kind)[1]


def sort_key_permutation(key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(sorted key, stable permutation int32)`` of a 1D int32/int64 key.

    On a CUDA tensor kernels 1 and 2 sort it; an int32 key leaves the last
    pass sorted (packed-32), an int64 key is taken by the permutation in one
    column-gather launch. On a CPU tensor `hbm_sort_plain`.
    """
    if key.device.type == "cpu":
        perm = sort_permutation(key)
        return key[perm.long()], perm
    if key.device.type != "cuda":
        raise ValueError(f"hbm_sort: unsupported device {key.device}")
    kind = element_kind((key,), 1)
    if key.shape[0] == 0:
        return key, torch.empty(0, dtype=torch.int32, device=key.device)
    first, perm = sort_elements(key, key, kind)
    return (gather(perm, (key,))[0] if first is None else first), perm


def hbm_sort_rows(parts, *, out=None, live=None) -> torch.Tensor:
    """Tables' rows in the stable order of their keys, side by side.

    ``parts`` holds ``(key, rows, cols)`` tuples: a 1D int32/int64 key,
    a row-major table of as many rows and its kept columns (all if None).
    Returns ``out`` with ``out[i, c + q] = rows[perm[i], cols[q]]`` for each
    part, ``perm`` the stable sorting permutation of its key and ``c`` its
    window's first column; ``out`` and ``live`` are `gather_rows`'s. CUDA tensors run kernels 1 and 2 on each key and one row
    gather for all parts; CPU tensors the plain versions.
    """
    gathers = []
    for key, rows, *cols in parts:
        if rows.dim() != 2 or rows.shape[0] != key.shape[0] or rows.device != key.device:
            raise ValueError(
                f"hbm_sort_rows: a key and a table of as many rows on one device, got "
                f"{tuple(key.shape)} on {key.device} and {tuple(rows.shape)} on {rows.device}"
            )
        gathers.append((rows, sort_permutation(key), *cols))
    return gather_rows(gathers, out=out, live=live)
