"""The 1:1 join-rank scan: CUDA kernels for Hopper.

Replaces the TPU kernels of `pim_sort_merge_join_tpu/ops/pallas/join_scan.py`
(`_forward_kernel`, `_backward_kernel`). From the merge sort's outputs
(``mkeys`` ascending, side 1 first on ties; ``mpos`` the concat position)
it computes each element's 1:1 output slot, or the drop value ``n``, and
the output row count; the result equals `ops/join._merged_dest_plain`,
the plain torch version, exactly. The TPU carried the scan state from
tile to tile in order; CUDA blocks run in no order, so `csrc/join_scan.cu`
chains the blocks through published carries instead.
"""

from __future__ import annotations

import ctypes

import torch

from pim_sort_merge_join_tpu_torch.ops.kernels import build

# Kernel launches by this module's wrappers, for showing which path ran.
LAUNCHES = {"join_scan_forward": 0, "join_scan_backward": 0}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_fns: dict = {}


def _fn(name: str):
    if name not in _fns:
        argtypes = {
            "smj_join_scan_block_size": [],
            "smj_join_scan_forward": [_P, ctypes.c_int, _P, _I64, ctypes.c_int, _P, _P, _P, _P],
            "smj_join_scan_backward": [_P, ctypes.c_int, _P, _P, _I64, _P, _P, _P, _P],
        }[name]
        _fns[name] = build.c_function(name, argtypes)
    return _fns[name]


def _carry_state(n: int, device) -> torch.Tensor:
    """Zeroed chain state of one pass: a ticket counter, then one published
    carry record per block."""
    nblocks = -(-n // _fn("smj_join_scan_block_size")())
    return torch.zeros(8 + 8 * nblocks, dtype=torch.int32, device=device)


def join_scan_forward(mkeys: torch.Tensor, mpos: torch.Tensor, cap1: int):
    """Kernel 3: ``(cand, m2cum)``, int32 ``[n]`` each, for ``n >= 1``."""
    build.require_cuda("join_scan", mkeys, mpos)
    n = mkeys.shape[0]
    if mkeys.dtype not in (torch.int32, torch.int64) or mpos.dtype != torch.int32:
        raise ValueError(
            f"join_scan: keys must be int32/int64 and mpos int32, got "
            f"{mkeys.dtype}, {mpos.dtype}"
        )
    if mkeys.dim() != 1 or mpos.shape != (n,) or not 1 <= n < 2**31:
        raise ValueError(
            f"join_scan: mkeys and mpos must be 1D of one length in [1, 2^31), "
            f"got {tuple(mkeys.shape)}, {tuple(mpos.shape)}"
        )
    cand = torch.empty(n, dtype=torch.int32, device=mkeys.device)
    m2 = torch.empty(n, dtype=torch.int32, device=mkeys.device)
    err = _fn("smj_join_scan_forward")(
        mkeys.data_ptr(), mkeys.element_size(), mpos.data_ptr(), n, cap1,
        cand.data_ptr(), m2.data_ptr(), _carry_state(n, mkeys.device).data_ptr(),
        build.stream_ptr(mkeys),
    )
    build.check(err, "join_scan forward")
    LAUNCHES["join_scan_forward"] += 1
    return cand, m2


def join_scan_backward(mkeys: torch.Tensor, cand: torch.Tensor, m2: torch.Tensor):
    """Kernel 4: ``(dest int32 [n], num_out int32 0-d)`` from the forward pass."""
    build.require_cuda("join_scan", mkeys, cand, m2)
    n = mkeys.shape[0]
    if cand.shape != (n,) or m2.shape != (n,) or n < 1:
        raise ValueError("join_scan: forward outputs must match the keys' length")
    dest = torch.empty(n, dtype=torch.int32, device=mkeys.device)
    num_out = torch.empty((), dtype=torch.int32, device=mkeys.device)
    err = _fn("smj_join_scan_backward")(
        mkeys.data_ptr(), mkeys.element_size(), cand.data_ptr(), m2.data_ptr(), n,
        dest.data_ptr(), num_out.data_ptr(), _carry_state(n, mkeys.device).data_ptr(),
        build.stream_ptr(mkeys),
    )
    build.check(err, "join_scan backward")
    LAUNCHES["join_scan_backward"] += 1
    return dest, num_out


def join_scan_cuda(mkeys: torch.Tensor, mpos: torch.Tensor, cap1: int):
    """(dest int32 [n], num_out int32 0-d) on the card (kernels 3 + 4)."""
    if mkeys.shape[0] == 0:
        empty = torch.empty(0, dtype=torch.int32, device=mkeys.device)
        return empty, torch.zeros((), dtype=torch.int32, device=mkeys.device)
    cand, m2 = join_scan_forward(mkeys, mpos, cap1)
    return join_scan_backward(mkeys, cand, m2)


def join_scan_dest(mkeys: torch.Tensor, mpos: torch.Tensor, cap1: int):
    """(dest, num_out): the kernels for CUDA tensors at every size and key
    width, the plain version for CPU tensors; any other device raises."""
    if mkeys.device.type == "cpu" and mpos.device.type == "cpu":
        from pim_sort_merge_join_tpu_torch.ops.join import _merged_dest_plain

        return _merged_dest_plain(mkeys, mpos, cap1)
    if mkeys.device.type == "cuda":
        return join_scan_cuda(mkeys, mpos, cap1)
    raise ValueError(f"join_scan: unsupported device {mkeys.device}")
