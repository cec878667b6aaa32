"""The group operations of the multi-device engine, and the one place where
the backend is read.

The engine's ranks talk through a handful of operations: `all_to_all` of a
``[P, ...]`` block (``dist.all_to_all_single``), `all_gather`
(``dist.all_gather_into_tensor``), `all_reduce` with MIN or MAX,
`broadcast_object` (``dist.broadcast_object_list``) and `barrier`. The
backend is the group's, read from ``dist.get_backend(group)``:

- NCCL (ranks on distinct cards): device tensors;
- Gloo (the simulator and the tests): CPU tensors;
- Gloo (several ranks sharing one card): CUDA tensors, which Gloo stages
  through host memory itself (`tools/collective_probe.py` times it).

Every backend takes the tensor as it is.

Tensors travel as the bits of their width (`columnar/dtypes.bits`): Gloo
has no unsigned 64-bit type. Without an initialized process group the
process is a world of one rank and every operation is the identity; a
group of one rank still calls its backend.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from pim_sort_merge_join_tpu_torch.columnar import dtypes

_REDUCE_OPS = {"min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size(group=None) -> int:
    return dist.get_world_size(group) if initialized() else 1


def rank(group=None) -> int:
    return dist.get_rank(group) if initialized() else 0


def backend(group=None) -> str | None:
    return dist.get_backend(group) if initialized() else None


def default_group():
    """The default process group, or None when there is none (one rank)."""
    return dist.group.WORLD if initialized() else None


def _signed(t: torch.Tensor) -> torch.Tensor:
    return dtypes.bits(t).contiguous()


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """``out[i] = x_i[me]``: block j of this rank's ``[P, ...]`` tensor goes
    to rank j, and block i of the result came from rank i."""
    if not initialized():
        return x.clone()
    b = _signed(x)
    out = torch.empty_like(b)
    dist.all_to_all_single(out, b, group=group)
    return dtypes.from_bits(out, x.dtype)


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """``[P, *x.shape]``: every rank's ``x`` in rank order, on every rank."""
    if not initialized():
        return x.unsqueeze(0).clone()
    # The backends gather along dim 0: [P * n, ...], viewed as [P, n, ...].
    b = _signed(x).reshape((-1,) + tuple(x.shape[1:]))
    p = world_size(group)
    shape = (p * b.shape[0],) + tuple(b.shape[1:])
    out = torch.empty(shape, dtype=b.dtype, device=b.device)
    dist.all_gather_into_tensor(out, b, group=group)
    return dtypes.from_bits(out.reshape((p,) + tuple(x.shape)), x.dtype)


def gather_numpy(x: torch.Tensor, group=None) -> np.ndarray:
    """`all_gather` read back: the same ``[P, ...]`` host array on every rank,
    so every rank takes the same decision from it."""
    return all_gather(x, group).cpu().numpy()


def all_reduce(x: torch.Tensor, op: str, group=None) -> torch.Tensor:
    """The elementwise ``op`` ("min" or "max") of every rank's signed
    integer ``x``, on every rank."""
    if not initialized():
        return x.clone()
    out = x.clone()
    dist.all_reduce(out, op=_REDUCE_OPS[op], group=group)
    return out


def broadcast_object(obj, group=None, src: int = 0):
    """Rank ``src``'s ``obj`` (picklable) on every rank."""
    if not initialized():
        return obj
    box = [obj]
    device = None
    if backend(group) == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    dist.broadcast_object_list(box, src=src, group=group, device=device)
    return box[0]


def barrier(group=None) -> None:
    if not initialized():
        return
    if backend(group) == "nccl":
        dist.barrier(group=group, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group=group)
