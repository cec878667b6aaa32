"""The 1:1 join-rank scan: CUDA kernels for Hopper.

Replaces the TPU kernels of `pim_sort_merge_join_tpu/ops/pallas/join_scan.py`
(`_forward_kernel`, `_backward_kernel`). From the merge sort's outputs
(``mkeys`` ascending, side 1 first on ties; ``mpos`` the concat position)
it computes each element's 1:1 output slot, or the drop value ``n``, and
the output row count; the result equals `_merged_dest_plain`, the plain
torch version, exactly. `join_scan_forward_plain` and
`join_scan_backward_plain` are that function's two halves, one per kernel.
All three, and the inner join's `ops/join._match_info_keys`, read the
merged sequence's equal-key runs from one helper, `merged_runs`.

The TPU carried the scan state from tile to tile in order. CUDA blocks run
in no order, so `csrc/join_scan.cu` makes each pass a single-pass scan with
a decoupled look-back: a block publishes a summary of its own elements
without waiting, combines the summaries of the blocks before it until it
meets one that is already a whole prefix, and publishes its own prefix.
That needs a carry that is associative. `segment_summary` and `combine`
are that carry in plain Python, and `join_scan_blocked_plain` walks the
kernels' dataflow block by block (per-block summaries, an exclusive fold,
per-block local work) at any block size, so the CPU tests reach it.

`place_sources` (kernel ``join_scan_place_kernel``, replacing the sorts of
steps 2 and 3 of the JAX package's `ops/join._one_to_one_merged`) turns the
scan's slots into each output slot's source rows in one pass over the
merged elements; `place_sources_plain` is its plain version.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from pim_sort_merge_join_tpu_torch.columnar.dtypes import key_sentinel
from pim_sort_merge_join_tpu_torch.ops.kernels import build

_P = ctypes.c_void_p
_I64 = ctypes.c_int64

build.declare(
    {
        "smj_join_scan_block_size": [],
        "smj_join_scan_forward": [_P, ctypes.c_int, _P, _I64, ctypes.c_int, _P, _P, _P, _P],
        "smj_join_scan_backward": [_P, ctypes.c_int, _P, _P, _I64, _P, _P, _P, _P],
        "smj_join_scan_place": [_P, _P, _I64, ctypes.c_int, ctypes.c_int, _P, _P, _P],
    },
    ("join_scan_forward", "join_scan_backward", "join_scan_place"),
)


def block_size() -> int:
    """Elements per CUDA block, compile-time in `csrc/join_scan.cu`."""
    return build.entry("smj_join_scan_block_size")()


def _carry_state(n: int, device, words_per_block: int) -> torch.Tensor:
    """Zeroed look-back state of one pass: a ticket counter in a 16-byte
    header, then one published record per block."""
    nblocks = -(-n // block_size())
    return torch.zeros(4 + words_per_block * nblocks, dtype=torch.int32, device=device)


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
    err = build.entry("smj_join_scan_forward")(
        mkeys.data_ptr(), mkeys.element_size(), mpos.data_ptr(), n, cap1,
        cand.data_ptr(), m2.data_ptr(), _carry_state(n, mkeys.device, 4).data_ptr(),
        build.stream_ptr(mkeys),
    )
    build.check(err, "join_scan forward")
    build.launched("join_scan_forward")
    return cand, m2


def join_scan_backward(mkeys: torch.Tensor, cand: torch.Tensor, m2: torch.Tensor):
    """Kernel 4: ``(dest int32 [n], num_out int32 0-d)`` from the forward pass."""
    build.require_cuda("join_scan", mkeys, cand, m2)
    n = mkeys.shape[0]
    if cand.shape != (n,) or m2.shape != (n,) or n < 1:
        raise ValueError("join_scan: forward outputs must match the keys' length")
    dest = torch.empty(n, dtype=torch.int32, device=mkeys.device)
    num_out = torch.empty((), dtype=torch.int32, device=mkeys.device)
    err = build.entry("smj_join_scan_backward")(
        mkeys.data_ptr(), mkeys.element_size(), cand.data_ptr(), m2.data_ptr(), n,
        dest.data_ptr(), num_out.data_ptr(), _carry_state(n, mkeys.device, 2).data_ptr(),
        build.stream_ptr(mkeys),
    )
    build.check(err, "join_scan backward")
    build.launched("join_scan_backward")
    return dest, num_out


def place_sources(dest: torch.Tensor, mpos: torch.Tensor, cap1: int, out_rows: int):
    """Each output slot's source rows: ``(src1, src2)``, int32 ``[out_rows]``.

    For every merged element ``i`` with ``dest[i] < out_rows`` (a matched
    one: the others carry the drop value ``n``), ``src1[dest[i]] =
    mpos[i]`` on side 1 (``mpos[i] < cap1``) and ``src2[dest[i]] = mpos[i]
    - cap1`` on side 2. The matched slots of each side are ``0 ..
    num_out-1``; the slots from ``num_out`` on are left unwritten. CUDA
    tensors launch the kernel, CPU tensors take `place_sources_plain`.
    """
    if dest.device.type == "cpu" and mpos.device.type == "cpu":
        return place_sources_plain(dest, mpos, cap1, out_rows)
    build.require_cuda("join_scan_place", dest, mpos)
    n = dest.shape[0]
    if dest.dtype != torch.int32 or mpos.dtype != torch.int32:
        raise ValueError(f"join_scan_place: dest and mpos must be int32, got {dest.dtype}, {mpos.dtype}")
    if dest.dim() != 1 or mpos.shape != (n,) or n >= 2**31 or not 0 <= out_rows < 2**31:
        raise ValueError(
            f"join_scan_place: dest and mpos must be 1D of one length below 2^31, got "
            f"{tuple(dest.shape)}, {tuple(mpos.shape)}, out_rows {out_rows}"
        )
    src1 = torch.empty(out_rows, dtype=torch.int32, device=dest.device)
    src2 = torch.empty(out_rows, dtype=torch.int32, device=dest.device)
    if n == 0:
        return src1, src2
    err = build.entry("smj_join_scan_place")(
        dest.data_ptr(), mpos.data_ptr(), n, cap1, out_rows, src1.data_ptr(), src2.data_ptr(),
        build.stream_ptr(dest),
    )
    build.check(err, "join_scan place")
    build.launched("join_scan_place")
    return src1, src2


# --- the plain versions, one per kernel ---------------------------------------


def place_sources_plain(dest: torch.Tensor, mpos: torch.Tensor, cap1: int, out_rows: int):
    """`place_sources` as a masked `index_put_` per side (any device)."""
    src1 = torch.empty(out_rows, dtype=torch.int32, device=dest.device)
    src2 = torch.empty(out_rows, dtype=torch.int32, device=dest.device)
    placed = dest < out_rows
    side1 = mpos < cap1
    for src, side, shift in ((src1, placed & side1, 0), (src2, placed & ~side1, cap1)):
        src.index_put_((dest[side].long(),), mpos[side] - shift)
    return src1, src2


# The run broadcasts below replace the reference's running max / reverse
# running min (``lax.cummax``/``cummin``), which equal them where ``vals``
# is non-decreasing, as at every call here. An element's run id is the
# count of run heads up to it, minus one; a gather of the heads' (tails')
# values by run id is exact for any ``vals``. On an H100 torch's CUDA
# ``cummax`` takes 54.7 ms over 20M int32 elements and this form 0.65 ms
# (PERF.md, "Where the time goes"). ``head[0]`` must be set.


def head_broadcast(head: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Broadcast each run head's value over its run."""
    if vals.shape[0] == 0:
        return vals
    return vals[head][torch.cumsum(head, 0) - 1]


def _tail_broadcast(head: torch.Tensor, tail: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Broadcast each run tail's value back over its run."""
    if vals.shape[0] == 0:
        return vals
    return vals[tail][torch.cumsum(head, 0) - 1]


class Runs(NamedTuple):
    """The equal-key runs of a merged sequence, per element; within a run
    every side-1 element precedes every side-2 element."""

    is2: torch.Tensor  # int32: 1 on side 2 (``mpos >= cap1``)
    head: torch.Tensor  # bool: first of its run
    tail: torch.Tensor  # bool: last of its run
    iota: torch.Tensor  # int32: the element's index
    c2: torch.Tensor  # int32: side-2 elements up to here, this one included
    run_start: torch.Tensor  # int32: index of the run's first element
    base2: torch.Tensor  # int32: side-2 elements before the run
    live: torch.Tensor  # bool: the key is no sentinel

    def end2(self) -> torch.Tensor:
        """Side-2 elements up to the run's end: the one backward broadcast."""
        return _tail_broadcast(self.head, self.tail, self.c2)


def merged_runs(mkeys: torch.Tensor, mpos: torch.Tensor, cap1: int) -> Runs:
    """`Runs` of the merged keys ``mkeys`` (ascending, side 1 first on
    ties) whose concat positions are ``mpos``, as plain torch (any device)."""
    n = mkeys.shape[0]
    dev = mkeys.device
    is2 = (mpos >= cap1).to(torch.int32)
    one = torch.ones(1, dtype=torch.bool, device=dev)
    neq = mkeys[1:] != mkeys[:-1]
    head = torch.cat([one, neq])
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    c2 = torch.cumsum(is2, 0, dtype=torch.int32)
    return Runs(
        is2=is2, head=head, tail=torch.cat([neq, one]), iota=iota, c2=c2,
        run_start=head_broadcast(head, iota), base2=head_broadcast(head, c2 - is2),
        live=mkeys != key_sentinel(mkeys.dtype),
    )


def _forward_matches(r: Runs):
    """``(rank, matched2, m2cum)``: each element's rank in its side of the
    run, whether a side-2 element is matched (its rank is below the run's
    side-1 count so far), and the running count of matched side-2
    elements. Both scans are forward."""
    jr = r.iota - r.run_start
    s2r = r.c2 - r.base2
    rank = torch.where(r.is2 == 1, s2r - 1, jr)
    matched2 = (r.is2 == 1) & (rank < (jr + 1 - s2r)) & r.live
    m2cum = torch.cumsum(matched2.to(torch.int32), 0, dtype=torch.int32)
    return rank, matched2, m2cum


def _merged_dest_plain(mkeys: torch.Tensor, mpos: torch.Tensor, cap1: int):
    """Output slot per merged element, as plain torch scans (any device).

    Line-for-line port of the JAX `_merged_dest_xla`. Side-2 matches and
    the witness prefix are forward scans; the side-1 match test needs its
    run's side-2 total, one backward broadcast. Returns ``(dest int32 [n],
    num_out int32 0-d)``; dropped elements get ``n``.
    """
    n = mkeys.shape[0]
    r = merged_runs(mkeys, mpos, cap1)
    rank, matched2, m2cum = _forward_matches(r)
    matched1 = (r.is2 == 0) & (rank < (r.end2() - r.base2)) & r.live
    dest = torch.where(matched2, m2cum - 1, torch.where(matched1, m2cum + rank, n))
    num_out = matched2.sum(dtype=torch.int32)
    return dest, num_out


def join_scan_forward_plain(mkeys: torch.Tensor, mpos: torch.Tensor, cap1: int):
    """Kernel 3 as plain torch scans (any device): ``(cand, m2cum)``.

    The first half of `_merged_dest_plain`. ``cand`` is the slot ``m2cum -
    1`` of a matched side-2 element, the complement of the candidate slot
    ``m2cum + rank`` of a live side-1 element (whose match test needs its
    run's side-2 total, the backward pass), else ``n``.
    """
    n = mkeys.shape[0]
    r = merged_runs(mkeys, mpos, cap1)
    rank, matched2, m2cum = _forward_matches(r)
    side1 = (r.is2 == 0) & r.live
    cand = torch.where(matched2, m2cum - 1, torch.where(side1, ~(m2cum + rank), n))
    return cand, m2cum


def join_scan_backward_plain(mkeys: torch.Tensor, cand: torch.Tensor, m2: torch.Tensor):
    """Kernel 4 as plain torch (any device): ``(dest, num_out)``.

    A side-1 candidate holds if it lies below its run's ``m2cum`` total,
    the value at the run's tail. The kernel takes the suffix minimum of the
    tail-gated ``m2cum``, which is that value because ``m2cum`` never
    falls; here it is one gather per run.
    """
    n = mkeys.shape[0]
    one = torch.ones(1, dtype=torch.bool, device=mkeys.device)
    neq = mkeys[1:] != mkeys[:-1]
    end_m2 = _tail_broadcast(torch.cat([one, neq]), torch.cat([neq, one]), m2)
    slot = ~cand
    dest = torch.where(cand < 0, torch.where(slot < end_m2, slot, n), cand)
    return dest, m2[-1].clone()


# --- the kernels' carry, in plain Python --------------------------------------


class Summary(NamedTuple):
    """What a contiguous segment of the merged sequence passes on.

    Side 1 precedes side 2 within a run, so a run is two live counts
    ``(n1, n2)`` with ``min(n1, n2)`` matches; dead (sentinel-key) elements
    count for nothing.
    """

    has_head: bool  # a run starts in the segment
    p1: int  # live side-1 / side-2 counts before the first run head
    p2: int  # (of the whole segment if it has no head)
    closed: int  # matches of the runs that start and end in the segment
    t1: int  # live counts from the last run head to the segment's end
    t2: int

    @property
    def m2cum(self) -> int:
        """Matches up to the end of a segment that starts at element 0."""
        return self.closed + min(self.t1, self.t2)


EMPTY = Summary(False, 0, 0, 0, 0, 0)


def combine(a: Summary, b: Summary) -> Summary:
    """The summary of segment ``a`` followed by segment ``b``; associative,
    with `EMPTY` as its identity."""
    if not b.has_head:
        if a.has_head:
            return a._replace(t1=a.t1 + b.p1, t2=a.t2 + b.p2)
        return a._replace(p1=a.p1 + b.p1, p2=a.p2 + b.p2)
    if not a.has_head:
        return b._replace(p1=a.p1 + b.p1, p2=a.p2 + b.p2)
    closed = a.closed + min(a.t1 + b.p1, a.t2 + b.p2) + b.closed
    return Summary(True, a.p1, a.p2, closed, b.t1, b.t2)


def _segment_flags(mkeys: torch.Tensor, mpos: torch.Tensor, cap1: int, lo: int, hi: int):
    """(head, live side-1, live side-2) of elements ``lo .. hi-1``; a head
    test reads the key before the segment, as the kernel does."""
    k = mkeys[lo:hi]
    first = torch.tensor([lo == 0 or bool(mkeys[lo] != mkeys[lo - 1])])
    head = torch.cat([first, k[1:] != k[:-1]])
    live = k != key_sentinel(mkeys.dtype)
    is2 = mpos[lo:hi] >= cap1
    return head, live & ~is2, live & is2


def segment_summary(mkeys: torch.Tensor, mpos: torch.Tensor, cap1: int, lo: int, hi: int) -> Summary:
    """The `Summary` of elements ``lo .. hi-1`` (``lo < hi``), from per-run
    counts (CPU tensors)."""
    head, w1, w2 = _segment_flags(mkeys, mpos, cap1, lo, hi)
    run = torch.cumsum(head, 0)  # 0 before the first head
    nruns = int(run[-1]) + 1
    n1 = torch.zeros(nruns, dtype=torch.int64).index_add_(0, run, w1.long())
    n2 = torch.zeros(nruns, dtype=torch.int64).index_add_(0, run, w2.long())
    if nruns == 1:
        return Summary(False, int(n1[0]), int(n2[0]), 0, 0, 0)
    closed = int(torch.minimum(n1[1:-1], n2[1:-1]).sum())
    return Summary(True, int(n1[0]), int(n2[0]), closed, int(n1[-1]), int(n2[-1]))


def _forward_block(mkeys, mpos, cap1: int, lo: int, hi: int, before: Summary):
    """``(cand, m2cum)`` of one block from its elements and the summary of
    everything before it: the forward kernel after its look-back."""
    n = mkeys.shape[0]
    # The open run's live counts before the block, and the matches before it.
    t1, t2 = (before.t1, before.t2) if before.has_head else (before.p1, before.p2)
    m_before = before.closed + min(t1, t2)
    head, w1, w2 = _segment_flags(mkeys, mpos, cap1, lo, hi)
    run = torch.cumsum(head, 0)
    c1, c2 = torch.cumsum(w1, 0), torch.cumsum(w2, 0)
    lead = run == 0  # before the block's first head: the open run goes on
    a1, a2 = int(w1[lead].sum()), int(w2[lead].sum())
    # Live counts before the latest head, per element (unused where `lead`).
    h1 = (c1 - w1.long())[head][(run - 1).clamp(min=0)] if bool(head.any()) else c1
    h2 = (c2 - w2.long())[head][(run - 1).clamp(min=0)] if bool(head.any()) else c2
    r1 = torch.where(lead, t1 + c1, c1 - h1)  # the run's live counts up to here
    r2 = torch.where(lead, t2 + c2, c2 - h2)
    matched = w2 & (r2 - 1 < r1)
    # Matches before the first head, in closed form: side-2 elements there
    # continue the open run at rank t2, t2 + 1, ...
    lead_m = torch.minimum(c2, (r1 - t2).clamp(min=0))
    lead_m = torch.where(lead, lead_m, min(a2, max(t1 + a1 - t2, 0)))
    m = m_before + lead_m + torch.cumsum(matched & ~lead, 0)
    cand = torch.where(matched, m - 1, torch.where(w1, ~(m + r1 + r2 - 1), n))
    return cand.to(torch.int32), m.to(torch.int32)


def join_scan_blocked_plain(mkeys: torch.Tensor, mpos: torch.Tensor, cap1: int, block: int):
    """``(dest, num_out)`` by the kernels' dataflow, for blocks of ``block``
    elements (CPU tensors): per-block summaries, an exclusive fold of
    `combine`, the forward work of each block; then per-block minima of the
    tail-gated ``m2cum``, an exclusive fold from the end, and the backward
    work of each block. Equal to `_merged_dest_plain` at every block size.
    """
    n = mkeys.shape[0]
    if n == 0:
        return torch.empty(0, dtype=torch.int32), torch.zeros((), dtype=torch.int32)
    bounds = [(lo, min(lo + block, n)) for lo in range(0, n, block)]
    cand = torch.empty(n, dtype=torch.int32)
    m2 = torch.empty(n, dtype=torch.int32)
    before = [EMPTY]  # exclusive fold: the summary of everything before each block
    for lo, hi in bounds[:-1]:
        before.append(combine(before[-1], segment_summary(mkeys, mpos, cap1, lo, hi)))
    for (lo, hi), pre in zip(bounds, before):
        cand[lo:hi], m2[lo:hi] = _forward_block(mkeys, mpos, cap1, lo, hi, pre)

    int_max = torch.iinfo(torch.int32).max
    tail = torch.cat([mkeys[1:] != mkeys[:-1], torch.ones(1, dtype=torch.bool)])
    gated = torch.where(tail, m2, int_max)
    dest = torch.empty(n, dtype=torch.int32)
    after = int_max
    for lo, hi in reversed(bounds):
        suffix_min = torch.flip(torch.cummin(torch.flip(gated[lo:hi], [0]), 0).values, [0])
        end_m2 = suffix_min.clamp(max=after)
        c = cand[lo:hi]
        dest[lo:hi] = torch.where(c < 0, torch.where(~c < end_m2, ~c, n), c)
        after = min(after, int(suffix_min[0]))
    return dest, m2[-1].clone()


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
        return _merged_dest_plain(mkeys, mpos, cap1)
    if mkeys.device.type == "cuda":
        return join_scan_cuda(mkeys, mpos, cap1)
    raise ValueError(f"join_scan: unsupported device {mkeys.device}")
