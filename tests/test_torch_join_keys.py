"""The fused join's key vector (`ops/kernels/keys`) on the CPU.

`join_keys_plain` against the composition it took over from
`pipeline_core` (`ops/filter.predicate_mask` for each table,
`one_to_one_keys`), bit for bit: int64 and uint64 tables, every operator,
narrow and wide, padding rows, a predicate column other than the key
column, rows of 1 to 10 columns, and values at the int32 and int64 edges.
The kernel's wrapper runs here too, up to its launch: for every pair of
table types, its arguments, read by their pointers, strides and type codes
as `csrc/keys.cu` reads them, give the plain version's keys, and it raises
the plain version's errors.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np
import pytest
import torch

import chip_smoke
from pim_sort_merge_join_tpu_torch import EngineConfig, Predicate, Table
from pim_sort_merge_join_tpu_torch.columnar import dtypes
from pim_sort_merge_join_tpu_torch.engine.pipeline import pipeline_core
from pim_sort_merge_join_tpu_torch.ops import filter as filter_ops
from pim_sort_merge_join_tpu_torch.ops import join as join_ops
from pim_sort_merge_join_tpu_torch.ops.kernels import build, keys

OPS = (">", ">=", "<", "<=", "==", "!=")
I32MIN, I32MAX = -(2**31), 2**31 - 1
I64MIN, I64MAX = -(2**63), 2**63 - 1
# Values at the int32 window's and int64's edges, as int64 bits.
EDGES = np.array([I64MIN, I64MIN + 1, I32MIN - 1, I32MIN, -1, 0, 1, I32MAX - 1, I32MAX,
                  I32MAX + 1, I64MAX - 1, I64MAX], np.int64)


def _composition(t1, t2, p1, p2, key1, key2, narrow):
    """The torch ops `pipeline_core`'s ``keys`` stage ran before
    `join_keys`."""
    m1, m2 = filter_ops.predicate_mask(t1, p1), filter_ops.predicate_mask(t2, p2)
    return join_ops.one_to_one_keys(t1, t2, key1, key2, m1, m2, narrow=narrow)


def _table(rows: np.ndarray, num_rows: int, dtype) -> Table:
    """``rows`` (int64 bits) as a table of ``dtype`` whose first
    ``num_rows`` rows are valid; the rest are padding that keeps its
    values."""
    data = torch.from_numpy(rows.copy()).view(dtype)
    return Table(data, torch.tensor(num_rows, dtype=torch.int32))


def _case(rng, ncol: int, rows: int, edges: bool):
    r = rng.integers(-50, 50, (rows, ncol), dtype=np.int64)
    if edges and r.size:
        m = max(1, r.size // 3)
        r.reshape(-1)[rng.integers(0, r.size, m)] = rng.choice(EDGES, m)
    return r


def _pred(rng, ncol: int, op: str, dtype, edges: bool) -> Predicate:
    col = int(rng.integers(-ncol, ncol))
    if dtype == torch.uint64:
        values = [0, 3, 2**63 - 1, 2**63, 2**63 + 1, 2**64 - 1, 2**32]
        value = values[int(rng.integers(len(values)))] if edges else 3
    else:
        value = int(rng.choice(EDGES)) if edges else int(rng.integers(-5, 5))
    return Predicate(col, op, value)


def _same(got: torch.Tensor, want: torch.Tensor) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("edges", [False, True])
@pytest.mark.parametrize("narrow", [False, True])
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", [torch.int64, torch.uint64], ids=str)
def test_plain_equals_the_composition(dtype, op, narrow, edges):
    rng = np.random.default_rng([OPS.index(op), narrow, edges, dtype == torch.uint64])
    for ncol in range(1, 11):
        cap1, cap2 = int(rng.integers(0, 40)), int(rng.integers(1, 40))
        t1 = _table(_case(rng, ncol, cap1, edges), int(rng.integers(0, cap1 + 1)), dtype)
        t2 = _table(_case(rng, ncol, cap2, edges), int(rng.integers(0, cap2 + 1)), dtype)
        p1, p2 = _pred(rng, ncol, op, dtype, edges), _pred(rng, ncol, op, dtype, edges)
        key1, key2 = int(rng.integers(0, ncol)), int(rng.integers(-ncol, ncol))
        want = _composition(t1, t2, p1, p2, key1, key2, narrow)
        _same(keys.join_keys_plain(t1, t2, p1, p2, key1, key2, narrow), want)
        _same(keys.join_keys(t1, t2, p1, p2, key1, key2, narrow), want)


def test_edge_keys_narrow_as_the_composition_does():
    """A valid key equal to the order sentinel, keys either side of the
    int32 window and of 2^63 (uint64): the plain version keeps the
    composition's sentinel and truncation."""
    for dtype, col in ((torch.int64, [I64MAX, I64MAX - 1, I32MAX, I32MAX + 1, I32MIN - 1, I64MIN]),
                       (torch.uint64, [-1, -2, 2**31, I64MIN, I64MIN + 5, 0])):
        rows = np.array([[c, 7] for c in col], np.int64)
        t = _table(rows, len(col) - 1, dtype)
        every = Predicate(1, "==", 7)
        for narrow in (False, True):
            want = _composition(t, t, every, every, 0, 0, narrow)
            _same(keys.join_keys_plain(t, t, every, every, 0, 0, narrow), want)
            # The last row is padding: the sentinel, as is a valid key equal to it.
            sent = I32MAX if narrow else I64MAX
            assert int(want[len(col) - 1]) == sent and int(want[0]) == sent


@pytest.mark.parametrize("dtype", [torch.int32, torch.float64, "mixed"], ids=str)
def test_other_types_take_the_plain_version(dtype, monkeypatch):
    """On the CPU every pair of table types, these among them, takes the
    plain version; tables on any other device reach the kernel's wrapper,
    whatever their types."""
    taken = []
    monkeypatch.setattr(keys, "join_keys_cuda", lambda *a: taken.append("kernel"))
    rng = np.random.default_rng(3)
    t1 = _table(_case(rng, 3, 9, False), 7, torch.int64)
    d2 = torch.from_numpy(_case(rng, 3, 5, False))
    t2 = Table(d2.to(torch.float64 if dtype == "mixed" else dtype), torch.tensor(4, dtype=torch.int32))
    if dtype != "mixed":
        t1 = Table(t1.data.to(dtype), t1.num_rows)
    p = Predicate(0, ">", -10)
    got = keys.join_keys(t1, t2, p, p, 0, 0, True)
    _same(got, _composition(t1, t2, p, p, 0, 0, True))
    assert taken == []
    meta = [Table(t.data.to("meta"), t.num_rows.to("meta")) for t in (t1, t2)]
    keys.join_keys(*meta, p, p, 0, 0, True)
    assert taken == ["kernel"]


def test_card_tables_with_malformed_row_counts_raise():
    """A table off the CPU whose row count is not one int32 on its device
    breaks the `Table` invariant: the wrapper raises before it reads it."""
    d = torch.zeros((4, 2), dtype=torch.int64, device="meta")
    p = Predicate(0, ">", 0)
    for n in (torch.tensor(3, dtype=torch.int64, device="meta"), torch.tensor(3, dtype=torch.int32),
              torch.zeros(2, dtype=torch.int32, device="meta")):
        with pytest.raises(ValueError, match="num_rows must be one int32 on its device"):
            keys.join_keys_cuda(Table(d, n), Table(d, n), p, p, 0, 0, True)
    good = torch.tensor(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="tables must share one CUDA device"):
        on_cpu = Table(torch.zeros((4, 2), dtype=torch.int64), torch.tensor(3, dtype=torch.int32))
        keys.join_keys_cuda(on_cpu, Table(d, good), p, p, 0, 0, True)


def _read(ptr: int, n: int, ctype) -> np.ndarray:
    return np.ctypeslib.as_array((ctype * n).from_address(ptr))


# `csrc/keys.cu`'s type codes: (kind, shift) -> the table type.
_TYPES = {(0, 2): torch.int32, (0, 3): torch.int64, (1, 2): torch.uint32, (1, 3): torch.uint64,
          (2, 2): torch.float32, (2, 3): torch.float64}


def _kernel_on_host(*args):
    """`csrc/keys.cu`'s ``smj_join_keys`` on host memory, in torch ops:
    each table's buffer read through its pointer, type code and strides,
    its row count through its pointer, the predicate by its outcome bits
    and its value (an integer's order key, a float's double bits), the
    rows it drops from the sentinel's bits, converted to the keys' type;
    keys written through ``out``'s pointer."""
    to_kind, to_shift, narrow, out_ptr, _stream = args[28:]
    to = _TYPES[to_kind, to_shift]
    parts = []
    for (base, rows, ncol, s0, s1, num_rows, kind, shift, _contig, key, pcol, holds, value,
         sentinel) in (args[:14], args[14:28]):
        src, bits = _TYPES[kind, shift], torch.int64 if shift == 3 else torch.int32
        valid = int(_read(num_rows, 1, ctypes.c_int32)[0])
        extent = (rows - 1) * s0 + (ncol - 1) * s1 + 1 if rows else 0
        mem = torch.from_numpy(_read(base, extent, ctypes.c_int64 if shift == 3 else ctypes.c_int32)
                               .copy()) if rows else torch.zeros(0, dtype=bits)
        r = torch.arange(rows)
        k, p = (mem[r * s0 + c * s1].view(src) for c in (key, pcol))
        if kind == 2:
            x, v = p.double(), struct.unpack("<d", struct.pack("<q", value))[0]
            outcome = torch.where(x < v, 0, torch.where(x == v, 1, torch.where(x > v, 2, 3)))
        else:
            x = dtypes.order_key(p).long()
            outcome = torch.where(x < value, 0, torch.where(x == value, 1, 2))
        kept = torch.tensor([(holds >> o) & 1 for o in range(4)], dtype=torch.bool)
        keep = (r < valid) & kept[outcome]
        sent = torch.tensor([sentinel]).to(bits)
        parts.append(dtypes.order_key(torch.where(keep, k.view(bits), sent).view(src).to(to)))
    got = torch.cat(parts)
    if narrow:
        got = dtypes.narrow32(got, to)
    out = _read(out_ptr, got.shape[0], ctypes.c_int32 if narrow or to_shift == 2 else ctypes.c_int64)
    out[:] = got.numpy()
    return 0


@pytest.fixture
def wrapper_on_host(monkeypatch):
    """`join_keys_cuda` on CPU tables, its launch carried out by
    `_kernel_on_host`; returns the launches counted."""
    monkeypatch.setattr(keys, "_checked_tables", lambda t1, t2: None)
    monkeypatch.setattr(build, "entry", lambda name: _kernel_on_host)
    monkeypatch.setattr(build, "stream_ptr", lambda t: 0)
    launched = []
    monkeypatch.setattr(build, "launched", launched.append)
    return launched


# Same-type int64 and uint64 tables, then the other pairs of types.
WRAPPER_TYPES = [torch.int64, torch.uint64] + chip_smoke.KEYS_TYPES[2:]


@pytest.mark.parametrize("narrow", [False, True])
@pytest.mark.parametrize("dtype", WRAPPER_TYPES,
                         ids=lambda d: str(d) if isinstance(d, torch.dtype) else "/".join(d))
def test_wrapper_arguments_give_the_plain_keys(dtype, narrow, wrapper_on_host):
    """The wrapper's arguments, read by their pointers, strides and type
    codes, give the plain version's keys: every pair of types, rows of 1 to
    7, every operator, edge values (`chip_smoke.keys_table`) and each
    layout of `chip_smoke.probe_views`."""
    types = (dtype, dtype) if isinstance(dtype, torch.dtype) else dtype
    ty1, ty2 = (str(t).removeprefix("torch.") for t in types)
    rng = np.random.default_rng([7, narrow, WRAPPER_TYPES.index(dtype)])
    calls = 0
    for ncol in (1, 3, 4, 7):
        for op in OPS:
            a1, a2 = chip_smoke.keys_table(rng, 13, ncol, ty1), chip_smoke.keys_table(rng, 6, ncol, ty2)
            p1, p2 = (Predicate(c, op, a[rng.integers(a.shape[0]), c].item())
                      for a, c in ((a1, int(rng.integers(-ncol, ncol))), (a2, int(rng.integers(ncol)))))
            key1, key2 = int(rng.integers(-ncol, ncol)), int(rng.integers(0, ncol))
            v1 = chip_smoke.probe_views(torch.from_numpy(a1))
            v2 = chip_smoke.probe_views(torch.from_numpy(a2))
            for w1, w2 in zip(v1.values(), list(v2.values())[::-1]):
                t1 = Table(w1, torch.tensor(11, dtype=torch.int32))
                t2 = Table(w2, torch.tensor(6, dtype=torch.int32))
                want = _composition(t1, t2, p1, p2, key1, key2, narrow)
                _same(keys.join_keys_cuda(t1, t2, p1, p2, key1, key2, narrow), want)
                calls += 1
    assert wrapper_on_host == ["join_keys"] * calls == ["join_keys"] * (4 * len(OPS) * 5)


@pytest.mark.parametrize("case", chip_smoke.keys_error_cases(), ids=lambda c: c[0])
def test_wrapper_raises_the_plain_versions_errors(case, monkeypatch):
    want = chip_smoke.keys_error(case, "cpu")
    # The negative columns are no error: the plain version reads them from
    # the row's end, as the wrapper does.
    assert (want is None) == (case[0] == "negative columns")
    launched = []
    monkeypatch.setattr(keys, "join_keys_plain", keys.join_keys_cuda)
    monkeypatch.setattr(keys, "_checked_tables", lambda t1, t2: None)
    monkeypatch.setattr(build, "entry", lambda name: launched.append(name) or _kernel_on_host)
    monkeypatch.setattr(build, "stream_ptr", lambda t: 0)
    assert chip_smoke.keys_error(case, "cpu") == want
    assert launched == ([] if want else ["smj_join_keys"])


@pytest.mark.parametrize("narrow", [False, True, "auto"])
def test_pipeline_core_keys_stage_feeds_the_merge(narrow, monkeypatch):
    """The fused path hands `join_keys`' one vector to the join core, which
    concatenates nothing; on the CPU the stage launches nothing."""
    seen = []
    core = join_ops._one_to_one_merged
    monkeypatch.setattr(join_ops, "_one_to_one_merged",
                        lambda t1, t2, key2, k, **kw: seen.append(k) or core(t1, t2, key2, k, **kw))
    rng = np.random.default_rng(11)
    rows = [np.column_stack([rng.permutation(60), rng.integers(0, 9, (60, 2))]) for _ in range(2)]
    t1, t2 = (Table.from_numpy(r, capacity=64, device="cpu") for r in rows)
    cfg = EngineConfig(predicate1=Predicate(1, ">", 2), predicate2=Predicate(2, "<=", 6),
                       narrow_keys=narrow)
    out = pipeline_core(t1, t2, cfg)
    (k,) = seen
    _same(k, _composition(t1, t2, cfg.predicate1, cfg.predicate2, 0, 0, narrow))
    assert k.dtype == (torch.int32 if narrow is True else torch.int64)
    assert int(out.num_rows) > 0
