"""Drive the PyTorch port on one CUDA card and check every kernel it runs.

Usage, from the root of a checkout, on a machine with an NVIDIA H100 and
the CUDA toolkit:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. card details (nvidia-smi, torch, CUDA, nvcc);
  2. build the kernels from `pim_sort_merge_join_tpu_torch/csrc/` (first use);
  3. every kernel against its plain torch version on the card, exactly:
     adversarial cases, then the main path's shapes at 10M rows/table,
     timed with CUDA events (median of 3 after a warmup);
  4. the query at 100k rows/table through `QueryPipeline.run_csv`: rows and
     CSV bytes equal the numpy oracle's;
  5. the query at 10M rows/table through `run_tables` (the main path): the
     whole output buffer equals the plain path on CPU tensors, and every
     kernel of the path was launched in that run;
  6. the same at 1M rows/table with keys offset by 2^40 (64-bit keys).

The last three lines are the kernels' JSON record, the card's name and
power limit, and the result JSON. Without a CUDA device, or without the
package beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np


class SmokeError(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, setup=lambda: None, reps: int = 3) -> float:
    """Median device time of ``fn(setup())`` in ms, after one warmup run;
    ``setup`` runs outside the timed region."""
    import torch

    fn(setup())
    times = []
    for _ in range(reps):
        arg = setup()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(arg)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(got, want) -> int:
    """Largest absolute difference over paired integer tensors (0 = equal)."""
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise SmokeError(f"shape/dtype differ: {g.shape} {g.dtype} vs {w.shape} {w.dtype}")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    return err


# --- adversarial cases (tests/test_hbm_sort.py, tests/test_join_scan.py) ---


def sort_cases(rng):
    """(name, operands as numpy arrays, num_keys)."""
    i32max = np.iinfo(np.int32).max
    cases = []
    for n in (512, 2048, 4096):
        cases.append((f"pair_multi_pass_{n}", [rng.integers(0, 1 << 30, n).astype(np.int32),
                                               np.arange(n, dtype=np.int32)], 1))
    cases.append(("padding_1500", [rng.integers(-(1 << 30), 1 << 30, 1500).astype(np.int32),
                                   rng.integers(0, 100, 1500).astype(np.int32)], 1))
    cases.append(("stability_dups", [rng.integers(0, 7, 2048).astype(np.int32),
                                     np.arange(2048, dtype=np.int32)], 1))
    cases.append(("int64_keys", [rng.integers(-(1 << 60), 1 << 60, 1024),
                                 np.arange(1024, dtype=np.int64)], 1))
    sent = rng.integers(-(1 << 60), 1 << 60, 5000)
    sent[rng.random(5000) < 0.2] = np.iinfo(np.int64).max
    cases.append(("int64_sentinels", [sent, np.arange(5000, dtype=np.int32)], 1))
    cases.append(("table_rows_4col", [rng.integers(0, 1 << 40, 2048) for _ in range(4)], 1))
    cases.append(("unique_perm_payload", [rng.permutation(2048).astype(np.int32),
                                          rng.integers(-(2**62), 2**62, 2048)], 1))
    k = rng.integers(0, 50, 2048).astype(np.int32)
    k[rng.choice(2048, 200, replace=False)] = i32max
    cases.append(("two_keys_sentinel_ties", [k, np.arange(2048, dtype=np.int32)], 2))
    cases.append(("two_keys_payload", [rng.integers(0, 9, 2048).astype(np.int32),
                                       rng.permutation(2048).astype(np.int32),
                                       rng.integers(0, 10**12, 2048)], 2))
    cases.append(("two_keys_negative_second", [rng.integers(-3, 3, 3000).astype(np.int32),
                                               rng.integers(-(2**31), 2**31 - 1, 3000).astype(np.int32)], 2))
    cases.append(("two_keys_int64_primary", [rng.integers(-(2**60), 2**60, 2048),
                                             np.arange(2048, dtype=np.int32)], 2))
    cases.append(("one_element", [np.array([7], np.int32), np.array([3], np.int64)], 1))
    cases.append(("chunk_plus_one", [rng.integers(0, 100, 2049).astype(np.int32),
                                     np.arange(2049, dtype=np.int32)], 1))
    cases.append(("many_passes_300k", [rng.integers(0, 1 << 20, 300_000).astype(np.int32),
                                       rng.integers(-(2**62), 2**62, 300_000)], 1))
    return cases


def merged_case(rng, n1, n2, pool, dtype=np.int64, sentinel_frac=0.1):
    """Merge-sort output over random keys from ``pool``, some dead."""
    k1 = rng.choice(pool, size=n1)
    k2 = rng.choice(pool, size=n2)
    sent = np.iinfo(dtype).max
    k1[rng.random(n1) < sentinel_frac] = sent
    k2[rng.random(n2) < sentinel_frac] = sent
    keys = np.concatenate([k1, k2]).astype(dtype)
    pos = np.arange(n1 + n2, dtype=np.int32)
    order = np.lexsort((pos, keys))
    return keys[order], pos[order], n1


def scan_cases(rng):
    """(name, mkeys, mpos, cap1): runs across blocks, dead keys, empty sides."""
    wide = np.array([-(2**40), -5, 0, 7, 2**40])
    cases = []
    for n1, n2 in ((700, 900), (7000, 9000)):
        cases.append((f"mostly_unique_{n1}", *merged_case(rng, n1, n2, np.arange(1, 4000))))
        cases.append((f"long_runs_{n1}", *merged_case(rng, n1, n2, np.arange(1, 8))))
        cases.append((f"wide_extremes_{n1}", *merged_case(rng, n1, n2, wide)))
    cases.append(("int32_keys", *merged_case(rng, 512, 300, np.arange(1, 50), np.int32)))
    cases.append(("int32_keys_big", *merged_case(rng, 20000, 13001, np.arange(1, 50), np.int32)))
    cases.append(("side1_empty", *merged_case(rng, 0, 5000, np.arange(1, 30))))
    cases.append(("side2_empty", *merged_case(rng, 5000, 0, np.arange(1, 30))))
    for n, cap1 in ((400, 200), (10001, 5000)):
        cases.append((f"all_dead_{n}", np.full(n, np.iinfo(np.int64).max, np.int64),
                      np.arange(n, dtype=np.int32), cap1))
    for n, cap1 in ((1000, 600), (50000, 30000)):
        cases.append((f"one_run_{n}", np.full(n, 42, np.int64), np.arange(n, dtype=np.int32), cap1))
    return cases


# --- phases -----------------------------------------------------------------


def card_details() -> str:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    import torch

    from pim_sort_merge_join_tpu_torch.ops.kernels import build

    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True, text=True, check=True)
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}")
    log(f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    return card


def phase_build() -> None:
    from pim_sort_merge_join_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    path = build.build()
    build.library()
    log(f"build: {time.perf_counter() - t0:.2f} s -> {os.path.relpath(path)}")


def phase_adversarial(rng) -> dict[str, int]:
    import torch

    from pim_sort_merge_join_tpu_torch.ops.join import _merged_dest_plain
    from pim_sort_merge_join_tpu_torch.ops.kernels import hbm_sort as hs
    from pim_sort_merge_join_tpu_torch.ops.kernels import join_scan as js

    errs = {"sort": 0, "scan": 0}
    sorts, scans = sort_cases(rng), scan_cases(rng)
    for name, arrays, num_keys in sorts:
        ops = tuple(torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in arrays)
        err = max_abs_err(hs.hbm_sort(ops, num_keys), hs.hbm_sort_plain(ops, num_keys))
        check(err == 0, f"hbm_sort case {name}: kernel differs from plain (max err {err})")
        errs["sort"] = max(errs["sort"], err)
    for name, mkeys, mpos, cap1 in scans:
        mk, mp = torch.from_numpy(mkeys).cuda(), torch.from_numpy(mpos).cuda()
        err = max_abs_err(js.join_scan_cuda(mk, mp, cap1), _merged_dest_plain(mk, mp, cap1))
        check(err == 0, f"join_scan case {name}: kernel differs from plain (max err {err})")
        errs["scan"] = max(errs["scan"], err)
    torch.cuda.synchronize()
    log(f"adversarial: {len(sorts)} sort cases, {len(scans)} scan cases equal")
    return errs


def slice_inputs(n: int, key_offset: int = 0):
    """The bench workload: generate_table(n, seed=1/2), predicate > 3N/20."""
    from pim_sort_merge_join_tpu_torch import EngineConfig, Predicate
    from pim_sort_merge_join_tpu_torch.columnar.generate import generate_table

    r1 = generate_table(n, seed=1)
    r2 = generate_table(n, seed=2)
    r1[:, 0] += key_offset
    r2[:, 0] += key_offset
    thr = key_offset + (3 * n) // 20
    cfg = EngineConfig(predicate1=Predicate(0, ">", thr), predicate2=Predicate(0, ">", thr))
    return r1, r2, cfg


def phase_main_path_shapes(r1, r2, cfg) -> dict:
    """Each kernel at the shapes the 10M-row query gives it, vs plain."""
    import torch

    from pim_sort_merge_join_tpu_torch import Table
    from pim_sort_merge_join_tpu_torch.columnar.table import key_sentinel
    from pim_sort_merge_join_tpu_torch.ops import filter as filter_ops
    from pim_sort_merge_join_tpu_torch.ops.join import _merged_dest_plain, _narrow32
    from pim_sort_merge_join_tpu_torch.ops.kernels import hbm_sort as hs
    from pim_sort_merge_join_tpu_torch.ops.kernels import join_scan as js

    t1 = Table.from_numpy(r1, device="cuda")
    t2 = Table.from_numpy(r2, device="cuda")
    cap1, n = t1.capacity, t1.capacity + t2.capacity
    sent = key_sentinel(t1.dtype)
    k1 = torch.where(filter_ops.predicate_mask(t1, cfg.predicate1), t1.data[:, 0], sent)
    k2 = torch.where(filter_ops.predicate_mask(t2, cfg.predicate2), t2.data[:, 0], sent)
    keys = torch.cat([_narrow32(k1), _narrow32(k2)])
    pos = torch.arange(n, dtype=torch.int32, device="cuda")
    rec = {}

    # Merge sort: 2n (int32 key, int32 pos), two keys packed into one.
    merge_ops = (keys, pos)
    mkeys, mpos = hs.hbm_sort(merge_ops, 2)
    rec["merge_sort_err"] = max_abs_err((mkeys, mpos), hs.hbm_sort_plain(merge_ops, 2))
    rec["merge_sort_ms"] = time_ms(lambda _: hs.hbm_sort(merge_ops, 2))
    rec["merge_sort_plain_ms"] = time_ms(lambda _: hs.hbm_sort_plain(merge_ops, 2))
    rec["chunk_ms"] = time_ms(lambda _: hs.chunk_sort(keys, pos, hs.KIND_I32_PAIR))
    chunked = hs.chunk_sort(keys, pos, hs.KIND_I32_PAIR)
    rec["merge_ms"] = time_ms(
        lambda kv: hs.merge_passes(*kv), setup=lambda: tuple(t.clone() for t in chunked)
    )

    # Join scan over the merged 2n int32 keys.
    dest, num_out = js.join_scan_cuda(mkeys, mpos, cap1)
    rec["scan_err"] = max_abs_err((dest, num_out), _merged_dest_plain(mkeys, mpos, cap1))
    rec["scan_plain_ms"] = time_ms(lambda _: _merged_dest_plain(mkeys, mpos, cap1))
    rec["forward_ms"] = time_ms(lambda _: js.join_scan_forward(mkeys, mpos, cap1))
    cand, m2 = js.join_scan_forward(mkeys, mpos, cap1)
    rec["backward_ms"] = time_ms(lambda _: js.join_scan_backward(mkeys, cand, m2))
    rec["num_out"] = int(num_out)

    # Un-merge sort: 2n, one unique int32 key.
    unmerge_ops = (mpos, dest)
    _, dest_by_pos = hs.hbm_sort(unmerge_ops)
    rec["unmerge_sort_err"] = max_abs_err(hs.hbm_sort(unmerge_ops), hs.hbm_sort_plain(unmerge_ops))
    rec["unmerge_sort_ms"] = time_ms(lambda _: hs.hbm_sort(unmerge_ops))
    rec["unmerge_sort_plain_ms"] = time_ms(lambda _: hs.hbm_sort_plain(unmerge_ops))

    # Emit sort: n1 slots carrying the 4 int64 columns of table 1.
    d1 = dest_by_pos[:cap1]
    d1u = torch.where(d1 >= n, n + torch.arange(cap1, dtype=torch.int32, device="cuda"), d1)
    emit_ops = (d1u,) + tuple(t1.data[:, c].contiguous() for c in range(t1.ncol))
    rec["emit_sort_err"] = max_abs_err(hs.hbm_sort(emit_ops), hs.hbm_sort_plain(emit_ops))
    rec["emit_sort_ms"] = time_ms(lambda _: hs.hbm_sort(emit_ops))
    rec["emit_sort_plain_ms"] = time_ms(lambda _: hs.hbm_sort_plain(emit_ops))
    perm = hs.sort_permutation(d1u, d1u, hs.KIND_I32)
    perm64 = perm.long()
    rec["gather_err"] = max_abs_err(hs.gather(perm, emit_ops), tuple(o[perm64] for o in emit_ops))
    rec["gather_ms"] = time_ms(lambda _: hs.gather(perm, emit_ops))
    rec["gather_plain_ms"] = time_ms(lambda _: tuple(o[perm64] for o in emit_ops))
    torch.cuda.synchronize()
    for key in ("merge_sort_err", "scan_err", "unmerge_sort_err", "emit_sort_err", "gather_err"):
        check(rec[key] == 0, f"main-path shape {key} = {rec[key]}: kernel differs from plain")
    log("main-path shapes (ms, kernel vs plain): " + json.dumps(rec))
    return rec


def phase_csv_100k() -> float:
    import torch

    from pim_sort_merge_join_tpu_torch import EngineConfig, QueryPipeline
    from pim_sort_merge_join_tpu_torch.columnar import csv_io
    from pim_sort_merge_join_tpu_torch.columnar.generate import generate_table
    from pim_sort_merge_join_tpu_torch.ops import oracle

    with tempfile.TemporaryDirectory() as d:
        p1, p2, po = (os.path.join(d, f) for f in ("data1.csv", "data2.csv", "result.csv"))
        csv_io.write_csv(p1, generate_table(100_000, seed=1))
        csv_io.write_csv(p2, generate_table(100_000, seed=2))
        pipe = QueryPipeline(EngineConfig(), device="cuda")
        res = pipe.run_csv(p1, p2, po)
        rows1, rows2 = csv_io.load_csv_numpy(p1), csv_io.load_csv_numpy(p2)
        want = oracle.pipeline_oracle(rows1, rows2)
        check(np.array_equal(res.to_numpy(), want), "100k slice: rows differ from the oracle")
        buf = io.StringIO()
        csv_io.write_csv(buf, want)
        with open(po) as f:
            check(f.read() == buf.getvalue(), "100k slice: CSV bytes differ from the oracle's")
        from pim_sort_merge_join_tpu_torch import Table

        g1 = Table.from_numpy(rows1, device="cuda")
        g2 = Table.from_numpy(rows2, device="cuda")
        ms = host_ms(lambda: pipe.run_tables(g1, g2))
    torch.cuda.synchronize()
    log(f"slice 100k: {want.shape[0]} rows, CSV byte-identical to the oracle; "
        f"run_tables {ms:.3f} ms (median of 3)")
    return ms


def host_ms(fn, reps: int = 3) -> float:
    """Median host-clock ms of ``fn`` (which waits for the device), after a warmup."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_slice(r1, r2, cfg, *, expect_narrow: bool, label: str):
    """run_tables on CUDA vs the plain path on CPU; returns (launches, ms, rows)."""
    import torch

    from pim_sort_merge_join_tpu_torch import QueryPipeline, Table
    from pim_sort_merge_join_tpu_torch.ops import kernels

    g1 = Table.from_numpy(r1, device="cuda")
    g2 = Table.from_numpy(r2, device="cuda")
    pipe = QueryPipeline(cfg, device="cuda")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = pipe.run_tables(g1, g2)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    check(pipe.resolved_narrow_keys is expect_narrow,
          f"{label}: narrow_keys resolved {pipe.resolved_narrow_keys}, expected {expect_narrow}")
    for name, count in launches.items():
        check(count > 0, f"{label}: kernel {name} was not launched on the main path")
    ref = QueryPipeline(cfg).run_tables(Table.from_numpy(r1), Table.from_numpy(r2))
    rows = int(out.num_rows)
    check(rows == int(ref.num_rows) and rows > 0, f"{label}: num_rows {rows} vs plain {int(ref.num_rows)}")
    check(tuple(out.data.shape) == tuple(ref.data.shape), f"{label}: output shape differs")
    check(torch.equal(out.data.cpu(), ref.data), f"{label}: output buffer differs from the plain path")
    ms = host_ms(lambda: pipe.run_tables(g1, g2))
    log(f"slice {label}: {rows} rows equal to the plain path; launches {launches}; "
        f"run_tables {ms:.3f} ms (median of 3)")
    return launches, ms, rows


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    try:
        import pim_sort_merge_join_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from the root of a checkout (package not found)", file=sys.stderr)
        return 2

    card = card_details()
    phase_build()
    rng = np.random.default_rng(20241220)
    errs = phase_adversarial(rng)
    r1, r2, cfg = slice_inputs(10_000_000)
    shapes = phase_main_path_shapes(r1, r2, cfg)
    phase_csv_100k()
    launches, ms10, rows10 = phase_slice(r1, r2, cfg, expect_narrow=True, label="10M")
    del r1, r2
    torch.cuda.empty_cache()
    w1, w2, wcfg = slice_inputs(1_000_000, key_offset=2**40)
    phase_slice(w1, w2, wcfg, expect_narrow=False, label="1M wide keys")

    src = "pim_sort_merge_join_tpu_torch/csrc/"
    ref = "pim_sort_merge_join_tpu/ops/pallas/"
    sort_err = max(errs["sort"], shapes["merge_sort_err"], shapes["unmerge_sort_err"],
                   shapes["emit_sort_err"])
    kernels = [
        {"name": "hbm_sort_chunk", "route": "cuda", "source": src + "hbm_sort.cu",
         "replaces": ref + "hbm_sort.py:286", "launches": launches["hbm_sort_chunk"],
         "max_abs_err": sort_err, "ms": shapes["chunk_ms"],
         "plain_ms": shapes["merge_sort_plain_ms"]},
        {"name": "hbm_sort_merge", "route": "cuda", "source": src + "hbm_sort.cu",
         "replaces": ref + "hbm_sort.py:463", "launches": launches["hbm_sort_merge"],
         "max_abs_err": sort_err, "ms": shapes["merge_ms"],
         "plain_ms": shapes["merge_sort_plain_ms"]},
        {"name": "hbm_sort_gather", "route": "cuda", "source": src + "hbm_sort.cu",
         "replaces": ref + "hbm_sort.py:670", "launches": launches["hbm_sort_gather"],
         "max_abs_err": max(sort_err, shapes["gather_err"]), "ms": shapes["gather_ms"],
         "plain_ms": shapes["gather_plain_ms"]},
        {"name": "join_scan_forward", "route": "cuda", "source": src + "join_scan.cu",
         "replaces": ref + "join_scan.py:137", "launches": launches["join_scan_forward"],
         "max_abs_err": max(errs["scan"], shapes["scan_err"]), "ms": shapes["forward_ms"],
         "plain_ms": shapes["scan_plain_ms"]},
        {"name": "join_scan_backward", "route": "cuda", "source": src + "join_scan.cu",
         "replaces": ref + "join_scan.py:216", "launches": launches["join_scan_backward"],
         "max_abs_err": max(errs["scan"], shapes["scan_err"]), "ms": shapes["backward_ms"],
         "plain_ms": shapes["scan_plain_ms"]},
    ]
    log(f"slice 10M: {rows10} rows in {ms10:.3f} ms")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
