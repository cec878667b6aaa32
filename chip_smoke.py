"""Drive the PyTorch port on one CUDA card and check every kernel it runs.

Usage, from the root of a checkout, on a machine with an NVIDIA H100 and
the CUDA toolkit:

    python3 chip_smoke.py            # every phase below
    python3 chip_smoke.py --profile  # the fused 10M, staged 10M, 1:1 hash
                                     # 10M and uint64 fused 10M queries
                                     # under torch.profiler: busy time,
                                     # launches, the top kernels; no
                                     # torch.equal

Phases, in order; any failure exits non-zero:
  1. card details (nvidia-smi, torch, CUDA, nvcc);
  2. build the kernels from `pim_sort_merge_join_tpu_torch/csrc/` (first use);
  3. every kernel against its plain torch version on the card, exactly:
     adversarial cases (each join-scan kernel against its own plain half
     and the pair against the whole plain scan, with int64 and int32 keys,
     and the placement on the scan's slots, also one element off its
     alignment;
     the bitonic network at every width from 2 to 2^21 and around its tile;
     the row gather over widths, windows, block edges, live counts and two
     tables in one call; the column gather over lengths and alignments; both
     radix sorts over tiles, digit widths, key bits, operand counts and
     arrays one element off their alignment; the narrow probe's extremes
     over row widths, key columns, types, edge values, views and sizes,
     and its errors on empty buffers; the fused keys over row widths,
     capacities, row counts, operators, types, edge values and views,
     narrow and wide, and their errors),
     then the shapes the paths give them, timed with CUDA events (median of
     3 after a warmup): the fused path's at 10M rows/table (its merge
     sort as phase A, phase B and whole, beside stable `torch.sort` of the
     key alone; the join scans over its 20M int32 keys and over the 1M
     wide-keys query's 2M int64 keys; the placement over its 20M merged
     elements beside one `index_put_`; the un-merge sort and the emit sort
     with table 1's rows as payload that the placement replaced, as its
     yardstick), both gathers at the paths' shapes
     beside `index_select`, the bitonic sort at its 2^21 cap, and the radix
     tile sort at the merge sort's 20M elements (tiles of 2048, 512 and
     8192), beside the chunk sort and one `torch.sort` of every tile's keys.
     The radix sort then forms the runs of that merge sort (run formation:
     radix runs + merge passes), which must equal the `hbm_sort` result.
     Last the global radix sort (`xla_lsd_radix_sort`) of `(key, payload)`
     at the fused path's merge sort and at the replaced un-merge and emit
     sorts, which must equal
     `hbm_sort`'s result element for element and the plain version on the
     first 2^18 elements, beside `hbm_sort` and stable `torch.sort`; and
     the narrow probe over the 10M tables' buffers, beside `torch.aminmax`
     of each buffer; and the fused keys over the 10M tables, beside their
     plain version and their bound;
  4. the query at 100k rows/table through `QueryPipeline.run_csv`: rows and
     CSV bytes equal the numpy oracle's;
  5. the fused query at 10M rows/table through `run_tables` (the main
     path): the whole output buffer equals the plain path on CPU tensors;
  6. the same at 1M rows/table with keys offset by 2^40 (64-bit keys);
  7. the staged inner join at 10M rows/table (duplicate keys, the
     `hbm_sort` table sorts), then at 2M rows/table with the bitonic table
     sorts, each against the plain path on CPU tensors;
  8. the hash paths (`join_algorithm="hash"`) at 10M rows/table: first
     their kernels at the shapes the 1:1 hash join gives them (the hash
     mixes, the 20M wide merge sort of int64 hashes and positions, the
     20M int64 join scan pair, the 10M x 7 int64 restore sort, a 10M hash
     row sort), then the 1:1 hash join on the fused query's tables and the
     hash inner join on the staged query's, each against the plain path;
  9. `hash_aggregate` over a 10M table for each aggregate, `merge_tree` of
     8 sorted runs to 10M rows, `run_tables_resumable` at 2M rows/table
     (run, then resume from the saved sorted stage) and the 100k CSV query
     with `debug_log` on, whose events must agree with the result; each
     against the plain path on CPU tensors;
 10. the other element types at 10M rows/table on the int64 queries'
     kernels: the fused 1:1 query on uint64 tables (keys + 2^63, predicate
     + 2^63) and on float64 tables, the 1:1 hash join on the float64
     tables, the staged inner join on uint64 tables (path A's, keys +
     2^63), each equal to its int64 query's rows with the same key shift;
 11. `run_csv` at 10M rows/table from CSV files written by the native
     formatter, stage by stage (the native parser must have read them),
     and the native parse beside the numpy one;
 12. small tables of edge keys (±0.0, ±inf, NaN, subnormals, the unsigned
     extremes, 2^63 ± 1) through the filter, both table sorts,
     `stable_key_sort`, every join path, `hash_aggregate` and
     `merge_sorted`, equal to the plain path on CPU tensors;
 13. the command line (`runner.cli run`: default, ``--dtype float64``,
     ``--join-algorithm hash``, ``--profile``) and the launcher
     (`runner.run`) as subprocesses on the 100k pair, every output equal;
 13b. the entry points (`entry.py`) and the examples
     (`examples/`): `entry(n)`'s fused step at 4096 and 10M rows/table,
     equal to `pipeline_oracle` with exactly the fused path's kernels,
     timed; `concat_tables` on the card equal to the CPU's;
     `dryrun_multichip(4)` on 4 Gloo ranks sharing cuda:0; each of
     the five examples with ``--device cuda``, every returned value equal
     to the same example on the CPU (run in worker processes meanwhile);
 14. the multi-device engine (`engine/distributed.py`): (a) NCCL at world
     size 1 in this process, the fused 1:1 query on the phase 5 tables
     through `DistributedQueryPipeline`, equal to `QueryPipeline.run_tables`
     row for row; (b) 4 ranks spawned on cuda:0 in one Gloo group (NCCL
     takes one rank per card; Gloo takes the CUDA tensors and stages them
     through the host): range 1:1, hash 1:1, inner join (path A's tables)
     and `run_aggregate` at 10M rows/table, Zipf keys 1:1 and inner with
     heavy hitters at 2M, the inner join with the bitonic table sorts
     (``sort_algorithm="pallas_bitonic"``) at 2M, `run_tables_resumable`
     then a resume at 2M, each
     equal to the single-device rows (in order for range partitioning, as a
     multiset otherwise), every key on one rank (heavy keys excepted), each
     rank's rows in key order; per rank the exchange and the local join by
     CUDA events, the whole query by host clock between barriers, rows and
     bytes exchanged, the exchange's bound over the Gloo route's measured
     rate, and peak memory.
Each path runs with the launch counts set to 0 just before and read just
after: exactly the kernels of that path must have run (on every rank).

Each kernel's record carries its time, its plain version's, the time of the
one PyTorch call that computes the same function where there is one
(`library_ms`; the port never calls it), and its bound: the larger of the
bytes it must move (inputs read once, outputs written once; for a gather
the rows that this run's live count has it read) over 3.35 TB/s and its
compares over 33.5e12/s (the H100's 67 TFLOP/s of float32 outside the
tensor cores, one integer operation where a fused multiply-add counts two).

The last three lines are the kernels' JSON record, the card's name and
power limit, and the result JSON. Without a CUDA device, or without the
package beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
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


def element_edge_cases(rng):
    """`sort_cases` for each element kind of `hbm_sort` at the run and tile
    edges: run - 1, run, run + 1, a lone last run, a tile more than a run,
    all keys equal, INT32_MIN and INT32_MAX keys beside sentinels, and a
    2-key sort whose second key is not arange."""
    from pim_sort_merge_join_tpu_torch.ops.kernels.hbm_sort import RUN, TILE

    i32, i64max = np.iinfo(np.int32), np.iinfo(np.int64).max
    extremes = np.array([i32.min, i32.min + 1, -1, 0, i32.max - 1, i32.max], np.int32)

    def key32(n, lo=-(1 << 30), hi=1 << 30):
        return rng.integers(lo, hi, n).astype(np.int32)

    cases = []
    for n in (RUN - 1, RUN, RUN + 1, RUN + TILE, 2 * RUN + 5):
        iota = np.arange(n, dtype=np.int32)
        cases.append((f"packed32_{n}", [key32(n, 0, 50), rng.integers(-(2**62), 2**62, n)], 1))
        cases.append((f"pair32_{n}", [key32(n, -3, 3), rng.permutation(n).astype(np.int32)], 2))
        cases.append((f"wide_pair_{n}", [key32(n, -3, 3), key32(n, -5, 5),
                                         rng.integers(0, 10**12, n)], 2))
        cases.append((f"wide_i64_{n}", [rng.integers(-(2**60), 2**60, n), iota], 1))
        cases.append((f"wide_i64_arange_{n}", [rng.integers(-4, 4, n), iota.astype(np.int64),
                                               key32(n)], 2))
    n = 2 * RUN + 5
    iota = np.arange(n, dtype=np.int32)
    cases.append(("packed32_all_equal", [np.full(n, 7, np.int32), iota], 1))
    cases.append(("pair32_all_equal", [np.full(n, -7, np.int32), np.full(n, 3, np.int32)], 2))
    cases.append(("wide_i64_all_equal", [np.full(n, -(2**40)), iota], 1))
    cases.append(("packed32_extremes", [rng.choice(extremes, n), iota], 1))
    cases.append(("pair32_extremes", [rng.choice(extremes, n), rng.choice(extremes, n)], 2))
    cases.append(("wide_pair_extremes", [rng.choice(extremes, n), rng.choice(extremes, n), iota], 2))
    wide = rng.choice(np.array([-i64max - 1, -1, 0, 2**40, i64max - 1, i64max]), n)
    cases.append(("wide_i64_extremes", [wide, iota], 1))
    cases.append(("pair32_second_key_not_arange", [key32(n, 0, 9), key32(n, -(2**31), 2**31 - 1)], 2))
    return cases


def sort_cases(rng):
    """(name, operands as numpy arrays, num_keys)."""
    i32max = np.iinfo(np.int32).max
    cases = element_edge_cases(rng)
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
    """(name, mkeys, mpos, cap1): runs across blocks, dead keys, empty
    sides, lengths at the scan block's edges, one run and a dead tail
    across more than 40 blocks each, and 2^22 random elements."""
    from pim_sort_merge_join_tpu_torch.ops.kernels import join_scan as js

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
    block = js.block_size()
    n = 41 * block + 17
    cases.append(("one_run_41_blocks", np.full(n, 42, np.int64), np.arange(n, dtype=np.int32),
                  17 * block + 3))
    # 60 blocks of which three quarters are dead: a sentinel run of 45 blocks.
    cases.append(("dead_tail_45_blocks",
                  *merged_case(rng, 20 * block, 40 * block, np.arange(1, 9 * block),
                               sentinel_frac=0.75)))
    mk, mp, cap1 = merged_case(rng, 17 * block, 17 * block, np.arange(1, 5 * block))
    for n in (block - 1, block, block + 1, 33 * block + 5):
        # A prefix of a merged sequence is one too.
        cases.append((f"block_edge_{n}", mk[:n].copy(), mp[:n].copy(), cap1))
    cases.append(("random_2^22", *merged_case(rng, 2**21, 2**21, np.arange(1, 3 * 2**21))))
    return cases


def key_widths(mkeys):
    """The keys as int64 and, where every live key fits, as int32 (the
    sentinel is each type's maximum)."""
    i32, i64 = np.iinfo(np.int32), np.iinfo(np.int64)
    if mkeys.dtype == np.int32:
        return [np.where(mkeys == i32.max, i64.max, mkeys.astype(np.int64)), mkeys]
    live = mkeys[mkeys != i64.max]
    if live.size and (live.min() < i32.min or live.max() >= i32.max):
        return [mkeys]
    return [mkeys, np.where(mkeys == i64.max, i32.max, mkeys).astype(np.int32)]


def scan_errs(mk, mp, cap1) -> dict[str, int]:
    """Largest difference of each scan kernel from its own plain half, of
    the pair from the whole plain scan, and of the placement from its plain
    version on the scan's slots, on tensors on the card."""
    from pim_sort_merge_join_tpu_torch.ops.kernels.join_scan import _merged_dest_plain
    from pim_sort_merge_join_tpu_torch.ops.kernels import join_scan as js

    want_fw = js.join_scan_forward_plain(mk, mp, cap1)
    want = _merged_dest_plain(mk, mp, cap1)
    return {
        "scan_forward": max_abs_err(js.join_scan_forward(mk, mp, cap1), want_fw),
        "scan_backward": max_abs_err(js.join_scan_backward(mk, *want_fw),
                                     js.join_scan_backward_plain(mk, *want_fw)),
        "scan": max_abs_err(js.join_scan_cuda(mk, mp, cap1), want),
        "place": place_err(*want, mp, cap1),
    }


def place_err(dest, num_out, mpos, cap1: int) -> int:
    """Largest difference of `place_sources` from its plain version on the
    slots it fills (the first ``num_out`` of each output), as the arrays
    are and one element off their 16-byte alignment."""
    from pim_sort_merge_join_tpu_torch.ops.kernels import join_scan as js

    live = int(num_out)
    want = tuple(s[:live] for s in js.place_sources_plain(dest, mpos, cap1, cap1))
    return max(max_abs_err(tuple(s[:live] for s in js.place_sources(d, p, cap1, cap1)), want)
               for d, p in ((dest, mpos), (one_element_in(dest), one_element_in(mpos))))


I32MIN, I32MAX = np.iinfo(np.int32).min, np.iinfo(np.int32).max


def bitonic_cases(rng):
    """(name, keys, vals) as int32 numpy arrays, for `sort_pairs` (any length)."""
    cases = []
    for n in (1, 255, 256, 300, 1024, 5000, 2**16 + 3, 2**21):
        cases.append((f"random_{n}", rng.integers(0, 1 << 30, n).astype(np.int32),
                      np.arange(n, dtype=np.int32)))
    n = 20000
    iota = np.arange(n, dtype=np.int32)
    cases.append(("few_distinct", rng.integers(0, 4, n).astype(np.int32), iota))
    extremes = np.array([I32MIN, I32MIN + 1, 0, I32MAX - 1, I32MAX], np.int32)
    cases.append(("int32_extremes", rng.choice(extremes, n), iota))
    cases.append(("negative_keys_random_vals", rng.integers(-(1 << 30), 0, n).astype(np.int32),
                  rng.integers(-50, 50, n).astype(np.int32)))
    return cases


def bitonic_width_cases(rng, log_tile: int):
    """(name, keys, vals) of power-of-two length, for the network itself:
    every width from 2 to 2^21, and at half a tile, a tile, two and four
    tiles all keys equal, INT32 extremes with sentinel pairs, descending
    input, and equal ``(key, val)`` pairs."""
    extremes = np.array([I32MIN, I32MIN + 1, -1, 0, I32MAX - 1, I32MAX], np.int32)
    cases = []
    for m in range(1, 22):
        n = 1 << m
        cases.append((f"width_2^{m}", rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32),
                      rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)))
    for m in (log_tile - 1, log_tile, log_tile + 1, log_tile + 2):
        n = 1 << m
        iota = np.arange(n, dtype=np.int32)
        cases.append((f"all_equal_2^{m}", np.full(n, 7, np.int32), rng.permutation(n).astype(np.int32)))
        k, v = rng.choice(extremes, n), rng.choice(extremes, n)
        v[k == I32MAX] = I32MAX  # the padding pair of `sort_pairs`
        cases.append((f"extremes_2^{m}", k, v))
        cases.append((f"descending_2^{m}", iota[::-1].copy(), iota))
        cases.append((f"equal_pairs_2^{m}", rng.integers(0, 3, n).astype(np.int32),
                      rng.integers(0, 3, n).astype(np.int32)))
    return cases


def gather_rows_cases(rng):
    """(name, parts [(src [n, w], idx int32, cols or None)], out width, m,
    live or None): widths 1, 3, 4, 7 of int32 and int64, m != n with repeated
    indices, m at a block's edge, outputs wider than the window, kept columns
    that skip the key, an index shorter than the output, live counts of 0,
    inside and past the output, two tables side by side in one call (a
    join's output), the second index shorter and longer than the output, and
    tables wider than one launch reads (their slices land at odd column
    offsets, on misaligned rows)."""
    cases = []
    variant = 0
    for dtype in (np.int32, np.int64):
        info = np.iinfo(dtype)
        for w in (1, 3, 4, 7):
            for m in (255, 256, 257, 3001):
                n = 1000 + w
                src = rng.integers(info.min, info.max, (n, w)).astype(dtype)
                idx = rng.integers(0, n, m).astype(np.int32)
                cols = None if variant % 2 == 0 or w == 1 else list(range(1, w))
                k = w if cols is None else len(cols)
                out_w = k + (0, 3, 4)[variant % 3]
                live = (None, 0, m // 3, m + 5)[variant % 4]
                short = variant % 5 == 4  # the index ends before the output does
                cases.append((f"{np.dtype(dtype).name}_w{w}_m{m}_v{variant}",
                              [(src, idx[: m - 7] if short else idx, cols)], out_w, m, live))
                variant += 1
        for w1, w2, m, m2, live in ((4, 4, 1000, 1000, 400), (4, 4, 513, 300, None),
                                    (3, 7, 257, 700, 256), (1, 2, 255, 255, None)):
            t1 = rng.integers(info.min, info.max, (777, w1)).astype(dtype)
            t2 = rng.integers(info.min, info.max, (555, w2)).astype(dtype)
            parts = [(t1, rng.integers(0, 777, m).astype(np.int32), None),
                     (t2, rng.integers(0, 555, m2).astype(np.int32), list(range(1, w2)))]
            for pad in (0, 2):  # the windows make up the whole row, or leave columns
                cases.append((f"{np.dtype(dtype).name}_pair_w{w1}_w{w2}_m{m}_pad{pad}", parts,
                              w1 + w2 - 1 + pad, m, live))
        # Rows of more than 64 bytes: one slice past the limit, several slices,
        # kept columns out of order and across slices, beside a narrow table.
        per = 64 // np.dtype(dtype).itemsize
        for w, m, live in ((per + 1, 257, None), (2 * per + 3, 1000, 333), (3 * per, 256, None)):
            wide = rng.integers(info.min, info.max, (600, w)).astype(dtype)
            idx = rng.integers(0, 600, m).astype(np.int32)
            mixed = [w - 1, 0, per, per - 1, 1, w - 2]
            narrow = (rng.integers(info.min, info.max, (90, 3)).astype(dtype),
                      rng.integers(0, 90, m).astype(np.int32), [2, 1])
            name = f"{np.dtype(dtype).name}_wide_w{w}_m{m}"
            cases.append((name, [(wide, idx, None)], w, m, live))
            cases.append((name + "_skip_key", [(wide, idx, list(range(1, w)))], w + 1, m, live))
            cases.append((name + "_mixed_cols", [(wide, idx, mixed)], len(mixed), m, live))
            cases.append((name + "_after_narrow", [narrow, (wide, idx, mixed), narrow],
                          len(mixed) + 4, m, live))
    n = 5000
    src = rng.integers(0, 2**40, (n, 4))
    cases.append(("permutation_4xint64", [(src, rng.permutation(n).astype(np.int32), None)],
                  4, n, None))
    cases.append(("one_row_repeated", [(src, np.full(700, 3, np.int32), [0, 2])], 5, 700, 650))
    return cases


def column_gather_cases(rng):
    """(name, perm uint32 as int32, operands): lengths 4q - 1, 4q and 4q + 1,
    1, 3 and 8 columns of int32 and int64 mixed, and the same arrays offset
    by one element (off the 16-byte alignment)."""
    cases = []
    for n in (1023, 1024, 1025, 3):
        for ncols in (1, 3, 8):
            perm = rng.integers(0, n, n).astype(np.int32)
            ops = [rng.integers(-(2**31), 2**31, n).astype(np.int32) if c % 2 == 0
                   else rng.integers(-(2**62), 2**62, n) for c in range(ncols)]
            cases.append((f"n{n}_c{ncols}", perm, ops))
    return cases


def rows_err(case, device="cuda") -> int:
    """Largest difference of `gather_rows` from its plain version on one case,
    over the whole output, the columns past the window included."""
    import torch

    from pim_sort_merge_join_tpu_torch.ops.kernels import gather as gr

    name, parts, out_w, m, live = case
    parts_t = [(torch.from_numpy(src).to(device), torch.from_numpy(idx).to(device), cols)
               for src, idx, cols in parts]
    live_t = None if live is None else torch.tensor(live, dtype=torch.int32, device=device)
    outs = []
    for fn in (gr.gather_rows, gr.gather_rows_plain):
        out = torch.full((m, out_w), -7, dtype=parts_t[0][0].dtype, device=device)
        outs.append(fn(parts_t, out=out, live=live_t))
    return max_abs_err(outs[:1], outs[1:])


def column_gather_err(case, device="cuda") -> int:
    """`hbm_sort.gather` against indexing, aligned and offset by one element."""
    import torch

    from pim_sort_merge_join_tpu_torch.ops.kernels import hbm_sort as hs

    name, perm, ops = case
    perm_t = torch.from_numpy(perm).to(device)
    ops_t = tuple(torch.from_numpy(o).to(device) for o in ops)
    err = max_abs_err(hs.gather(perm_t, ops_t), tuple(o[perm_t.long()] for o in ops_t))
    if perm.shape[0] > 1:
        # Slices that start one element in: contiguous, but misaligned.
        p1 = perm_t.clone()[1:].copy_(torch.clamp(perm_t[1:] - 1, min=0))
        o1 = tuple(o[1:] for o in ops_t)
        err = max(err, max_abs_err(hs.gather(p1, o1), tuple(o[p1.long()] for o in o1)))
    return err


def radix_cases(rng):
    """(name, operands as int32 numpy arrays, tile, digit_bits, key_bits):
    tiles from 100 to 8192, 1 to 8 operands, 4- and 8-bit digits, 12 to 32
    key bits, sentinels, negative keys with 32 key bits, a tile with one
    digit value in every pass and tiles with one in some."""
    cases = []
    for i, (tile, digit_bits, key_bits) in enumerate(
        (t, d, b) for t in (256, 512, 2048) for d in (4, 8) for b in (20, 32)
    ):
        n = 6 * tile
        lo = 0 if key_bits < 32 else I32MIN  # negative keys sort after the others
        key = rng.integers(lo, 1 << min(key_bits, 31), n).astype(np.int32)
        key[rng.random(n) < 0.1] = I32MAX
        payloads = [rng.integers(I32MIN, I32MAX, n).astype(np.int32),
                    np.arange(n, dtype=np.int32)][: i % 3]
        cases.append((f"t{tile}_d{digit_bits}_b{key_bits}_ops{1 + i % 3}", [key] + payloads,
                      tile, digit_bits, key_bits))

    def payload(n):
        return rng.integers(I32MIN, I32MAX, n).astype(np.int32)

    for tile, digit_bits, key_bits, nops in ((8192, 8, 32, 2), (8192, 8, 25, 3), (128, 8, 32, 2),
                                             (128, 4, 12, 1), (100, 4, 12, 2), (1000, 8, 32, 8),
                                             (4096, 7, 31, 4), (16384, 8, 32, 2)):
        n = 3 * tile
        key = rng.integers(I32MIN if key_bits == 32 else 0, 1 << min(key_bits, 31), n).astype(np.int32)
        key[rng.random(n) < 0.1] = I32MAX
        cases.append((f"t{tile}_d{digit_bits}_b{key_bits}_ops{nops}",
                      [key] + [payload(n) for _ in range(nops - 1)], tile, digit_bits, key_bits))
    # Tile 0 holds one key only, tile 1 one value of the second digit, tile 2
    # keys below 2^8, tile 3 anything.
    tile = 2048
    key = np.concatenate([np.full(tile, 0x1234, np.int32),
                          (rng.integers(0, 256, tile) | 0x5A00 | (rng.integers(0, 99, tile) << 16)),
                          rng.integers(0, 256, tile), rng.integers(I32MIN, I32MAX, tile)]).astype(np.int32)
    cases.append(("one_digit_value_tiles", [key, payload(4 * tile)], tile, 8, 32))
    cases.append(("one_digit_value_tiles_3ops", [key, payload(4 * tile), payload(4 * tile)], tile, 8, 32))
    return cases


def lsd_cases(rng):
    """(name, operands as int32 numpy arrays, digit_bits, key_bits) for the
    global sort: the kinds of keys the blocked plain version is tested on
    (all equal, one digit value in some pass, sentinels, negative keys with
    32 key bits, 12, 25 and 31 key bits, 4-, 7- and 8-bit digits, keys
    alone, three and eight operands, one element), lengths around its tile
    and many tiles."""
    from pim_sort_merge_join_tpu_torch.ops.kernels import radix_sort as rs

    def payload(n):
        return rng.integers(I32MIN, I32MAX, n).astype(np.int32)

    def keys(n, hi, lo=0):
        k = rng.integers(lo, hi, n).astype(np.int32)
        k[rng.random(n) < 0.1] = I32MAX
        return k

    n = 50_000
    one_digit = (rng.integers(0, 256, n) | 0x5A00 | (rng.integers(0, 64, n) << 16)).astype(np.int32)
    cases = [
        ("all_equal", [np.full(n, 7, np.int32), payload(n)], 8, 32),
        ("one_digit_in_the_second_pass", [one_digit, payload(n)], 8, 32),
        ("sentinels_b31", [keys(n, 1 << 20), np.arange(n, dtype=np.int32)], 8, 31),
        ("sentinels_b32_d4", [keys(n, 1 << 20), payload(n)], 4, 32),
        ("negative_keys_b32", [rng.integers(-1000, 1000, n).astype(np.int32), payload(n)], 8, 32),
        ("int32_extremes_b32", [rng.choice(np.array([I32MIN, I32MIN + 1, -1, 0, 1, I32MAX - 1,
                                                     I32MAX], np.int32), n), payload(n)], 8, 32),
        ("key_bits_12", [rng.integers(0, 1 << 12, n).astype(np.int32), payload(n)], 8, 12),
        ("key_bits_12_wider_keys", [keys(n, 1 << 20), payload(n)], 4, 12),
        ("key_bits_25", [rng.permutation(1 << 25)[:n].astype(np.int32), payload(n)], 8, 25),
        ("key_bits_25_d9", [rng.permutation(1 << 25)[:n].astype(np.int32), payload(n)], 9, 25),
        ("key_bits_31_d7", [keys(n, I32MAX), payload(n)], 7, 31),
        ("key_bits_32_d7", [rng.integers(I32MIN, I32MAX, n).astype(np.int32), payload(n)], 7, 32),
        ("key_bits_32_d11", [rng.integers(I32MIN, I32MAX, n).astype(np.int32), payload(n)], 11, 32),
        ("few_distinct_d4", [rng.integers(0, 5, n).astype(np.int32), np.arange(n, dtype=np.int32)], 4, 32),
        ("key_only", [keys(n, 1 << 30, I32MIN)], 8, 32),
        ("three_operands", [keys(n, 50), payload(n), np.arange(n, dtype=np.int32)], 8, 32),
        ("eight_operands", [keys(n, 1 << 14)] + [payload(n) for _ in range(7)], 7, 14),
        ("one_element", [np.array([-5], np.int32), np.array([9], np.int32)], 8, 32),
    ]
    tile = rs.LSD_THREADS * rs.LSD_ITEMS
    for n in (tile - 1, tile, tile + 1, 33 * tile + 5, 1 << 22):
        cases.append((f"n_{n}", [keys(n, 3 * n, -n), payload(n)], 8, 32))
    return cases


PLAIN_LSD_MAX = 1 << 20  # the plain version's [n, 2^digit_bits] one-hot bounds it
PLAIN_LSD_HEAD = 1 << 18  # what of a path's shape it is given here: 0.4 s a sort


def lsd_want(ops, digit_bits: int, key_bits: int):
    """What the global sort must give: the plain version where it can hold
    the input, else a stable `torch.sort` of the bits the passes read."""
    from pim_sort_merge_join_tpu_torch.ops.kernels import radix_sort as rs

    if ops[0].shape[0] <= PLAIN_LSD_MAX:
        return rs.xla_lsd_radix_sort_plain(ops, digit_bits=digit_bits, key_bits=key_bits)
    import torch

    read = -(-key_bits // digit_bits) * digit_bits
    seen = (ops[0].long() & 0xFFFFFFFF) & ((1 << read) - 1)
    order = torch.sort(seen, stable=True).indices
    return tuple(o[order] for o in ops)


def one_element_in(t):
    """The same values one element into a new buffer: contiguous, but off
    the 16-byte alignment."""
    import torch

    return torch.cat([t[:1], t])[1:]


I64MIN, I64MAX = np.iinfo(np.int64).min, np.iinfo(np.int64).max
# The int32 narrowing window's edges and the 64-bit extremes.
PROBE_EDGES = np.array([I64MIN, I64MIN + 1, -(2**31) - 1, -(2**31), 2**31 - 2, 2**31 - 1, 2**31,
                        I64MAX - 1, I64MAX], np.int64)


def probe_table(rng, rows: int, ncol: int, key: int, plant: str):
    """``rows x ncol`` int64 in the int32 window; ``plant`` puts edge values
    at random rows: "key" in the key column, "other" in the other columns
    (all columns when there is no other), "both", or "none"."""
    d = rng.integers(-(2**31), 2**31 - 1, (rows, ncol), dtype=np.int64)
    others = [c for c in range(ncol) if c != key] or [key]
    cols = {"key": [key], "other": others, "both": [key] + others, "none": []}[plant]
    for c in cols:
        for v in rng.choice(PROBE_EDGES, size=min(rows, 3), replace=False):
            d[rng.integers(rows), c] = v
    return d


def probe_cases(rng):
    """The narrow probe's inputs: ``(name, d1, d2, k1, k2)``, numpy, both
    int64 or both uint64 (the int64 bits, so values from 2^63 on). Row
    widths 1, 3, 4 and 7, key columns that differ between the tables,
    element counts that are odd or leave a 16-byte pair split across rows,
    tables of different sizes, edge values in or out of the key columns,
    and tables whose loads cross many blocks."""
    cases = []
    shapes = [((1, 1), (1, 1)), ((3, 7), (5, 3)), ((4, 4), (1001, 999)), ((7, 3), (40_003, 70_001)),
              ((4, 1), (3, 8)), ((1, 4), (70_001, 1)), ((3, 3), (12_345, 7)),
              ((4, 4), (1_000_003, 1_500_001)), ((7, 1), (300_001, 2_000_000))]
    plants = ["key", "other", "both", "none"]
    for i, ((ncol1, ncol2), (rows1, rows2)) in enumerate(shapes):
        for j, (k1, k2) in enumerate(sorted({(0, 0), (ncol1 - 1, 0), (0, ncol2 - 1),
                                             (ncol1 // 2, ncol2 - 1)})):
            plant1, plant2 = plants[(i + j) % 4], plants[(i + 2 * j + 1) % 4]
            d1 = probe_table(rng, rows1, ncol1, k1, plant1)
            d2 = probe_table(rng, rows2, ncol2, k2, plant2)
            name = f"{rows1}x{ncol1} k{k1} {plant1} / {rows2}x{ncol2} k{k2} {plant2}"
            cases.append((name, d1, d2, k1, k2))
            if (i + j) % 2 == 0:
                cases.append((name + " uint64", d1.view(np.uint64), d2.view(np.uint64), k1, k2))
    return cases


def probe_views(t):
    """The same values as ``t`` (a 2D tensor) in other layouts: as it
    is, one element off the 16-byte alignment, every other row of a
    buffer twice as long, columns 1.. of a wider table, and column-major.
    Built on the signed bits of its width (`dtypes.bits`): torch has few
    unsigned ops on CUDA."""
    import torch

    from pim_sort_merge_join_tpu_torch.columnar import dtypes

    b = dtypes.bits(t)
    rows, ncol = b.shape
    flat = b.reshape(-1)
    spaced = torch.zeros((2 * rows, ncol), dtype=b.dtype, device=b.device)
    spaced[::2] = b
    wide = torch.zeros((rows, ncol + 2), dtype=b.dtype, device=b.device)
    wide[:, 1:ncol + 1] = b
    views = {"contiguous": b, "one element in": one_element_in(flat).view(rows, ncol),
             "every other row": spaced[::2], "column slice": wide[:, 1:ncol + 1],
             "column-major": b.t().contiguous().t()}
    return {name: v.view(t.dtype) for name, v in views.items()}


def probe_err(case) -> int:
    """Values of `narrow_extremes_cuda` that differ from the plain
    version's, over every pair of views of the case's tables; one launch a
    call, each on the scratch of the one before."""
    import torch

    from pim_sort_merge_join_tpu_torch.ops import kernels
    from pim_sort_merge_join_tpu_torch.ops.kernels import probe

    name, a1, a2, k1, k2 = case
    d1, d2 = (torch.from_numpy(a).cuda() for a in (a1, a2))
    want = torch.cat(probe.narrow_extremes_plain(d1, d2, k1, k2))
    v1, v2 = probe_views(d1), probe_views(d2)
    err = 0
    for w1, w2 in zip(v1.values(), list(v2.values())[1:] + list(v2.values())[:1]):
        for a, b in ((w1, w2), (v1["contiguous"], w2), (w1, v2["contiguous"])):
            before = kernels.launch_counts()["narrow_extremes"]
            got = torch.cat(probe.narrow_extremes_cuda(a, b, k1, k2))
            check(kernels.launch_counts()["narrow_extremes"] == before + 1,
                  f"narrow_extremes case {name}: not one launch")
            err += int((got != want).sum())
    return err


def probe_error_cases():
    """Calls at the edge of what the plain version takes: ``(name, d1, d2,
    k1, k2)`` as int64 shapes, each an empty buffer or a key column out of
    range, and negative key columns, which it reads from the row's end."""
    return [("empty first", (0, 4), (5, 4), 0, 0), ("empty second", (5, 4), (0, 4), 1, 2),
            ("both empty", (0, 3), (0, 3), 0, 0), ("no columns", (5, 0), (5, 4), 0, 0),
            ("key past the row", (5, 4), (5, 4), 4, 0), ("second key past", (5, 4), (5, 3), 0, 3),
            ("negative key", (5, 4), (5, 4), -1, -4), ("key before the row", (5, 4), (5, 4), -5, 0),
            ("empty, key past", (0, 4), (5, 4), 7, 0)]


def probe_error(case, device) -> tuple[str, str] | None:
    """``(type, message)`` that `narrow_extremes` raises on ``device`` for
    an error case, or None where it returns."""
    import torch

    from pim_sort_merge_join_tpu_torch.ops.kernels.probe import narrow_extremes

    _, s1, s2, k1, k2 = case
    d1, d2 = (torch.arange(np.prod(s), dtype=torch.int64, device=device).view(s) for s in (s1, s2))
    try:
        narrow_extremes(d1, d2, k1, k2)
    except Exception as e:  # noqa: BLE001 - the error itself is compared
        return type(e).__name__, str(e)
    return None


KEYS_OPS = (">", ">=", "<", "<=", "==", "!=")
# The pairs of table types the fused keys take: each type with itself, and
# mixed pairs that `dtypes.promote` takes to int64, uint64, float32 and
# float64.
KEYS_TYPES = [("int64", "int64"), ("uint64", "uint64"), ("int32", "int32"), ("uint32", "uint32"),
              ("float32", "float32"), ("float64", "float64"), ("int32", "int64"),
              ("uint32", "int64"), ("int32", "uint32"), ("uint32", "uint64"), ("int32", "uint64"),
              ("int64", "uint64"), ("int64", "float32"), ("uint64", "float64"),
              ("float32", "float64"), ("uint32", "float32"), ("float64", "int32")]
KEYS_FLOAT_EDGES = [np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1.5, -1.5, 2.0**24 + 1, 2.0**31,
                    -(2.0**31) - 1, 2.0**53 + 1, 2.0**63, 1e-30, 1e30, 1e300]
# 8-byte integers that a float32 rounds differently from a float64 rounded
# on to float32 (just above half a float32 step past 2^60, and its
# neighbours in uint64), and one a float64 does not hold.
KEYS_ROUNDING = np.array([2**60 + 2**36 + 1, -(2**60 + 2**36 + 1), 2**60 + 2**36, 2**53 + 1,
                          -(2**63) + 2**39 + 1], np.int64)
KEYS_INT32_EDGES = np.array([-(2**31), -(2**31) + 1, -1, 0, 1, 2**31 - 2, 2**31 - 1], np.int32)


def keys_table(rng, rows: int, ncol: int, dtype):
    """``rows x ncol`` of ``dtype`` with edge values planted: 8-byte
    integers from `probe_table`'s int64 bits, three edges a column, and
    `KEYS_ROUNDING` in one row in 64; 4-byte integers from int32 bits with
    the int32 edges (as uint32, 2^31 and its neighbours), and floats small
    integers and halves with NaN, the infinities, both zeros, the smallest
    subnormal, the type's largest value and values past the integers it
    holds exactly, in about one row in eight of every column."""
    dt = np.dtype(dtype)
    if dt.kind in "iu" and dt.itemsize == 8:
        d = probe_table(rng, rows, ncol, 0, "both")
        at = rng.integers(rows, size=(max(1, rows // 64), 2))
        d[at[:, 0], at[:, 1] % ncol] = rng.choice(KEYS_ROUNDING, size=at.shape[0])
        return d.view(dt)
    if dt.kind in "iu":
        d, edges = rng.integers(-(2**31), 2**31, (rows, ncol)).astype(np.int32), KEYS_INT32_EDGES
    else:
        info = np.finfo(dt)
        d = (rng.integers(-200, 200, (rows, ncol)) / 2).astype(dt)
        edges = np.array([v for v in KEYS_FLOAT_EDGES if not np.isfinite(v) or abs(v) <= float(info.max)]
                         + [info.smallest_subnormal, info.max, -info.max], dt)
    for c in range(ncol):  # an edge value in about one row in eight, three at least
        at = rng.integers(rows, size=max(3, rows // 8))
        d[at, c] = rng.choice(edges, size=at.shape[0])
    return d.view(dt)


def keys_cases(rng):
    """The fused keys' inputs: ``(name, d1, d2, n1, n2, p1, p2, k1, k2)``:
    numpy tables of a pair of `KEYS_TYPES` (`keys_table`), each table's
    row count, predicate ``(col, op, value)`` and key column. Every shape
    takes int64 tables and two other pairs in turn, so that every pair
    appears. Capacities odd, even and off a multiple of 16 (the output's
    spans straddle the tables' boundary), row counts 0, 1, the capacity
    and between, rows of 1, 3, 4 and 7, predicate columns other than the
    key's (but in one pair a shape), every operator, each value one of the table's own (a NaN
    among them), and tables across many blocks; then each pair again, with
    most rows valid."""
    cases = []
    shapes = [((1, 1), (1, 1)), ((3, 7), (5, 3)), ((4, 4), (1001, 999)), ((7, 3), (40_003, 70_001)),
              ((4, 1), (3, 8)), ((1, 4), (70_001, 1)), ((4, 4), (17, 16)),
              ((4, 4), (1_000_003, 1_500_001)), ((7, 1), (300_001, 2_000_000))]
    others = KEYS_TYPES[1:]
    for i, ((ncol1, ncol2), (cap1, cap2)) in enumerate(shapes):
        pairs = [KEYS_TYPES[0], others[(2 * i) % len(others)], others[(2 * i + 1) % len(others)]]
        for j, (ty1, ty2) in enumerate(pairs):
            d1, d2 = keys_table(rng, cap1, ncol1, ty1), keys_table(rng, cap2, ncol2, ty2)
            n1 = (0, 1, cap1, cap1 // 2)[(i + j) % 4]
            n2 = (cap2, cap2 // 3, 0, 1)[(i + 2 * j) % 4]
            k1, k2 = int(rng.integers(-ncol1, ncol1)), int(rng.integers(ncol2))
            preds = []
            for d, k, t in ((d1, k1, 3 * i + j), (d2, k2, 3 * i + j + 3)):
                ncol = d.shape[1]
                col = int(rng.integers(-ncol, ncol))
                if j != 1 and ncol > 1:  # another column than the key's, from either end
                    col = (k + int(rng.integers(1, ncol))) % ncol - ncol * int(rng.integers(2))
                preds.append((col, KEYS_OPS[t % 6], d[rng.integers(d.shape[0]), col].item()))
            name = (f"{cap1}x{ncol1} {ty1} {n1} rows {preds[0]} k{k1} / {cap2}x{ncol2} {ty2} "
                    f"{n2} rows {preds[1]} k{k2}")
            cases.append((name, d1, d2, n1, n2, *preds, k1, k2))
    for i, (ty1, ty2) in enumerate(KEYS_TYPES):  # each pair with most rows valid
        d1, d2 = keys_table(rng, 3001, 4, ty1), keys_table(rng, 2999, 3, ty2)
        preds = [(c, KEYS_OPS[(i + t) % 6], d[rng.integers(d.shape[0]), c].item())
                 for t, (d, c) in enumerate(((d1, 1), (d2, -1)))]
        name = f"3001x4 {ty1} / 2999x3 {ty2} {preds}"
        cases.append((name, d1, d2, 2990, 2999, *preds, 0, 0))
    return cases


def keys_err(case) -> int:
    """Keys of `join_keys_cuda` that differ from the plain version's on the
    CPU, narrow and wide, over pairs of views of the case's tables
    (`probe_views`); one launch a call."""
    import torch

    from pim_sort_merge_join_tpu_torch import Predicate, Table
    from pim_sort_merge_join_tpu_torch.ops import kernels
    from pim_sort_merge_join_tpu_torch.ops.kernels import keys

    name, a1, a2, n1, n2, p1, p2, k1, k2 = case
    h1, h2 = torch.from_numpy(a1), torch.from_numpy(a2)
    c1, c2 = (torch.tensor(n, dtype=torch.int32) for n in (n1, n2))
    r1, r2 = c1.cuda(), c2.cuda()
    p1, p2 = Predicate(*p1), Predicate(*p2)
    v1, v2 = probe_views(h1.cuda()), probe_views(h2.cuda())
    err = 0
    for narrow in (False, True):
        want = keys.join_keys_plain(Table(h1, c1), Table(h2, c2), p1, p2, k1, k2, narrow)
        for w1, w2 in zip(v1.values(), list(v2.values())[1:] + list(v2.values())[:1]):
            for a, b in ((w1, w2), (v1["contiguous"], w2), (w1, v2["contiguous"])):
                before = kernels.launch_counts()["join_keys"]
                got = keys.join_keys_cuda(Table(a, r1), Table(b, r2), p1, p2, k1, k2, narrow).cpu()
                check(kernels.launch_counts()["join_keys"] == before + 1,
                      f"join_keys case {name}: not one launch")
                check(got.dtype == want.dtype and got.shape == want.shape,
                      f"join_keys case {name}: {got.dtype} {tuple(got.shape)}, the plain version "
                      f"{want.dtype} {tuple(want.shape)}")
                err += int((got != want).sum())
    return err


def keys_error_cases():
    """Calls at the edge of what the plain version takes, on one 5 x 4
    table of 4 rows: ``(name, dtype, p1, p2, k1, k2)``, each predicate
    ``(col, op, value)``: values past the type's range, columns before and
    past the row, an unknown operator, and two faults in one call, of which
    the plain version raises the first."""
    nan = float("nan")
    return [
        ("value past int64", "int64", (0, ">", 2**63), (0, ">", 0), 0, 0),
        ("value below int64", "int64", (0, ">", 0), (1, "<", -(2**63) - 1), 0, 0),
        ("value past uint64", "uint64", (0, ">", 2**64), (0, ">", 0), 0, 0),
        ("negative uint64 value", "uint64", (0, ">", 0), (0, "!=", -1), 0, 0),
        ("value past int32", "int32", (0, ">", 2**31), (0, ">", 0), 0, 0),
        ("NaN for int32", "int32", (0, ">", 0), (2, "==", nan), 0, 0),
        ("value past uint32", "uint32", (0, "<", 2**32), (0, ">", 0), 0, 0),
        ("huge value for int64", "int64", (0, ">=", 1e30), (0, ">", 0), 0, 0),
        ("predicate column past the row", "int64", (4, ">", 0), (0, ">", 2**64), 0, 0),
        ("predicate column before the row", "uint64", (-5, ">", 0), (0, ">", 0), 0, 0),
        ("unknown operator", "int64", (0, "<>", 0), (0, ">", 0), 0, 0),
        ("unknown operator on floats", "float32", (0, ">", 0), (0, "=", 1.5), 0, 0),
        ("key column past the row", "int64", (0, ">", 0), (0, ">", 0), 4, 0),
        ("second key before the row", "uint64", (0, ">", 0), (0, ">", 0), 0, -5),
        ("float key past the row", "float64", (0, ">", 0), (0, ">", 0), 0, 4),
        ("bad value before bad keys", "int64", (0, ">", 2**70), (0, ">", 0), 9, 9),
        ("negative columns", "uint64", (-1, "<=", 2**63 + 9), (-4, ">=", 3), -1, -2),
    ]


def keys_error(case, device) -> tuple[str, str] | None:
    """``(type, message)`` that `join_keys` raises on ``device`` for an
    error case, or None where it returns."""
    import torch

    from pim_sort_merge_join_tpu_torch import Predicate, Table
    from pim_sort_merge_join_tpu_torch.ops.kernels import keys

    _, dtype, p1, p2, k1, k2 = case
    d = torch.from_numpy(np.arange(20).reshape(5, 4).astype(dtype)).to(device)
    t = Table(d, torch.tensor(4, dtype=torch.int32, device=device))
    try:
        keys.join_keys(t, t, Predicate(*p1), Predicate(*p2), k1, k2, True)
    except Exception as e:  # noqa: BLE001 - the error itself is compared
        return type(e).__name__, str(e)
    return None


def plain_sort_pairs(keys, vals):
    """`sort_pairs` with the plain network, on the tensors' own device."""
    import torch

    from pim_sort_merge_join_tpu_torch.ops.kernels import bitonic_sort as bs

    n = keys.shape[0]
    pad = torch.full((max(bs._next_pow2(n), bs.MIN_WIDTH) - n,), I32MAX, dtype=torch.int32,
                     device=keys.device)
    k, v = bs.bitonic_sort_plain(torch.cat([keys, pad]), torch.cat([vals, pad]))
    return k[:n], v[:n]


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

    from pim_sort_merge_join_tpu_torch.ops.kernels import bitonic_sort as bs
    from pim_sort_merge_join_tpu_torch.ops.kernels import hbm_sort as hs
    from pim_sort_merge_join_tpu_torch.ops.kernels import radix_sort as rs

    errs = {"sort": 0, "scan": 0, "scan_forward": 0, "scan_backward": 0, "place": 0, "bitonic": 0,
            "radix": 0, "lsd": 0, "gather_rows": 0, "gather": 0, "probe": 0, "keys": 0}
    sorts, scans = sort_cases(rng), scan_cases(rng)
    bitonics, radixes, lsds = bitonic_cases(rng), radix_cases(rng), lsd_cases(rng)
    widths = bitonic_width_cases(rng, bs.LOG_TILE)
    rows, columns = gather_rows_cases(rng), column_gather_cases(rng)
    probes, keyses = probe_cases(rng), keys_cases(rng)
    for case in keyses:
        err = keys_err(case)
        check(err == 0, f"join_keys case {case[0]}: kernel differs from plain ({err} keys)")
        errs["keys"] = max(errs["keys"], err)
    for case in keys_error_cases():
        got, want = keys_error(case, "cuda"), keys_error(case, "cpu")
        check(got == want, f"join_keys error case {case[0]}: {got}, the plain version {want}")
    for case in probes:
        err = probe_err(case)
        check(err == 0, f"narrow_extremes case {case[0]}: kernel differs from plain ({err} values)")
        errs["probe"] = max(errs["probe"], err)
    for case in probe_error_cases():
        got, want = probe_error(case, "cuda"), probe_error(case, "cpu")
        check(got == want, f"narrow_extremes error case {case[0]}: {got}, the plain version {want}")
    for case in rows:
        err = rows_err(case)
        check(err == 0, f"gather_rows case {case[0]}: kernel differs from plain (max err {err})")
        errs["gather_rows"] = max(errs["gather_rows"], err)
    for case in columns:
        err = column_gather_err(case)
        check(err == 0, f"column gather case {case[0]}: kernel differs from plain (max err {err})")
        errs["gather"] = max(errs["gather"], err)
    for name, keys, vals in widths:
        k, v = torch.from_numpy(keys).cuda(), torch.from_numpy(vals).cuda()
        want = bs.bitonic_sort_plain(k, v)
        err = max(max_abs_err(bs.bitonic_sort_cuda(k, v), want),
                  # Offset by one element: off the kernel's 16-byte alignment.
                  max_abs_err(bs.bitonic_sort_cuda(torch.cat([k[:1], k])[1:],
                                                   torch.cat([v[:1], v])[1:]), want))
        check(err == 0, f"bitonic case {name}: kernel differs from plain (max err {err})")
        errs["bitonic"] = max(errs["bitonic"], err)
    for name, arrays, num_keys in sorts:
        ops = tuple(torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in arrays)
        err = max_abs_err(hs.hbm_sort(ops, num_keys), hs.hbm_sort_plain(ops, num_keys))
        check(err == 0, f"hbm_sort case {name}: kernel differs from plain (max err {err})")
        errs["sort"] = max(errs["sort"], err)
    for name, mkeys, mpos, cap1 in scans:
        mp = torch.from_numpy(mpos).cuda()
        for keys in key_widths(mkeys):
            for which, err in scan_errs(torch.from_numpy(keys).cuda(), mp, cap1).items():
                check(err == 0, f"join_scan case {name}, {keys.dtype} keys: {which} differs "
                                f"from plain (max err {err})")
                errs[which] = max(errs[which], err)
    for name, keys, vals in bitonics:
        k, v = torch.from_numpy(keys).cuda(), torch.from_numpy(vals).cuda()
        err = max_abs_err(bs.sort_pairs(k, v), plain_sort_pairs(k, v))
        check(err == 0, f"bitonic case {name}: kernel differs from plain (max err {err})")
        errs["bitonic"] = max(errs["bitonic"], err)
    for name, arrays, tile, digit_bits, key_bits in radixes:
        ops = tuple(torch.from_numpy(a).cuda() for a in arrays)
        kw = dict(tile=tile, digit_bits=digit_bits, key_bits=key_bits)
        want = rs.radix_tile_sort_plain(ops, **kw)
        err = max(max_abs_err(rs.radix_tile_sort(ops, **kw), want),
                  max_abs_err(rs.radix_tile_sort(tuple(one_element_in(o) for o in ops), **kw), want))
        check(err == 0, f"radix case {name}: kernel differs from plain (max err {err})")
        errs["radix"] = max(errs["radix"], err)
    for name, arrays, digit_bits, key_bits in lsds:
        ops = tuple(torch.from_numpy(a).cuda() for a in arrays)
        kw = dict(digit_bits=digit_bits, key_bits=key_bits)
        want = lsd_want(ops, **kw)
        err = max(max_abs_err(rs.xla_lsd_radix_sort(ops, **kw), want),
                  max_abs_err(rs.xla_lsd_radix_sort(tuple(one_element_in(o) for o in ops), **kw), want))
        check(err == 0, f"global radix sort case {name}: kernels differ from plain (max err {err})")
        errs["lsd"] = max(errs["lsd"], err)
    torch.cuda.synchronize()
    log(f"adversarial: {len(sorts)} sort, {len(scans)} scan, {len(bitonics)} + {len(widths)} "
        f"bitonic, {len(radixes)} radix tile, {len(lsds)} global radix, {len(rows)} row gather, "
        f"{len(columns)} column gather, {len(probes)} + {len(probe_error_cases())} narrow probe, "
        f"{len(keyses)} + {len(keys_error_cases())} fused keys cases equal")
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


HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
INT_OPS_PER_S = 33.5e12  # 67 TFLOP/s float32 outside the tensor cores / 2


def bound(nbytes: float, compares: float = 0.0) -> dict:
    """The least time the card could take: bytes moved once over the memory
    rate, or the compares over the integer rate, whichever is larger."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, compares / INT_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def time_sort(rec: dict, name: str, ops: tuple, num_keys: int, whole=None, inputs=None) -> None:
    """One main-path sort: the whole sort against `hbm_sort_plain` of
    ``ops`` (exact), phase A and phase B alone, and stable `torch.sort` of
    the key alone as the library's time. ``whole`` is the path's call
    (`hbm_sort` of ``ops`` by default) and ``inputs`` what it reads
    (``ops``); the bound reads those once and writes its result once."""
    import torch

    from pim_sort_merge_join_tpu_torch.ops.kernels import hbm_sort as hs

    n = ops[0].shape[0]
    kind = hs.element_kind(ops, num_keys)
    k0, k1 = hs.key_operands(ops, kind)
    sort = whole or (lambda _=None: hs.hbm_sort(ops, num_keys))
    got = sort()
    rec[f"{name}_err"] = max_abs_err(got, hs.hbm_sort_plain(ops, num_keys))
    rec[f"{name}_ms"] = time_ms(sort)
    rec[f"{name}_plain_ms"] = time_ms(lambda _: hs.hbm_sort_plain(ops, num_keys))
    rec[f"{name}_library_ms"] = time_ms(lambda _: torch.sort(ops[0], stable=True))
    rec[f"{name}_phase_a_ms"] = time_ms(lambda _: hs.chunk_sort(k0, k1, kind))
    runs = hs.chunk_sort(k0, k1, kind)
    rec[f"{name}_phase_b_ms"] = time_ms(
        lambda kv: hs.merge_passes(*kv, kind, n),
        setup=lambda: tuple(None if t is None else t.clone() for t in runs),
    )
    rec[f"{name}_bound_ms"] = bound(nbytes(*(ops if inputs is None else inputs)) + nbytes(*got))["bound_ms"]


def time_scan(rec: dict, prefix: str, mkeys, mpos, cap1: int) -> None:
    """The two scan kernels on one merged input: each against its own plain
    half and the pair against the whole plain scan (exact), their times,
    the plain versions' and the bounds."""
    from pim_sort_merge_join_tpu_torch.ops.kernels.join_scan import _merged_dest_plain
    from pim_sort_merge_join_tpu_torch.ops.kernels import join_scan as js

    n = mkeys.shape[0]
    errs = scan_errs(mkeys, mpos, cap1)
    rec[f"{prefix}forward_err"] = errs["scan_forward"]
    rec[f"{prefix}backward_err"] = errs["scan_backward"]
    rec[f"{prefix}scan_err"] = errs["scan"]
    rec[f"{prefix}place_err"] = errs["place"]
    cand, m2 = js.join_scan_forward(mkeys, mpos, cap1)
    dest, _ = js.join_scan_backward(mkeys, cand, m2)
    rec[f"{prefix}scan_n"] = n
    rec[f"{prefix}scan_plain_ms"] = time_ms(lambda _: _merged_dest_plain(mkeys, mpos, cap1))
    rec[f"{prefix}forward_ms"] = time_ms(lambda _: js.join_scan_forward(mkeys, mpos, cap1))
    rec[f"{prefix}forward_plain_ms"] = time_ms(lambda _: js.join_scan_forward_plain(mkeys, mpos, cap1))
    rec[f"{prefix}backward_ms"] = time_ms(lambda _: js.join_scan_backward(mkeys, cand, m2))
    rec[f"{prefix}backward_plain_ms"] = time_ms(lambda _: js.join_scan_backward_plain(mkeys, cand, m2))
    rec[f"{prefix}forward_bound"] = bound(nbytes(mkeys, mpos, cand, m2), compares=4 * n)
    rec[f"{prefix}backward_bound"] = bound(nbytes(mkeys, cand, m2, dest), compares=4 * n)
    for which in ("forward_err", "backward_err", "scan_err", "place_err"):
        check(rec[prefix + which] == 0,
              f"main-path shape {prefix}{which} = {rec[prefix + which]}: kernel differs from plain")


def time_place(rec: dict, dest, num_out, mpos, cap1: int) -> None:
    """The placement over the query's merged elements: its time, its plain
    version's, its bound (``dest`` and ``mpos`` read, one int32 written per
    matched element of each side) and, as the library's, one `index_put_`
    of the matched elements alone at slots computed beforehand."""
    import torch

    from pim_sort_merge_join_tpu_torch.ops.kernels import join_scan as js

    live = int(num_out)
    matched = dest < cap1
    side2 = (mpos >= cap1).to(torch.int32)
    slot = (dest + side2 * cap1)[matched].long()
    vals = (mpos - side2 * cap1)[matched]
    buf = torch.empty(2 * cap1, dtype=torch.int32, device=dest.device)
    rec["place_ms"] = time_ms(lambda _: js.place_sources(dest, mpos, cap1, cap1), reps=9)
    rec["place_plain_ms"] = time_ms(lambda _: js.place_sources_plain(dest, mpos, cap1, cap1))
    rec["place_library_ms"] = time_ms(lambda _: buf.index_put_((slot,), vals), reps=9)
    rec["place_bound"] = bound(nbytes(dest, mpos) + 2 * 4 * live)


def phase_probe_shape(r1, r2) -> dict:
    """The narrow probe over the fused query's two table buffers: equal to
    its plain version, launched once a call; its time, the plain version's,
    `torch.aminmax` of each buffer (the library's; it finds the values'
    extremes alone) and its bound, both buffers read once. The kernel and
    the library call are timed 20 calls back to back, per call (median of
    9), so that the wrapper's host time, which the card hides behind the
    launch before, does not count."""
    import torch

    from pim_sort_merge_join_tpu_torch import Table
    from pim_sort_merge_join_tpu_torch.ops import kernels
    from pim_sort_merge_join_tpu_torch.ops.kernels import probe

    d1, d2 = Table.from_numpy(r1).data, Table.from_numpy(r2).data
    want = torch.cat(probe.narrow_extremes_plain(d1, d2, 0, 0))
    before = kernels.launch_counts()["narrow_extremes"]
    err = 0
    for _ in range(20):  # each launch on the scratch the one before left
        err += int((torch.cat(probe.narrow_extremes_cuda(d1, d2, 0, 0)) != want).sum())
    check(err == 0, f"narrow_extremes at the query's shape: {err} values differ from plain")
    check(kernels.launch_counts()["narrow_extremes"] == before + 20,
          "narrow_extremes: not one launch a call")
    def per_call(fn):
        return time_ms(lambda _: [fn() for _ in range(20)], reps=9) / 20

    rec = {"err": err, "shape": [list(d1.shape), list(d2.shape)],
           "ms": per_call(lambda: probe.narrow_extremes_cuda(d1, d2, 0, 0)),
           "plain_ms": time_ms(lambda _: probe.narrow_extremes_plain(d1, d2, 0, 0)),
           "library_ms": per_call(lambda: (torch.aminmax(d1), torch.aminmax(d2))),
           **bound(nbytes(d1, d2))}
    log("narrow probe at the query's shape: " + json.dumps(rec))
    return rec


def phase_keys_shape(r1, r2, cfg) -> dict:
    """The fused keys over the 10M query's two tables, narrowed as the
    query resolves them: equal to the plain version, launched once a call;
    the kernel's time (20 calls back to back, per call, so that the
    wrapper's host time, which the card hides behind the launch before,
    does not count; CUDA events, median of 9), one call alone, the plain
    version's and the bound: each table's rows read once (a 32-byte row is
    one sector, which holds the key and predicate columns) and the keys
    written once."""
    import torch

    from pim_sort_merge_join_tpu_torch import Table
    from pim_sort_merge_join_tpu_torch.ops import kernels
    from pim_sort_merge_join_tpu_torch.ops.kernels import keys

    t1, t2 = Table.from_numpy(r1), Table.from_numpy(r2)
    args = (t1, t2, cfg.predicate1, cfg.predicate2, cfg.join_key1, cfg.join_key2, True)
    want = keys.join_keys_plain(*args)
    before = kernels.launch_counts()["join_keys"]
    err = sum(int((keys.join_keys_cuda(*args) != want).sum()) for _ in range(20))
    check(err == 0, f"join_keys at the query's shape: {err} keys differ from plain")
    check(kernels.launch_counts()["join_keys"] == before + 20, "join_keys: not one launch a call")
    rec = {"err": err, "shape": [list(t1.data.shape), list(t2.data.shape)], "dtype": str(want.dtype),
           "ms": time_ms(lambda _: [keys.join_keys_cuda(*args) for _ in range(20)], reps=9) / 20,
           "one_call_ms": time_ms(lambda _: keys.join_keys_cuda(*args), reps=9),
           "plain_ms": time_ms(lambda _: keys.join_keys_plain(*args), reps=9),
           **bound(nbytes(t1.data, t2.data, want))}
    log("fused keys at the query's shape: " + json.dumps(rec))
    return rec


def wide_merged_keys():
    """The merge sort's output in the 1M-rows/table query with keys offset
    by 2^40: 2M int64 keys, their positions and cap1, on the card."""
    import torch

    from pim_sort_merge_join_tpu_torch import Table
    from pim_sort_merge_join_tpu_torch.columnar.table import key_sentinel
    from pim_sort_merge_join_tpu_torch.ops import filter as filter_ops
    from pim_sort_merge_join_tpu_torch.ops.kernels import hbm_sort as hs

    r1, r2, cfg = slice_inputs(1_000_000, key_offset=2**40)
    t1, t2 = Table.from_numpy(r1), Table.from_numpy(r2)
    sent = key_sentinel(t1.dtype)
    k1 = torch.where(filter_ops.predicate_mask(t1, cfg.predicate1), t1.data[:, 0], sent)
    k2 = torch.where(filter_ops.predicate_mask(t2, cfg.predicate2), t2.data[:, 0], sent)
    mkeys, mpos = hs.sort_key_permutation(torch.cat([k1, k2]))
    return mkeys, mpos, t1.capacity


def phase_main_path_shapes(r1, r2, cfg) -> dict:
    """Each kernel at the shapes the 10M-row query gives it, vs plain."""
    import torch

    from pim_sort_merge_join_tpu_torch import Table
    from pim_sort_merge_join_tpu_torch.columnar.table import key_sentinel
    from pim_sort_merge_join_tpu_torch.ops import filter as filter_ops
    from pim_sort_merge_join_tpu_torch.ops.join import _narrow32
    from pim_sort_merge_join_tpu_torch.ops.kernels import gather as gr
    from pim_sort_merge_join_tpu_torch.ops.kernels import hbm_sort as hs
    from pim_sort_merge_join_tpu_torch.ops.kernels import join_scan as js

    t1 = Table.from_numpy(r1)
    t2 = Table.from_numpy(r2)
    check(t1.device.type == "cuda", f"Table.from_numpy defaults to {t1.device}, not the card")
    cap1, n = t1.capacity, t1.capacity + t2.capacity
    sent = key_sentinel(t1.dtype)
    k1 = torch.where(filter_ops.predicate_mask(t1, cfg.predicate1), t1.data[:, 0], sent)
    k2 = torch.where(filter_ops.predicate_mask(t2, cfg.predicate2), t2.data[:, 0], sent)
    keys = torch.cat([_narrow32(k1), _narrow32(k2)])
    pos = torch.arange(n, dtype=torch.int32, device="cuda")
    rec = {}

    # Merge sort: 2n (int32 key, int32 pos), the pair-32 element.
    merge_ops = (keys, pos)
    mkeys, mpos = hs.hbm_sort(merge_ops, 2)
    time_sort(rec, "merge_sort", merge_ops, 2)
    npad, runs = hs.pass_schedule(n)
    rec["sort_n"], rec["sort_npad"], rec["merge_passes"] = n, npad, len(runs)
    # Kernels 1 and 2 at this shape: phase A reads both keys and writes the
    # elements; phase B (all passes) reads the elements and writes both keys.
    # One PyTorch call for phase A: every run of the packed elements sorted.
    packed = hs.pack_pair32(torch.cat([keys, torch.full((npad - n,), I32MAX, dtype=torch.int32,
                                                        device="cuda")]),
                            torch.arange(npad, dtype=torch.int32, device="cuda"))
    rec["chunk"] = {"ms": rec["merge_sort_phase_a_ms"],
                    "library_ms": time_ms(lambda _: torch.sort(packed.view(-1, hs.RUN), dim=1)),
                    **bound(nbytes(keys, pos) + 8 * npad, compares=13 * npad)}
    del packed
    elements = hs.chunk_sort(keys, pos, hs.KIND_PAIR32)[0]
    rec["merge"] = {"ms": rec["merge_sort_phase_b_ms"],
                    "library_ms": time_ms(lambda _: torch.sort(elements)),
                    **bound(8 * npad + nbytes(mkeys, mpos), compares=len(runs) * npad)}
    del elements

    # Join scan over the merged 2n int32 keys, then over the 1M wide-keys
    # query's 2M int64 keys.
    time_scan(rec, "", mkeys, mpos, cap1)
    dest, num_out = js.join_scan_cuda(mkeys, mpos, cap1)
    rec["num_out"] = int(num_out)
    time_scan(rec, "wide_", *wide_merged_keys())
    time_place(rec, dest, num_out, mpos, cap1)

    # The sorts the placement replaced, at their shapes in the query, kept
    # as its yardstick and as `hbm_sort`'s cases. Un-merge sort: 2n, one
    # unique int32 key and one int32 payload, sorted as two keys
    # (`stable_key_sort`, unique_keys): pair-32, no gather.
    unmerge_ops = (mpos, dest)
    _, dest_by_pos = hs.hbm_sort(unmerge_ops, 2)
    check(max_abs_err((dest_by_pos,), hs.hbm_sort_plain(unmerge_ops, 1)[1:]) == 0,
          "un-merge sort: two keys and one key disagree on a unique key")
    time_sort(rec, "unmerge_sort", unmerge_ops, 2)

    # Emit sort: n1 unique slots whose payload is table 1's rows (4 int64),
    # written into the join's output with zeros from num_out on.
    d1 = dest_by_pos[:cap1]
    d1u = torch.where(d1 >= n, n + torch.arange(cap1, dtype=torch.int32, device="cuda"), d1)
    width = t1.ncol + t2.ncol - 1

    def emit_rows(sort_rows):
        out = torch.empty((cap1, width), dtype=t1.dtype, device="cuda")
        return sort_rows([(d1u, t1.data)], out=out, live=num_out)[:, : t1.ncol]

    def plain_sort_rows(parts, **kw):
        return gr.gather_rows_plain(
            [(rows, hs.hbm_sort_plain((key, torch.arange(key.shape[0], dtype=torch.int32,
                                                         device=key.device)))[1], *cols)
             for key, rows, *cols in parts], **kw)

    rec["emit_sort_err"] = max_abs_err((emit_rows(hs.hbm_sort_rows),), (emit_rows(plain_sort_rows),))
    rec["emit_sort_ms"] = time_ms(lambda _: emit_rows(hs.hbm_sort_rows))
    rec["emit_sort_plain_ms"] = time_ms(lambda _: emit_rows(plain_sort_rows))
    rec["emit_sort_library_ms"] = time_ms(lambda _: torch.sort(d1u, stable=True))
    live = int(num_out)
    rec["emit_sort_bound_ms"] = bound(nbytes(d1u) + live * t1.ncol * 8 + cap1 * t1.ncol * 8)["bound_ms"]
    perm = hs.sort_elements(d1u, d1u, hs.KIND_PACKED32)[1]
    torch.cuda.synchronize()
    for key in ("merge_sort_err", "unmerge_sort_err", "emit_sort_err"):
        check(rec[key] == 0, f"main-path shape {key} = {rec[key]}: kernel differs from plain")
    log("main-path shapes (ms, kernel vs plain vs library): " + json.dumps(rec))
    rec.update(phase_gather_shapes(t1.data, t2.data, perm, num_out))
    rec.update(phase_run_formation(keys, pos))
    rec.update(phase_lsd_shapes(keys, pos, mpos, dest, d1u))
    return rec


def emit_permutation(r1, r2, cfg):
    """The fused 10M query up to its first emit sort, through the kernels:
    ``(table 1's data, table 2's data, the emit sort's permutation,
    num_out)``. For timing the gathers at that shape on their own."""
    import torch

    from pim_sort_merge_join_tpu_torch import Table
    from pim_sort_merge_join_tpu_torch.columnar.table import key_sentinel
    from pim_sort_merge_join_tpu_torch.ops import filter as filter_ops
    from pim_sort_merge_join_tpu_torch.ops.join import _narrow32
    from pim_sort_merge_join_tpu_torch.ops.kernels import hbm_sort as hs
    from pim_sort_merge_join_tpu_torch.ops.kernels import join_scan as js

    t1, t2 = Table.from_numpy(r1), Table.from_numpy(r2)
    cap1, n = t1.capacity, t1.capacity + t2.capacity
    sent = key_sentinel(t1.dtype)
    k1 = torch.where(filter_ops.predicate_mask(t1, cfg.predicate1), t1.data[:, 0], sent)
    k2 = torch.where(filter_ops.predicate_mask(t2, cfg.predicate2), t2.data[:, 0], sent)
    pos = torch.arange(n, dtype=torch.int32, device="cuda")
    mkeys, mpos = hs.hbm_sort((torch.cat([_narrow32(k1), _narrow32(k2)]), pos), 2)
    dest, num_out = js.join_scan_cuda(mkeys, mpos, cap1)
    d1 = hs.hbm_sort((mpos, dest))[1][:cap1]
    d1u = torch.where(d1 >= n, n + torch.arange(cap1, dtype=torch.int32, device="cuda"), d1)
    return t1.data, t2.data, hs.sort_elements(d1u, d1u, hs.KIND_PACKED32)[1], num_out


def phase_gather_shapes(data1, data2, perm, num_out, rows: bool = True) -> dict:
    """Both gathers at the paths' shapes, each against its plain version
    (exact), with its bound and the one PyTorch call for the same function.

    Rows (`gather_rows`): table 1's 4 int64 columns and table 2's 3 of 4,
    each by a permutation, into the fused query's [10M, 7] output in one
    launch, zeros from num_out on; table 1 alone into its window of that
    output; whole rows by a permutation into a new table (the staged path's
    table sort), of 4 and of 10 columns; and the staged inner join's emit, sorted row indices with
    repeats, both tables with a live count and table 1 alone, all live.
    Columns (`hbm_sort.gather`): 20M x 3 int32 (the inner join's un-merge
    sort), 20M x 1 int32, 10M x 4 int32 and 10M x 4 int64 (the payloads of
    the fused query's un-merge and emit sorts when they rode as columns).
    ``rows=False`` times the column gather alone.
    """
    import torch

    from pim_sort_merge_join_tpu_torch.ops.kernels import hbm_sort as hs

    n, w = data1.shape
    es = data1.element_size()
    rec = {}

    def column_shape(name, p, cols):
        p64 = p.long()
        stacked = torch.stack(cols)
        err = max_abs_err(hs.gather(p, cols), tuple(o[p64] for o in cols))
        check(err == 0, f"column gather {name}: kernel differs from plain ({err})")
        rec[f"gather_{name}"] = {
            "err": err, "ms": time_ms(lambda _: hs.gather(p, cols)),
            "plain_ms": time_ms(lambda _: tuple(o[p64] for o in cols)),
            "library_ms": time_ms(lambda _: stacked.index_select(1, p)),
            **bound(nbytes(p) + 2 * nbytes(*cols))}

    cols64 = tuple(data1[:, c].contiguous() for c in range(w))
    cols32 = tuple(c.to(torch.int32) for c in cols64)
    perm20 = torch.randperm(2 * n, device="cuda").to(torch.int32)
    col20 = tuple(torch.randint(0, 2 * n, (2 * n,), dtype=torch.int32, device="cuda")
                  for _ in range(3))
    column_shape("20M_3xint32", perm20, col20)
    column_shape("20M_1xint32", perm20, col20[:1])
    column_shape("10M_4xint32", perm, cols32)
    column_shape("10M_4xint64", perm, cols64)
    del cols64, cols32, perm20, col20
    if not rows:
        log("gather shapes (ms, kernel vs plain vs library): " + json.dumps(rec))
        return rec

    from pim_sort_merge_join_tpu_torch.ops.kernels import gather as gr

    def rows_shape(name, parts, width, live, rows_read, library):
        def run(fn):
            out = torch.zeros((parts[0][1].shape[0], width), dtype=data1.dtype, device="cuda")
            return fn(parts, out=out, live=live)

        m = parts[0][1].shape[0]
        kept = sum(p[0].shape[1] if len(p) < 3 else len(p[2]) for p in parts)
        # Read: of every live row an index and the kept columns of each table;
        # written: every row of the window.
        moved = rows_read * (4 * len(parts) + kept * es) + m * kept * es
        err = max_abs_err((run(gr.gather_rows),), (run(gr.gather_rows_plain),))
        check(err == 0, f"row gather {name}: kernel differs from plain ({err})")
        out = torch.empty((m, width), dtype=data1.dtype, device="cuda")
        rec[f"rows_{name}"] = {
            "err": err,
            "ms": time_ms(lambda _: gr.gather_rows(parts, out=out, live=live)),
            "plain_ms": time_ms(lambda _: gr.gather_rows_plain(parts, out=out, live=live)),
            "library_ms": None if library is None else time_ms(lambda _: library()),
            **bound(moved)}

    live = int(num_out)
    keep2 = list(range(1, data2.shape[1]))
    width = w + len(keep2)
    perm2 = torch.randperm(data2.shape[0], device="cuda").to(torch.int32)
    rows_shape("emit", [(data1, perm), (data2, perm2, keep2)], width, num_out, live, None)
    rows_shape("emit_t1_window", [(data1, perm)], width, num_out, live,
               lambda: data1.index_select(0, perm))
    rows_shape("table_sort", [(data1, perm)], w, None, n, lambda: data1.index_select(0, perm))
    # A table of 10 columns: rows of 80 bytes go as two column slices, one launch.
    wide = torch.randint(0, 2**40, (n, 10), dtype=data1.dtype, device="cuda")
    rows_shape("wide_table_sort", [(wide, perm)], 10, None, n, lambda: wide.index_select(0, perm))
    del wide
    # The staged inner join's emit: output slot j takes table-1 row src1[j]
    # and table-2 row src2[j], both non-decreasing with repeats; about a
    # third of the slots are live.
    src1 = torch.sort(torch.randint(0, n, (n,), dtype=torch.int32, device="cuda")).values
    src2 = torch.sort(torch.randint(0, n, (n,), dtype=torch.int32, device="cuda")).values
    rows_shape("inner_emit", [(data1, src1), (data2, src2, keep2)], width, num_out, live, None)
    rows_shape("inner_emit_t1_all_live", [(data1, src1)], w, None, n,
               lambda: data1.index_select(0, src1))
    log("gather shapes (ms, kernel vs plain vs library): " + json.dumps(rec))
    return rec


def radix_runs_merged(kp, pp, n: int):
    """Run formation by the radix tile sort, then the `hbm_sort` merge
    passes: the stable sort of the first n of ``(kp, pp)`` by both."""
    from pim_sort_merge_join_tpu_torch.ops.kernels import hbm_sort as hs
    from pim_sort_merge_join_tpu_torch.ops.kernels import radix_sort as rs

    rk, rp = rs.radix_tile_sort((kp, pp), tile=hs.RUN, digit_bits=8, key_bits=32)
    # The merge passes take the chunk sort's element: here both int32
    # operands in one 64-bit word (pair-32).
    return hs.merge_passes(hs.pack_pair32(rk, rp), None, hs.KIND_PAIR32, n)


def phase_run_formation(keys, pos) -> dict:
    """The radix tile sort at the fused merge sort's shape (20M non-negative
    int32 keys + positions), at tiles 2048 and 512 and at the merge sort's
    run length, beside its plain version and the chunk sort; then the
    run-formation path against `hbm_sort`'s own kernels."""
    import torch

    from pim_sort_merge_join_tpu_torch.ops import kernels
    from pim_sort_merge_join_tpu_torch.ops.kernels import hbm_sort as hs
    from pim_sort_merge_join_tpu_torch.ops.kernels import radix_sort as rs

    n = keys.shape[0]
    npad, _ = hs.pass_schedule(n)
    kp = torch.cat([keys, torch.full((npad - n,), I32MAX, dtype=torch.int32, device="cuda")])
    pp = torch.arange(npad, dtype=torch.int32, device="cuda")
    rec = {"radix_n": npad}
    for tile in (2048, 512, hs.RUN):
        kw = dict(tile=tile, digit_bits=8, key_bits=32)
        rec[f"radix{tile}_err"] = max_abs_err(rs.radix_tile_sort((kp, pp), **kw),
                                              rs.radix_tile_sort_plain((kp, pp), **kw))
        rec[f"radix{tile}_ms"] = time_ms(lambda _: rs.radix_tile_sort((kp, pp), **kw))
        rec[f"radix{tile}_plain_ms"] = time_ms(lambda _: rs.radix_tile_sort_plain((kp, pp), **kw))
        # One PyTorch call sorts every tile's keys (and moves no payload).
        rec[f"radix{tile}_library_ms"] = time_ms(
            lambda _: torch.sort(kp.view(-1, tile), dim=1, stable=True))
        check(rec[f"radix{tile}_err"] == 0, f"radix tile {tile}: kernel differs from plain")
    rec["radix_bound"] = bound(2 * nbytes(kp, pp), compares=4 * npad)
    rec["chunk_sort_ms"] = time_ms(lambda _: hs.chunk_sort(keys, pos, hs.KIND_PAIR32))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    got = radix_runs_merged(kp, pp, n)
    torch.cuda.synchronize()
    rec["launches"] = kernels.launch_counts()
    ran = {name for name, c in rec["launches"].items() if c > 0}
    check(ran == {"radix_tile", "hbm_sort_merge"}, f"run formation launched {sorted(ran)}")
    rec["run_formation_err"] = max_abs_err(got, hs.sort_elements(keys, pos, hs.KIND_PAIR32))
    rec["run_formation_ms"] = time_ms(lambda _: radix_runs_merged(kp, pp, n))
    rec["sort_elements_ms"] = time_ms(lambda _: hs.sort_elements(keys, pos, hs.KIND_PAIR32))
    check(rec["run_formation_err"] == 0,
          f"run formation differs from the chunk sort's ({rec['run_formation_err']})")
    log("run formation (ms, radix vs plain vs chunk sort): " + json.dumps(rec))
    return rec


LSD_KERNELS = {"lsd_radix_histogram", "lsd_radix_scan", "lsd_radix_pass"}


def phase_lsd_shapes(keys, pos, mpos, dest, d1u) -> dict:
    """The global radix sort of `(key, payload)` at the fused query's sort
    shapes: the 20M merge sort (non-negative keys and sentinels, 31 key
    bits), the 20M un-merge sort (a permutation below 2^25 as key; also read
    as 25 key bits in 9-bit digits, three passes for four) and the 10M emit
    sort. Each must equal `hbm_sort`'s result element for element, and the
    plain version on its first 2^18 elements; timed beside `hbm_sort` and a
    stable `torch.sort` of the key alone. The sorts run once with the
    launch counts set to 0 just before: only the global sort's kernels may
    have run."""
    import torch

    from pim_sort_merge_join_tpu_torch.ops import kernels
    from pim_sort_merge_join_tpu_torch.ops.kernels import hbm_sort as hs
    from pim_sort_merge_join_tpu_torch.ops.kernels import radix_sort as rs

    iota = torch.arange(d1u.shape[0], dtype=torch.int32, device="cuda")
    shapes = {
        "merge": ((keys, pos), dict(digit_bits=8, key_bits=31),
                  lambda: hs.sort_elements(keys, pos, hs.KIND_PAIR32)),
        "unmerge": ((mpos, dest), dict(digit_bits=8, key_bits=32),
                    lambda: hs.sort_elements(mpos, dest, hs.KIND_PAIR32)),
        "unmerge_b25_d9": ((mpos, dest), dict(digit_bits=9, key_bits=25),
                           lambda: hs.sort_elements(mpos, dest, hs.KIND_PAIR32)),
        "emit": ((d1u, iota), dict(digit_bits=8, key_bits=32),
                 lambda: hs.sort_elements(d1u, d1u, hs.KIND_PACKED32)),
    }
    check(int(keys.min()) >= 0 and int(mpos.max()) < 1 << 25 and int(d1u.min()) >= 0,
          "global radix sort shapes: keys outside the bits the passes read")
    rec = {}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    got = {name: rs.xla_lsd_radix_sort(ops, **kw) for name, (ops, kw, _) in shapes.items()}
    torch.cuda.synchronize()
    rec["lsd_launches"] = {k: v for k, v in kernels.launch_counts().items() if v > 0}
    check(set(rec["lsd_launches"]) == LSD_KERNELS,
          f"global radix sort launched {sorted(rec['lsd_launches'])}")
    for name, (ops, kw, by_hbm_sort) in shapes.items():
        n = ops[0].shape[0]
        head = tuple(o[:PLAIN_LSD_HEAD].contiguous() for o in ops)
        err = max(max_abs_err(got[name], by_hbm_sort()),
                  max_abs_err(rs.xla_lsd_radix_sort(head, **kw), rs.xla_lsd_radix_sort_plain(head, **kw)))
        check(err == 0, f"global radix sort, {name} shape: differs from hbm_sort or plain ({err})")
        npass = -(-kw["key_bits"] // kw["digit_bits"])
        rec[f"lsd_{name}"] = {
            "n": n, "passes": npass, "err": err,
            "ms": time_ms(lambda _: rs.xla_lsd_radix_sort(ops, **kw)),
            "hbm_sort_ms": time_ms(lambda _: by_hbm_sort()),
            "library_ms": time_ms(lambda _: torch.sort(ops[0], stable=True)),
            "head_ms": time_ms(lambda _: rs.xla_lsd_radix_sort(head, **kw)),
            "head_n": head[0].shape[0],
            **bound(2 * nbytes(*ops)),
            # Every pass moves the operands once more, and the histogram reads the key.
            "passes_bound_ms": bound(npass * 2 * nbytes(*ops) + nbytes(ops[0]))["bound_ms"],
        }
    head = tuple(o[:PLAIN_LSD_HEAD].contiguous() for o in shapes["merge"][0])
    rec["lsd_merge"]["head_plain_ms"] = time_ms(
        lambda _: rs.xla_lsd_radix_sort_plain(head, **shapes["merge"][1]), reps=1)
    log("global radix sort (ms, kernels vs hbm_sort vs library; plain on the head): " + json.dumps(rec))
    return rec


def phase_bitonic_shape(rng) -> dict:
    """The bitonic sort at its cap: the 2M-rows/table table sort, which
    `sort_pairs` pads to 2^21 pairs."""
    import torch

    from pim_sort_merge_join_tpu_torch.ops.kernels import bitonic_sort as bs

    n = 2_000_000
    keys = torch.from_numpy(rng.integers(1, 3 * n, n).astype(np.int32)).cuda()
    keys[-n // 20:] = I32MAX  # the filtered-out tail of a compacted table
    vals = torch.arange(n, dtype=torch.int32, device="cuda")
    rec = {"bitonic_width": bs._next_pow2(n),
           "bitonic_launches": len(bs.bitonic_schedule(bs._next_pow2(n)))}
    rec["bitonic_err"] = max_abs_err(bs.sort_pairs(keys, vals), plain_sort_pairs(keys, vals))
    # Under half a millisecond: more repeats than the other phases take.
    rec["bitonic_ms"] = time_ms(lambda _: bs.sort_pairs(keys, vals), reps=9)
    rec["bitonic_plain_ms"] = time_ms(lambda _: plain_sort_pairs(keys, vals))
    rec["bitonic_library_ms"] = time_ms(lambda _: torch.sort(keys, stable=True), reps=9)
    width = rec["bitonic_width"]
    steps = width.bit_length() - 1
    rec["bitonic_bound"] = bound(4 * nbytes(keys), compares=width // 2 * steps * (steps + 1) // 2)
    torch.cuda.synchronize()
    check(rec["bitonic_err"] == 0, f"bitonic at 2^21: kernel differs from plain ({rec['bitonic_err']})")
    log("bitonic at its cap (ms, kernel vs plain): " + json.dumps(rec))
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


# The kernels each path must launch, and no other. The fused query with
# narrow keys needs no column gather: its merge sort carries both operands
# in the element, the placement names each slot's rows and one row gather
# moves them.
FUSED_KERNELS = {"hbm_sort_chunk", "hbm_sort_merge", "gather_rows",
                 "join_scan_forward", "join_scan_backward", "join_scan_place"}
FUSED_WIDE_KERNELS = FUSED_KERNELS | {"hbm_sort_gather"}
STAGED_KERNELS = {"hbm_sort_chunk", "hbm_sort_merge", "hbm_sort_gather", "gather_rows"}
STAGED_BITONIC_KERNELS = STAGED_KERNELS | {"bitonic_local", "bitonic_strided"}
# The narrow probe's kernel, once a query, beside a path's kernels wherever
# `run_tables` (one device or several) resolves an "auto" narrow_keys or
# narrow_data on int64/uint64 tables. `pipeline_core`, the operators, CSV
# queries (probed on the host) and a resumable run on one device probe
# nothing on the card.
PROBE_KERNELS = {"narrow_extremes"}
# The fused path's keys (`ops/kernels/keys.join_keys`), once a query,
# wherever `pipeline_core`'s fused branch runs on tables of the card, of
# any types (`run_tables` on one device, `entry`). The operators, the hash
# paths, the multi-device engine's local joins and a resumable run make
# their keys with torch ops.
KEYS_KERNELS = {"join_keys"}


def staged_inputs(n: int, sort_algorithm: str):
    """The staged inner join: generate_table(n, seed=1/2) with uniform keys
    (duplicates on both sides), predicate > 3N/20 on both."""
    from pim_sort_merge_join_tpu_torch import EngineConfig, Predicate
    from pim_sort_merge_join_tpu_torch.columnar.generate import generate_table

    r1 = generate_table(n, seed=1, key_distribution="uniform")
    r2 = generate_table(n, seed=2, key_distribution="uniform")
    thr = (3 * n) // 20
    cfg = EngineConfig(join_mode="inner", sort_algorithm=sort_algorithm,
                       predicate1=Predicate(0, ">", thr), predicate2=Predicate(0, ">", thr))
    return r1, r2, cfg


def run_counted(fn, kernels_of_path: set, label: str):
    """``fn()`` once with the launch counts set to 0 just before: exactly
    ``kernels_of_path`` must have run. Returns (result, launches)."""
    import torch

    from pim_sort_merge_join_tpu_torch.ops import kernels

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    ran = {name for name, count in launches.items() if count > 0}
    check(ran == kernels_of_path,
          f"{label}: launched {sorted(ran)}, the path's kernels are {sorted(kernels_of_path)}")
    return out, {k: v for k, v in launches.items() if v}


def same_table(got, want, label: str) -> None:
    import torch

    check(got.data.dtype == want.data.dtype and tuple(got.data.shape) == tuple(want.data.shape),
          f"{label}: output {got.data.dtype} {tuple(got.data.shape)} vs plain "
          f"{want.data.dtype} {tuple(want.data.shape)}")
    check(int(got.num_rows) == int(want.num_rows), f"{label}: num_rows differs from the plain path")
    check(torch.equal(got.data.cpu(), want.data), f"{label}: output buffer differs from the plain path")
    check(got.names == want.names, f"{label}: names differ")


def phase_slice(r1, r2, cfg, *, expect_narrow: bool, label: str, kernels_of_path: set):
    """run_tables on CUDA vs the plain path on CPU; returns (launches, ms, rows).

    Exactly ``kernels_of_path`` must have been launched in the CUDA run."""
    import torch

    from pim_sort_merge_join_tpu_torch import QueryPipeline, Table

    g1 = Table.from_numpy(r1)
    g2 = Table.from_numpy(r2)
    pipe = QueryPipeline(cfg)
    check(pipe.device.type == "cuda" and g1.device.type == "cuda",
          f"{label}: the default device is {pipe.device} / {g1.device}, not the card")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out, launches = run_counted(lambda: pipe.run_tables(g1, g2), kernels_of_path, label)
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    check(pipe.resolved_narrow_keys is expect_narrow,
          f"{label}: narrow_keys resolved {pipe.resolved_narrow_keys}, expected {expect_narrow}")
    same_table(out, QueryPipeline(cfg, device="cpu").run_tables(
        Table.from_numpy(r1, device="cpu"), Table.from_numpy(r2, device="cpu")), label)
    rows = int(out.num_rows)
    check(rows > 0, f"{label}: no rows")
    ms = host_ms(lambda: pipe.run_tables(g1, g2))
    log(f"slice {label}: {rows} rows equal to the plain path; launches {launches}; "
        f"run_tables {ms:.3f} ms (median of 3); peak memory above the tables {peak:.2f} GB")
    return launches, ms, rows


# The 1:1 hash join on int64 tables runs the fused path's kernels on 64-bit
# hashes: its merge sort is the wide element and gathers both operands. The
# hash inner join, the aggregate and the merge sort rows and sort keys with
# payloads, and scan nothing.
HASH_ONE_TO_ONE_KERNELS = FUSED_WIDE_KERNELS
HASH_INNER_KERNELS = STAGED_KERNELS
HASH_AGGREGATE_KERNELS = STAGED_KERNELS
MERGE_KERNELS = {"hbm_sort_chunk", "hbm_sort_merge", "gather_rows"}
RESUMABLE_KERNELS = FUSED_WIDE_KERNELS


def hash_config(cfg):
    import dataclasses

    return dataclasses.replace(cfg, join_algorithm="hash")


def phase_hash_shapes(r1, r2, cfg) -> dict:
    """The kernels at the shapes the 1:1 hash join gives them at 10M
    rows/table, each against its plain version on the card (exact): the
    hash mixes of both filtered tables (torch ops; their time and bound),
    the 20M merge sort of int64 hashes (`sort_key_permutation`: the wide
    element and one column gather; phase A, phase B, whole, beside stable
    `torch.sort` of the hashes), the join scans over those 20M int64 keys, the restore sort of
    the core's 10M x 8 output (key: the table-1 row index, payload 7 int64
    columns of its rows, zeros from num_out on) and the hash inner join's
    10M row sort (`stable_key_sort_rows_with_key`: the wide element, one
    column gather of the hashes, one row gather)."""
    import torch

    from pim_sort_merge_join_tpu_torch import Table
    from pim_sort_merge_join_tpu_torch.ops import filter as filter_ops
    from pim_sort_merge_join_tpu_torch.ops import hash_join as hj
    from pim_sort_merge_join_tpu_torch.ops import join as join_ops
    from pim_sort_merge_join_tpu_torch.ops.kernels import gather as gr
    from pim_sort_merge_join_tpu_torch.ops.kernels import hbm_sort as hs
    from pim_sort_merge_join_tpu_torch.ops.kernels import join_scan as js
    from pim_sort_merge_join_tpu_torch.ops.sort import stable_key_sort_rows_with_key

    t1, t2 = Table.from_numpy(r1), Table.from_numpy(r2)
    f1 = filter_ops.apply_filter(t1, cfg.predicate1)
    f2 = filter_ops.apply_filter(t2, cfg.predicate2)
    cap1, n = f1.capacity, f1.capacity + f2.capacity
    rec = {}
    h1, h2 = hj._hashed_keys(f1, 0), hj._hashed_keys(f2, 0)
    mix_want = hj._hashed_keys(Table(f1.data.cpu(), f1.num_rows.cpu(), f1.names), 0)
    rec["hash_mix_err"] = max_abs_err((h1.cpu(),), (mix_want,))
    rec["hash_mix_ms"] = time_ms(lambda _: (hj._hashed_keys(f1, 0), hj._hashed_keys(f2, 0)))
    # Each table's key column read (a strided 8 bytes a row), the hash written.
    rec["hash_mix_bound"] = bound(2 * nbytes(h1, h2), compares=12 * n)

    # The merge sort as the path runs it (`sort_key_permutation`): the key
    # sorted with its position as the payload, so the permutation is the
    # merged positions; one column gather of the key.
    keys = torch.cat([h1, h2])
    pos = torch.arange(n, dtype=torch.int32, device="cuda")
    check(hs.element_kind((keys,), 1) == hs.KIND_WIDE_I64, "hash merge sort: not the wide element")
    time_sort(rec, "hash_merge_sort", (keys, pos), 1,
              whole=lambda _=None: hs.sort_key_permutation(keys), inputs=(keys,))
    mkeys, mpos = hs.sort_key_permutation(keys)
    time_scan(rec, "hash_", mkeys, mpos, cap1)

    iota1 = torch.arange(cap1, dtype=torch.int32, device="cuda")
    t1aug = Table(torch.cat([f1.data, iota1.to(f1.dtype)[:, None]], dim=1), f1.num_rows, ())
    joined = join_ops._one_to_one_merged(t1aug, f2, 0, torch.cat([h1, h2]))
    num_out = joined.num_rows
    j = torch.arange(joined.capacity, dtype=torch.int32, device="cuda")
    restore = torch.where(j < num_out, joined.data[:, f1.ncol].to(torch.int32), cap1 + j)
    keep = [c for c in range(joined.ncol) if c != f1.ncol]

    def plain_sort_rows(parts, **kw):
        return gr.gather_rows_plain(
            [(rows, hs.hbm_sort_plain((key, torch.arange(key.shape[0], dtype=torch.int32,
                                                         device=key.device)))[1], *cols)
             for key, rows, *cols in parts], **kw)

    def restore_rows(sort_rows):
        return sort_rows([(restore, joined.data, keep)], live=num_out)

    rec["restore_sort_err"] = max_abs_err((restore_rows(hs.hbm_sort_rows),),
                                          (restore_rows(plain_sort_rows),))
    rec["restore_sort_ms"] = time_ms(lambda _: restore_rows(hs.hbm_sort_rows))
    rec["restore_sort_plain_ms"] = time_ms(lambda _: restore_rows(plain_sort_rows))
    rec["restore_sort_library_ms"] = time_ms(lambda _: torch.sort(restore, stable=True))
    live = int(num_out)
    rec["restore_rows"], rec["restore_live"] = joined.capacity, live
    rec["restore_sort_bound_ms"] = bound(nbytes(restore) + live * len(keep) * 8
                                         + joined.capacity * len(keep) * 8)["bound_ms"]

    def row_sort_plain():
        perm = hs.hbm_sort_plain((h1, iota1))[1]
        return h1[perm.long()], perm, gr.gather_rows_plain([(f1.data, perm)])

    got, want = stable_key_sort_rows_with_key(h1, f1.data), row_sort_plain()
    rec["hash_row_sort_err"] = max_abs_err(got, want)
    rec["hash_row_sort_ms"] = time_ms(lambda _: stable_key_sort_rows_with_key(h1, f1.data))
    rec["hash_row_sort_plain_ms"] = time_ms(lambda _: row_sort_plain())
    rec["hash_row_sort_library_ms"] = time_ms(lambda _: torch.sort(h1, stable=True))
    rec["hash_row_sort_bound_ms"] = bound(2 * nbytes(h1, f1.data) + nbytes(iota1))["bound_ms"]
    torch.cuda.synchronize()
    for key in ("hash_mix_err", "hash_merge_sort_err", "restore_sort_err", "hash_row_sort_err"):
        check(rec[key] == 0, f"hash path shape {key} = {rec[key]}: kernel differs from plain")
    log("hash path shapes (ms, kernel vs plain vs library): " + json.dumps(rec))
    return rec


def phase_operators() -> dict:
    """`hash_aggregate` over a 10M table (the staged query's table 1:
    uniform keys, about 0.3 rows a key) for each aggregate, and `merge_tree`
    of 8 key-sorted runs of 1.25M rows (uniform keys) into one of 10M, on
    the card against the plain path on CPU tensors, with their kernels and
    times."""
    import torch

    from pim_sort_merge_join_tpu_torch import Table
    from pim_sort_merge_join_tpu_torch.columnar.generate import generate_table
    from pim_sort_merge_join_tpu_torch.ops import hash_join as hj
    from pim_sort_merge_join_tpu_torch.ops import merge as merge_ops

    rec = {}
    rows = generate_table(10_000_000, seed=1, key_distribution="uniform")
    g, c = Table.from_numpy(rows), Table.from_numpy(rows, device="cpu")
    del rows
    for agg in ("sum", "count", "min", "max"):
        out, launches = run_counted(lambda: hj.hash_aggregate(g, 0, 1, agg), HASH_AGGREGATE_KERNELS,
                                    f"hash_aggregate {agg}")
        same_table(out, hj.hash_aggregate(c, 0, 1, agg), f"hash_aggregate {agg}")
        rec[f"aggregate_{agg}"] = {"groups": int(out.num_rows), "launches": launches,
                                   "ms": time_ms(lambda _: hj.hash_aggregate(g, 0, 1, agg))}
    del g, c
    runs_np = []
    for i in range(8):
        r = generate_table(1_250_000, seed=10 + i, key_distribution="uniform")
        runs_np.append(r[np.argsort(r[:, 0], kind="stable")])
    runs = [Table.from_numpy(r) for r in runs_np]
    out, launches = run_counted(lambda: merge_ops.merge_tree(runs, 0), MERGE_KERNELS, "merge_tree")
    want = merge_ops.merge_tree([Table.from_numpy(r, device="cpu") for r in runs_np], 0)
    same_table(out, want, "merge_tree")
    rec["merge_tree"] = {"rows": int(out.num_rows), "launches": launches,
                         "ms": time_ms(lambda _: merge_ops.merge_tree(runs, 0))}
    torch.cuda.synchronize()
    log("operators (hash_aggregate 10M, merge_tree 8 runs to 10M; ms): " + json.dumps(rec))
    return rec


def phase_resumable() -> dict:
    """`run_tables_resumable` at 2M rows/table into a temporary directory:
    the first run saves the sorted and joined stages, a second pipeline
    resumes from the sorted stage with zero tables of the same shape; both
    equal the plain path's resumable run on CPU tensors."""
    import dataclasses

    import torch

    from pim_sort_merge_join_tpu_torch import QueryPipeline, Table
    from pim_sort_merge_join_tpu_torch.engine.checkpoint import StageCheckpointer, config_fingerprint

    r1, r2, cfg = slice_inputs(2_000_000)
    rec = {}
    with tempfile.TemporaryDirectory() as d:
        gcfg = dataclasses.replace(cfg, checkpoint_dir=os.path.join(d, "card"))
        g1, g2 = Table.from_numpy(r1), Table.from_numpy(r2)
        t0 = time.perf_counter()
        out, rec["launches"] = run_counted(lambda: QueryPipeline(gcfg).run_tables_resumable(g1, g2),
                                           RESUMABLE_KERNELS, "resumable run")
        rec["run_ms"] = (time.perf_counter() - t0) * 1e3
        stages = StageCheckpointer(gcfg.checkpoint_dir, config_fingerprint(gcfg)).completed_stages()
        check(stages == ["sorted", "joined"], f"resumable run: stages {stages}")
        zeros = Table.from_numpy(np.zeros_like(r1))
        t0 = time.perf_counter()
        again, rec["resume_launches"] = run_counted(
            lambda: QueryPipeline(gcfg).run_tables_resumable(zeros, zeros), RESUMABLE_KERNELS,
            "resumed run")
        rec["resume_ms"] = (time.perf_counter() - t0) * 1e3
        ccfg = dataclasses.replace(cfg, checkpoint_dir=os.path.join(d, "cpu"))
        want = QueryPipeline(ccfg, device="cpu").run_tables_resumable(
            Table.from_numpy(r1, device="cpu"), Table.from_numpy(r2, device="cpu"))
        same_table(out, want, "resumable run")
        same_table(again, want, "resumed run")
        rec["rows"] = int(out.num_rows)
    torch.cuda.synchronize()
    log("resumable 2M (run, then resume from the sorted stage; host ms): " + json.dumps(rec))
    return rec


def phase_csv_debug_log() -> dict:
    """The 100k CSV query with `debug_log` on: the ingest, filter, join and
    materialize events, in that order, must agree with the tables and the
    result."""
    import torch

    from pim_sort_merge_join_tpu_torch import EngineConfig, QueryPipeline
    from pim_sort_merge_join_tpu_torch.columnar import csv_io
    from pim_sort_merge_join_tpu_torch.columnar.generate import generate_table
    from pim_sort_merge_join_tpu_torch.engine import logging as elog

    buf = io.StringIO()
    elog.configure(stream=buf)
    rows1, rows2 = generate_table(100_000, seed=1), generate_table(100_000, seed=2)
    with tempfile.TemporaryDirectory() as d:
        p1, p2, po = (os.path.join(d, f) for f in ("data1.csv", "data2.csv", "result.csv"))
        csv_io.write_csv(p1, rows1)
        csv_io.write_csv(p2, rows2)
        res = QueryPipeline(EngineConfig(debug_log=True)).run_csv(p1, p2, po)
    torch.cuda.synchronize()
    elog.get_logger().handlers.clear()
    events = [json.loads(line) for line in buf.getvalue().splitlines() if line]
    names = [e["event"] for e in events]
    check(names == ["ingest", "filter", "join", "materialize"], f"debug_log events {names}")
    by = {e["event"]: e for e in events}
    rows = int(res.num_rows)
    check(by["ingest"]["table1_rows"] == by["filter"]["table1_rows_in"] == 100_000,
          "debug_log: ingest/filter row counts")
    check(by["filter"]["table1_rows_out"] == int(np.sum(rows1[:, 0] > 5000))
          and by["filter"]["table2_rows_out"] == int(np.sum(rows2[:, 0] > 5000)),
          "debug_log: filter counts differ from the tables'")
    check(by["join"]["rows_out"] == by["materialize"]["rows"] == rows > 0,
          "debug_log: join/materialize counts differ from the result")
    log(f"debug_log 100k CSV: events {names} agree with the {rows} result rows")
    return by


# --- the other element types (uint64, float64, float32, uint32) --------------

# Keys of an 8-byte type that do not fit int32 run the int64 query's wide
# kernels on their order keys: the wide merge sort with its column gathers
# and the int64 join scan; a float table's rows move as int64 bits.
TYPED_FUSED_KERNELS = FUSED_WIDE_KERNELS
TYPED_HASH_KERNELS = HASH_ONE_TO_ONE_KERNELS
TYPED_STAGED_KERNELS = STAGED_KERNELS


def shifted_key(rows, dtype, shift: int = 0):
    """``rows`` as ``dtype`` with ``shift`` added to the key column (col 0)."""
    out = rows.astype(dtype)
    out[:, 0] += np.dtype(dtype).type(shift)
    return out


def int64_rows(r1, r2, cfg) -> np.ndarray:
    """The valid rows of the int64 query on the card (checked against the
    plain path in its own phase)."""
    from pim_sort_merge_join_tpu_torch import QueryPipeline, Table

    return QueryPipeline(cfg).run_tables(Table.from_numpy(r1), Table.from_numpy(r2)).to_numpy()


def typed_query(t1, t2, cfg, want: np.ndarray, label: str, kernels_of_path: set) -> dict:
    """`run_tables` of ``cfg`` on the card's typed tables, counted: exactly
    ``kernels_of_path``, valid rows bit for bit ``want``, zeros after them;
    its host ms (median of 3) and peak memory above the tables."""
    import torch

    from pim_sort_merge_join_tpu_torch import QueryPipeline
    from pim_sort_merge_join_tpu_torch.columnar import dtypes

    pipe = QueryPipeline(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out, launches = run_counted(lambda: pipe.run_tables(t1, t2), kernels_of_path, label)
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    got = out.to_numpy()
    check(got.dtype == want.dtype and got.shape == want.shape and got.tobytes() == want.tobytes(),
          f"{label}: {got.shape} {got.dtype} rows differ from the int64 query's {want.shape}")
    check(not bool(dtypes.bits(out.data[got.shape[0]:]).any()), f"{label}: rows past num_rows")
    check(got.shape[0] > 0, f"{label}: no rows")
    ms = host_ms(lambda: pipe.run_tables(t1, t2))
    rec = {"rows": got.shape[0], "ms": ms, "peak_gb": round(peak, 3), "launches": launches,
           "narrow_keys": pipe.resolved_narrow_keys}
    log(f"typed {label}: {got.shape[0]} rows equal to the int64 query's; launches {launches}; "
        f"run_tables {ms:.3f} ms (median of 3); peak memory above the tables {peak:.2f} GB")
    return rec


def phase_types(r1, r2, cfg, a1, a2, acfg) -> dict:
    """The fused 1:1 query on uint64 tables (keys + 2^63, predicate + 2^63)
    and on float64 tables of the same values, the 1:1 hash join on those
    float64 tables, and the staged inner join on uint64 tables (path A's,
    keys + 2^63), at 10M rows/table: each must give the int64 query's rows
    with the same key shift, in its own type."""
    import dataclasses

    import torch

    from pim_sort_merge_join_tpu_torch import Predicate, Table

    hi, thr = 2**63, cfg.predicate1.value
    want = int64_rows(r1, r2, cfg)
    want_hash = int64_rows(r1, r2, hash_config(cfg))
    rec = {}
    upred = Predicate(0, ">", hi + thr)
    u1, u2 = (Table.from_numpy(shifted_key(r, np.uint64, hi), dtype=np.uint64) for r in (r1, r2))
    rec["uint64 fused 10M"] = typed_query(
        u1, u2, dataclasses.replace(cfg, dtype="uint64", predicate1=upred, predicate2=upred),
        shifted_key(want, np.uint64, hi), "uint64 fused 10M",
        TYPED_FUSED_KERNELS | PROBE_KERNELS | KEYS_KERNELS)
    del u1, u2
    f1, f2 = (Table.from_numpy(r, dtype=np.float64) for r in (r1, r2))
    fcfg = dataclasses.replace(cfg, dtype="float64")
    rec["float64 fused 10M"] = typed_query(f1, f2, fcfg, want.astype(np.float64),
                                           "float64 fused 10M", TYPED_FUSED_KERNELS | KEYS_KERNELS)
    rec["float64 hash 1:1 10M"] = typed_query(f1, f2, hash_config(fcfg),
                                              want_hash.astype(np.float64),
                                              "float64 hash 1:1 10M", TYPED_HASH_KERNELS)
    del f1, f2, want, want_hash
    torch.cuda.empty_cache()
    want_a = int64_rows(a1, a2, acfg)
    apred = Predicate(0, ">", hi + acfg.predicate1.value)
    u1, u2 = (Table.from_numpy(shifted_key(r, np.uint64, hi), dtype=np.uint64) for r in (a1, a2))
    rec["uint64 staged inner 10M"] = typed_query(
        u1, u2, dataclasses.replace(acfg, dtype="uint64", predicate1=apred, predicate2=apred),
        shifted_key(want_a, np.uint64, hi), "uint64 staged inner 10M",
        TYPED_STAGED_KERNELS | PROBE_KERNELS)
    del u1, u2
    for label, r in rec.items():
        check(r["narrow_keys"] is False, f"{label}: keys narrowed, the wide kernels did not run")
    torch.cuda.empty_cache()
    return rec


def edge_key_pools() -> dict:
    """Per type, the keys that need care: ±0.0, ±inf, NaN, subnormals and
    the extremes of the floats; 0, 2^63 ± 1 and the maxima of the unsigned."""
    pools = {}
    for dtype in (np.float32, np.float64):
        info = np.finfo(dtype)
        sub = np.nextafter(dtype(0), dtype(1))
        pools[np.dtype(dtype).name] = np.array(
            [0.0, -0.0, np.inf, -np.inf, np.nan, sub, -sub, info.tiny, 1.5, -1.5, info.max,
             info.min], dtype)
    pools["uint64"] = np.array([0, 1, 2**63 - 1, 2**63, 2**63 + 1, 2**64 - 2, 2**64 - 1, 5],
                               np.uint64)
    pools["uint32"] = np.array([0, 1, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 2, 2**32 - 1],
                               np.uint32)
    return pools


def phase_edge_keys(rng) -> dict:
    """Small tables of edge keys through every function that compares keys:
    the filter (`>` and `!=`), `sort_by_key` (the merge sort and the
    bitonic table sort), `stable_key_sort`, the fused 1:1 join, the staged
    inner join, both hash joins, `hash_aggregate` and `merge_sorted`. The
    card's result must equal the plain path's on CPU tensors bit for bit
    (the payloads are small integers, so float sums are exact in any
    order)."""
    import dataclasses

    import torch

    from pim_sort_merge_join_tpu_torch import EngineConfig, Predicate, Table
    from pim_sort_merge_join_tpu_torch.columnar import dtypes
    from pim_sort_merge_join_tpu_torch.engine.pipeline import pipeline_core
    from pim_sort_merge_join_tpu_torch.ops import filter as filter_ops
    from pim_sort_merge_join_tpu_torch.ops import hash_join as hj
    from pim_sort_merge_join_tpu_torch.ops import merge as merge_ops
    from pim_sort_merge_join_tpu_torch.ops import sort as sort_ops
    from pim_sort_merge_join_tpu_torch.ops.kernels.hbm_sort import RUN

    def same(got, want, what):
        if isinstance(got, Table):
            check(int(got.num_rows) == int(want.num_rows), f"edge keys {what}: num_rows")
            got, want = got.data, want.data
        g, w = got.cpu(), want
        check(g.dtype == w.dtype and g.shape == w.shape
              and torch.equal(dtypes.bits(g) if g.dtype != torch.bool else g,
                              dtypes.bits(w) if w.dtype != torch.bool else w),
              f"edge keys {what}: the card differs from the plain path")

    checked = 0
    for name, pool in edge_key_pools().items():
        big, small = 3 * RUN + 5, 1500
        rows = {n: np.column_stack([rng.choice(pool, n), rng.integers(0, 9, (n, 3)).astype(pool.dtype)])
                for n in (big, small, small + 7)}
        card = {n: Table.from_numpy(r, dtype=pool.dtype, capacity=n + 3) for n, r in rows.items()}
        host = {n: Table.from_numpy(r, dtype=pool.dtype, capacity=n + 3, device="cpu")
                for n, r in rows.items()}
        value = int(pool[2]) if pool.dtype.kind == "u" else 0
        for op in (">", "!="):
            same(filter_ops.predicate_mask(card[big], Predicate(0, op, value)),
                 filter_ops.predicate_mask(host[big], Predicate(0, op, value)), f"{name} filter {op}")
        for alg in ("auto", "pallas_bitonic"):
            same(sort_ops.sort_by_key(card[big], 0, algorithm=alg),
                 sort_ops.sort_by_key(host[big], 0, algorithm=alg), f"{name} sort_by_key {alg}")
        ops = lambda t: (t.data[:, 0].contiguous(), t.data[:, 1].contiguous())  # noqa: E731
        for g, w in zip(sort_ops.stable_key_sort(ops(card[big])), sort_ops.stable_key_sort(ops(host[big]))):
            same(g, w, f"{name} stable_key_sort")
        for agg in ("sum", "count", "min", "max"):
            same(hj.hash_aggregate(card[big], 0, 1, agg), hj.hash_aggregate(host[big], 0, 1, agg),
                 f"{name} hash_aggregate {agg}")
        s1, s2 = (sort_ops.sort_by_key(card[n], 0) for n in (small, small + 7))
        h1, h2 = (sort_ops.sort_by_key(host[n], 0) for n in (small, small + 7))
        same(merge_ops.merge_sorted(s1, s2, 0), merge_ops.merge_sorted(h1, h2, 0), f"{name} merge_sorted")
        pred = Predicate(1, "!=", 99)
        base = EngineConfig(predicate1=pred, predicate2=pred, dtype=name)
        for label, kw in (("fused", {}), ("inner", {"join_mode": "inner", "join_slack": 400.0}),
                          ("hash", {"join_algorithm": "hash"}),
                          ("hash inner", {"join_algorithm": "hash", "join_mode": "inner",
                                          "join_slack": 400.0})):
            c = dataclasses.replace(base, narrow_keys=False, narrow_data=False, **kw)
            got = pipeline_core(card[small], card[small + 7], c)
            want = pipeline_core(host[small], host[small + 7], c)
            same(got, want, f"{name} {label}")
            check(int(got.num_rows) > 0, f"edge keys {name} {label}: no rows")
            checked += 1
        checked += 10
    torch.cuda.synchronize()
    log(f"edge keys: {checked} results on the card equal to the plain path "
        f"({', '.join(edge_key_pools())})")
    return {"checked": checked}


def phase_csv_stages(r1, r2, cfg, want_rows: int) -> dict:
    """The fused cell's tables written once as CSV with the port's native
    formatter, then `run_csv` at 10M rows/table: its stages (ingest with
    the native parser, host to device, execute, materialize), and the
    native parse beside the numpy parse (the numpy one at 1M rows)."""
    import torch

    from pim_sort_merge_join_tpu_torch import QueryPipeline
    from pim_sort_merge_join_tpu_torch.columnar import csv_io
    from pim_sort_merge_join_tpu_torch.native import csv_native

    check(csv_native.available(), "the native CSV parser did not build on this machine")
    rec = {}
    with tempfile.TemporaryDirectory() as d:
        p1, p2, po, pm = (os.path.join(d, f) for f in ("d1.csv", "d2.csv", "r.csv", "d1_1m.csv"))
        t0 = time.perf_counter()
        csv_io.write_csv(p1, r1)
        csv_io.write_csv(p2, r2)
        rec["write_2_tables_s"] = time.perf_counter() - t0
        rec["file_mb"] = os.path.getsize(p1) / 1e6
        pipe = QueryPipeline(cfg)
        res = pipe.run_csv(p1, p2, po)
        torch.cuda.synchronize()
        stages = {m.name: m for m in pipe.metrics.stages}
        check(stages["ingest"].extra.get("parser") == "native",
              f"run_csv ingest used the {stages['ingest'].extra.get('parser')} parser")
        rec["stages_ms"] = {k: m.wall_s * 1e3 for k, m in stages.items()}
        rows = int(res.num_rows)
        check(rows == want_rows, f"run_csv 10M: {rows} rows, run_tables gave {want_rows}")
        got = csv_native.parse_csv(po)
        check(np.array_equal(got, res.to_numpy()), "run_csv 10M: the CSV differs from the result")
        t0 = time.perf_counter()
        parsed = csv_native.parse_csv(p1)
        rec["native_parse_10M_s"] = time.perf_counter() - t0
        check(np.array_equal(parsed, r1), "native parse of the 10M table differs from the table")
        csv_io.write_csv(pm, r1[:1_000_000])
        t0 = time.perf_counter()
        native_1m = csv_native.parse_csv(pm)
        rec["native_parse_1M_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        numpy_1m = csv_io._load_numpy(pm)
        rec["numpy_parse_1M_s"] = time.perf_counter() - t0
        check(np.array_equal(native_1m, numpy_1m) and np.array_equal(numpy_1m, r1[:1_000_000]),
              "native and numpy parses of 1M rows differ")
    log("CSV stages 10M (run_csv ms by stage; parse s): " + json.dumps(rec))
    return rec


def phase_cli() -> dict:
    """The command line and the launcher as subprocesses on the 100k pair,
    all started together: `cli run` with the default config, with
    ``--dtype float64`` and with ``--profile DIR`` must write the oracle's
    bytes; with ``--join-algorithm hash`` the bytes of the same command on
    the CPU (its rows are in table-1 order) and the oracle's rows;
    `runner.run` must exit 0 with ``OUTPUT MATCH``."""
    from pim_sort_merge_join_tpu_torch.columnar import csv_io
    from pim_sort_merge_join_tpu_torch.columnar.generate import generate_table
    from pim_sort_merge_join_tpu_torch.engine.profiling import trace_path
    from pim_sort_merge_join_tpu_torch.ops import oracle

    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
    rows1, rows2 = generate_table(100_000, seed=1), generate_table(100_000, seed=2)
    with tempfile.TemporaryDirectory() as d:
        p1, p2 = os.path.join(d, "data1.csv"), os.path.join(d, "data2.csv")
        csv_io.write_csv(p1, rows1)
        csv_io.write_csv(p2, rows2)
        out = {k: os.path.join(d, f"{k}.csv") for k in
               ("default", "float64", "hash", "hash_cpu", "profile", "launcher")}
        cli = [sys.executable, "-m", "pim_sort_merge_join_tpu_torch.runner.cli", "run", p1, p2]
        cmds = {
            "default": cli + ["-o", out["default"]],
            "float64": cli + ["-o", out["float64"], "--dtype", "float64"],
            "hash": cli + ["-o", out["hash"], "--join-algorithm", "hash"],
            "hash_cpu": cli + ["-o", out["hash_cpu"], "--join-algorithm", "hash", "--device", "cpu"],
            "profile": cli + ["-o", out["profile"], "--profile", os.path.join(d, "prof")],
            "launcher": [sys.executable, "-m", "pim_sort_merge_join_tpu_torch.runner.run", p1, p2,
                         out["launcher"]],
        }
        t0 = time.perf_counter()
        procs = {k: subprocess.Popen(c, cwd=root, env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True) for k, c in cmds.items()}
        done = {k: (p.communicate(timeout=300), p.returncode) for k, p in procs.items()}
        wall = time.perf_counter() - t0
        for k, ((_, err), rc) in done.items():
            check(rc == 0, f"cli {k}: exit {rc}\n{err[-2000:]}")
        check("OUTPUT MATCH" in done["launcher"][0][0], "runner.run printed no OUTPUT MATCH")

        def oracle_bytes(a, b):
            buf = io.StringIO()
            csv_io.write_csv(buf, oracle.pipeline_oracle(a, b))
            return buf.getvalue().encode()

        def read(k):
            with open(out[k], "rb") as f:
                return f.read()

        want = oracle_bytes(rows1, rows2)
        for k in ("default", "profile", "launcher"):
            check(read(k) == want, f"cli {k}: output bytes differ from the oracle's")
        check(read("float64") == oracle_bytes(rows1.astype(np.float64), rows2.astype(np.float64)),
              "cli --dtype float64: output bytes differ from the oracle's")
        check(read("hash") == read("hash_cpu"), "cli --join-algorithm hash: card and CPU differ")
        hashed = csv_io.load_csv_numpy(out["hash"])
        want_rows = oracle.pipeline_oracle(rows1, rows2)
        check(np.array_equal(hashed[np.argsort(hashed[:, 0], kind="stable")], want_rows),
              "cli --join-algorithm hash: rows differ from the oracle's")
        check(os.path.getsize(trace_path(os.path.join(d, "prof"))) > 0, "cli --profile: no trace")
    rec = {"commands": len(cmds), "wall_s": wall, "rows": int(want_rows.shape[0])}
    log(f"cli and launcher: {len(cmds)} subprocesses in {wall:.1f} s, every output equal "
        f"({rec['rows']} rows); trace written")
    return rec


# --- phase 13b: the entry points and the examples -------------------------

ENTRY_WIDTHS = (4096, 10_000_000)
# The kernels each example launches in this process (its ranks, for the
# multi-device examples 02 and 05, are other processes: phase 14 checks the
# ranks' launches on the same engine). 01's CSV query resolves narrow keys
# and data on the host; 03's 1:1 hash join runs the wide fused kernels and
# its aggregate the staged ones; 04's table sorts, merges and resumable 1:1
# join (unresolved narrow: wide) the same.
EXAMPLE_KERNELS = {
    "single_chip_pipeline": FUSED_KERNELS | KEYS_KERNELS,
    "distributed": set(),
    "hash_join_aggregate": FUSED_WIDE_KERNELS,
    "streaming_merge_checkpoint": FUSED_WIDE_KERNELS,
    "skew_and_profiling": set(),
}


def entry_oracle(n: int) -> np.ndarray:
    """`pipeline_oracle` of `entry_rows(n)` (in a worker of phase 13b's pool)."""
    from pim_sort_merge_join_tpu_torch.entry import entry_rows
    from pim_sort_merge_join_tpu_torch.ops import oracle

    return oracle.pipeline_oracle(*entry_rows(n))


def cpu_worker_init() -> None:
    import torch

    torch.set_num_threads(2)


def run_example(name: str, argv: list, quiet: bool = True) -> tuple[dict, str]:
    """An example's ``main(argv)``: what it returns and, ``quiet``, what it
    printed (else it prints; a thread must not redirect the process's
    stdout)."""
    import contextlib
    import importlib

    main = importlib.import_module(f"pim_sort_merge_join_tpu_torch.examples.{name}").main
    if not quiet:
        return main(argv), ""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = main(argv)
    return out, buf.getvalue()


def same_value(a, b) -> bool:
    """Equal dicts, lists and scalars; arrays of one dtype and equal elements."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            same_value(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(same_value(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    return type(a) is type(b) and a == b


def phase_concat_tables() -> None:
    """`concat_tables` on the card equal to the same call on the CPU, bit
    for bit, for tables of three types with empty and padded members."""
    from pim_sort_merge_join_tpu_torch.columnar.table import Table, concat_tables

    rng = np.random.default_rng(7)
    for dtype in (np.int64, np.uint64, np.float64):
        parts = [(rng.integers(0, 2**62, size=(k, 4)).astype(dtype), cap)
                 for k, cap in ((5, 8), (0, 4), (1_000_000, 1_000_000), (3, 16))]
        got, want = (concat_tables([Table.from_numpy(r, capacity=c, dtype=dtype, device=device)
                                    for r, c in parts]) for device in ("cuda", "cpu"))
        check(got.device.type == "cuda" and int(got.num_rows) == int(want.num_rows)
              and got.names == want.names and got.dtype == want.dtype
              and np.array_equal(got.data.cpu().numpy().view(np.int64),
                                 want.data.numpy().view(np.int64)),
              f"concat_tables {np.dtype(dtype).name}: the card's table differs from the CPU's")
    log("concat_tables: int64, uint64 and float64 tables on the card equal to the CPU's")


def phase_entry_examples(card: str) -> dict:
    """Phase 13b: the entry points and the five examples on the card.

    (a) `entry.entry(n)`'s step at n = 4096 and 10M: rows equal to
    `pipeline_oracle` on the same numpy tables, exactly the fused path's
    kernels launched, timed by CUDA events (median of 3 after a warmup);
    then `concat_tables` on the card against the CPU;
    (b) `dryrun_multichip(4)` on 4 Gloo ranks sharing cuda:0; (c) each
    example with ``--device cuda`` (02 and 05 on 4 ranks on cuda:0), every
    value it returns equal to the same example with ``--device cpu``.
    The 10M oracle goes to a worker process at the start, the CPU's runs
    once (a) is timed; then (b) and the card's 02 and 05, whose time is
    their ranks' start, run in threads beside the other examples.
    """
    import concurrent.futures
    import multiprocessing

    import torch

    from pim_sort_merge_join_tpu_torch.entry import dryrun_multichip, entry, entry_rows
    from pim_sort_merge_join_tpu_torch.examples import NAMES
    from pim_sort_merge_join_tpu_torch.ops import oracle

    t_phase = time.perf_counter()
    rec = {"entry": {}, "examples": {}}
    outputs = tempfile.TemporaryDirectory()

    def example_argv(name, device):
        # 01 writes its result CSV where it is told.
        out = os.path.join(outputs.name, f"{name}.{device}.csv")
        return (["--output", out] if name == "single_chip_pipeline" else []) + ["--device", device]

    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=4, mp_context=multiprocessing.get_context("spawn"),
        initializer=cpu_worker_init)
    try:
        big = pool.submit(entry_oracle, ENTRY_WIDTHS[-1])
        results = {}
        for n in ENTRY_WIDTHS:
            fn, (t1, t2) = entry(n)
            check(t1.device.type == "cuda", f"entry({n}): tables on {t1.device}, not the card")
            # `pipeline_core` takes an unresolved "auto" as wide.
            path, kernels_of_path = (
                ("FUSED_KERNELS", FUSED_KERNELS) if fn.keywords["config"].narrow_keys is True
                else ("FUSED_WIDE_KERNELS", FUSED_WIDE_KERNELS))
            kernels_of_path = kernels_of_path | KEYS_KERNELS
            out, launches = run_counted(lambda: fn(t1, t2), kernels_of_path, f"entry({n})")
            results[n] = out.to_numpy()
            ms = time_ms(lambda _: fn(t1, t2))
            rec["entry"][n] = {"rows": int(results[n].shape[0]), "ms": ms, "launches": launches,
                               "kernels": path}
            log(f"entry({n}): {results[n].shape[0]} rows; launched exactly {path} {launches}; "
                f"step {ms:.3f} ms (CUDA events, median of 3); {card}")
            del fn, t1, t2, out
        torch.cuda.empty_cache()
        phase_concat_tables()
        # The multi-device examples first: their ranks' start is most of
        # their time.
        order = sorted(NAMES, key=lambda name: bool(EXAMPLE_KERNELS[name]))
        cpu = {name: pool.submit(run_example, name, example_argv(name, "cpu")) for name in order}

        def timed(fn, *args):
            t0 = time.perf_counter()
            return fn(*args), time.perf_counter() - t0

        # Nothing here redirects stdout: threads share it. The threads'
        # code launches no kernel in this process (their ranks do), so the
        # counts read around each example of this thread are its own.
        got = {}
        with concurrent.futures.ThreadPoolExecutor(max_workers=3) as threads:
            ranked = {name: threads.submit(timed, run_example, name, example_argv(name, "cuda"),
                                           False)
                      for name in order if not EXAMPLE_KERNELS[name]}
            dryrun = threads.submit(timed, dryrun_multichip, 4, "cuda:0")
            for name in order:
                if EXAMPLE_KERNELS[name]:
                    t0 = time.perf_counter()
                    (got[name], _), launches = run_counted(
                        lambda: run_example(name, example_argv(name, "cuda"), False),
                        EXAMPLE_KERNELS[name], f"example {name}")
                    rec["examples"][name] = {"s": time.perf_counter() - t0, "launches": launches}
            rows, rec["dryrun_4_s"] = dryrun.result()
            for name, fut in ranked.items():
                (got[name], _), wall = fut.result()
                rec["examples"][name] = {"s": wall, "launches": {}}
        log(f"dryrun_multichip(4) on cuda:0: {rows.shape[0]} rows equal to the oracle in "
            f"{rec['dryrun_4_s']:.1f} s (host clock, the ranks' start included); {card}")
        for name in NAMES:
            want, _ = cpu[name].result()
            check(same_value(got[name], want), f"example {name}: the card's results differ from "
                  f"the CPU's: {sorted(k for k in want if not same_value(got[name].get(k), want[k]))}")
            r = rec["examples"][name]
            log(f"example {name}: every returned value equal to --device cpu; {r['s']:.2f} s "
                f"(host clock); launches here {r['launches']}")
        for n in ENTRY_WIDTHS:
            want = big.result() if n == ENTRY_WIDTHS[-1] else oracle.pipeline_oracle(*entry_rows(n))
            check(np.array_equal(results[n], want), f"entry({n}): rows differ from pipeline_oracle")
        log(f"entry({', '.join(map(str, ENTRY_WIDTHS))}): rows equal to pipeline_oracle")
    finally:
        pool.shutdown(cancel_futures=True)
        outputs.cleanup()
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"entry and examples: phase {rec['phase_s']:.1f} s; {card}")
    return rec


# --- phase 14: the multi-device engine ---------------------------------------

DIST_RANKS = 4
# Every rank packs its rows with the int32 destination as the key (packed-32
# element, one row gather) and compacts what arrives with a row gather, then
# runs the local join of its path: the fused join's kernels on the 1:1 runs;
# on the inner and aggregate runs the local table sorts, the broadcast side's
# pack and union sort, and the inner join's or the aggregate's kernels;
# with ``sort_algorithm="pallas_bitonic"`` the inner join's local table
# sorts run the bitonic kernel.
# Every run but the aggregate resolves narrow keys through the probe.
DIST_FUSED_KERNELS = FUSED_KERNELS | PROBE_KERNELS
DIST_STAGED_KERNELS = STAGED_KERNELS | PROBE_KERNELS
DIST_STAGED_BITONIC_KERNELS = STAGED_BITONIC_KERNELS | PROBE_KERNELS


def dist_cases(n: int, nz: int) -> tuple[dict, list[dict]]:
    """Phase 14's inputs (name -> two tables) and runs. ``n`` rows a table
    for the range, hash, inner and aggregate runs (the phase 5 and path A
    tables), ``nz`` for the Zipf, bitonic inner and resumable runs (a
    rank's received table, about ``nz / 2`` rows at the exchange slack of
    2, stays within the bitonic kernel's 2^21). The Zipf tables keep
    every row (``col1 > 0``); their hottest key holds about a quarter of
    the rows, and the heavy-hitter fraction of 0.05 of the pooled sample
    makes it (and the next ones) heavy. The keys below the first splitter
    still hold about half the rows, so the Zipf runs take an exchange slack
    of 3 and a join slack of 2. The Zipf inner join pairs the Zipf
    table with one whose keys are 1..nz, each once, so that its cross
    products stay small."""
    import dataclasses

    from pim_sort_merge_join_tpu_torch import EngineConfig, Predicate
    from pim_sort_merge_join_tpu_torch.columnar.generate import generate_table

    r1, r2, cfg = slice_inputs(n)
    a1, a2, acfg = staged_inputs(n, "auto")
    b1, b2, bcfg = staged_inputs(nz, "pallas_bitonic")
    f1, f2, fcfg = slice_inputs(nz)
    z1 = generate_table(nz, seed=1, key_distribution="zipf")
    z2 = generate_table(nz, seed=2, key_distribution="zipf")
    u2 = f2.copy()
    u2[:, 0] = np.random.default_rng(3).permutation(nz) + 1
    every = Predicate(0, ">", 0)
    zcfg = EngineConfig(predicate1=every, predicate2=every, heavy_hitter_fraction=0.05,
                        exchange_slack=3.0, join_slack=2.0)
    inputs = {"fused": (r1, r2), "staged": (a1, a2), "zipf": (z1, z2), "zipf_unique": (z1, u2),
              "fused_small": (f1, f2), "staged_small": (b1, b2)}
    cases = [
        {"label": "range 1:1", "inputs": "fused", "kind": "join", "cfg": cfg, "order": True,
         "kernels": DIST_FUSED_KERNELS, "to_numpy": True},
        {"label": "hash 1:1", "inputs": "fused", "kind": "join",
         "cfg": dataclasses.replace(cfg, partition_scheme="hash"), "order": False,
         "kernels": DIST_FUSED_KERNELS},
        {"label": "inner", "inputs": "staged", "kind": "join", "cfg": acfg, "order": False,
         "kernels": DIST_STAGED_KERNELS},
        {"label": "aggregate sum", "inputs": "staged", "kind": "aggregate", "cfg": acfg,
         "order": True, "kernels": STAGED_KERNELS},
        {"label": "zipf 1:1", "inputs": "zipf", "kind": "join", "cfg": zcfg, "order": False,
         "heavy": True, "kernels": DIST_FUSED_KERNELS},
        {"label": "zipf inner", "inputs": "zipf_unique", "kind": "join",
         "cfg": dataclasses.replace(zcfg, join_mode="inner"), "order": False, "heavy": True,
         "kernels": DIST_STAGED_KERNELS},
        {"label": "inner bitonic", "inputs": "staged_small", "kind": "join", "cfg": bcfg,
         "order": False, "kernels": DIST_STAGED_BITONIC_KERNELS},
        {"label": "resumable", "inputs": "fused_small", "kind": "resumable", "cfg": fcfg,
         "order": True, "kernels": DIST_FUSED_KERNELS},
    ]
    return inputs, cases


def dist_single(case: dict, r1, r2, device: str = "cuda") -> np.ndarray:
    """The single-device rows a run is held against: `QueryPipeline.run_tables`,
    or `hash_aggregate` of table 1 for the aggregate."""
    from pim_sort_merge_join_tpu_torch import QueryPipeline, Table
    from pim_sort_merge_join_tpu_torch.ops.hash_join import hash_aggregate

    if case["kind"] == "aggregate":
        return hash_aggregate(Table.from_numpy(r1, device=device), 0, 1, "sum").to_numpy()
    t1, t2 = Table.from_numpy(r1, device=device), Table.from_numpy(r2, device=device)
    return QueryPipeline(case["cfg"], device=device).run_tables(t1, t2).to_numpy()


def _span_ms(fn, device):
    """``fn()``'s result and its milliseconds: CUDA events on the card, the
    host clock on the CPU."""
    import torch

    if device.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def dist_rank(directory: str, cases: list, device: str) -> dict:
    """One rank of phase 14 (started by `spawn_simulator`, Gloo): every run
    of ``cases`` on ``device``, each with the launch counts set to 0 just
    before and read just after; this rank's output rows go to
    ``directory/<run>.rank<r>.npy`` and its record to
    ``directory/rank<r>.json``. Then each run again, warm, whole, between
    barriers (host clock), and each join run once more, its exchange and
    its local join apart (CUDA events)."""
    import hashlib

    import torch
    import torch.distributed as dist

    from pim_sort_merge_join_tpu_torch.engine import distributed as dq
    from pim_sort_merge_join_tpu_torch.exchange import collectives
    from pim_sort_merge_join_tpu_torch.ops import kernels

    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        collectives.barrier()

    # The Gloo route's rate: 256 MiB from each rank in one all_to_all (the
    # 10M runs move 160 MiB of blocks a table).
    probe = torch.zeros((world, (32 << 20) // world), dtype=torch.int64, device=dev)
    collectives.all_to_all(probe)
    sync()
    _, probe_ms = _span_ms(lambda: collectives.all_to_all(probe), dev)
    recs = {"route": {"bytes": probe.numel() * 8, "ms": probe_ms,
                      "gb_per_s": probe.numel() * 8 / probe_ms / 1e6}}
    for case in cases:
        label, cfg = case["label"], case["cfg"]
        r1, r2 = (np.load(os.path.join(directory, f"{case['inputs']}.{i}.npy"), mmap_mode="r")
                  for i in (1, 2))
        t1 = dq.ShardedTable.from_numpy(r1, device=dev)
        t2 = dq.ShardedTable.from_numpy(r2, device=dev)
        pipe = dq.DistributedQueryPipeline(cfg, device=dev)
        if case["kind"] == "resumable":
            cfg = dataclasses.replace(cfg, checkpoint_dir=os.path.join(directory, "checkpoint"))
            pipe = dq.DistributedQueryPipeline(cfg, device=dev)
        run = {"join": lambda: pipe.run_tables(t1, t2),
               "aggregate": lambda: pipe.run_aggregate(t1, key=0, value=1, agg="sum"),
               "resumable": lambda: pipe.run_tables_resumable(t1, t2)}[case["kind"]]
        sync()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = run()
        sync()
        rec = {"first_query_ms": (time.perf_counter() - t0) * 1e3,
               "launches": {k: v for k, v in kernels.launch_counts().items() if v},
               "rows": int(out.num_rows), "capacity": out.capacity}
        if dev.type == "cuda":
            rec["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        rows = out.data[:rec["rows"]].cpu().numpy()
        np.save(os.path.join(directory, f"{label}.rank{rank}.npy"), rows)
        if case.get("to_numpy"):
            rec["to_numpy_sha256"] = hashlib.sha256(out.to_numpy().tobytes()).hexdigest()
        if case["kind"] == "resumable":
            zeros = dq.ShardedTable.from_numpy(np.zeros(r1.shape, r1.dtype), device=dev)
            again = dq.DistributedQueryPipeline(cfg, device=dev)
            stages = again.checkpoint_stages()
            sync()
            kernels.reset_launch_counts()
            resumed = again.run_tables_resumable(zeros, zeros)
            sync()
            rec["resume_launches"] = {k: v for k, v in kernels.launch_counts().items() if v}
            rec["resumed_from"] = stages
            rec["resume_equal"] = bool(int(resumed.num_rows) == rec["rows"] and torch.equal(
                resumed.data, out.data))
        if case["kind"] != "resumable":
            # Warm: the whole query again between barriers (host clock).
            sync()
            t0 = time.perf_counter()
            run()
            sync()
            rec["warm_query_ms"] = (time.perf_counter() - t0) * 1e3
        if case["kind"] == "join":
            # And once more, the exchange and the local join apart.
            cap = pipe._exchange_capacity(t1, t2)
            rcfg = pipe._resolved_config(t1, t2)
            sync()
            (s1, s2, _), rec["exchange_ms"] = _span_ms(
                lambda: dq.distributed_exchange_core(t1, t2, rcfg, exchange_capacity=cap), dev)
            _, rec["join_ms"] = _span_ms(lambda: dq.distributed_join_core(s1, s2, rcfg), dev)
            sync()
            bucket = -(-cap // world)
            rec["rows_received"] = int(s1.num_rows) + int(s2.num_rows)
            rec["bytes_received"] = rec["rows_received"] * t1.ncol * 8
            # Both tables' padded blocks, sent and received once each.
            rec["wire_bytes"] = 2 * world * bucket * t1.ncol * 8
            # The least time over the route: the rows any exchange must
            # move; and the padded blocks this one moves.
            rate = recs["route"]["gb_per_s"] * 1e6
            rec["exchange_bound_ms"] = rec["bytes_received"] / rate
            rec["padded_bound_ms"] = rec["wire_bytes"] / rate
        recs[label] = rec
        del t1, t2, out, pipe
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    with open(os.path.join(directory, f"rank{rank}.json"), "w") as f:
        json.dump(recs, f)
    return recs


def in_hash_order(rows: np.ndarray) -> np.ndarray:
    """``rows`` stably sorted by a 64-bit hash of the whole row. Two arrays
    come out equal when they hold the same multiset of rows (a `lexsort`
    of 3M rows of 7 columns takes 8 s); distinct rows of equal hash can
    only make equal multisets compare unequal, never the reverse."""
    mult = np.random.default_rng(0).integers(1, 2**63, rows.shape[1], dtype=np.uint64) | 1
    h = (rows.astype(np.uint64) * mult).sum(axis=1, dtype=np.uint64)
    return rows[np.argsort(h, kind="stable")]


def check_dist_case(case: dict, want: np.ndarray, blocks: list, recs: list) -> None:
    """Hold one run's rank blocks against the single-device rows: in rank
    order for range partitioning, as a multiset otherwise; every key on one
    rank (heavy keys excepted, which skew spreads), each rank's rows in key
    order, and each rank's launches exactly the kernels of the path."""
    from pim_sort_merge_join_tpu_torch.exchange.skew import max_heavy_hitters

    label = case["label"]
    got = np.concatenate(blocks)
    check(got.shape == want.shape, f"distributed {label}: {got.shape} rows vs single {want.shape}")
    if case["order"]:
        check(np.array_equal(got, want), f"distributed {label}: rows differ from the single-device "
              "rows in order")
    else:
        check(np.array_equal(in_hash_order(got), in_hash_order(want)),
              f"distributed {label}: the rows differ from the single-device rows as a multiset")
    for r, b in enumerate(blocks):
        check(bool((np.diff(b[:, 0]) >= 0).all()), f"distributed {label}: rank {r} not in key order")
    keys = [np.unique(b[:, 0]) for b in blocks]
    allk, cnt = np.unique(np.concatenate(keys), return_counts=True)
    spread = allk[cnt > 1]
    if case.get("heavy"):
        hot = np.bincount(want[:, 0]).argmax()
        check(hot in spread, f"distributed {label}: the hottest key {hot} is on one rank: no heavy "
              "hitter was detected")
        k_max = max_heavy_hitters(case["cfg"].heavy_hitter_fraction, len(blocks))
        check(len(spread) <= k_max, f"distributed {label}: {len(spread)} keys on several ranks, "
              f"more than {k_max} heavy hitters")
    else:
        check(spread.size == 0, f"distributed {label}: keys {spread[:5]} on several ranks")
    for r, rec in enumerate(recs):
        runs = {"launches": rec["launches"], **({"resume_launches": rec["resume_launches"]}
                                               if "resume_launches" in rec else {})}
        for what, launches in runs.items():
            check(set(launches) == case["kernels"], f"distributed {label}: rank {r} {what} "
                  f"{sorted(launches)}, the path's kernels are {sorted(case['kernels'])}")
        if case["kind"] == "resumable":
            check(rec["resumed_from"] == ["exchanged", "joined"] and rec["resume_equal"],
                  f"distributed {label}: rank {r} resumed from {rec['resumed_from']}, equal "
                  f"{rec['resume_equal']}")
    if case.get("to_numpy"):
        import hashlib

        sha = hashlib.sha256(got.tobytes()).hexdigest()
        check(all(rec["to_numpy_sha256"] == sha for rec in recs),
              f"distributed {label}: to_numpy differs from the ranks' blocks")


def phase_distributed(card: str, n: int = 10_000_000, nz: int = 2_000_000) -> dict:
    """Phase 14: the multi-device engine on the card.

    (a) NCCL at world size 1 in this process: the fused 1:1 query on the
    phase 5 tables through `DistributedQueryPipeline`, equal to
    `QueryPipeline.run_tables` row for row, with the fused kernels.
    (b) `DIST_RANKS` ranks spawned on cuda:0 in one Gloo group (NCCL takes
    one rank per card; Gloo stages the CUDA tensors through the host):
    every run of `dist_cases`, held by `check_dist_case` against the
    single-device rows computed here on the card.
    """
    import torch
    import torch.distributed as dist

    from pim_sort_merge_join_tpu_torch import QueryPipeline, Table
    from pim_sort_merge_join_tpu_torch.engine.distributed import (
        DistributedQueryPipeline,
        ShardedTable,
    )
    from pim_sort_merge_join_tpu_torch.runner.simulator import spawn_simulator

    t_phase = time.perf_counter()
    inputs, cases = dist_cases(n, nz)
    spans = {"inputs_s": time.perf_counter() - t_phase}
    r1, r2 = inputs["fused"]
    single = QueryPipeline(cases[0]["cfg"]).run_tables(Table.from_numpy(r1), Table.from_numpy(r2))
    want = single.to_numpy()
    del single
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        pipe = DistributedQueryPipeline(cases[0]["cfg"])
        t1, t2 = ShardedTable.from_numpy(r1), ShardedTable.from_numpy(r2)
        out, launches_a = run_counted(lambda: pipe.run_tables(t1, t2), DIST_FUSED_KERNELS,
                                      "distributed NCCL 1 rank")
        check(np.array_equal(out.to_numpy(), want),
              "distributed NCCL 1 rank: rows differ from QueryPipeline.run_tables")
        nccl_ms = host_ms(lambda: pipe.run_tables(t1, t2))
        del pipe, t1, t2, out
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    log(f"distributed (a) NCCL world size 1, range 1:1 {n}: {want.shape[0]} rows equal to "
        f"QueryPipeline.run_tables; launches {launches_a}; run_tables {nccl_ms:.3f} ms (host, "
        f"median of 3); {card}")
    rec = {"nccl_1_rank": {"rows": want.shape[0], "ms": nccl_ms, "launches": launches_a}}
    spans["nccl_s"] = time.perf_counter() - t_phase - sum(spans.values())
    with tempfile.TemporaryDirectory() as d:
        for name, (a, b) in inputs.items():
            np.save(os.path.join(d, f"{name}.1.npy"), a)
            np.save(os.path.join(d, f"{name}.2.npy"), b)
        spans["save_s"] = time.perf_counter() - t_phase - sum(spans.values())
        wants = {c["label"]: dist_single(c, *inputs[c["inputs"]]) for c in cases}
        spans["single_s"] = time.perf_counter() - t_phase - sum(spans.values())
        del inputs, r1, r2
        torch.cuda.empty_cache()
        spawn_simulator(dist_rank, DIST_RANKS, d, cases, "cuda:0", timeout=300)
        spans["ranks_s"] = time.perf_counter() - t_phase - sum(spans.values())
        recs = []
        for r in range(DIST_RANKS):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                recs.append(json.load(f))
        for case in cases:
            label = case["label"]
            blocks = [np.load(os.path.join(d, f"{label}.rank{r}.npy")) for r in range(DIST_RANKS)]
            check_dist_case(case, wants[label], blocks, [rr[label] for rr in recs])
            rec[label] = {"rows": int(wants[label].shape[0]),
                          "ranks": [rr[label] for rr in recs]}
    spans["checks_s"] = time.perf_counter() - t_phase - sum(spans.values())
    rec["route"] = [rr["route"] for rr in recs]
    rec["phase_s"] = {"total": time.perf_counter() - t_phase, **spans}
    log(f"distributed (b) {DIST_RANKS} ranks on cuda:0 over Gloo, every run equal to "
        f"the single-device rows, keys co-located, each rank in key order, each rank's launches "
        f"the path's; {card}; Gloo route GB/s by rank "
        f"{[round(r['gb_per_s'], 3) for r in rec['route']]}; phase s {json.dumps(rec['phase_s'])}")
    per_rank = ("first_query_ms", "warm_query_ms", "exchange_ms", "join_ms", "exchange_bound_ms",
                "padded_bound_ms", "rows_received", "bytes_received", "wire_bytes", "rows",
                "peak_gb")
    for case in cases:
        ranks = rec[case["label"]]["ranks"]
        summary = {k: [r[k] for r in ranks] for k in per_rank if k in ranks[0]}
        log(f"  distributed {case['label']}: {rec[case['label']]['rows']} rows; per rank "
            + json.dumps(summary) + f"; launches (rank 0) {ranks[0]['launches']}"
            + (f", resumed {ranks[0]['resume_launches']}" if "resume_launches" in ranks[0] else ""))
    return rec


# The launch counters each entry of the `kernels` line counts.
LAUNCH_KEYS = {
    "hbm_sort_chunk": {"hbm_sort_chunk"}, "hbm_sort_merge": {"hbm_sort_merge"},
    "hbm_sort_gather": {"hbm_sort_gather"}, "gather_rows": {"gather_rows"},
    "join_scan_forward": {"join_scan_forward"}, "join_scan_backward": {"join_scan_backward"},
    "join_scan_place": {"join_scan_place"},
    "bitonic_sort": {"bitonic_local", "bitonic_strided"}, "radix_tile_sort": {"radix_tile"},
    "lsd_radix_sort": LSD_KERNELS, "narrow_extremes": PROBE_KERNELS, "join_keys": KEYS_KERNELS,
}

# The device names of the kernels in csrc/, as the profiler lists them.
PORT_KERNEL_NAMES = ("run_sort_kernel", "merge_kernel", "gather_kernel", "gather_rows_kernel",
                     "join_scan_", "bitonic_pass_kernel", "radix_", "narrow_extremes_kernel",
                     "join_keys_kernel")


def phase_profile() -> None:
    """One `run_tables` of the fused 10M, the staged 10M, the 1:1 hash 10M
    and the uint64 fused 10M query under `torch.profiler`: device span,
    busy time, kernel launches, peak memory and the kernels by device time;
    none may call `torch.equal`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pim_sort_merge_join_tpu_torch import QueryPipeline, Table

    import dataclasses

    from pim_sort_merge_join_tpu_torch import Predicate

    r1, r2, cfg = slice_inputs(10_000_000)
    upred = Predicate(0, ">", 2**63 + cfg.predicate1.value)
    ucfg = dataclasses.replace(cfg, dtype="uint64", predicate1=upred, predicate2=upred)
    u1, u2 = (shifted_key(r, np.uint64, 2**63) for r in (r1, r2))
    for label, (r1, r2, cfg) in (("fused 10M", (r1, r2, cfg)),
                                 ("staged inner 10M", staged_inputs(10_000_000, "auto")),
                                 ("hash 1:1 10M", (r1, r2, hash_config(cfg))),
                                 ("uint64 fused 10M", (u1, u2, ucfg))):
        g1, g2 = (Table.from_numpy(r, dtype=cfg.dtype) for r in (r1, r2))
        pipe = QueryPipeline(cfg)
        del r1, r2
        for _ in range(2):
            pipe.run_tables(g1, g2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            pipe.run_tables(g1, g2)
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
        # The stage spans (`engine/metrics`, ``smj.*``) show on the device's
        # timeline too, as annotations: no device work.
        on_card = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)]
        check(bool(on_card), f"profile {label}: the profiler saw no device activity")
        equals = sum(1 for e in prof.events() if e.name == "aten::equal")
        check(equals == 0, f"profile {label}: {equals} torch.equal calls (a host sync each)")
        start = min(e.time_range.start for e in on_card)
        end = max(e.time_range.end for e in on_card)
        busy = sum(e.time_range.end - e.time_range.start for e in on_card)
        by_name: dict = {}
        for e in on_card:
            t, c = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.end - e.time_range.start, c + 1)
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
        # The 14 longest, and the join scans wherever they rank.
        top = ranked[:14] + [kv for kv in ranked[14:] if "join_scan" in kv[0]]
        ours = sum(t for name, (t, _) in by_name.items()
                   if any(k in name for k in PORT_KERNEL_NAMES))
        log(f"profile {label}: no torch.equal; host {host_ms:.3f} ms under the profiler; device span "
            f"{(end - start) / 1e3:.3f} ms, busy {busy / 1e3:.3f} ms "
            f"({100 * (1 - busy / (end - start)):.1f}% idle; the port's kernels {ours / 1e3:.3f} ms, "
            f"torch ops {(busy - ours) / 1e3:.3f} ms), {len(on_card)} device activities; "
            f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        for name, (t, c) in top:
            log(f"  {t / 1e3:8.3f} ms  x{c:<4d} {name[:100]}")
        del g1, g2, pipe
        torch.cuda.empty_cache()


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
    if sys.argv[1:] == ["--profile"]:
        phase_profile()
        print(card)
        return 0
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}", file=sys.stderr)
        return 2
    rng = np.random.default_rng(20241220)
    errs = phase_adversarial(rng)
    r1, r2, cfg = slice_inputs(10_000_000)
    shapes = phase_main_path_shapes(r1, r2, cfg)
    probe_rec = phase_probe_shape(r1, r2)
    keys_rec = phase_keys_shape(r1, r2, cfg)
    torch.cuda.empty_cache()
    bitonic = phase_bitonic_shape(rng)
    phase_csv_100k()
    launches, ms10, rows10 = phase_slice(r1, r2, cfg, expect_narrow=True, label="10M",
                                         kernels_of_path=FUSED_KERNELS | PROBE_KERNELS | KEYS_KERNELS)
    del r1, r2
    torch.cuda.empty_cache()
    w1, w2, wcfg = slice_inputs(1_000_000, key_offset=2**40)
    phase_slice(w1, w2, wcfg, expect_narrow=False, label="1M wide keys",
                kernels_of_path=FUSED_WIDE_KERNELS | PROBE_KERNELS | KEYS_KERNELS)
    a1, a2, acfg = staged_inputs(10_000_000, "auto")
    launches_a, msa, rowsa = phase_slice(a1, a2, acfg, expect_narrow=True, label="staged inner 10M",
                                kernels_of_path=STAGED_KERNELS | PROBE_KERNELS)
    del a1, a2
    torch.cuda.empty_cache()
    b1, b2, bcfg = staged_inputs(2_000_000, "pallas_bitonic")
    launches_b, msb, rowsb = phase_slice(b1, b2, bcfg, expect_narrow=True,
                                         label="staged inner 2M bitonic",
                                         kernels_of_path=STAGED_BITONIC_KERNELS | PROBE_KERNELS)
    del b1, b2
    r1, r2, cfg = slice_inputs(10_000_000)
    phase_hash_shapes(r1, r2, cfg)
    torch.cuda.empty_cache()
    _, msh, rowsh = phase_slice(r1, r2, hash_config(cfg), expect_narrow=True, label="hash 1:1 10M",
                                kernels_of_path=HASH_ONE_TO_ONE_KERNELS | PROBE_KERNELS)
    del r1, r2
    torch.cuda.empty_cache()
    a1, a2, acfg = staged_inputs(10_000_000, "auto")
    _, mshi, rowshi = phase_slice(a1, a2, hash_config(acfg), expect_narrow=True,
                                  label="hash inner 10M",
                                  kernels_of_path=HASH_INNER_KERNELS | PROBE_KERNELS)
    check(rowshi == rowsa, f"hash inner 10M: {rowshi} rows, the sort-merge inner join {rowsa}")
    r1, r2, cfg = slice_inputs(10_000_000)
    typed = phase_types(r1, r2, cfg, a1, a2, acfg)
    del a1, a2
    torch.cuda.empty_cache()
    csv_stages = phase_csv_stages(r1, r2, cfg, rows10)
    del r1, r2
    torch.cuda.empty_cache()
    phase_operators()
    torch.cuda.empty_cache()
    phase_resumable()
    phase_csv_debug_log()
    phase_edge_keys(rng)
    phase_cli()
    phase_entry_examples(card)
    phase_distributed(card)

    src = "pim_sort_merge_join_tpu_torch/csrc/"
    ref = "pim_sort_merge_join_tpu/ops/pallas/"
    sort_err = max(errs["sort"], shapes["merge_sort_err"], shapes["unmerge_sort_err"])
    pair_err = max(errs["scan"], shapes["scan_err"], shapes["wide_scan_err"])
    forward_err = max(pair_err, errs["scan_forward"], shapes["forward_err"],
                      shapes["wide_forward_err"])
    backward_err = max(pair_err, errs["scan_backward"], shapes["backward_err"],
                       shapes["wide_backward_err"])
    place_err_ = max(errs["place"], shapes["place_err"], shapes["wide_place_err"])

    def entry(name, source, replaces, launches, err, ms, plain_ms, bound_rec, library_ms=None):
        # Launches per query on each path of the other element types.
        by_path = {label: sum(v for k, v in r["launches"].items() if k in LAUNCH_KEYS[name])
                   for label, r in typed.items()}
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": ref + replaces, "launches": launches, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_rec["bound_ms"],
                "bound_by": bound_rec["bound_by"], "library_ms": library_ms,
                "launches_typed_paths": by_path}

    chunk, merge = shapes["chunk"], shapes["merge"]
    # The column gather at the inner join's un-merge sort (staged A launches
    # it; the fused query with narrow keys needs none). The row gather at the
    # staged path's table sort, whole rows by a permutation, where one
    # PyTorch call computes the same (`index_select`); its two-table shapes
    # (`rows_emit`, `rows_inner_emit`), which no single call computes, are in
    # the "gather shapes" line.
    gather, rows = shapes["gather_20M_3xint32"], shapes["rows_table_sort"]
    lsd = shapes["lsd_merge"]
    gather_err = max(errs["gather"], *(v["err"] for k, v in shapes.items() if k.startswith("gather_")))
    rows_err_ = max(errs["gather_rows"], shapes["emit_sort_err"],
                    *(v["err"] for k, v in shapes.items() if k.startswith("rows_")))
    kernels = [
        entry("hbm_sort_chunk", "hbm_sort.cu", "hbm_sort.py:286", launches["hbm_sort_chunk"],
              sort_err, chunk["ms"], shapes["merge_sort_plain_ms"], chunk, chunk["library_ms"]),
        # All merge passes of the 20M merge sort; the library call sorts the
        # same run-sorted elements.
        entry("hbm_sort_merge", "hbm_sort.cu", "hbm_sort.py:463", launches["hbm_sort_merge"],
              sort_err, merge["ms"], shapes["merge_sort_plain_ms"], merge, merge["library_ms"]),
        entry("hbm_sort_gather", "hbm_sort.cu", "hbm_sort.py:670", launches_a["hbm_sort_gather"],
              max(sort_err, gather_err), gather["ms"], gather["plain_ms"], gather,
              gather["library_ms"]),
        entry("gather_rows", "gather.cu", "hbm_sort.py:670", launches["gather_rows"],
              rows_err_, rows["ms"], rows["plain_ms"], rows, rows["library_ms"]),
        entry("join_scan_forward", "join_scan.cu", "join_scan.py:137",
              launches["join_scan_forward"], forward_err, shapes["forward_ms"],
              shapes["forward_plain_ms"], shapes["forward_bound"]),
        entry("join_scan_backward", "join_scan.cu", "join_scan.py:216",
              launches["join_scan_backward"], backward_err, shapes["backward_ms"],
              shapes["backward_plain_ms"], shapes["backward_bound"]),
        # No Pallas kernel: it replaces the sorts of steps 2-3 of the JAX
        # package's `_one_to_one_merged`.
        {**entry("join_scan_place", "join_scan.cu", "", launches["join_scan_place"],
                 place_err_, shapes["place_ms"], shapes["place_plain_ms"], shapes["place_bound"],
                 shapes["place_library_ms"]),
         "replaces": "pim_sort_merge_join_tpu/ops/join.py:261 _one_to_one_merged, steps 2-3"},
        entry("bitonic_sort", "bitonic_sort.cu", "sort_kernel.py:138",
              launches_b["bitonic_local"] + launches_b["bitonic_strided"],
              max(errs["bitonic"], bitonic["bitonic_err"]), bitonic["bitonic_ms"],
              bitonic["bitonic_plain_ms"], bitonic["bitonic_bound"],
              bitonic["bitonic_library_ms"]),
        entry("radix_tile_sort", "radix_sort.cu", "radix_sort.py:78",
              shapes["launches"]["radix_tile"],
              max(errs["radix"], *(shapes[f"radix{t}_err"] for t in (2048, 512, 8192))),
              shapes["radix2048_ms"], shapes["radix2048_plain_ms"], shapes["radix_bound"],
              shapes["radix2048_library_ms"]),
        # The global sort at the merge sort's shape; its plain version is
        # timed on the first `plain_n` elements (an [n, 256] one-hot bounds
        # what it holds), where the kernels take `head_ms`.
        {**entry("lsd_radix_sort", "radix_sort.cu", "radix_sort.py:187",
                 sum(shapes["lsd_launches"].values()),
                 max(errs["lsd"], *(v["err"] for k, v in shapes.items() if k.startswith("lsd_")
                                    and k != "lsd_launches")),
                 lsd["ms"], lsd["head_plain_ms"], lsd, lsd["library_ms"]),
         "plain_n": lsd["head_n"], "head_ms": lsd["head_ms"]},
        # No Pallas kernel: the JAX package's probe is one jitted XLA
        # function. The library call finds the values' extremes alone.
        {**entry("narrow_extremes", "probe.cu", "", launches["narrow_extremes"],
                 max(errs["probe"], probe_rec["err"]), probe_rec["ms"], probe_rec["plain_ms"],
                 probe_rec, probe_rec["library_ms"]),
         "replaces": "pim_sort_merge_join_tpu/engine/pipeline.py:138 "
                     "QueryPipeline._resolve_narrow_device, probe"},
        # No Pallas kernel: the JAX package's fused keys are part of one
        # jitted function. No one PyTorch call makes them.
        {**entry("join_keys", "keys.cu", "", launches["join_keys"],
                 max(errs["keys"], keys_rec["err"]), keys_rec["ms"], keys_rec["plain_ms"],
                 keys_rec),
         "replaces": "pim_sort_merge_join_tpu/engine/pipeline.py:58 pipeline_core, the fused "
                     "path's predicate masks and keys"},
    ]
    log(f"slice 10M: {rows10} rows in {ms10:.3f} ms; staged inner 10M: {rowsa} rows in "
        f"{msa:.3f} ms; staged inner 2M bitonic: {rowsb} rows in {msb:.3f} ms; hash 1:1 10M: "
        f"{rowsh} rows in {msh:.3f} ms; hash inner 10M: {rowshi} rows in {mshi:.3f} ms")
    log("typed paths 10M (host ms, median of 3): " + json.dumps(
        {label: round(r["ms"], 3) for label, r in typed.items()})
        + f"; run_csv 10M stages (ms): {json.dumps(csv_stages['stages_ms'])}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
