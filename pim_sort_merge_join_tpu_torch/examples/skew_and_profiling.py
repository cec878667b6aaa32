"""Example 5: skewed joins, partition schemes, and device profiling.

Three capabilities of the multi-device engine, on N ranks (4 unless
``--simulator N`` says; the card shared by the ranks, or the CPU):

- Zipf-skewed join keys (BASELINE config 4): heavy hitters found in the
  pooled splitter sample are spread over the ranks by occurrence rank
  (`exchange/skew.py`), so a key holding 30% of all rows no longer
  overflows one rank's exchange bucket. The reference's static boundary
  co-partitioning (app.c:585-633) cannot rebalance a hot key at all.
- ``partition_scheme="hash"`` (BASELINE config 3): mix(key) % P routing as
  an alternative to range partitioning.
- `engine/profiling.device_trace`: a `torch.profiler` capture of a run
  that Perfetto reads (also ``smj-torch run --profile DIR``); rank 0
  writes it.

Run: python -m pim_sort_merge_join_tpu_torch.examples.skew_and_profiling [--simulator N]
"""

from __future__ import annotations

import contextlib
import os
import sys
import tempfile

import numpy as np

from pim_sort_merge_join_tpu_torch.examples import example_parser, parse

N = 50_000
PREDICATE = (1, ">", 0)


def tables() -> tuple[np.ndarray, np.ndarray]:
    from pim_sort_merge_join_tpu_torch.columnar.generate import generate_table

    return (generate_table(N, seed=1, key_distribution="zipf", zipf_a=1.3),
            generate_table(N, seed=2, key_distribution="zipf", zipf_a=1.3))


def configs() -> tuple:
    """The skewed range join (a tight slack: without skew handling it
    overflows) and the hash-partitioned one."""
    import pim_sort_merge_join_tpu_torch as smj

    pred = smj.Predicate(*PREDICATE)
    skewed = smj.EngineConfig(predicate1=pred, predicate2=pred, exchange_slack=1.5,
                              splitter_sample=2048)
    hashed = smj.EngineConfig(predicate1=pred, predicate2=pred, partition_scheme="hash",
                              exchange_slack=4.0, splitter_sample=2048)
    return skewed, hashed


def rank_flow(device: str, trace_dir: str) -> dict:
    """One rank: both joins, then the skewed one again under
    `device_trace` (on rank 0). Every rank returns the joined rows."""
    from pim_sort_merge_join_tpu_torch.engine.distributed import DistributedQueryPipeline
    from pim_sort_merge_join_tpu_torch.engine.profiling import device_trace
    from pim_sort_merge_join_tpu_torch.exchange import collectives

    rows1, rows2 = tables()
    skewed, hashed = configs()
    pipe = DistributedQueryPipeline(skewed, device=device)
    out = pipe.run_arrays(rows1, rows2).to_numpy()
    out_h = DistributedQueryPipeline(hashed, device=device).run_arrays(rows1, rows2).to_numpy()
    trace = device_trace(trace_dir) if collectives.rank() == 0 else contextlib.nullcontext()
    with trace:
        DistributedQueryPipeline(skewed, device=device).run_arrays(rows1, rows2)
    return {"partitions": pipe.num_partitions, "zipf": out, "hash": out_h}


def _sorted(a: np.ndarray) -> np.ndarray:
    return a[np.lexsort(a.T[::-1])]


def main(argv=None) -> dict:
    args = parse(example_parser("skew_and_profiling", __doc__), argv)

    from pim_sort_merge_join_tpu_torch.device import rank_device
    from pim_sort_merge_join_tpu_torch.ops import oracle
    from pim_sort_merge_join_tpu_torch.runner.simulator import spawn_simulator

    device = rank_device(args.device)
    with tempfile.TemporaryDirectory(prefix="smj-example-") as td:
        res = spawn_simulator(rank_flow, args.ranks, device, td)
        n_files = sum(len(fs) for _, _, fs in os.walk(td))
    out, out_h, p = res["zipf"], res["hash"], res["partitions"]

    # --- 1. a Zipf-skewed join that naive range partitioning cannot balance
    rows1, rows2 = tables()
    want = oracle.pipeline_oracle(rows1, rows2, pred1=PREDICATE, pred2=PREDICATE)
    assert out.shape == want.shape
    zipf_ok = bool(np.array_equal(_sorted(out), _sorted(want)))
    print(f"zipf a=1.3 join over {p} shards: {out.shape[0]} rows, "
          f"matches oracle multiset: {zipf_ok}")
    # --- 2. the same join, hash-partitioned
    hash_ok = bool(np.array_equal(_sorted(out_h), _sorted(want)))
    print(f"hash-partitioned: {out_h.shape[0]} rows, same multiset: {hash_ok}")
    # --- 3. the device trace of a run
    print(f"device trace captured: {n_files} file(s) under a temp dir "
          f"(use smj-torch run --profile DIR to keep one)")
    return {"partitions": p, "zipf_rows": out.shape[0], "zipf_matches_oracle": zipf_ok,
            "hash_rows": out_h.shape[0], "hash_same_multiset": hash_ok,
            "trace_files": n_files, "zipf": out, "hash": out_h}


if __name__ == "__main__":
    main(sys.argv[1:])
