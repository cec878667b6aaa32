"""Side-by-side launcher: the numpy oracle and the port on one CSV pair
(counterpart of the root `run.py`, the reference's `run.py:1-25`).

Runs the numpy oracle pipeline and the port's `QueryPipeline.run_csv` (on
the card unless ``--device`` names another device) on the same CSV pair,
prints the oracle's time and the port's stage times, and exits 0 only when
the two results are equal (``OUTPUT MATCH``).

Usage:
    python -m pim_sort_merge_join_tpu_torch.runner.run [data1.csv data2.csv [result.csv]]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

# The reference repository's data files, relative to where it is run.
DEFAULT_D1 = "data/data1.csv"
DEFAULT_D2 = "data/data2.csv"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m pim_sort_merge_join_tpu_torch.runner.run")
    parser.add_argument("table1", nargs="?", default=DEFAULT_D1)
    parser.add_argument("table2", nargs="?", default=DEFAULT_D2)
    parser.add_argument("output", nargs="?", default="result.csv")
    parser.add_argument("--device", default=None, help="the card unless named")
    args = parser.parse_args(argv)

    import numpy as np

    import pim_sort_merge_join_tpu_torch as smj
    from pim_sort_merge_join_tpu_torch.columnar import csv_io
    from pim_sort_merge_join_tpu_torch.ops import oracle

    rows1 = csv_io.load_csv_numpy(args.table1)
    rows2 = csv_io.load_csv_numpy(args.table2)

    print("######### CPU oracle #########")
    t0 = time.perf_counter()
    want = oracle.pipeline_oracle(rows1, rows2)
    cpu_ms = (time.perf_counter() - t0) * 1000
    print(f"rows: {want.shape[0]}   exec time: {cpu_ms:.1f} ms")

    print("######### PyTorch port #########")
    pipe = smj.QueryPipeline(smj.EngineConfig(), device=args.device)
    print(f"device: {pipe.device}")
    got = pipe.run_csv(args.table1, args.table2, args.output).to_numpy()
    stages = {s.name: s.wall_s * 1000 for s in pipe.metrics.stages}
    for name, ms in stages.items():
        print(f"{name:>16}: {ms:.1f} ms")
    print(f"{'total':>16}: {sum(stages.values()):.1f} ms")

    if np.array_equal(got, want):
        print(f"OUTPUT MATCH: {got.shape[0]} rows -> {args.output}")
        return 0
    print("OUTPUT MISMATCH between oracle and engine!", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
