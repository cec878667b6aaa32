"""Example 4: incremental sorted-run merging + stage-checkpointed queries.

Two capabilities of the reference's SDK, engine-style:

- `ops/merge.py` is the analog of merge_dpu.c and the app.c merge-tree
  loop (app.c:408-547): sorted runs arriving over time (micro-batches,
  spill files) are merged into one sorted table without re-sorting.
- `engine/checkpoint.py` is the analog of dpu_checkpoint.h: a query
  interrupted after its filter+sort stage resumes at the join.

Run: python -m pim_sort_merge_join_tpu_torch.examples.streaming_merge_checkpoint [--device cpu]
"""

from __future__ import annotations

import sys
import tempfile

import numpy as np

from pim_sort_merge_join_tpu_torch.examples import example_parser, parse


def main(argv=None) -> dict:
    args = parse(example_parser("streaming_merge_checkpoint", __doc__), argv)

    import pim_sort_merge_join_tpu_torch as smj
    from pim_sort_merge_join_tpu_torch.columnar.table import Table
    from pim_sort_merge_join_tpu_torch.ops.merge import merge_sorted, merge_tree
    from pim_sort_merge_join_tpu_torch.ops.sort import sort_by_key

    device = args.device
    rng = np.random.default_rng(0)

    # --- incremental merge: sorted micro-batches -> one sorted table ------
    batches = []
    for _ in range(4):
        rows = np.column_stack(
            [rng.integers(0, 10_000, 250), rng.integers(0, 100, (250, 3))]
        ).astype(np.int64)
        t = Table.from_numpy(rows, capacity=256, device=device)
        batches.append(sort_by_key(t, 0))

    merged = merge_tree(batches, 0)
    merged_rows = merged.to_numpy()
    keys = merged_rows[:, 0]
    is_sorted = bool((keys[1:] >= keys[:-1]).all())
    assert is_sorted, "merge_tree output must be sorted"
    print(f"merged {len(batches)} sorted runs -> {int(merged.num_rows)} rows, "
          f"capacity {merged.capacity}")

    # Streaming flavor: fold each new run into the accumulated table as it lands.
    acc = batches[0]
    for b in batches[1:]:
        acc = merge_sorted(acc, b, 0)
    print(f"streaming fold: {int(acc.num_rows)} rows")

    # --- stage-checkpointed query: stop after sort, resume at join --------
    with tempfile.TemporaryDirectory(prefix="smj-example-") as ckdir:
        cfg = smj.EngineConfig(
            predicate1=smj.Predicate(0, ">", 500),
            predicate2=smj.Predicate(0, ">", 500),
            checkpoint_dir=ckdir,
        )
        pipe = smj.QueryPipeline(cfg, device=device)
        n = 2_000
        r1 = np.column_stack(
            [rng.permutation(np.arange(1, n + 1)), rng.integers(1, n, (n, 3))]
        ).astype(np.int64)
        r2 = np.column_stack(
            [rng.permutation(np.arange(1, n + 1)), rng.integers(1, n, (n, 3))]
        ).astype(np.int64)
        t1 = Table.from_numpy(r1, device=device)
        t2 = Table.from_numpy(r2, device=device)

        out1 = pipe.run_tables_resumable(t1, t2)  # writes the "sorted" checkpoint
        # A fresh pipeline (a new process in real life) resumes from the
        # sorted snapshot: the join runs, the filter+sort stage does not.
        pipe2 = smj.QueryPipeline(cfg, device=device)
        out2 = pipe2.run_tables_resumable(t1, t2)
        resumed = out2.to_numpy()
        same = bool(np.array_equal(out1.to_numpy(), resumed))
        assert same and resumed.shape[0] > 0
        print(f"resumed query matches: {resumed.shape[0]} rows")
    return {"merged_rows": int(merged.num_rows), "merged_capacity": merged.capacity,
            "merged": merged_rows, "merged_sorted": is_sorted,
            "fold_rows": int(acc.num_rows), "fold": acc.to_numpy(),
            "resumed_rows": resumed.shape[0], "resumed": resumed, "resumed_matches": same,
            "resumed_stages": [s.name for s in pipe2.metrics.stages]}


if __name__ == "__main__":
    main(sys.argv[1:])
