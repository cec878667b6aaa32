"""Example 2: the multi-device pipeline over a process group.

The same query as example 1 on N ranks (4 unless ``--simulator N``
says), with the splitter-sampled all-to-all range exchange in place of the
reference's host merge tree. The ranks are processes in one Gloo group
(`runner/simulator.spawn_simulator`), their tensors on the card (all on
``cuda:0``) or, with ``--device cpu`` or ``--simulator N``, on the CPU.

Run: python -m pim_sort_merge_join_tpu_torch.examples.distributed [--simulator 8]
"""

from __future__ import annotations

import json
import sys

from pim_sort_merge_join_tpu_torch.examples import example_parser, parse

ROWS = 100_000


def rank_query(device: str) -> dict:
    """One rank: the query on the 100k reference tables; every rank
    returns the joined rows in rank order."""
    import pim_sort_merge_join_tpu_torch as smj
    from pim_sort_merge_join_tpu_torch.columnar.generate import generate_table
    from pim_sort_merge_join_tpu_torch.engine.distributed import DistributedQueryPipeline

    rows1 = generate_table(ROWS, seed=1)
    rows2 = generate_table(ROWS, seed=2)
    config = smj.EngineConfig(
        predicate1=smj.Predicate(0, ">", 5000),
        predicate2=smj.Predicate(0, ">", 5000),
    )
    pipe = DistributedQueryPipeline(config, device=device)
    result = pipe.run_arrays(rows1, rows2).to_numpy()
    return {"partitions": pipe.num_partitions, "result": result,
            "metrics": json.loads(pipe.metrics_json())}


def main(argv=None) -> dict:
    args = parse(example_parser("distributed", __doc__), argv)

    from pim_sort_merge_join_tpu_torch.device import rank_device
    from pim_sort_merge_join_tpu_torch.runner.simulator import spawn_simulator

    device = rank_device(args.device)
    out = spawn_simulator(rank_query, args.ranks, device)
    print(f"mesh: {out['partitions']} Gloo ranks on {device}")
    print(f"joined rows: {out['result'].shape[0]}")
    print(json.dumps(out["metrics"]))
    return {"partitions": out["partitions"], "rows": out["result"].shape[0],
            "result": out["result"]}


if __name__ == "__main__":
    main(sys.argv[1:])
