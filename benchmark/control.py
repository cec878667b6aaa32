"""The check's control, on the card at a cell's own size.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...] [--seconds 4]

For each seed it runs the cell as `run.py` does, with the control in the
program's place: `QueryPipeline.run_tables` answers with the plain
reference's rows, its join keys compared in float32 (the guarantee of
exact rows broken); on a sharded cell every rank's
`DistributedQueryPipeline.run_tables` does, each rank answering its
share of the reference's rows of the whole tables. The harness then
decides ``correct`` as in any run.
The window is short; every ``--check-every``-th query of it is checked
(4 by default), so that it checks at least as many queries as a full run
of the program does. It prints one JSON line per seed: the result's
``correct``, ``checked`` and ``checks``. The benchmark's own runs do not
run it.
"""

import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":  # as a script the checkout, not this directory, starts imports
    sys.path[0] = str(CHECKOUT)

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from benchmark import harness, program  # noqa: E402
from benchmark.reference import relational  # noqa: E402


def query_of(cfg) -> dict:
    """The reference's query from an `EngineConfig`."""
    def pred(p):
        return {"col": p.col, "op": p.op, "value": p.value}

    return {"predicate1": pred(cfg.predicate1), "predicate2": pred(cfg.predicate2),
            "join_key1": cfg.join_key1, "join_key2": cfg.join_key2,
            "join_mode": cfg.join_mode}


def control_run_tables(self, t1, t2, **_):
    """The reference in the program's place, join keys in float32."""
    rows = [t.data[: int(t.num_rows)] for t in (t1, t2)]
    out = relational.run_query(*rows, query_of(self.config), key_dtype=torch.float32)
    names = tuple(t1.names) + tuple(n for c, n in enumerate(t2.names)
                                    if c != self.config.join_key2)
    return program.table(out, names)


def _whole(t) -> torch.Tensor:
    """The valid rows of every rank's block of ``t``, in rank order."""
    p = dist.get_world_size()
    counts = torch.empty(p, dtype=torch.int32, device=t.device)
    dist.all_gather_into_tensor(counts, t.num_rows.reshape(1))
    blocks = torch.empty((p * t.capacity, t.ncol), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(blocks, t.data.contiguous())
    blocks = blocks.reshape(p, t.capacity, t.ncol)
    return torch.cat([blocks[i, :n] for i, n in enumerate(counts.tolist())])


def control_run_sharded(self, t1, t2, **_):
    """The reference in the program's place on one rank of a sharded cell:
    the reference's rows of the whole tables, join keys in float32, and of
    them this rank's contiguous share (the ranks' shares in rank order are
    the reference's rows)."""
    out = relational.run_query(_whole(t1), _whole(t2), query_of(self.config),
                               key_dtype=torch.float32)
    share = -(-out.shape[0] // dist.get_world_size())
    mine = out[dist.get_rank() * share:][:share]
    num_rows = torch.tensor(mine.shape[0], dtype=torch.int32, device=mine.device)
    return program.ShardedTable(mine, num_rows, t1.names)


def control_hook(rank: int) -> None:
    """The control in the program's place in a rank > 0 (a rank hook)."""
    program.DistributedQueryPipeline.run_tables = control_run_sharded


@contextlib.contextmanager
def control_in_place():
    real = program.QueryPipeline.run_tables, program.DistributedQueryPipeline.run_tables
    program.QueryPipeline.run_tables = control_run_tables
    program.DistributedQueryPipeline.run_tables = control_run_sharded
    try:
        yield
    finally:
        program.QueryPipeline.run_tables, program.DistributedQueryPipeline.run_tables = real


def control_result(cell: harness.Cell, seed: int, seconds: float, device: str,
                   log=None) -> dict:
    """A run of ``cell`` with the control in the program's place (on
    every rank of a sharded cell)."""
    with control_in_place():
        return harness.run(cell, seed, seconds, False, device, log=log or (lambda msg: None),
                           rank_hook=control_hook)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=4.0)
    parser.add_argument("--check-every", type=int, default=4)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("control.py: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.find_cell(harness.load_benchmark(), args.workload)
    cell.traffic["check_every"] = args.check_every
    for seed in args.seeds:
        result = control_result(cell, seed, args.seconds, "cuda")
        print(json.dumps({"workload": cell.name, "seed": seed, "correct": result["correct"],
                          "attempted": result["attempted"], "checked": result["checked"],
                          "checks": result["checks"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
