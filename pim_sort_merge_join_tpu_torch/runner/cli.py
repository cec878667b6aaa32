"""Command-line interface of the port (counterpart of `runner/cli.py`):
``smj-torch`` or ``python -m pim_sort_merge_join_tpu_torch.runner.cli``.

Subcommands:
  run        execute the pipeline on two CSVs, write the result CSV
  generate   create a benchmark table pair

``run`` takes the JAX CLI's flags with its defaults and ``--dtype``
choices, and runs on the card; ``--device cpu`` is the only way onto the
host. ``--distributed`` runs the multi-device pipeline over the process
group that torchrun set up (``--backend`` names its backend), or over one
rank when there is none; ``--simulator N`` runs it on N Gloo ranks on the
CPU (`runner/simulator.py`). With range partitioning both write the
single-device query's bytes. ``bench`` waits for the port's H100
benchmark: it exits with status 2 and says so.
"""

from __future__ import annotations

import argparse
import contextlib
import sys

BENCHMARK = 'ROADMAP queue 1, "The H100 benchmark"'


def _add_run_parser(sub):
    p = sub.add_parser("run", help="run the filter/sort/join pipeline")
    p.add_argument("table1")
    p.add_argument("table2")
    p.add_argument("-o", "--output", default="result.csv")
    p.add_argument("--select-col1", type=int, default=0)
    p.add_argument("--select-op1", default=">")
    p.add_argument("--select-val1", type=int, default=5000)
    p.add_argument("--select-col2", type=int, default=0)
    p.add_argument("--select-op2", default=">")
    p.add_argument("--select-val2", type=int, default=5000)
    p.add_argument("--join-key1", type=int, default=0)
    p.add_argument("--join-key2", type=int, default=0)
    p.add_argument("--join-mode", choices=["one_to_one", "inner"], default="one_to_one")
    p.add_argument("--join-algorithm", choices=["sort_merge", "hash"], default="sort_merge")
    p.add_argument("--distributed", action="store_true",
                   help="run the multi-device pipeline over the process group torchrun set "
                   "up (one rank without one)")
    p.add_argument("--backend", choices=["nccl", "gloo"], default="nccl",
                   help="the process group's backend under torchrun with --distributed")
    p.add_argument("--simulator", type=int, metavar="N", default=None,
                   help="run the multi-device pipeline on N Gloo ranks on the CPU (no card "
                   "needed)")
    p.add_argument("--dtype", choices=["int64", "uint64", "int32", "float64"], default="int64",
                   help="element type (the reference's T modes and the narrow int32)")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--narrow-keys", action="store_true",
                   help="sort the join's merge pass on int32 keys (requires every "
                   "join-key value to fit int32; validated at ingest)")
    p.add_argument("--metrics", action="store_true", help="print stage metrics JSON")
    p.add_argument("--debug", action="store_true",
                   help="emit per-stage structured debug events (rows in/out, bytes, "
                   "overflow headroom) to stderr")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="write a torch.profiler Chrome trace of the run to DIR/trace.json "
                   "(Perfetto reads it)")
    p.add_argument("--device", default=None,
                   help="where the query runs: the card unless named ('cpu' runs the "
                   "kernels' plain torch versions)")


def _add_generate_parser(sub):
    p = sub.add_parser("generate", help="generate benchmark table pairs")
    p.add_argument("rows", type=int)
    p.add_argument("--cols", type=int, default=4)
    p.add_argument("--out1", default="data1.csv")
    p.add_argument("--out2", default="data2.csv")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--keys", choices=["unique", "uniform", "zipf"], default="unique")


def _refuse(what: str, item: str) -> int:
    print(f"smj-torch: {what} is not in the PyTorch port yet ({item})", file=sys.stderr)
    return 2


def _config(args):
    from pim_sort_merge_join_tpu_torch.config import EngineConfig, Predicate

    return EngineConfig(
        predicate1=Predicate(args.select_col1, args.select_op1, args.select_val1),
        predicate2=Predicate(args.select_col2, args.select_op2, args.select_val2),
        join_key1=args.join_key1,
        join_key2=args.join_key2,
        join_mode=args.join_mode,
        join_algorithm=args.join_algorithm,
        dtype=args.dtype,
        checkpoint_dir=args.checkpoint_dir,
        # --narrow-keys forces the narrowing on (with ingest validation);
        # without it the pipeline's "auto" probe decides per query.
        narrow_keys=True if args.narrow_keys else "auto",
        debug_log=args.debug,
    )


def _distributed_query(args, device) -> tuple[int, str, bool]:
    """The query on this rank of the default process group (one rank when
    there is none): every rank reads both CSVs whole, rank 0 writes the
    result. Returns (rows, metrics JSON, whether this rank reports)."""
    from pim_sort_merge_join_tpu_torch.columnar import csv_io
    from pim_sort_merge_join_tpu_torch.engine.distributed import DistributedQueryPipeline
    from pim_sort_merge_join_tpu_torch.exchange import collectives

    pipe = DistributedQueryPipeline(_config(args), device=device)
    rows1 = csv_io.load_csv_numpy(args.table1)
    rows2 = csv_io.load_csv_numpy(args.table2)
    result = pipe.run_arrays(rows1, rows2).to_numpy()
    reports = collectives.rank() == 0
    if reports:
        csv_io.write_csv(args.output, result)
    return result.shape[0], pipe.metrics_json(), reports


def simulated_query(args) -> tuple[int, str, bool]:
    """`_distributed_query` on a simulator rank (on the CPU); rank 0 logs."""
    from pim_sort_merge_join_tpu_torch.exchange import collectives

    if args.debug and collectives.rank() == 0:
        from pim_sort_merge_join_tpu_torch.engine.logging import configure

        configure()
    return _distributed_query(args, "cpu")


def _run(args) -> tuple[int, str, bool]:
    if args.simulator:
        from pim_sort_merge_join_tpu_torch.runner.simulator import spawn_simulator

        return spawn_simulator(simulated_query, args.simulator, args)
    if args.distributed:
        import torch.distributed as dist

        from pim_sort_merge_join_tpu_torch.runner.multihost import initialize_multihost

        device = initialize_multihost(None, None, None, args.backend, args.device)
        try:
            return _distributed_query(args, device)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
    from pim_sort_merge_join_tpu_torch.engine.pipeline import QueryPipeline

    pipe = QueryPipeline(_config(args), device=args.device)
    n = int(pipe.run_csv(args.table1, args.table2, args.output).num_rows)
    return n, pipe.metrics_json(), True


def _cmd_run(args) -> int:
    if args.debug:
        from pim_sort_merge_join_tpu_torch.engine.logging import configure

        configure()
    trace_cm = contextlib.nullcontext()
    if args.profile:
        from pim_sort_merge_join_tpu_torch.engine.profiling import device_trace

        trace_cm = device_trace(args.profile)
    with trace_cm:
        n, metrics, reports = _run(args)
    if not reports:
        return 0  # a rank other than 0: rank 0 wrote and reports
    print(f"wrote {n} rows to {args.output}", file=sys.stderr)
    if args.profile:
        from pim_sort_merge_join_tpu_torch.engine.profiling import trace_path

        print(f"device trace written to {trace_path(args.profile)}", file=sys.stderr)
    if args.metrics:
        print(metrics)
    return 0


def _cmd_generate(args) -> int:
    from pim_sort_merge_join_tpu_torch.columnar.generate import write_table_pair

    write_table_pair(
        args.out1, args.out2, args.rows, seed=args.seed, num_cols=args.cols,
        key_distribution=args.keys,
    )
    print(f"wrote {args.rows}-row pair to {args.out1}, {args.out2}", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="smj-torch", description="sort/merge-join query engine, PyTorch + CUDA port"
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    _add_run_parser(sub)
    _add_generate_parser(sub)
    sub.add_parser("bench", help=f"the port's benchmark (not in the port yet: {BENCHMARK})")
    args = parser.parse_args(argv)
    if args.cmd == "run":
        return _cmd_run(args)
    if args.cmd == "generate":
        return _cmd_generate(args)
    return _refuse("bench", BENCHMARK)


if __name__ == "__main__":
    sys.exit(main())
