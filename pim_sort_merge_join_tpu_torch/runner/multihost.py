"""Multi-process entry point (port of `runner/multihost.py`).

One process per rank, joined by `torch.distributed`; each rank parses only
its byte range of the CSVs (`csv_io.load_csv_shard`), so no process holds a
whole table, and the same `DistributedQueryPipeline` runs on every rank.
Rank 0 writes the result.

Launch with ``torchrun`` on a machine with K cards (one rank per card,
NCCL):

    torchrun --nproc-per-node K -m pim_sort_merge_join_tpu_torch.runner.multihost \\
        data1.csv data2.csv -o result.csv --backend nccl

or by hand, one process per rank, with a coordinator address
(``host:port`` for TCP, or a ``file://`` path that every rank can reach):

    python -m pim_sort_merge_join_tpu_torch.runner.multihost data1.csv data2.csv \\
        --coordinator <host0>:8476 --num-processes N --process-id $ID \\
        --backend gloo --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch
import torch.distributed as dist

from pim_sort_merge_join_tpu_torch.device import resolve_device
from pim_sort_merge_join_tpu_torch.exchange import collectives


def rank_device(device: str | None) -> torch.device:
    """This rank's device: ``device`` if it names one (``cpu``, ``cuda:0``);
    for a bare ``cuda`` (the default) the card of the rank's local index
    (``LOCAL_RANK`` from torchrun, else the rank modulo the cards), made
    the current one. Raises without a card unless the CPU is named."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", collectives.rank()))
            dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def initialize_multihost(
    coordinator: str | None,
    num_processes: int | None,
    process_id: int | None,
    backend: str = "nccl",
    device: str | None = None,
) -> torch.device:
    """Join the process group and return this rank's device.

    Under torchrun (``WORLD_SIZE`` in the environment, no
    ``num_processes``) the group comes from the environment; with
    ``num_processes > 1`` from ``coordinator`` (``host:port`` or a URL such as
    ``file:///shared/store``); one process joins no group (a no-op, as in
    the reference). ``backend`` is named, never guessed: ``nccl`` for ranks
    on distinct cards, ``gloo`` for CPU ranks or ranks sharing a card.
    """
    if num_processes is None and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        dist.init_process_group(backend, init_method="env://")
    elif num_processes is not None and num_processes > 1:
        if coordinator is None:
            raise ValueError("--coordinator is needed with --num-processes > 1")
        url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        dist.init_process_group(backend, init_method=url, world_size=num_processes,
                                rank=process_id)
    return rank_device(device)


def _bench(pipe, t1, t2, reps: int, device: torch.device) -> list[float]:
    """Milliseconds of ``reps`` whole `run_tables` calls after a warmup,
    each between barriers: CUDA events on the card, the host clock on the
    CPU."""
    pipe.run_tables(t1, t2)
    times = []
    for _ in range(reps):
        collectives.barrier(pipe.group)
        if device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            pipe.run_tables(t1, t2)
            collectives.barrier(pipe.group)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            pipe.run_tables(t1, t2)
            collectives.barrier(pipe.group)
            times.append((time.perf_counter() - t0) * 1e3)
    return times


def run_query(args, device: torch.device) -> int:
    from pim_sort_merge_join_tpu_torch.columnar import csv_io
    from pim_sort_merge_join_tpu_torch.config import EngineConfig, Predicate
    from pim_sort_merge_join_tpu_torch.engine.distributed import (
        DistributedQueryPipeline,
        ShardedTable,
    )

    config = EngineConfig(
        predicate1=Predicate(args.select_col1, ">", args.select_val1),
        predicate2=Predicate(args.select_col2, ">", args.select_val2),
        join_key1=args.join_key1,
        join_key2=args.join_key2,
        exchange_slack=args.exchange_slack,
        exchange_chunks=args.exchange_chunks,
        checkpoint_dir=args.checkpoint_dir,
    )
    pipe = DistributedQueryPipeline(config, device=device)
    pid, nproc = collectives.rank(), collectives.world_size()
    rows1 = csv_io.load_csv_shard(args.table1, pid, nproc)
    rows2 = csv_io.load_csv_shard(args.table2, pid, nproc)
    t1 = ShardedTable.from_process_local(rows1, pipe.group, device=device)
    t2 = ShardedTable.from_process_local(rows2, pipe.group, device=device)

    if args.aggregate:
        out = pipe.run_aggregate(t1, key=args.agg_key, value=args.agg_value, agg=args.aggregate)
        result = out.to_numpy()
        if pid == 0:
            csv_io.write_csv(args.output, result)
            print(f"wrote {result.shape[0]} aggregate rows to {args.output}", file=sys.stderr)
            print(pipe.metrics_json())
        return 0

    if args.bench_reps:
        times = _bench(pipe, t1, t2, args.bench_reps, device)
        if pid == 0:
            print(json.dumps({
                "bench": "multihost_pipeline",
                "backend": collectives.backend(),
                "device": str(device),
                "exchange_chunks": config.exchange_chunks,
                "processes": nproc,
                "rows": int(rows1.shape[0]),
                "times_ms": times,
                "median_ms": sorted(times)[len(times) // 2],
            }))
        return 0

    if args.checkpoint_dir:
        # Checkpointed at the exchange boundary: a rerun with the same
        # config and P resumes at the join.
        resumed = pipe.checkpoint_stages()
        out = pipe.run_tables_resumable(t1, t2)
        print(f"checkpoint resumed_from={resumed}", file=sys.stderr)
    else:
        out = pipe.run_tables(t1, t2)
    result = out.to_numpy()  # a collective: every rank takes part, rank 0 writes
    if pid == 0:
        csv_io.write_csv(args.output, result)
        print(f"wrote {result.shape[0]} rows to {args.output}", file=sys.stderr)
        # Resolved from a global MIN/MAX, so every rank holds the same value.
        print(f"narrow_keys resolved={pipe.resolved_narrow_keys}", file=sys.stderr)
        print(pipe.metrics_json())
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="pim_sort_merge_join_tpu_torch.runner.multihost")
    ap.add_argument("table1")
    ap.add_argument("table2")
    ap.add_argument("-o", "--output", default="result.csv")
    ap.add_argument("--coordinator", default=None,
                    help="rank 0's host:port, or a URL (file:///path) every rank can reach")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--backend", choices=["nccl", "gloo"], default="nccl",
                    help="nccl for ranks on distinct cards; gloo for CPU ranks or ranks "
                    "sharing a card")
    ap.add_argument("--device", default=None,
                    help="this rank's device: the card of its local rank unless named "
                    "('cpu', 'cuda:0')")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="exchange-boundary checkpoint directory (rank 0 writes, every "
                    "rank reads); reruns resume after the last completed stage")
    ap.add_argument("--exchange-slack", type=float, default=2.0)
    ap.add_argument("--exchange-chunks", type=int, default=4)
    ap.add_argument("--aggregate", default=None, choices=["sum", "min", "max", "count"],
                    help="instead of the join, a group-by aggregate of table1 "
                    "(--agg-key by --agg-value)")
    ap.add_argument("--agg-key", type=int, default=0)
    ap.add_argument("--agg-value", type=int, default=1)
    ap.add_argument("--bench-reps", type=int, default=0,
                    help="time N whole run_tables calls instead of writing output")
    ap.add_argument("--select-col1", type=int, default=0)
    ap.add_argument("--select-val1", type=int, default=5000)
    ap.add_argument("--select-col2", type=int, default=0)
    ap.add_argument("--select-val2", type=int, default=5000)
    ap.add_argument("--join-key1", type=int, default=0)
    ap.add_argument("--join-key2", type=int, default=0)
    args = ap.parse_args(argv)
    device = initialize_multihost(args.coordinator, args.num_processes, args.process_id,
                                  args.backend, args.device)
    try:
        return run_query(args, device)
    finally:
        if collectives.initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
