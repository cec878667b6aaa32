"""What the collectives of this machine take from ranks that share one card.

Usage, from the root of a checkout, on a machine with a CUDA card:

    python3 -m pim_sort_merge_join_tpu_torch.tools.collective_probe

Three probes, each on ranks started with the spawn method, all on cuda:0,
meeting in a `FileStore`, with a time limit (a rank that hangs is killed
and reported as such):

1. two NCCL ranks on the one card: an `all_reduce` (NCCL takes one rank
   per card; the text of its refusal is what this records);
2. two Gloo ranks given CUDA tensors: `all_to_all_single` and
   `all_gather_into_tensor` (the engine passes CUDA tensors to Gloo as
   they are, `exchange/collectives.py`);
3. four Gloo ranks: the milliseconds of one all-to-all of 16, 64 and 256
   MiB from each rank (median of 3 after a warmup, between barriers), on
   the engine's route (`collectives.all_to_all`, CUDA tensors into Gloo),
   which bounds the exchange, and, for comparison, staged by hand (copied
   to pinned host memory, exchanged there, copied back).

It prints one JSON line per probe, then the card's name and power limit.
"""

from __future__ import annotations

import datetime
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import tempfile
import time


def _rank(probe: str, rank: int, world: int, directory: str) -> None:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    result: dict = {}
    try:
        backend = "nccl" if probe == "nccl" else "gloo"
        dist.init_process_group(backend, store=dist.FileStore(os.path.join(directory, "store"),
                                                              world),
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=60))
        if probe == "nccl":
            x = torch.ones(4, device="cuda:0")
            dist.all_reduce(x)
            torch.cuda.synchronize()
            result["all_reduce"] = f"ok: {x.tolist()}"
        elif probe == "gloo_cuda":
            for name, call in (("all_to_all_single", _a2a), ("all_gather_into_tensor", _gather)):
                try:
                    result[name] = call(world)
                except Exception as e:  # the refusal's text is the result
                    result[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:300]}"
        else:
            result.update(_route_rate(world))
        dist.destroy_process_group()
    except Exception as e:  # the refusal's text is the result
        result["error"] = f"{type(e).__name__}: {str(e).splitlines()[0][:300]}"
    with open(os.path.join(directory, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)


def _a2a(world: int) -> str:
    import torch
    import torch.distributed as dist

    x = torch.arange(world * 4, dtype=torch.int64, device="cuda:0") + 100 * dist.get_rank()
    y = torch.empty_like(x)
    dist.all_to_all_single(y, x)
    return f"ok: {y.tolist()}"


def _gather(world: int) -> str:
    import torch
    import torch.distributed as dist

    x = torch.full((2,), dist.get_rank(), dtype=torch.int64, device="cuda:0")
    y = torch.empty(2 * world, dtype=torch.int64, device="cuda:0")
    dist.all_gather_into_tensor(y, x)
    return f"ok: {y.tolist()}"


def _staged_all_to_all(x):
    import torch
    import torch.distributed as dist

    send = torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(x)
    recv = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    dist.all_to_all_single(recv, send)
    return recv.to(x.device)


def _route_rate(world: int) -> dict:
    import torch

    from pim_sort_merge_join_tpu_torch.exchange import collectives

    out = {}
    for route, call in (("direct", collectives.all_to_all), ("staged", _staged_all_to_all)):
        for mib in (16, 64, 256):
            x = torch.zeros((world, (mib << 20) // 8 // world), dtype=torch.int64,
                            device="cuda:0")
            call(x)
            times = []
            for _ in range(3):
                collectives.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call(x)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            ms = statistics.median(times)
            out[f"{route} {mib}MiB"] = {"ms": ms, "gb_per_s": (mib << 20) / ms / 1e6}
    return out


def probe(name: str, world: int, timeout: float = 90.0) -> dict:
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as d:
        procs = [ctx.Process(target=_rank, args=(name, r, world, d)) for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        ranks = {}
        for r in range(world):
            path = os.path.join(d, f"rank{r}.json")
            if os.path.exists(path):
                with open(path) as f:
                    ranks[r] = json.load(f)
        return {"probe": name, "world": world, "hung_ranks": hung,
                "exit_codes": [p.exitcode for p in procs], "ranks": ranks}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("collective_probe: no CUDA device", file=sys.stderr)
        return 1
    for name, world in (("nccl", 2), ("gloo_cuda", 2), ("gloo_route", 4)):
        print(json.dumps(probe(name, world)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
