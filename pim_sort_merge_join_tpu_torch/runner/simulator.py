"""The CPU "simulator": the multi-device engine on N Gloo processes.

The reference's `use_simulator(N)` forces N virtual CPU devices in one
process. The port's ranks are processes, so its simulator spawns N of
them (`spawn_simulator`), joined in one Gloo group on the CPU: the same
engine code, collectives and process boundaries, on a machine with no
card. The group meets in a `FileStore` in a temporary directory, so no TCP
port is chosen and simulators started side by side cannot collide. The
group and the wait for the ranks both have a timeout, so a collective that
hangs fails instead.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import sys
import tempfile
import time
import traceback

_ACTIVE = False


def simulator_active() -> bool:
    """Whether this process is a rank started by `spawn_simulator`."""
    return _ACTIVE


def _rank_main(rank: int, world: int, directory: str, timeout_s: float, fn, args) -> None:
    global _ACTIVE
    import torch
    import torch.distributed as dist

    _ACTIVE = True
    torch.set_num_threads(1)
    out = os.path.join(directory, f"rank{rank}")
    try:
        store = dist.FileStore(os.path.join(directory, "store"), world)
        dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            result = fn(*args)
        finally:
            dist.destroy_process_group()
        with open(out + ".tmp", "wb") as f:
            pickle.dump(result if rank == 0 else None, f)
        os.replace(out + ".tmp", out + ".result")
    except BaseException:
        with open(out + ".error", "w") as f:
            f.write(traceback.format_exc())
        sys.exit(1)  # the traceback goes to the caller, not to stderr


def spawn_simulator(fn, n: int, *args, timeout: float = 300.0):
    """Run ``fn(*args)`` on ``n`` ranks of one Gloo group; returns rank 0's
    result. Where a rank's tensors live is ``fn``'s choice: the CPU for the
    simulator, or one card that every rank shares (Gloo then stages CUDA
    tensors through the host, `exchange/collectives.py`).

    Each rank is a process of the spawn start method with one torch thread,
    in one Gloo group over a `FileStore` (``dist.get_rank()`` tells ``fn``
    its rank). ``fn``, ``args`` and rank 0's result are pickled, so ``fn`` is
    a module-level function. Raises `RuntimeError` with every failed
    rank's traceback if a rank fails, and `TimeoutError` (after killing the
    ranks) if they are not done within ``timeout`` seconds.
    """
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="smj-simulator-") as directory:
        procs = [ctx.Process(target=_rank_main, args=(r, n, directory, timeout, fn, args),
                             daemon=True) for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            # A rank that fails leaves the others waiting in a collective:
            # stop waiting at the first failure.
            while time.monotonic() < deadline and any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                time.sleep(0.02)
            failed = any(p.exitcode not in (None, 0) for p in procs)
            late = [] if failed else [r for r, p in enumerate(procs) if p.is_alive()]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        errors = []
        for r in range(n):
            path = os.path.join(directory, f"rank{r}.error")
            if os.path.exists(path):
                with open(path) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
        if errors:
            raise RuntimeError("simulator ranks failed:\n" + "\n".join(errors))
        if late:
            raise TimeoutError(f"simulator ranks {late} not done after {timeout} s")
        if failed:
            raise RuntimeError("simulator ranks exited with "
                               f"{[p.exitcode for p in procs]} and no traceback")
        with open(os.path.join(directory, "rank0.result"), "rb") as f:
            return pickle.load(f)
