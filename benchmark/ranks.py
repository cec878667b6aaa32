"""Cells on more than one card: one process, a rank, per card.

A cell whose traffic mode is sharded (``Mode.sharded = True``) runs on
``cell.chips`` ranks. The harness's own process is rank 0, on ``cuda:0``;
`Ranks` spawns ranks 1 to P-1, one on each ``cuda:r``, and each runs
`rank_main`: the same set-up, warm-up, window and check fetches as rank 0
(`harness.run_rank`), from the same seed. All ranks join one group through
a `FileStore` in a temporary directory, so no port is chosen. Its backend
follows the placement (`placement`): NCCL where each rank has a card of its
own, Gloo on the CPU or where ranks share a card. A second group, Gloo on
the CPU, carries the harness's own words (`Group`): before each query rank
0 broadcasts its index, or that the window has closed; a checked query's
rows and, after the window, every rank's peak, traced window and forbidden
modules go to rank 0.

A rank that raises or dies ends the run. Rank 0 watches its children and
kills them all at the first failure; its own loop then stops, and the
query counts as failed. Every collective has the group's timeout
(`GROUP_TIMEOUT_S`). Children are daemons, exit when rank 0's process
does, write nothing to standard output, and are killed on every way out
of `Ranks`, which also removes the store's directory and reaps the
resource tracker that spawning them started.
"""

from __future__ import annotations

import contextlib
import datetime
import multiprocessing
import os
from multiprocessing import resource_tracker
import shutil
import sys
import tempfile
import threading
import time
import traceback

import torch
import torch.distributed as dist

GROUP_TIMEOUT_S = 120.0  # the group's start and every collective
GRACE_S = 20.0  # after a failure, how long rank 0 has to leave `Ranks`
JOIN_S = 30.0  # at the end, how long the children have to exit
STOP = -1  # the word that closes the window


def placement(device: str, world: int) -> tuple[list[torch.device], str]:
    """Each rank's device and the group's backend: on the CPU every rank
    and Gloo; on CUDA rank r on card ``r % cards``, NCCL where every rank
    has a card of its own, else Gloo (NCCL refuses two ranks on one card)."""
    if torch.device(device).type != "cuda":
        return [torch.device("cpu")] * world, "gloo"
    cards = torch.cuda.device_count()
    return ([torch.device("cuda", r % cards) for r in range(world)],
            "nccl" if cards >= world else "gloo")


class Group:
    """One rank's place in the group and the harness's words over the
    control group. On rank 0 ``watch`` follows the children; ``control_s``
    is the seconds rank 0 spent saying which query comes next."""

    def __init__(self, rank: int, world: int, device: torch.device, backend: str,
                 control, watch=None):
        self.rank, self.world, self.device, self.backend = rank, world, device, backend
        self.control, self.watch = control, watch
        self.control_s = 0.0

    @property
    def failed(self) -> bool:
        return self.watch is not None and self.watch.failed.is_set()

    def check(self) -> None:
        """Raises on rank 0 once a rank has failed."""
        if self.failed:
            raise RuntimeError(f"rank(s) {sorted(self.watch.lost)} failed")

    def fail(self) -> None:
        """Rank 0 ends the run: every child is killed."""
        self.watch.fail()

    def next_query(self, i: int | None) -> int | None:
        """Rank 0 says which query comes next (``i``), or None once the
        window has closed; every rank returns rank 0's word."""
        t0 = time.perf_counter()
        word = torch.tensor([STOP if i is None else i], dtype=torch.int64)
        dist.broadcast(word, src=0, group=self.control)
        if self.rank == 0:
            self.control_s += time.perf_counter() - t0
        return None if int(word[0]) == STOP else int(word[0])

    def gather(self, obj) -> list | None:
        """Every rank's ``obj`` on rank 0, in rank order; None on the others."""
        out = [None] * self.world if self.rank == 0 else None
        dist.gather_object(obj, out, dst=0, group=self.control)
        return out


def join(rank: int, world: int, directory: str, device: torch.device, backend: str,
         watch=None) -> Group:
    """Join the group (the engine's collectives use it as the default
    group) and the control group."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        # P ranks on the CPU share its cores: with torch's default pool each
        # a query took 20-40 times longer (4 ranks, 8 cores). On cards
        # torch's default stands: one thread a rank moved nothing measurable.
        torch.set_num_threads(1)
    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    store = dist.FileStore(os.path.join(directory, "store"), world)
    extra = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, store=store, rank=rank, world_size=world, timeout=timeout,
                            **extra)
    control = dist.new_group(backend="gloo", timeout=timeout)
    return Group(rank, world, device, backend, control, watch)


class _Watch(threading.Thread):
    """Rank 0's watch over its children: at the first that exits with
    an error it kills them all. If rank 0 has not left `Ranks` within
    `GRACE_S` (stuck in a collective that cannot fail over NCCL), the
    process exits."""

    def __init__(self, procs: list, backend: str, directory: str):
        super().__init__(daemon=True, name="ranks-watch")
        self.procs, self.backend, self.directory = procs, backend, directory
        self.failed, self.done = threading.Event(), threading.Event()
        self.lost: dict[int, int] = {}  # rank: exit code, of the ranks that failed first
        self.lock = threading.Lock()

    def run(self) -> None:
        while not self.done.wait(0.05):
            if any(p.exitcode not in (None, 0) for p in self.procs):
                self.fail()
                if not self.done.wait(GRACE_S):
                    print(f"ranks: rank(s) {sorted(self.lost)} failed and rank 0 did not come "
                          f"back within {GRACE_S:g} s", file=sys.stderr, flush=True)
                    shutil.rmtree(self.directory, ignore_errors=True)
                    _stop_tracker()
                    os._exit(4)
                return

    def fail(self) -> None:
        with self.lock:
            if self.failed.is_set():
                return
            self.lost = {r + 1: p.exitcode for r, p in enumerate(self.procs)
                         if p.exitcode not in (None, 0)}
            self.failed.set()
            for p in self.procs:
                if p.is_alive():
                    p.kill()
            if self.backend == "nccl":
                # Unblocks rank 0 in a collective whose peer is gone.
                dist.distributed_c10d._abort_process_group()


class Ranks:
    """Rank 0's side of a cell on several ranks, as a context manager that
    returns rank 0's `Group`. ``hook``, a module-level function, is called
    with its rank in each child before its set-up (tests and the control
    put a fault or the control in place there; rank 0 is the caller's).
    On exit every child has ended and ``errors`` holds the last lines of
    each failed child's traceback."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool, device: str, hook=None):
        self.world = cell.chips
        self.devices, self.backend = placement(device, self.world)
        self.args = (cell, seed, seconds, trace, hook)
        self.errors: list[str] = []
        self.directory = self.watch = None
        self.procs: list = []
        self.threads = torch.get_num_threads()  # `join` sets 1 on the CPU

    def __enter__(self) -> Group:
        self.directory = tempfile.mkdtemp(prefix="smj-bench-ranks-")
        try:
            ctx = multiprocessing.get_context("spawn")
            self.procs = [ctx.Process(target=rank_main, name=f"rank{r}", daemon=True,
                                      args=(r, self.world, self.directory, self.devices[r],
                                            self.backend) + self.args)
                          for r in range(1, self.world)]
            for p in self.procs:
                p.start()
            self.watch = _Watch(self.procs, self.backend, self.directory)
            self.watch.start()
            return join(0, self.world, self.directory, self.devices[0], self.backend, self.watch)
        except BaseException:
            self.close()
            raise

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        if self.watch is not None:
            self.watch.done.set()
        failed = self.watch is not None and self.watch.failed.is_set()
        if dist.is_initialized() and not (failed and self.backend == "nccl"):
            dist.destroy_process_group()
        deadline = time.monotonic() + (0 if failed else JOIN_S)
        for p in self.procs:
            if p.pid is None:  # never started
                continue
            p.join(max(deadline - time.monotonic(), 0))
            if p.is_alive():
                p.kill()
                p.join()
        for r, code in sorted(self.watch.lost.items() if self.watch is not None else ()):
            lines = []
            with contextlib.suppress(FileNotFoundError), \
                    open(os.path.join(self.directory, f"rank{r}.error")) as f:
                lines = f.read().strip().splitlines()[-3:]
            self.errors.append(f"rank {r}: " + (" | ".join(lines) or f"exited with code {code}"))
        shutil.rmtree(self.directory, ignore_errors=True)
        _stop_tracker()
        torch.set_num_threads(self.threads)


def _stop_tracker() -> None:
    """Stop and reap the resource tracker that starting the children
    started: left to exit with this process, it outlives it as a zombie."""
    resource_tracker._resource_tracker._stop()


def _exit_with_parent() -> None:
    multiprocessing.parent_process().join()
    os._exit(1)


def rank_main(rank: int, world: int, directory: str, device: torch.device, backend: str,
              cell, seed: int, seconds: float, trace: bool, hook) -> None:
    """A child rank: join the group, run the cell's set-up, warm-up and
    window as rank 0 says, send rank 0 what it asks for, and exit."""
    os.dup2(2, 1)  # standard output is rank 0's, for the result alone
    sys.stdout = sys.stderr
    threading.Thread(target=_exit_with_parent, daemon=True).start()
    try:
        if hook is not None:
            hook(rank)
        from benchmark import harness

        group = join(rank, world, directory, device, backend)
        harness.run_rank(cell, seed, seconds, trace, group)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(directory, f"rank{rank}.error"), "w") as f:
            f.write(traceback.format_exc())
        sys.stderr.flush()
        os._exit(1)
    sys.stderr.flush()
    os._exit(0)
