"""The entry points of `__graft_entry__.py`, on the port.

`entry` returns the engine's flagship step, the fused filter -> sort ->
1:1 merge-join (`engine/pipeline.pipeline_core`) at the reference
configuration, with its two tables; `dryrun_multichip` runs the
multi-device step (filter, splitter sample, range exchange, sort,
co-partitioned join) on N ranks and checks it against the numpy oracle.
Both run on the card unless the caller names ``device="cpu"``.

    python -m pim_sort_merge_join_tpu_torch.entry [--device cpu] [--ranks N]

runs both, as the JAX package's file does.
"""

from __future__ import annotations

import argparse
import functools
import sys

import numpy as np
import torch

from pim_sort_merge_join_tpu_torch.columnar.table import Table
from pim_sort_merge_join_tpu_torch.config import EngineConfig, Predicate
from pim_sort_merge_join_tpu_torch.device import rank_device
from pim_sort_merge_join_tpu_torch.engine.pipeline import pipeline_core


def entry_rows(n: int = 4096) -> tuple[np.ndarray, np.ndarray]:
    """The entry step's two ``[n, 4]`` int64 tables, made by the JAX
    entry's numpy calls: unique keys drawn from ``[1, 3n]``, the other
    columns uniform in ``[1, 3n)``."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(2):
        out.append(np.column_stack([
            rng.choice(np.arange(1, 3 * n + 1), size=n, replace=False),
            rng.integers(1, 3 * n, size=(n, 3)),
        ]).astype(np.int64))
    return out[0], out[1]


def entry(n: int = 4096, device: str | torch.device | None = None):
    """Return ``(fn, (t1, t2))``: ``fn`` is `pipeline_core` at the reference
    configuration, ``t1`` and ``t2`` the `entry_rows` tables on ``device``
    (the card unless named)."""
    rows1, rows2 = entry_rows(n)
    t1 = Table.from_numpy(rows1, device=device)
    t2 = Table.from_numpy(rows2, device=device)
    fn = functools.partial(pipeline_core, config=EngineConfig())
    return fn, (t1, t2)


def dryrun_rows(n_devices: int) -> tuple[np.ndarray, np.ndarray, EngineConfig]:
    """The dry run's tables (``64 * n_devices`` rows, a permutation of
    ``1..n`` as keys) and config (``col1 > n / 4``, 64 samples a rank)."""
    n = 64 * n_devices
    rng = np.random.default_rng(0)
    rows1 = np.column_stack(
        [rng.permutation(np.arange(1, n + 1)), rng.integers(1, n, size=(n, 3))]
    ).astype(np.int64)
    rows2 = np.column_stack(
        [rng.permutation(np.arange(1, n + 1)), rng.integers(1, n, size=(n, 3))]
    ).astype(np.int64)
    config = EngineConfig(
        predicate1=Predicate(0, ">", n // 4),
        predicate2=Predicate(0, ">", n // 4),
        splitter_sample=64,
    )
    return rows1, rows2, config


def dryrun_rank(n_devices: int, device: str) -> np.ndarray:
    """One rank of the dry run: the distributed pipeline on the dry run's
    tables; every rank returns the joined rows in rank order."""
    from pim_sort_merge_join_tpu_torch.engine.distributed import DistributedQueryPipeline

    rows1, rows2, config = dryrun_rows(n_devices)
    return DistributedQueryPipeline(config, device=device).run_arrays(rows1, rows2).to_numpy()


def dryrun_multichip(n_devices: int, device: str | torch.device | None = None) -> np.ndarray:
    """Run the multi-device step on ``n_devices`` Gloo ranks
    (`runner/simulator.spawn_simulator`) with each rank's tensors on
    ``device``: the card (``cuda:0``, shared by the ranks) unless named;
    ``device="cpu"`` is the simulator. Asserts that the joined rows equal
    `ops/oracle.pipeline_oracle` in order; returns them."""
    from pim_sort_merge_join_tpu_torch.ops import oracle
    from pim_sort_merge_join_tpu_torch.runner.simulator import spawn_simulator

    result = spawn_simulator(dryrun_rank, n_devices, n_devices, rank_device(device),
                             timeout=300)
    rows1, rows2, config = dryrun_rows(n_devices)
    pred = (0, ">", config.predicate1.value)
    want = oracle.pipeline_oracle(rows1, rows2, pred1=pred, pred2=pred)
    np.testing.assert_array_equal(result, want)
    print(
        f"dryrun_multichip({n_devices}): OK -- {result.shape[0]} joined rows "
        f"match oracle across {n_devices}-device mesh"
    )
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m pim_sort_merge_join_tpu_torch.entry")
    parser.add_argument("--device", default=None, help="the card unless named")
    parser.add_argument("--ranks", type=int, default=4, help="ranks of the dry run")
    args = parser.parse_args(argv)
    fn, fn_args = entry(device=args.device)
    out = fn(*fn_args)
    print("entry: compiled + ran, rows:", int(out.num_rows))
    dryrun_multichip(args.ranks, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
