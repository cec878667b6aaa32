"""The multi-device cases the tests run on the port's Gloo CPU ranks.

Imported by the test files and by every rank that `spawn_simulator`
starts, so it imports torch and the port only, never jax. A case is plain
data (a label, how to make its tables, its config fields, what to run), so
the tests can build the same tables and config for the JAX package in the
parent process. `run_cases` runs a list of cases on one rank and returns,
on rank 0, what every rank holds afterwards as the JAX package's global
host view (``data [P * cap, ncol]``, ``counts [P]``).
"""

from __future__ import annotations

import os

import numpy as np

# How each case's two tables are made, from a seed (the flows of
# tests/test_distributed.py).


def reference_like(rng, nrow: int, ncol: int = 4):
    hi = 3 * nrow
    out = []
    for _ in range(2):
        col1 = rng.choice(np.arange(1, hi + 1), size=nrow, replace=False)
        out.append(np.column_stack([col1, rng.integers(1, hi, size=(nrow, ncol - 1))])
                   .astype(np.int64))
    return out


def duplicate_keys(rng, n: int = 0):
    keys1, keys2 = rng.integers(0, 15, 400), rng.integers(0, 15, 300)
    r1 = np.column_stack([keys1, rng.integers(0, 100, (400, 3))]).astype(np.int64)
    r2 = np.column_stack([keys2, rng.integers(0, 100, (300, 3))]).astype(np.int64)
    return r1, r2


def skewed(rng, n: int = 600, hot: int = 7, hot_frac: float = 0.7):
    """One key holds ``hot_frac`` of each table's rows."""
    nh = int(n * hot_frac)
    out = []
    for _ in range(2):
        k = np.concatenate([np.full(nh, hot), rng.integers(100, 10_000, n - nh)])
        out.append(rng.permutation(
            np.column_stack([k, rng.integers(0, 100, (n, 3))]).astype(np.int64)))
    return out


def skewed_inner(rng, n: int = 600):
    """Table 1 hot on one key; table 2 holds five rows of it."""
    k1 = np.concatenate([np.full(400, 7), rng.integers(100, 10_000, n - 400)])
    r1 = np.column_stack([k1, rng.integers(0, 100, (n, 3))]).astype(np.int64)
    k2 = np.concatenate([np.full(5, 7), rng.integers(100, 10_000, 295)])
    r2 = np.column_stack([k2, rng.integers(0, 100, (300, 3))]).astype(np.int64)
    return r1, r2


def grouped(rng, n: int = 500, groups: int = 40):
    """A table of ``groups`` keys for the aggregates (and its copy)."""
    rows = np.column_stack([rng.integers(0, groups, size=n),
                            rng.integers(1, 100, (n, 2))]).astype(np.int64)
    return rows, rows.copy()


def wide_keys(rng, n: int = 512):
    """Half the keys beyond int32, on both sides (the resume probe's tables)."""
    out = []
    for _ in range(2):
        keys = rng.permutation(np.arange(1, n + 1)).astype(np.int64)
        keys[keys % 2 == 0] += np.int64(1) << 40
        out.append(np.column_stack([keys, rng.integers(1, 100, (n, 3))]).astype(np.int64))
    return out


def unique_small(rng, n: int = 64):
    return [np.column_stack([rng.permutation(np.arange(1, n + 1)),
                             rng.integers(1, n, (n, 3))]).astype(np.int64) for _ in range(2)]


def exchange_rows(rng, shape):
    """Rows of two columns (table 1) and a destination rank per row in
    column 0 of table 2: ``shape = (rows, ranks)``."""
    n, p = shape
    return (rng.integers(0, 1000, (n, 2)).astype(np.int64),
            rng.integers(0, p, (n, 1)).astype(np.int64))


MAKERS = {"exchange_rows": exchange_rows, "reference_like": reference_like,
          "duplicate_keys": duplicate_keys, "skewed": skewed, "skewed_inner": skewed_inner,
          "grouped": grouped, "wide_keys": wide_keys, "unique_small": unique_small}


def tables(case: dict):
    """The case's two tables: ``case["tables"] = (maker, seed, n)``, in the
    config's ``dtype``: uint64 keys shifted by 2^63 (the case's predicate
    values carry the shift), float64 keys halved less 100.25."""
    maker, seed, n = case["tables"]
    out = MAKERS[maker](np.random.default_rng(seed), n)
    dtype = case.get("cfg", {}).get("dtype", "int64")
    if dtype == "uint64":
        out = [r.astype(np.uint64) for r in out]
        for r in out:
            r[:, 0] += np.uint64(2**63)
    elif dtype == "float64":
        out = [r.astype(np.float64) for r in out]
        for r in out:
            r[:, 0] = r[:, 0] * 0.5 - 100.25
    return out


def config_fields(case: dict) -> dict:
    """The config's fields, predicates as ``(col, op, value)`` tuples."""
    return dict(case.get("cfg", {}))


def port_config(case: dict, **extra):
    from pim_sort_merge_join_tpu_torch.config import EngineConfig, Predicate

    kw = config_fields(case)
    for name in ("predicate1", "predicate2"):
        if name in kw:
            kw[name] = Predicate(*kw[name])
    return EngineConfig(**kw, **extra)


# What runs on every rank.


def _global(st) -> dict:
    data, counts = st.host_arrays()
    return {"data": data, "counts": counts}


def _run_join(case, t1, t2, pipe, directory):
    from pim_sort_merge_join_tpu_torch.engine import distributed as dq

    out = pipe.run_tables(t1, t2)
    cfg = pipe._resolved_config(t1, t2)
    _, _, diag = dq.distributed_exchange_core(
        t1, t2, cfg, pipe.group, exchange_capacity=pipe._exchange_capacity(t1, t2))
    keys = ("exchange_true_rows1", "exchange_true_rows2", "heavy_true_rows1",
            "heavy_true_rows2", "sorted_rows1", "sorted_rows2")
    return {**_global(out), "rows": out.to_numpy(),
            "diag": {k: dq._host_diag(diag[k], pipe.group) for k in keys},
            "narrow": (pipe.resolved_narrow_keys, pipe.resolved_narrow_data)}


def _run_aggregate(case, t1, t2, pipe, directory):
    out = pipe.run_aggregate(t1, key=0, value=1, agg=case["agg"])
    return {**_global(out), "rows": out.to_numpy()}


def _run_overflow(case, t1, t2, pipe, directory):
    import torch

    from pim_sort_merge_join_tpu_torch.engine.errors import ExchangeOverflowError
    from pim_sort_merge_join_tpu_torch.exchange import collectives

    try:
        pipe.run_tables(t1, t2)
        raised, message = 0, ""
    except ExchangeOverflowError as e:
        raised, message = 1, str(e)
    flags = collectives.gather_numpy(torch.tensor([raised]), pipe.group).reshape(-1)
    return {"raised_on": flags.tolist(), "message": message}


def _run_resumable(case, t1, t2, pipe, directory):
    import dataclasses

    from pim_sort_merge_join_tpu_torch.engine import distributed as dq
    from pim_sort_merge_join_tpu_torch.exchange import collectives

    ckdir = os.path.join(directory, case["label"])
    cfg = dataclasses.replace(pipe.config, checkpoint_dir=ckdir)
    first = dq.DistributedQueryPipeline(cfg, device="cpu")
    before = first.checkpoint_stages()
    run = first.run_tables_resumable(t1, t2)
    zeros = dq.ShardedTable.from_numpy(np.zeros((t1.total_rows(), t1.ncol), np.int64),
                                       device="cpu")
    again = dq.DistributedQueryPipeline(cfg, device="cpu")
    after = again.checkpoint_stages()
    resumed = again.run_tables_resumable(zeros, zeros)
    collectives.barrier()
    return {"run": _global(run), "resume": _global(resumed), "rows": resumed.to_numpy(),
            "stages": (before, after), "checkpoint": ckdir,
            "narrow": [(first.resolved_narrow_keys, first.resolved_narrow_data),
                       (again.resolved_narrow_keys, again.resolved_narrow_data)]}


def _run_exchange(case, t1, t2, pipe, directory):
    """`all_to_all_exchange` of each rank's block of table 1 to the ranks
    named by table 2's first column, for every ``num_chunks``."""
    import torch

    from pim_sort_merge_join_tpu_torch.exchange import collectives
    from pim_sort_merge_join_tpu_torch.exchange.shuffle import all_to_all_exchange

    out = {}
    for k in case["chunks"]:
        ex = all_to_all_exchange(t1.data, t2.data[:, 0].to(torch.int32), pipe.group,
                                 bucket_capacity=case["bucket"], recv_capacity=case["recv"],
                                 num_chunks=k)
        out[k] = {"data": collectives.all_gather(ex.data, pipe.group).reshape(-1, t1.ncol).numpy(),
                  "num_rows": collectives.gather_numpy(ex.num_rows.reshape(1)).reshape(-1),
                  "true_rows": collectives.gather_numpy(ex.true_rows.reshape(1)).reshape(-1)}
    return out


RUNS = {"join": _run_join, "aggregate": _run_aggregate, "overflow": _run_overflow,
        "resumable": _run_resumable, "exchange": _run_exchange}


def run_cases(cases: list, directory: str) -> dict:
    """Every case on this rank (a `spawn_simulator` function); rank 0
    returns ``{label: result}``. ``directory`` holds the checkpoints."""
    import torch.distributed as dist

    from pim_sort_merge_join_tpu_torch.engine.distributed import (
        DistributedQueryPipeline,
        ShardedTable,
    )

    results = {}
    for case in cases:
        r1, r2 = tables(case)
        cfg = port_config(case)
        pipe = DistributedQueryPipeline(cfg, device="cpu")
        t1 = ShardedTable.from_numpy(r1, dtype=cfg.torch_dtype(), device="cpu")
        t2 = ShardedTable.from_numpy(r2, dtype=cfg.torch_dtype(), device="cpu")
        results[case["label"]] = RUNS[case["kind"]](case, t1, t2, pipe, directory)
    return results if dist.get_rank() == 0 else None
