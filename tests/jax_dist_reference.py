"""The JAX package's side of the multi-device tests: each case of
`tests/torch_dist_cases.py` run by `DistributedQueryPipeline` (or
`all_to_all_exchange` under `jax.shard_map`) on a P-device CPU mesh, with
the results in the shape `torch_dist_cases.run_cases` gives the port's."""

from __future__ import annotations

import dataclasses
import functools
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from pim_sort_merge_join_tpu.config import EngineConfig, Predicate
from pim_sort_merge_join_tpu.engine.distributed import DistributedQueryPipeline, ShardedTable
from pim_sort_merge_join_tpu.engine.errors import ExchangeOverflowError
from pim_sort_merge_join_tpu.exchange.shuffle import all_to_all_exchange
from pim_sort_merge_join_tpu.ops.pallas import sort_kernel
from pim_sort_merge_join_tpu_torch.ops import oracle

import torch_dist_cases as cases


def mesh(p: int) -> Mesh:
    return Mesh(np.array(jax.devices()[:p]), ("p",))


def config(case: dict, **extra) -> EngineConfig:
    kw = cases.config_fields(case)
    for name in ("predicate1", "predicate2"):
        if name in kw:
            kw[name] = Predicate(*kw[name])
    return EngineConfig(**kw, **extra)


def _global(st) -> dict:
    data, counts = st._host_arrays()
    return {"data": data, "counts": counts}


def run(case: dict, p: int, directory: str) -> dict:
    """The JAX package's result of one case on a ``p``-device mesh. The
    Pallas bitonic kernel (``sort_algorithm="pallas_bitonic"``) runs
    interpreted, as the JAX package's own tests run it on the CPU."""
    if cases.config_fields(case).get("sort_algorithm") != "pallas_bitonic":
        return _run(case, p, directory)
    interpreted = functools.partial(sort_kernel.sort_pairs_pallas, interpret=True)
    with mock.patch.object(sort_kernel, "sort_pairs_pallas", interpreted):
        return _run(case, p, directory)


def _run(case: dict, p: int, directory: str) -> dict:
    m = mesh(p)
    r1, r2 = cases.tables(case)
    cfg = config(case)
    pipe = DistributedQueryPipeline(cfg, m)
    dtype = cfg.jnp_dtype()
    t1 = ShardedTable.from_numpy(r1, m, "p", dtype=dtype)
    t2 = ShardedTable.from_numpy(r2, m, "p", dtype=dtype)
    kind = case["kind"]
    if kind == "join":
        # run_tables, keeping the diagnostics it reads.
        shard_cap = max(t1.data.shape[0], t2.data.shape[0]) // p
        cap = -(-int(shard_cap * cfg.exchange_slack) // 128) * 128
        probed = pipe._resolve_narrow_device(t1, t2)
        narrow = cfg.narrow_keys if cfg.narrow_keys != "auto" else probed[0]
        narrow_data = cfg.narrow_data if cfg.narrow_data != "auto" else probed[1]
        out, diag = pipe._get_jitted(cap, bool(narrow), bool(narrow_data))(t1, t2)
        keys = ("exchange_true_rows1", "exchange_true_rows2", "heavy_true_rows1",
                "heavy_true_rows2", "sorted_rows1", "sorted_rows2")
        return {**_global(out), "rows": out.to_numpy(),
                "diag": {k: np.asarray(diag[k]) for k in keys},
                "narrow": (bool(narrow), bool(narrow_data))}
    if kind == "aggregate":
        out = pipe.run_aggregate(t1, key=0, value=1, agg=case["agg"])
        return {**_global(out), "rows": out.to_numpy()}
    if kind == "overflow":
        try:
            pipe.run_tables(t1, t2)
            return {"raised_on": [0] * p, "message": ""}
        except ExchangeOverflowError as e:
            return {"raised_on": [1] * p, "message": str(e)}
    if kind == "resumable":
        ckdir = os.path.join(directory, case["label"])
        rcfg = dataclasses.replace(cfg, checkpoint_dir=ckdir)
        first = DistributedQueryPipeline(rcfg, m)
        before = first.checkpoint_stages()
        out = first.run_tables_resumable(t1, t2)
        zeros = ShardedTable.from_numpy(np.zeros_like(r1), m, "p")
        again = DistributedQueryPipeline(rcfg, m)
        after = again.checkpoint_stages()
        resumed = again.run_tables_resumable(zeros, zeros)
        return {"run": _global(out), "resume": _global(resumed), "rows": resumed.to_numpy(),
                "stages": (before, after), "checkpoint": ckdir,
                "narrow": [(first.resolved_narrow_keys, first.resolved_narrow_data),
                           (again.resolved_narrow_keys, again.resolved_narrow_data)]}
    if kind == "exchange":
        out = {}
        for k in case["chunks"]:
            def body(d, t, k=k):
                res = all_to_all_exchange(d, t, "p", bucket_capacity=case["bucket"],
                                          recv_capacity=case["recv"], num_chunks=k)
                return res.data, res.num_rows.reshape(1), res.true_rows.reshape(1)

            data, num_rows, true_rows = jax.jit(jax.shard_map(
                body, mesh=m, in_specs=(P("p", None), P("p")),
                out_specs=(P("p", None), P("p"), P("p")), check_vma=False,
            ))(jnp.asarray(r1), jnp.asarray(r2[:, 0].astype(np.int32)))
            out[k] = {"data": np.asarray(data), "num_rows": np.asarray(num_rows),
                      "true_rows": np.asarray(true_rows)}
        return out
    raise ValueError(kind)


def same_global(got: dict, want: dict) -> None:
    """Every rank's whole block and row count equal, and the type."""
    np.testing.assert_array_equal(got["counts"], want["counts"])
    assert got["data"].dtype == want["data"].dtype
    np.testing.assert_array_equal(got["data"], want["data"])


def oracle_rows(case: dict) -> np.ndarray:
    r1, r2 = cases.tables(case)
    cfg = cases.config_fields(case)
    return oracle.pipeline_oracle(r1, r2, pred1=cfg.get("predicate1", (0, ">", 5000)),
                                  pred2=cfg.get("predicate2", (0, ">", 5000)),
                                  mode=cfg.get("join_mode", "one_to_one"))


def sorted_rows(a: np.ndarray) -> np.ndarray:
    return a[np.lexsort(a.T[::-1])]


def check_join(got: dict, want: dict, case: dict) -> None:
    """A join case: equal to the JAX package rank by rank (blocks, counts,
    diagnostics, narrow flags, gathered rows), and to the oracle: in order
    where range partitioning keeps the single-device order (no skew
    spreading, 1:1), as a multiset otherwise."""
    same_global(got, want)
    for k, v in want["diag"].items():
        np.testing.assert_array_equal(got["diag"][k], v, err_msg=k)
    assert got["narrow"] == want["narrow"]
    np.testing.assert_array_equal(got["rows"], want["rows"])
    expect = oracle_rows(case)
    cfg = case["cfg"]
    if cfg.get("partition_scheme", "range") == "range" and cfg.get("heavy_hitter_fraction") in (
            None, 1.0) and cfg.get("join_mode") != "inner":
        np.testing.assert_array_equal(got["rows"], expect)
    else:
        np.testing.assert_array_equal(sorted_rows(got["rows"]), sorted_rows(expect))
