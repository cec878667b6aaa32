"""The query pipeline on one device (port of `engine/pipeline.py`).

`pipeline_core` is the filter -> sort -> join dataflow: fused for the
sort-merge 1:1 join, staged (compact, sort each table, join) for the
sort-merge inner join, compact then hash join for ``join_algorithm="hash"``.
`QueryPipeline` drives it on tables (`run_tables`, with the device narrow
probe), on CSV paths (`run_csv`) or stage by stage with checkpoints
(`run_tables_resumable`); ``debug_log`` sends its stage events through
`engine/logging.log_event`. PyTorch runs eagerly, so there is no compile
cache. Tables of every type of `columnar/dtypes` run every path.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pim_sort_merge_join_tpu_torch.columnar import csv_io, dtypes
from pim_sort_merge_join_tpu_torch.columnar.table import Table
from pim_sort_merge_join_tpu_torch.config import EngineConfig
from pim_sort_merge_join_tpu_torch.device import resolve_device
from pim_sort_merge_join_tpu_torch.engine import metrics
from pim_sort_merge_join_tpu_torch.engine.checkpoint import StageCheckpointer, config_fingerprint
from pim_sort_merge_join_tpu_torch.engine.errors import JoinOverflowError
from pim_sort_merge_join_tpu_torch.engine.logging import log_event
from pim_sort_merge_join_tpu_torch.engine.metrics import MetricsCollector
from pim_sort_merge_join_tpu_torch.ops import filter as filter_ops
from pim_sort_merge_join_tpu_torch.ops import join as join_ops
from pim_sort_merge_join_tpu_torch.ops import sort as sort_ops
from pim_sort_merge_join_tpu_torch.ops.hash_join import hash_join
from pim_sort_merge_join_tpu_torch.ops.kernels.keys import join_keys
from pim_sort_merge_join_tpu_torch.ops.kernels.probe import narrow_extremes
from pim_sort_merge_join_tpu_torch.utils import validate


def pipeline_core(t1: Table, t2: Table, config: EngineConfig) -> Table:
    """The filter -> sort -> join dataflow on two tables of one device.

    Its steps are stages of the active collector (`engine/metrics`): the
    fused path's ``keys`` then the join core's ``merge``, ``unmerge`` and
    ``emit``; the staged path's ``filter``, ``sort`` and ``join``; the hash
    path's ``filter`` and ``join``."""
    if config.join_algorithm == "sort_merge" and config.join_mode == "one_to_one":
        # Fused path: filtering is a key mask and the join's slot-permutation
        # sorts subsume the standalone compaction and table sorts.
        with metrics.stage("keys", rows_in=t1.capacity + t2.capacity):
            keys = join_keys(
                t1, t2, config.predicate1, config.predicate2, config.join_key1,
                config.join_key2, config.narrow_keys,
            )
        return join_ops._one_to_one_merged(
            t1, t2, config.join_key2, keys, sort_algorithm=config.sort_algorithm,
        )
    with metrics.stage("filter", rows_in=t1.capacity + t2.capacity):
        f1 = filter_ops.apply_filter(t1, config.predicate1)
        f2 = filter_ops.apply_filter(t2, config.predicate2)
    out_cap = None
    if config.join_mode == "inner":
        out_cap = int(t1.capacity * config.join_slack)
    if config.join_algorithm == "hash":
        # The hash join orders itself in hash space, so it comes before the
        # sort stage. Its rows are in table-1 filtered-row order, not key
        # order; it takes no narrow keys.
        with metrics.stage("join"):
            return hash_join(
                f1, f2, config.join_key1, config.join_key2,
                mode=config.join_mode, out_capacity=out_cap,
            )
    with metrics.stage("sort"):
        s1 = sort_ops.sort_by_key(
            f1, config.join_key1, algorithm=config.sort_algorithm,
            narrow=config.narrow_keys is True,
        )
        s2 = sort_ops.sort_by_key(
            f2, config.join_key2, algorithm=config.sort_algorithm,
            narrow=config.narrow_keys is True,
        )
    with metrics.stage("join"):
        return join_ops.merge_join(
            s1, s2, config.join_key1, config.join_key2,
            mode=config.join_mode, out_capacity=out_cap,
            narrow=config.narrow_keys,
            narrow_data=config.narrow_data,
            sort_algorithm=config.sort_algorithm,
        )


def narrow_fits(lo: torch.Tensor, hi: torch.Tensor, dtype: torch.dtype) -> tuple[bool, bool]:
    """``(keys fit int32, every value fits int32)`` from `narrow_extremes`."""
    # The order key of a uint64 value v is v - 2^63.
    shift = 2**63 if dtypes.is_unsigned(dtype) else 0
    both = torch.cat([lo, hi])
    with metrics.sync(both.numel() * both.element_size()):
        values = both.tolist()
    klo, dlo, khi, dhi = (v + shift for v in values)
    info = np.iinfo(np.int32)
    return bool(klo >= info.min and khi < info.max), bool(dlo >= info.min and dhi < info.max)


def resolve_narrow(
    config: EngineConfig,
    t1,
    t2,
    narrow: bool | None = None,
    narrow_data: bool | None = None,
    reduce=None,
) -> EngineConfig:
    """``config`` with narrow_keys / narrow_data concrete: ``narrow`` /
    ``narrow_data`` where given, else the configuration's, whose "auto"
    reads the tables' buffers (`narrow_extremes`, one readback in
    `narrow_fits`). ``reduce(lo, hi)`` combines the extremes of every rank
    (`DistributedQueryPipeline`). "auto" resolves to False, with no probe,
    unless both the configuration's type and the tables' are int64 or
    uint64: `join_keys` narrows no other type."""
    narrow = config.narrow_keys if narrow is None else narrow
    narrow_data = config.narrow_data if narrow_data is None else narrow_data
    if "auto" in (narrow, narrow_data):
        fits = (False, False)
        if config.narrowable() and {t1.dtype, t2.dtype} <= {torch.int64, torch.uint64}:
            lo, hi = narrow_extremes(t1.data, t2.data, config.join_key1, config.join_key2)
            if reduce is not None:
                lo, hi = reduce(lo, hi)
            fits = narrow_fits(lo, hi, t1.dtype)
        narrow = fits[0] if narrow == "auto" else narrow
        narrow_data = fits[1] if narrow_data == "auto" else narrow_data
    return dataclasses.replace(config, narrow_keys=bool(narrow), narrow_data=bool(narrow_data))


def _resolve_device(device: str | torch.device | None) -> torch.device:
    dev = resolve_device(device)  # raises when the card is asked for and absent
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"QueryPipeline: unsupported device {dev}")
    return dev


class QueryPipeline:
    """Host-facing entry point: tables or CSV paths in, result table / CSV out.

    ``device`` is where the tables live and the query runs: the card unless
    named (`device.DEFAULT_DEVICE`), which runs the hand-written kernels;
    "cpu" runs their plain torch versions and is used only when asked for.
    """

    def __init__(
        self, config: EngineConfig | None = None, device: str | torch.device | None = None
    ):
        self.config = config or EngineConfig()
        self.device = _resolve_device(device)
        self.metrics = MetricsCollector(enabled=self.config.collect_metrics)
        # Concrete narrow_keys / narrow_data decisions of the most recent
        # run; None until a query resolves them.
        self.resolved_narrow_keys: bool | None = None
        self.resolved_narrow_data: bool | None = None

    def _check_devices(self, *tables: Table) -> None:
        for t in tables:
            if t.device.type != self.device.type:
                raise ValueError(f"table on {t.device}, pipeline on {self.device}")

    def _debug_filter_counts(self, t1: Table, t2: Table) -> None:
        """The ``filter`` event of ``debug_log``: each table's rows before
        and after its predicate, from one readback. The fused path never
        counts its survivors otherwise, so this costs a pass over each
        table, and only when the option is on."""
        cfg = self.config
        with metrics.stage("debug_filter"):
            counts = torch.stack([
                t1.num_rows,
                filter_ops.predicate_mask(t1, cfg.predicate1).sum(dtype=torch.int32),
                t2.num_rows,
                filter_ops.predicate_mask(t2, cfg.predicate2).sum(dtype=torch.int32),
            ])
            with metrics.sync(counts.numel() * counts.element_size()):
                counts = counts.tolist()
        log_event(
            "filter",
            table1_rows_in=counts[0],
            table1_rows_out=counts[1],
            table2_rows_in=counts[2],
            table2_rows_out=counts[3],
            predicate1=cfg.predicate1.describe(),
            predicate2=cfg.predicate2.describe(),
        )

    def run_tables(
        self,
        t1: Table,
        t2: Table,
        *,
        narrow: bool | None = None,
        narrow_data: bool | None = None,
    ) -> Table:
        self._check_devices(t1, t2)
        # ``execute`` holds the query's stages, each with a span of its own:
        # ``probe`` (the narrow decision, with the device probe where it is
        # "auto"), pipeline_core's steps, the row count's ``readback``.
        with metrics.collecting(self.metrics), self.metrics.stage("execute", span=False) as m:
            with metrics.stage("probe"):
                cfg = resolve_narrow(self.config, t1, t2, narrow, narrow_data)
            self.resolved_narrow_keys = cfg.narrow_keys
            self.resolved_narrow_data = cfg.narrow_data
            if self.config.debug_log:
                self._debug_filter_counts(t1, t2)
            result = pipeline_core(t1, t2, cfg)
            with metrics.stage("readback") as r, metrics.sync(result.num_rows.element_size()):
                m.rows_out = r.rows_out = int(result.num_rows)  # waits for the device
        if self.config.debug_log:
            log_event(
                "join",
                rows_out=m.rows_out,
                output_capacity=result.capacity,
                overflow_headroom=result.capacity - m.rows_out,
            )
        # Inner joins report the true match count in num_rows even past the
        # output capacity (ops/join.merge_join_inner); rows beyond the
        # capacity were dropped, so raise instead of truncating silently.
        if m.rows_out > result.capacity:
            raise JoinOverflowError(m.rows_out, result.capacity)
        return result

    def run_csv(
        self,
        path1: str,
        path2: str,
        output_path: str | None = None,
        *,
        capacity: int | None = None,
    ) -> Table:
        dtype = self.config.torch_dtype()
        np_dtype = np.dtype(self.config.dtype)
        with self.metrics.stage("ingest") as m:
            # Every field is parsed as an integer, whatever the type (the
            # reference's `atoi`); the cast to the table type follows.
            rows1, parser1 = csv_io.read_csv(path1, dtype=np.int64)
            rows2, parser2 = csv_io.read_csv(path2, dtype=np.int64)
            m.rows_in = rows1.shape[0] + rows2.shape[0]
            m.extra["parser"] = parser1 if parser1 == parser2 else f"{parser1},{parser2}"
        if self.config.debug_log:
            log_event(
                "ingest",
                table1_rows=rows1.shape[0],
                table2_rows=rows2.shape[0],
                table1_bytes=rows1.nbytes,
                table2_bytes=rows2.nbytes,
                parser=m.extra["parser"],
            )
        if np_dtype.itemsize < 8:
            validate.check_dtype_range(rows1, np_dtype, path1)
            validate.check_dtype_range(rows2, np_dtype, path2)
            rows1 = rows1.astype(np_dtype)
            rows2 = rows2.astype(np_dtype)
        if self.config.narrow_keys is True:
            validate.check_narrow_keys(rows1, self.config.join_key1, path1)
            validate.check_narrow_keys(rows2, self.config.join_key2, path2)
        if self.config.narrow_data is True:
            validate.check_narrow_data(rows1, path1)
            validate.check_narrow_data(rows2, path2)
        narrow = None
        narrow_data = None
        if self.config.narrow_keys == "auto":
            # Host probe while the arrays are still on the host.
            narrow = self.config.resolve_narrow(
                rows1[:, self.config.join_key1], rows2[:, self.config.join_key2]
            ).narrow_keys
        if self.config.narrow_data == "auto":
            narrow_data = self.config.resolve_narrow_data(rows1, rows2).narrow_data
        with self.metrics.stage("host_to_device") as m:
            t1 = Table.from_numpy(rows1, capacity=capacity, dtype=dtype, device=self.device)
            t2 = Table.from_numpy(rows2, capacity=capacity, dtype=dtype, device=self.device)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            m.bytes_moved = rows1.nbytes + rows2.nbytes
        result = self.run_tables(t1, t2, narrow=narrow, narrow_data=narrow_data)
        if output_path is not None:
            with self.metrics.stage("materialize") as m:
                out = result.to_numpy()
                csv_io.write_csv(output_path, out, names=result.names)
                m.rows_out = out.shape[0]
                m.bytes_moved = out.nbytes
            if self.config.debug_log:
                log_event("materialize", rows=out.shape[0], bytes=out.nbytes, path=output_path)
        return result

    def metrics_json(self) -> str:
        return self.metrics.to_json()

    def run_tables_resumable(self, t1: Table, t2: Table) -> Table:
        """Execution checkpointed at stage boundaries (``checkpoint_dir``).

        Stage ``sorted`` filters and sorts both tables and saves them; stage
        ``joined`` joins them with `merge_join` and saves the result. A
        rerun with the same config resumes after the last completed stage.
        As in the reference, this path sorts and merges whatever
        ``join_algorithm`` says, and resolves no narrow keys or data.
        Without ``checkpoint_dir`` it is `run_tables`.
        """
        cfg = self.config
        if cfg.checkpoint_dir is None:
            return self.run_tables(t1, t2)
        self._check_devices(t1, t2)
        ckpt = StageCheckpointer(cfg.checkpoint_dir, config_fingerprint(cfg))
        if ckpt.has("sorted"):
            s1 = ckpt.load_table("sorted", "t1", device=self.device)
            s2 = ckpt.load_table("sorted", "t2", device=self.device)
        else:
            with self.metrics.stage("filter_sort"):
                s1, s2 = (
                    sort_ops.sort_by_key(
                        filter_ops.apply_filter(t, pred), key, algorithm=cfg.sort_algorithm
                    )
                    for t, pred, key in ((t1, cfg.predicate1, cfg.join_key1),
                                         (t2, cfg.predicate2, cfg.join_key2))
                )
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            ckpt.save("sorted", t1=s1, t2=s2)
        with self.metrics.stage("join") as m:
            out_cap = None
            if cfg.join_mode == "inner":
                out_cap = int(t1.capacity * cfg.join_slack)
            result = join_ops.merge_join(
                s1, s2, cfg.join_key1, cfg.join_key2, mode=cfg.join_mode, out_capacity=out_cap,
            )
            m.rows_out = int(result.num_rows)
        ckpt.save("joined", result=result)
        return result
