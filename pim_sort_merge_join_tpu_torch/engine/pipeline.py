"""The query pipeline on one device (port of `engine/pipeline.py`).

`pipeline_core` is the filter -> sort -> join dataflow: fused for the
sort-merge 1:1 join, staged (compact, sort each table, join) for the
sort-merge inner join. `QueryPipeline` drives it on tables (`run_tables`,
with the device narrow probe) or on CSV paths (`run_csv`). PyTorch runs
eagerly, so there is no compile cache. Hash joins and resumable runs come
later (ROADMAP, "The other single-chip operators" and "Checkpoint/resume").
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pim_sort_merge_join_tpu_torch.columnar import csv_io
from pim_sort_merge_join_tpu_torch.columnar.table import Table
from pim_sort_merge_join_tpu_torch.config import EngineConfig
from pim_sort_merge_join_tpu_torch.device import resolve_device
from pim_sort_merge_join_tpu_torch.engine.errors import JoinOverflowError
from pim_sort_merge_join_tpu_torch.engine.metrics import MetricsCollector
from pim_sort_merge_join_tpu_torch.ops import filter as filter_ops
from pim_sort_merge_join_tpu_torch.ops import join as join_ops
from pim_sort_merge_join_tpu_torch.ops import sort as sort_ops
from pim_sort_merge_join_tpu_torch.utils import validate


def pipeline_core(t1: Table, t2: Table, config: EngineConfig) -> Table:
    """The filter -> sort -> join dataflow on two tables of one device."""
    if config.join_algorithm != "sort_merge":
        raise NotImplementedError(
            f"join_algorithm={config.join_algorithm!r}: not ported yet "
            "(ROADMAP, \"The other single-chip operators\")"
        )
    if config.join_mode == "one_to_one":
        # Fused path: filtering is a key mask and the join's slot-permutation
        # sorts subsume the standalone compaction and table sorts.
        m1 = filter_ops.predicate_mask(t1, config.predicate1)
        m2 = filter_ops.predicate_mask(t2, config.predicate2)
        return join_ops.filter_join_one_to_one(
            t1, t2, config.join_key1, config.join_key2, m1, m2,
            narrow=config.narrow_keys,
            narrow_data=config.narrow_data,
            sort_algorithm=config.sort_algorithm,
        )
    f1 = filter_ops.apply_filter(t1, config.predicate1)
    f2 = filter_ops.apply_filter(t2, config.predicate2)
    s1 = sort_ops.sort_by_key(
        f1, config.join_key1, algorithm=config.sort_algorithm,
        narrow=config.narrow_keys is True,
    )
    s2 = sort_ops.sort_by_key(
        f2, config.join_key2, algorithm=config.sort_algorithm,
        narrow=config.narrow_keys is True,
    )
    out_cap = None
    if config.join_mode == "inner":
        out_cap = int(t1.capacity * config.join_slack)
    return join_ops.merge_join(
        s1, s2, config.join_key1, config.join_key2,
        mode=config.join_mode, out_capacity=out_cap,
        narrow=config.narrow_keys,
        narrow_data=config.narrow_data,
        sort_algorithm=config.sort_algorithm,
    )


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

    def _resolve_narrow_device(self, t1: Table, t2: Table) -> tuple[bool, bool]:
        """Resolve narrow_keys/narrow_data="auto" from the device tables.

        Probes the raw buffers, padding included: padding zeros keep the
        range inside int32, never push a valid value out. One readback.
        Returns (keys_fit, all_data_fits).
        """
        if not self.config.narrowable():
            return False, False
        k1c, k2c = self.config.join_key1, self.config.join_key2
        probe = torch.stack([
            torch.minimum(t1.data[:, k1c].min(), t2.data[:, k2c].min()),
            torch.maximum(t1.data[:, k1c].max(), t2.data[:, k2c].max()),
            torch.minimum(t1.data.min(), t2.data.min()),
            torch.maximum(t1.data.max(), t2.data.max()),
        ])
        klo, khi, dlo, dhi = probe.tolist()
        info = np.iinfo(np.int32)
        keys_fit = bool(klo >= info.min and khi < info.max)
        data_fit = bool(dlo >= info.min and dhi < info.max)
        return keys_fit, data_fit

    def run_tables(
        self,
        t1: Table,
        t2: Table,
        *,
        narrow: bool | None = None,
        narrow_data: bool | None = None,
    ) -> Table:
        for t in (t1, t2):
            if t.device.type != self.device.type:
                raise ValueError(f"table on {t.device}, pipeline on {self.device}")
        if narrow is None or narrow_data is None:
            need_probe = (narrow is None and self.config.narrow_keys == "auto") or (
                narrow_data is None and self.config.narrow_data == "auto"
            )
            probed = self._resolve_narrow_device(t1, t2) if need_probe else (False, False)
            if narrow is None:
                narrow = (
                    self.config.narrow_keys
                    if self.config.narrow_keys != "auto"
                    else probed[0]
                )
            if narrow_data is None:
                narrow_data = (
                    self.config.narrow_data
                    if self.config.narrow_data != "auto"
                    else probed[1]
                )
        self.resolved_narrow_keys = bool(narrow)
        self.resolved_narrow_data = bool(narrow_data)
        cfg = dataclasses.replace(
            self.config, narrow_keys=bool(narrow), narrow_data=bool(narrow_data)
        )
        with self.metrics.stage("execute") as m:
            result = pipeline_core(t1, t2, cfg)
            m.rows_out = int(result.num_rows)  # waits for the device
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
            rows1 = csv_io.load_csv_numpy(path1, dtype=np.int64)
            rows2 = csv_io.load_csv_numpy(path2, dtype=np.int64)
            m.rows_in = rows1.shape[0] + rows2.shape[0]
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
        return result

    def metrics_json(self) -> str:
        return self.metrics.to_json()
