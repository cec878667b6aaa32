"""The multi-device pipeline on `torch.distributed` (port of `engine/distributed.py`).

In the reference one process holds a mesh and a global ``[P * cap, ncol]``
array sharded on axis "p". Here each **rank** is one process holding its
own block: a `ShardedTable` is this rank's ``[cap, ncol]`` rows and its row
count, and the group's P ranks together hold the table. The dataflow is the
reference's: every rank filters its rows and samples its keys; the pooled
samples give range splitters (or heavy hitters and masked splitters); rows
go to their rank in one exchange (`exchange/shuffle.py`); every rank then
sorts and joins (or aggregates) its own key range. The collectives are
`exchange/collectives.py`'s, over an explicit group whose backend (NCCL
for ranks on distinct cards, Gloo for CPU ranks or ranks sharing a card)
its creator named. Each rank's local work runs on its tables' device,
through the same operators (and kernels on the card) as `QueryPipeline`.

Output order: with ``partition_scheme="range"`` the ranks own ascending key
ranges and each rank's output follows its key order, so the ranks' outputs
concatenated in rank order are the single-device output byte for byte,
duplicate keys included: the row blocks are contiguous, so (source rank,
source position) is the global position, which the stable filter, the
exchange's arrival order and the merged-domain join's tie-break all keep.
Skew's rank spreading and ``partition_scheme="hash"`` trade that order away
by design (the same multiset of rows, key-sorted within each rank), as in
the reference; there the port equals the reference rank by rank.

Every check that can raise (`ExchangeOverflowError`, `JoinOverflowError`)
decides from values all-gathered to every rank, at the same point on every
rank, so all ranks raise together and none is left in a collective.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from pim_sort_merge_join_tpu_torch.columnar import dtypes
from pim_sort_merge_join_tpu_torch.columnar.table import Table
from pim_sort_merge_join_tpu_torch.config import EngineConfig
from pim_sort_merge_join_tpu_torch.device import resolve_device
from pim_sort_merge_join_tpu_torch.engine.checkpoint import StageCheckpointer, config_fingerprint
from pim_sort_merge_join_tpu_torch.engine.errors import ExchangeOverflowError, JoinOverflowError
from pim_sort_merge_join_tpu_torch.engine.logging import log_event
from pim_sort_merge_join_tpu_torch.engine.metrics import MetricsCollector
from pim_sort_merge_join_tpu_torch.engine.pipeline import resolve_narrow
from pim_sort_merge_join_tpu_torch.exchange import collectives, skew
from pim_sort_merge_join_tpu_torch.exchange.partition import (
    choose_splitters,
    destination_of,
    hash_destination_of,
    sample_keys,
)
from pim_sort_merge_join_tpu_torch.exchange.shuffle import all_to_all_exchange
from pim_sort_merge_join_tpu_torch.ops import filter as filter_ops
from pim_sort_merge_join_tpu_torch.ops import join as join_ops
from pim_sort_merge_join_tpu_torch.ops import sort as sort_ops
from pim_sort_merge_join_tpu_torch.ops.hash_join import hash_aggregate
from pim_sort_merge_join_tpu_torch.utils import validate


def _default_names(ncol: int) -> tuple:
    return tuple(f"col{i + 1}" for i in range(ncol))


@dataclasses.dataclass
class ShardedTable:
    """This rank's block of a table partitioned row-wise over a group.

    ``data`` is ``[cap, ncol]`` (every rank of the group has the same
    ``cap``), ``num_rows`` a 0-d int32 tensor on its device, ``group`` the
    process group (None: the default group, or a world of one rank when
    there is none). Methods that read other ranks' blocks are collectives.
    """

    data: torch.Tensor
    num_rows: torch.Tensor
    names: tuple = ()
    group: object = None

    @property
    def ncol(self) -> int:
        return self.data.shape[1]

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    def local(self) -> Table:
        return Table(data=self.data, num_rows=self.num_rows, names=self.names)

    def counts(self) -> np.ndarray:
        """``[P]`` int32 row counts of every rank (a collective)."""
        return collectives.gather_numpy(self.num_rows.reshape(1), self.group).reshape(-1)

    def total_rows(self) -> int:
        return int(self.counts().sum())

    @classmethod
    def from_numpy(
        cls,
        array: np.ndarray,
        group=None,
        *,
        shard_capacity: int | None = None,
        names: Sequence[str] | None = None,
        dtype=torch.int64,
        device: str | torch.device | None = None,
    ) -> "ShardedTable":
        """This rank's contiguous row block of ``array``, which every rank
        holds the same: rank i keeps ``base + (i < rem)`` rows, ``cap =
        ceil(n / P)`` (the reference's row-block scatter)."""
        nrow, ncol = array.shape
        p, me = collectives.world_size(group), collectives.rank(group)
        if shard_capacity is None:
            shard_capacity = -(-nrow // p) if nrow else 1
        base, rem = divmod(nrow, p)
        sizes = [base + (1 if i < rem else 0) for i in range(p)]
        for i, n_i in enumerate(sizes):
            if n_i > shard_capacity:
                raise ValueError(f"shard {i} needs {n_i} rows > shard_capacity {shard_capacity}")
        start = sum(sizes[:me])
        t = Table.from_numpy(array[start:start + sizes[me]], capacity=shard_capacity,
                             names=names, dtype=dtype, device=device)
        return cls(data=t.data, num_rows=t.num_rows, names=t.names, group=group)

    @classmethod
    def from_process_local(
        cls,
        array: np.ndarray,
        group=None,
        *,
        names: Sequence[str] | None = None,
        dtype=torch.int64,
        device: str | torch.device | None = None,
    ) -> "ShardedTable":
        """A sharded table from the rows each rank holds (e.g. its byte range
        of a CSV, `csv_io.load_csv_shard`); no rank holds the whole table.
        The global row order is (rank, local order); the capacity is the
        largest rank's row count, from an all-gather. A collective."""
        device = resolve_device(device)
        rows = torch.tensor([array.shape[0]], dtype=torch.int64, device=device)
        cap = max(int(collectives.gather_numpy(rows, group).max()), 1)
        t = Table.from_numpy(array, capacity=cap, names=names, dtype=dtype, device=device)
        return cls(data=t.data, num_rows=t.num_rows, names=t.names, group=group)

    def host_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """The reference's global view on every rank: ``data [P * cap, ncol]``
        (every block whole, padding included) and ``counts [P]`` int32. A
        collective."""
        data = collectives.all_gather(self.data, self.group)
        return data.reshape(-1, self.ncol).cpu().numpy(), self.counts()

    def to_numpy(self) -> np.ndarray:
        """The valid rows of every rank, in rank order, on every rank (a
        collective; each block is cut to the longest rank's rows first)."""
        counts = self.counts()
        keep = int(counts.max())
        if keep == 0:
            return self.data[:0].cpu().numpy()
        blocks = collectives.all_gather(self.data[:keep].contiguous(), self.group).cpu().numpy()
        return np.concatenate([blocks[i, :n] for i, n in enumerate(counts)], axis=0)


def _host_diag(x: torch.Tensor, group=None) -> np.ndarray:
    """A rank's diagnostic scalar gathered to ``[P]`` on every rank, so that
    every rank decides from the same array (a collective)."""
    return collectives.gather_numpy(x.reshape(1), group).reshape(-1)


def _round128(n: int) -> int:
    return -(-n // 128) * 128


def _fused_local_join(config: EngineConfig) -> bool:
    """Only the 1:1 sort-merge join skips the local sort; any other
    ``join_algorithm`` still sort-merges (as in the reference)."""
    return config.join_mode == "one_to_one" and config.join_algorithm == "sort_merge"


def distributed_exchange_core(t1: ShardedTable, t2: ShardedTable, config: EngineConfig,
                              group=None, *, exchange_capacity: int):
    """Stages 1-3: filter -> sample splitters -> exchange [-> local sort].

    Returns ``(s1, s2, diagnostics)``: the co-partitioned tables after the
    exchange (the checkpoint boundary) and this rank's diagnostic scalars
    under the reference's keys. A collective.
    """
    p = collectives.world_size(group)
    sample_size = config.splitter_sample
    bucket_cap = -(-exchange_capacity // p)

    def filter_sample(t: ShardedTable, pred, key):
        f = filter_ops.apply_filter(t.local(), pred)
        return f, sample_keys(f.order_keys(key), f.num_rows, sample_size)

    f1, smp1 = filter_sample(t1, config.predicate1, config.join_key1)
    f2, smp2 = filter_sample(t2, config.predicate2, config.join_key2)
    pooled = collectives.all_gather(torch.stack([smp1, smp2]), group)  # [P, 2, S]
    pooled = torch.cat([pooled[:, 0].reshape(-1), pooled[:, 1].reshape(-1)])

    # For the fused 1:1 join the local sort after the exchange is skipped:
    # the merged-domain join needs no sorted input, and the arrival order is
    # deterministic. Heavy keys from the pooled sample are rank
    # co-partitioned (both modes); the inner join also broadcasts table 2's
    # heavy rows (a cross product needs every pair co-located).
    fused = _fused_local_join(config)
    heavy_frac = (config.heavy_hitter_fraction if config.heavy_hitter_fraction is not None
                  else 0.5 / p)
    k_heavy = skew.max_heavy_hitters(heavy_frac, p)
    heavy_cap = (config.heavy_gather_capacity if config.heavy_gather_capacity is not None
                 else bucket_cap)
    if k_heavy > 0:
        heavy_keys = skew.detect_heavy_hitters(pooled, heavy_frac, k_heavy)
        splitters = choose_splitters(skew.mask_heavy_samples(pooled, heavy_keys), p)
    else:
        heavy_keys = None
        splitters = choose_splitters(pooled, p)

    def exchange_sort(f: Table, key: int, side: int):
        keys = f.order_keys(key)
        valid = f.valid_mask()
        if config.partition_scheme == "hash":
            dest = hash_destination_of(f.masked_keys(key), p, valid)
        else:
            dest = destination_of(keys, splitters, valid)
        heavy_true = torch.zeros((), dtype=torch.int32, device=f.device)
        broadcast = None
        if heavy_keys is not None:
            is_heavy, slot = skew.heavy_slot_of(keys, heavy_keys, valid)
            if side == 2 and config.join_mode == "inner":
                dest = torch.where(is_heavy, p, dest)  # broadcast instead
                g_rows, g_valid, heavy_true = skew.gather_heavy_side(
                    f.data, is_heavy, group, capacity=heavy_cap)
                broadcast = (g_rows, g_valid)
            else:
                dest_h = skew.heavy_rank_destination(is_heavy, slot, k_heavy, group)
                dest = torch.where(is_heavy, dest_h, dest)
        ex = all_to_all_exchange(f.data, dest, group, bucket_capacity=bucket_cap,
                                 recv_capacity=exchange_capacity,
                                 num_chunks=config.exchange_chunks)
        if broadcast is not None:
            # The broadcast heavy rows join the received ones; one stable
            # sort of the union by key makes a valid-prefix table.
            g_rows, g_valid = broadcast
            top = dtypes.order_max(ex.data.dtype)
            live = torch.arange(exchange_capacity, device=f.device) < ex.num_rows
            k_ex = torch.where(live, dtypes.order_key(ex.data[:, key]), top)
            k_hv = torch.where(g_valid, dtypes.order_key(g_rows[:, key]), top)
            union = torch.cat([dtypes.bits(ex.data), dtypes.bits(g_rows)])
            data = sort_ops.stable_key_sort_rows([(torch.cat([k_ex, k_hv]), union)])
            local = Table(dtypes.from_bits(data, ex.data.dtype),
                          ex.num_rows + g_valid.sum(dtype=torch.int32), ())
        else:
            local = Table(ex.data, ex.num_rows, ())
            if not fused:
                local = sort_ops.sort_by_key(local, key, algorithm=config.sort_algorithm)
        return local, ex.true_rows, heavy_true

    s1, true1, htrue1 = exchange_sort(f1, config.join_key1, 1)
    s2, true2, htrue2 = exchange_sort(f2, config.join_key2, 2)
    diagnostics = {
        "exchange_true_rows1": true1,
        "exchange_true_rows2": true2,
        "heavy_true_rows1": htrue1,
        "heavy_true_rows2": htrue2,
        "heavy_gather_capacity": heavy_cap,
        "sorted_rows1": s1.num_rows,
        "sorted_rows2": s2.num_rows,
    }
    return (ShardedTable(s1.data, s1.num_rows, t1.names, group),
            ShardedTable(s2.data, s2.num_rows, t2.names, group), diagnostics)


def distributed_join_core(s1: ShardedTable, s2: ShardedTable, config: EngineConfig,
                          group=None) -> ShardedTable:
    """Stage 4: each rank joins its co-partitioned blocks (`merge_join`)."""
    a = Table(s1.data, s1.num_rows, _default_names(s1.ncol))
    b = Table(s2.data, s2.num_rows, _default_names(s2.ncol))
    out_cap = None
    if config.join_mode == "inner":
        # join_slack sizes each rank's output past its input capacity;
        # num_rows still reports the true match count (overflow check).
        out_cap = _round128(int(s1.capacity * config.join_slack))
    out = join_ops.merge_join(
        a, b, config.join_key1, config.join_key2, mode=config.join_mode,
        presorted=not _fused_local_join(config), out_capacity=out_cap,
        narrow=config.narrow_keys, narrow_data=config.narrow_data,
        sort_algorithm=config.sort_algorithm,
    )
    return ShardedTable(out.data, out.num_rows, _default_names(out.ncol), group)


def distributed_pipeline_core(t1: ShardedTable, t2: ShardedTable, config: EngineConfig,
                              group=None, *, exchange_capacity: int):
    """filter -> sample splitters -> exchange -> sort -> join; returns
    ``(result, diagnostics)``."""
    s1, s2, diagnostics = distributed_exchange_core(
        t1, t2, config, group, exchange_capacity=exchange_capacity)
    return distributed_join_core(s1, s2, config, group), diagnostics


def distributed_aggregate_core(t: ShardedTable, config: EngineConfig, group=None, *, key: int,
                               value: int, agg: str, exchange_capacity: int):
    """Group-by aggregate: exchange by key, `hash_aggregate` on each rank.

    Equal keys co-locate, so each rank's groups are whole; with range
    partitioning the ranks hold ascending key ranges, so their outputs in
    rank order are key-sorted. Returns ``(result, diagnostics)``.
    """
    p = collectives.world_size(group)
    loc = t.local()
    valid = loc.valid_mask()
    if config.partition_scheme == "hash":
        dest = hash_destination_of(loc.masked_keys(key), p, valid)
    else:
        keys = loc.order_keys(key)
        smp = sample_keys(keys, loc.num_rows, config.splitter_sample)
        splitters = choose_splitters(collectives.all_gather(smp, group).reshape(-1), p)
        dest = destination_of(keys, splitters, valid)
    ex = all_to_all_exchange(loc.data, dest, group, bucket_capacity=-(-exchange_capacity // p),
                             recv_capacity=exchange_capacity, num_chunks=config.exchange_chunks)
    out = hash_aggregate(Table(ex.data, ex.num_rows, ()), key, value, agg)
    return (ShardedTable(out.data, out.num_rows, ("key", agg), group),
            {"exchange_true_rows": ex.true_rows})


class DistributedQueryPipeline:
    """The multi-device pipeline's entry point on this rank.

    The counterpart of `QueryPipeline` over a process group: every rank of
    ``group`` builds one with the same config and calls the same methods in
    the same order (they are collectives). ``device`` is where this rank's
    tables live (the card unless named). The simulator is this class on N
    Gloo ranks on the CPU (`runner/simulator.py`).
    """

    def __init__(self, config: EngineConfig | None = None, group=None,
                 device: str | torch.device | None = None):
        self.config = config or EngineConfig()
        self.group = collectives.default_group() if group is None else group
        self.device = resolve_device(device)
        self.metrics = MetricsCollector(enabled=self.config.collect_metrics)
        self.resolved_narrow_keys: bool | None = None
        self.resolved_narrow_data: bool | None = None

    @property
    def num_partitions(self) -> int:
        return collectives.world_size(self.group)

    def _exchange_capacity(self, *tables: ShardedTable) -> int:
        """Each rank's receive capacity: the block capacity (the same on
        every rank) times ``exchange_slack``, rounded up to 128 rows."""
        shard_cap = max(t.capacity for t in tables)
        return _round128(int(shard_cap * self.config.exchange_slack))

    def _resolved_config(self, t1: ShardedTable, t2: ShardedTable) -> EngineConfig:
        """`resolve_narrow` over every rank's raw buffers: the global
        MIN/MAX of `narrow_extremes`, so every rank resolves the same (a
        collective). Padding zeros can only keep the range inside int32."""
        cfg = resolve_narrow(self.config, t1, t2, reduce=lambda lo, hi: (
            collectives.all_reduce(lo, "min", self.group),
            collectives.all_reduce(hi, "max", self.group)))
        self.resolved_narrow_keys = cfg.narrow_keys
        self.resolved_narrow_data = cfg.narrow_data
        return cfg

    def run_tables(self, t1: ShardedTable, t2: ShardedTable, *,
                   check_overflow: bool = True) -> ShardedTable:
        exchange_capacity = self._exchange_capacity(t1, t2)
        cfg = self._resolved_config(t1, t2)
        with self.metrics.stage("execute") as m:
            out, diag = distributed_pipeline_core(t1, t2, cfg, self.group,
                                                  exchange_capacity=exchange_capacity)
            counts = out.counts()  # waits for every rank
            sorted1 = _host_diag(diag["sorted_rows1"], self.group)
            sorted2 = _host_diag(diag["sorted_rows2"], self.group)
            m.rows_out = int(counts.sum())
            m.bytes_moved = int(sorted1.sum() + sorted2.sum()) * t1.ncol * t1.data.element_size()
        if self.config.debug_log:
            true1 = _host_diag(diag["exchange_true_rows1"], self.group)
            true2 = _host_diag(diag["exchange_true_rows2"], self.group)
            log_event(
                "exchange",
                bytes_moved=m.bytes_moved,
                per_shard_capacity=exchange_capacity,
                table1_max_shard_rows=int(true1.max()),
                table2_max_shard_rows=int(true2.max()),
                overflow_headroom=int(exchange_capacity - max(true1.max(), true2.max())),
            )
            log_event("join", rows_out=m.rows_out, per_shard_capacity=out.capacity,
                      max_shard_rows=int(counts.max()))
        if check_overflow:
            self._check_exchange_overflow(diag, exchange_capacity)
            self._check_join_overflow(out)
        return out

    def _check_exchange_overflow(self, diag, exchange_capacity: int) -> None:
        for name, true_key in (("table1", "exchange_true_rows1"),
                               ("table2", "exchange_true_rows2")):
            true = _host_diag(diag[true_key], self.group)
            if (true > exchange_capacity).any():
                raise ExchangeOverflowError(name, true, exchange_capacity)
        hcap = int(diag["heavy_gather_capacity"])
        for name in ("heavy_true_rows1", "heavy_true_rows2"):
            true = _host_diag(diag[name], self.group)
            if (true > hcap).any():
                raise ExchangeOverflowError(f"{name} (broadcast side)", true, hcap)

    def _check_join_overflow(self, out: ShardedTable) -> None:
        # Inner joins report each rank's true match count; rows past the
        # output capacity were dropped.
        counts = out.counts()
        if (counts > out.capacity).any():
            raise JoinOverflowError(int(counts.max()), out.capacity)

    def _checkpointer(self) -> StageCheckpointer:
        return StageCheckpointer(
            self.config.checkpoint_dir,
            config_fingerprint(self.config) + f"|mesh={self.num_partitions}",
            group=self.group,
        )

    def checkpoint_stages(self) -> list:
        """Stages already completed in checkpoint_dir for this config and P."""
        if self.config.checkpoint_dir is None:
            return []
        return self._checkpointer().completed_stages()

    def run_tables_resumable(self, t1: ShardedTable, t2: ShardedTable) -> ShardedTable:
        """Execution checkpointed at the exchange boundary.

        Phase 1 filters, samples and exchanges both tables and saves the
        co-partitioned blocks (stage ``exchanged``); phase 2 joins and saves
        the result (``joined``). A rerun with the same config and P resumes
        at the join and runs no exchange. On resume the narrow probe reads
        the restored blocks, not the inputs (which may then be any tables
        of the same shape): its padding can only widen the range.
        """
        if self.config.checkpoint_dir is None:
            return self.run_tables(t1, t2)
        ckpt = self._checkpointer()
        resumed = ckpt.has("exchanged")
        if resumed:
            s1 = ckpt.load_sharded("exchanged", "t1", self.device)
            s2 = ckpt.load_sharded("exchanged", "t2", self.device)
            cfg = self._resolved_config(s1, s2)
        else:
            cfg = self._resolved_config(t1, t2)
            cap = self._exchange_capacity(t1, t2)
            with self.metrics.stage("exchange") as m:
                s1, s2, diag = distributed_exchange_core(t1, t2, cfg, self.group,
                                                         exchange_capacity=cap)
                m.rows_out = s1.total_rows() + s2.total_rows()
            self._check_exchange_overflow(diag, cap)
            ckpt.save("exchanged", t1=s1, t2=s2)
        with self.metrics.stage("join") as m:
            out = distributed_join_core(s1, s2, cfg, self.group)
            m.rows_out = out.total_rows()
        self._check_join_overflow(out)
        ckpt.save("joined", result=out)
        return out

    def metrics_json(self) -> str:
        return self.metrics.to_json()

    def run_aggregate(self, t: ShardedTable, *, key: int = 0, value: int = 1, agg: str = "sum",
                      check_overflow: bool = True) -> ShardedTable:
        """Group-by-key aggregate over the group."""
        exchange_capacity = self._exchange_capacity(t)
        with self.metrics.stage("aggregate") as m:
            out, diag = distributed_aggregate_core(
                t, self.config, self.group, key=key, value=value, agg=agg,
                exchange_capacity=exchange_capacity)
            m.rows_out = out.total_rows()
        if check_overflow:
            true = _host_diag(diag["exchange_true_rows"], self.group)
            if (true > exchange_capacity).any():
                raise ExchangeOverflowError("aggregate", true, exchange_capacity)
        return out

    def run_arrays(self, rows1: np.ndarray, rows2: np.ndarray) -> ShardedTable:
        """The query on host row arrays that every rank holds the same."""
        dtype = self.config.torch_dtype()
        np_dtype = np.dtype(self.config.dtype)
        if np_dtype.itemsize < 8:
            validate.check_dtype_range(rows1, np_dtype, "table1")
            validate.check_dtype_range(rows2, np_dtype, "table2")
        if self.config.narrow_keys is True:
            validate.check_narrow_keys(rows1, self.config.join_key1, "table1")
            validate.check_narrow_keys(rows2, self.config.join_key2, "table2")
        if self.config.narrow_data is True:
            validate.check_narrow_data(rows1, "table1")
            validate.check_narrow_data(rows2, "table2")
        with self.metrics.stage("host_to_device") as m:
            t1 = ShardedTable.from_numpy(rows1, self.group, dtype=dtype, device=self.device)
            t2 = ShardedTable.from_numpy(rows2, self.group, dtype=dtype, device=self.device)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            m.bytes_moved = rows1.nbytes + rows2.nbytes
        return self.run_tables(t1, t2)
