"""Runtime engine configuration (PyTorch port of `pim_sort_merge_join_tpu/config.py`).

The field set and defaults equal the JAX package's `EngineConfig`, so a
config carries across unchanged (`convert.config_from_reference`), and so
do its checks: ``dtype`` is one of the six table types
(`columnar/dtypes.TORCH_DTYPES`), and ``narrow_keys``/``narrow_data`` may be
forced on only for an integer type.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np
import torch

from pim_sort_merge_join_tpu_torch.columnar.dtypes import TORCH_DTYPES

PredicateOp = Literal[">", ">=", "<", "<=", "==", "!="]


@dataclasses.dataclass(frozen=True)
class Predicate:
    """A single-column comparison predicate, `col <op> value`."""

    col: int = 0
    op: PredicateOp = ">"
    value: int = 5000

    def describe(self) -> str:
        return f"col{self.col + 1} {self.op} {self.value}"


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """All runtime tunables of the engine; defaults equal the JAX package's.

    Fields that only the multi-device path reads (partition scheme,
    exchange, skew) are ignored by the single-device path; ``mesh_axis``
    is kept only so that any reference config carries across.
    """

    predicate1: Predicate = Predicate()
    predicate2: Predicate = Predicate()
    join_key1: int = 0
    join_key2: int = 0
    join_mode: str = "one_to_one"
    dtype: str = "int64"
    donate_inputs: bool = False
    join_algorithm: str = "sort_merge"
    # "pallas_bitonic" selects the bitonic kernel for the staged path's
    # table sorts (`ops/sort.sort_by_key`) and means "auto" for the join's
    # internal sorts, as in the JAX package. Every other value means the
    # `hbm_sort` kernels. Either way: the hand-written kernels for CUDA
    # tensors, their plain torch versions for CPU tensors.
    sort_algorithm: str = "auto"
    partition_scheme: str = "range"
    narrow_keys: bool | str = "auto"
    narrow_data: bool | str = "auto"
    mesh_axis: str = "p"
    exchange_slack: float = 2.0
    splitter_sample: int = 1024
    exchange_chunks: int = 4
    heavy_hitter_fraction: float | None = None
    heavy_gather_capacity: int | None = None
    join_slack: float = 1.0
    collect_metrics: bool = True
    debug_log: bool = False
    checkpoint_dir: str | None = None

    def __post_init__(self):
        if self.dtype not in TORCH_DTYPES:
            raise ValueError(
                f"dtype={self.dtype!r}: one of {sorted(TORCH_DTYPES)}"
            )
        for name in ("narrow_keys", "narrow_data"):
            val = getattr(self, name)
            if val not in (True, False, "auto"):
                raise ValueError(
                    f"{name} must be True, False, or 'auto' (got {val!r})"
                )
            if val is True and self.torch_dtype().is_floating_point:
                raise ValueError(
                    f"{name} applies to integer dtypes only "
                    f"(got dtype={self.dtype!r})"
                )

    def torch_dtype(self) -> torch.dtype:
        return TORCH_DTYPES[self.dtype]

    def narrowable(self) -> bool:
        """Whether narrow-key dispatch can apply to this dtype at all: every
        8-byte integer type (int64 and uint64)."""
        return self.torch_dtype() in (torch.int64, torch.uint64)

    def resolve_narrow(self, *key_columns) -> "EngineConfig":
        """Return a copy with ``narrow_keys`` resolved to a concrete bool.

        ``key_columns`` are host numpy arrays of join-key values (one per
        table); "auto" resolves to True iff every value fits the int32
        narrowing window [INT32_MIN, INT32_MAX) (ops/join.py:_narrow32).
        """
        if self.narrow_keys != "auto":
            return self
        resolved = False
        if self.narrowable() and key_columns:
            resolved = all(_fits_int32(c) for c in key_columns)
        return dataclasses.replace(self, narrow_keys=resolved)

    def resolve_narrow_data(self, *tables) -> "EngineConfig":
        """Return a copy with ``narrow_data`` resolved to a concrete bool.

        ``tables`` are host numpy row arrays (whole tables); "auto" resolves
        to True iff EVERY value in every table fits the int32 window.
        """
        if self.narrow_data != "auto":
            return self
        resolved = False
        if self.narrowable() and tables:
            resolved = all(_fits_int32(t) for t in tables)
        return dataclasses.replace(self, narrow_data=resolved)


def _fits_int32(a: np.ndarray) -> bool:
    info = np.iinfo(np.int32)
    return a.size == 0 or bool(a.min() >= info.min and a.max() < info.max)


def reference_config() -> EngineConfig:
    """The exact configuration of the reference benchmark run."""
    return EngineConfig()
