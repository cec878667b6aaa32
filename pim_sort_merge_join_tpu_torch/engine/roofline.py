"""Device-memory roofline accounting for the port (counterpart of
`engine/roofline.py`).

The pipeline is bound by bytes (relational operators do almost no
arithmetic per byte), so its speed-of-light time is the least traffic over
the card's peak memory rate. `hbm_peak_gbps` gives that rate from the
device's name; `pipeline_traffic` the least bytes of filter -> sort -> join
over two tables; `roofline_fraction` the share of the peak a measured time
reaches.

Traffic model (bytes; row = ncol * itemsize), a lower bound:
  filter  read n rows + write the kept rows (the compaction moves each row once);
  sort    the port's merge sort (`ops/kernels/hbm_sort.pass_schedule`): one
          run-forming pass and one pass per merge, each reading and writing
          every element once; an element is 8 bytes for an int32 (or
          narrowed) key with its position and 12 bytes for an int64 order
          key with its position. Then one row gather reads and writes every
          row once. With ``unique_keys`` a 4-byte key whose table is that key
          and one 4-byte payload sorts as two keys in one 8-byte element and
          moves no rows (`ops/sort.stable_key_sort`);
  join    read both sorted tables + write the output rows once.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pim_sort_merge_join_tpu_torch.ops.kernels.hbm_sort import pass_schedule

# Peak device-memory rate per card, GB/s, matched on the name
# `torch.cuda.get_device_name` gives, first match wins (NVIDIA's published
# figures: H100 NVL 3.9 TB/s, H100 PCIe 2.0 TB/s, H100 SXM5 3.35 TB/s).
_HBM_PEAK_GBPS = (
    ("h100 nvl", 3900.0),
    ("h100 pcie", 2000.0),
    ("h100", 3350.0),  # the SXM5 card, named "NVIDIA H100 80GB HBM3"
)
CPU_NOMINAL_GBPS = 50.0  # a nominal DDR figure for runs on the host


def hbm_peak_gbps(device: str | torch.device | None = None) -> float:
    """Peak memory GB/s of ``device`` (the card if there is one, else the
    host); `CPU_NOMINAL_GBPS` for the host; raises for a card that is not
    in the table, whose rate is not known."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cpu":
        return CPU_NOMINAL_GBPS
    name = torch.cuda.get_device_name(device)
    for key, peak in _HBM_PEAK_GBPS:
        if key in name.lower():
            return peak
    raise ValueError(f"hbm_peak_gbps: no published memory rate for {name!r}")


@dataclass
class TrafficModel:
    filter_bytes: int
    sort_bytes: int
    join_bytes: int

    @property
    def total_bytes(self) -> int:
        return self.filter_bytes + self.sort_bytes + self.join_bytes

    def speed_of_light_ms(self, peak_gbps: float) -> float:
        return self.total_bytes / (peak_gbps * 1e9) * 1e3


def _sort_passes(n: int) -> int:
    """1 run-forming pass + one pass per merge (`pass_schedule`)."""
    return 0 if n == 0 else 1 + len(pass_schedule(n)[1])


def _sort_bytes(n: int, itemsize: int, ncol: int, *, narrow: bool, unique_keys: bool) -> int:
    """Least bytes of `sort_by_key` (``unique_keys=False``) or of a unique
    key sort through `stable_key_sort` on ``n`` rows of ``ncol`` columns."""
    key_bytes = 4 if narrow or itemsize == 4 else 8
    if unique_keys and key_bytes == 4 and ncol == 2 and itemsize == 4:
        return _sort_passes(n) * 2 * n * 8  # pair-32: both columns in one element
    elem = key_bytes + 4  # the key and the element's position
    return _sort_passes(n) * 2 * n * elem + 2 * n * ncol * itemsize


def pipeline_traffic(
    n1: int,
    n2: int,
    kept1: int,
    kept2: int,
    out_rows: int,
    *,
    ncol: int = 4,
    dtype=np.int64,
    narrow: bool = False,
    unique_keys: bool = False,
) -> TrafficModel:
    """Least device-memory bytes of filter -> sort -> join over two tables
    of ``n1``/``n2`` rows, ``kept1``/``kept2`` after the filter, and
    ``out_rows`` joined rows. ``narrow``: 8-byte integer keys sort as int32.
    ``unique_keys``: the sorts' keys are unique (see `_sort_bytes`); the
    staged path's table sorts are not (the default)."""
    itemsize = np.dtype(dtype).itemsize
    row = ncol * itemsize
    out_row = (2 * ncol - 1) * itemsize
    filter_b = (n1 + kept1 + n2 + kept2) * row
    sort_b = sum(
        _sort_bytes(k, itemsize, ncol, narrow=narrow, unique_keys=unique_keys)
        for k in (kept1, kept2)
    )
    join_b = (kept1 + kept2) * row + out_rows * out_row
    return TrafficModel(filter_bytes=filter_b, sort_bytes=sort_b, join_bytes=join_b)


def roofline_fraction(measured_ms: float, model: TrafficModel, peak_gbps: float) -> float:
    """Fraction of the peak memory rate reached: speed-of-light time over
    the measured time."""
    if measured_ms <= 0:
        return 0.0
    return model.speed_of_light_ms(peak_gbps) / measured_ms
