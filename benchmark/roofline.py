"""The least bytes a query has to move, and the cards' published memory
rates: the yardstick of ``query_roofline_share``.

Whatever implements it, a query reads the predicate column of every input
row and writes every output row once, each value at its stored width. Nothing else is
counted: a row that the filter drops need not be read beyond its
predicate column, so counting whole input rows would overstate the bound.
"""

from __future__ import annotations

# Peak device-memory rate per card name, bytes/s, first match wins
# (NVIDIA's data sheets: H100 NVL 3.9 TB/s, H100 PCIe 2.0 TB/s, H100 SXM5
# 3.35 TB/s, which `torch.cuda.get_device_name` calls "NVIDIA H100 80GB HBM3").
PEAK_BYTES_PER_S = (
    ("h100 nvl", 3.9e12),
    ("h100 pcie", 2.0e12),
    ("h100", 3.35e12),
)


def peak_bytes_per_s(card_name: str) -> float | None:
    """The published rate of the card named ``card_name``, None if unknown."""
    for key, rate in PEAK_BYTES_PER_S:
        if key in card_name.lower():
            return rate
    return None


def least_bytes(rows_per_table: tuple[int, int], out_ncol: int, rows_out: int,
                item_bytes: int) -> int:
    """Predicate column of every input row read once, every output row
    written once, ``item_bytes`` a value (the tables' element size)."""
    return item_bytes * (sum(rows_per_table) + rows_out * out_ncol)
