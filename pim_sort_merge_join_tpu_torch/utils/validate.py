"""Host-side ingest checks (port of the three checks of `utils/validate.py`
that `run_csv` uses): a narrowing cast or the narrow-key / narrow-data
paths fail loudly instead of wrapping."""

from __future__ import annotations

import numpy as np

from pim_sort_merge_join_tpu_torch.engine.errors import MalformedInputError


def check_dtype_range(rows: np.ndarray, dtype, name: str = "input") -> None:
    """Raise MalformedInputError when values exceed a narrow dtype's range."""
    dtype = np.dtype(dtype)
    if dtype.itemsize >= 8 or not np.issubdtype(dtype, np.integer):
        return
    info = np.iinfo(dtype)
    if rows.size and (rows.max() > info.max or rows.min() < info.min):
        raise MalformedInputError(
            f"{name}: values exceed configured dtype {dtype} range "
            f"[{info.min}, {info.max}]"
        )


def check_narrow_keys(rows: np.ndarray, key: int, name: str = "input") -> None:
    """Raise MalformedInputError when join-key values do not fit int32
    (INT32_MAX itself is the narrow sentinel)."""
    if not rows.size:
        return
    info = np.iinfo(np.int32)
    col = rows[:, key]
    if col.max() >= info.max or col.min() < info.min:
        raise MalformedInputError(
            f"{name}: join-key values outside [{info.min}, {info.max}) -- "
            "narrow_keys=True requires every key to fit int32; disable it "
            "for this data"
        )


def check_narrow_data(rows: np.ndarray, name: str = "input") -> None:
    """Raise MalformedInputError when ANY table value does not fit int32."""
    if not rows.size:
        return
    info = np.iinfo(np.int32)
    if rows.max() >= info.max or rows.min() < info.min:
        raise MalformedInputError(
            f"{name}: table values outside [{info.min}, {info.max}) -- "
            "narrow_data=True requires every value to fit int32; disable it "
            "for this data"
        )
