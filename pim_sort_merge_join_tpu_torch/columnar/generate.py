"""Benchmark data generation (port of `columnar/generate.py`; numpy only, so
the bits equal the JAX package's for the same seed).

Replaces the reference's `data/generate_data.py:1-26`: N rows x C columns of
ints where col1 is unique (sampled without replacement from [1, 3N]) and the
remaining columns are uniform in [1, 3N). Adds a Zipf-skewed key mode for the
heavy-hitter join benchmarks (BASELINE.json config 4), which the reference
has no analog for.
"""

from __future__ import annotations

import numpy as np


def generate_table(
    num_rows: int,
    num_cols: int = 4,
    *,
    seed: int = 0,
    key_distribution: str = "unique",
    zipf_a: float = 1.3,
) -> np.ndarray:
    """Row-major [num_rows, num_cols] int64 table.

    key_distribution:
      - "unique": col1 unique ints from [1, 3N] (generate_data.py:9)
      - "uniform": col1 uniform ints in [1, 3N) (duplicates allowed)
      - "zipf": col1 Zipf(a)-distributed, clipped to [1, 3N] -- heavy hitters
    """
    rng = np.random.default_rng(seed)
    hi = 3 * num_rows
    if key_distribution == "unique":
        col1 = rng.choice(np.arange(1, hi + 1, dtype=np.int64), size=num_rows,
                          replace=False)
    elif key_distribution == "uniform":
        col1 = rng.integers(1, hi, size=num_rows, dtype=np.int64)
    elif key_distribution == "zipf":
        col1 = np.minimum(rng.zipf(zipf_a, size=num_rows), hi).astype(np.int64)
    else:
        raise ValueError(f"unknown key_distribution {key_distribution!r}")
    rest = rng.integers(1, hi, size=(num_rows, num_cols - 1), dtype=np.int64)
    return np.column_stack([col1, rest])


def write_table_pair(
    path1: str, path2: str, num_rows: int, *, seed: int = 0, **kw
) -> None:
    """Generate and write a benchmark table pair as CSVs."""
    from pim_sort_merge_join_tpu_torch.columnar import csv_io

    csv_io.write_csv(path1, generate_table(num_rows, seed=seed, **kw))
    csv_io.write_csv(path2, generate_table(num_rows, seed=seed + 1, **kw))
