"""The upstream's table pair (`data/generate_data.py`), made on the device.

Each table has ``rows_per_table`` rows of ``columns`` int64 columns: col1
unique, drawn without replacement from [1, 3N], the other columns uniform
in [1, 3N). The two tables of a pair come from streams of their own.
"""

from __future__ import annotations

import torch

from benchmark.seeds import derive


def make_table(n: int, ncol: int, seed: int, device) -> torch.Tensor:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    table = torch.randint(1, 3 * n, (n, ncol), generator=g, device=device, dtype=torch.int64)
    table[:, 0] = torch.randperm(3 * n, generator=g, device=device)[:n] + 1
    return table


def make_pair(config: dict, seed: int, pair: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    n, ncol = config["scale"]["rows_per_table"], config["scale"]["columns"]
    return tuple(make_table(n, ncol, derive(seed, "upmem_gen", pair, side), device)
                 for side in (1, 2))
