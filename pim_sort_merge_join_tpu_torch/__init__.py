"""PyTorch + CUDA port of the query engine in `pim_sort_merge_join_tpu`.

Everything the JAX package does, on one card or over a process group: the
fused filter -> sort -> 1:1 merge-join, the staged inner join, the hash
join and aggregate, the merge of sorted runs, checkpoint/resume and the
structured debug log, on tables of every element type of the JAX package
(`columnar/dtypes.py`); the native CSV parser, the command line and the
launcher (`runner/`); the multi-device engine on `torch.distributed`
(`exchange/`, `engine/distributed.py`); the entry points
(`entry.py`) and the examples (`examples/`). Plain tensor code is PyTorch;
the sorts, the gathers and the join-rank scan are CUDA kernels written for
Hopper (`csrc/`), built with nvcc at first use and chosen whenever the
tensors are on a CUDA device. On CPU tensors the same functions run their
plain torch versions. Importing this package never imports jax and builds
nothing.
"""

from pim_sort_merge_join_tpu_torch.config import EngineConfig, Predicate
from pim_sort_merge_join_tpu_torch.columnar.table import Table
from pim_sort_merge_join_tpu_torch.columnar import csv_io
from pim_sort_merge_join_tpu_torch.ops import filter as filter_ops
from pim_sort_merge_join_tpu_torch.ops import sort as sort_ops
from pim_sort_merge_join_tpu_torch.ops import join as join_ops
from pim_sort_merge_join_tpu_torch.engine.pipeline import QueryPipeline

__version__ = "0.1.0"

__all__ = [
    "EngineConfig",
    "Predicate",
    "Table",
    "csv_io",
    "filter_ops",
    "sort_ops",
    "join_ops",
    "QueryPipeline",
    "__version__",
]
