"""PyTorch + CUDA port of the query engine in `pim_sort_merge_join_tpu`.

The single-device engine on integer tables: the fused filter -> sort -> 1:1
merge-join, the staged inner join, the hash join and aggregate, the merge
of sorted runs, checkpoint/resume and the structured debug log. Plain
tensor code is PyTorch; the sorts, the gathers and the join-rank scan are
CUDA kernels written for Hopper (`csrc/`), built with nvcc at first use and
chosen whenever the tensors are on a CUDA device. On CPU tensors the same
functions run their plain torch versions. Importing this package never
imports jax.
"""

from pim_sort_merge_join_tpu_torch.columnar.table import Table
from pim_sort_merge_join_tpu_torch.config import EngineConfig, Predicate
from pim_sort_merge_join_tpu_torch.engine.pipeline import QueryPipeline

__all__ = ["EngineConfig", "Predicate", "Table", "QueryPipeline"]
