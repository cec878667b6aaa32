"""The single- and multi-device pipelines, checkpoints, metrics, logging, profiling."""

from pim_sort_merge_join_tpu_torch._exports import lazy_exports

_EXPORTS = {"QueryPipeline": "pipeline"}
__all__ = list(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
