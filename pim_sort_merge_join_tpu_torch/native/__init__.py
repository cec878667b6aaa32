"""The native CSV parser and formatter (g++ at first use)."""

from pim_sort_merge_join_tpu_torch._exports import lazy_exports

_EXPORTS = {"csv_native": "csv_native"}
__all__ = list(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
