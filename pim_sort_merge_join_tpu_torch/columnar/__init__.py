"""The table model, CSV I/O, the element types and the table generator."""

from pim_sort_merge_join_tpu_torch._exports import lazy_exports

_EXPORTS = {"Table": "table", "csv_io": "csv_io"}
__all__ = list(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
