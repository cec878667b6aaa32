"""Input and result validation, and the build lock."""

from pim_sort_merge_join_tpu_torch._exports import lazy_exports

_EXPORTS = {"validate": "validate"}
__all__ = list(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
