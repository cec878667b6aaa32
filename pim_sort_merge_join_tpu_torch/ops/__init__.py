"""The relational operators, the oracle and the hand-written kernels (`ops/kernels`)."""

from pim_sort_merge_join_tpu_torch._exports import lazy_exports

_EXPORTS = {name: name for name in ("filter", "sort", "join", "merge", "oracle")}
__all__ = list(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
