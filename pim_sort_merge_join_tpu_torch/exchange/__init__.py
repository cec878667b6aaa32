"""Partitioning, the all-to-all row exchange, skew handling and the collectives."""

from pim_sort_merge_join_tpu_torch._exports import lazy_exports

_EXPORTS = {
    "choose_splitters": "partition",
    "destination_of": "partition",
    "sample_keys": "partition",
    "all_to_all_exchange": "shuffle",
}
__all__ = list(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
