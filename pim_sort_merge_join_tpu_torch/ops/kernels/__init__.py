"""Hand-written CUDA kernels of the port, with their plain versions."""

from pim_sort_merge_join_tpu_torch.ops.kernels import (
    bitonic_sort,
    build,
    gather,
    hbm_sort,
    join_scan,
    probe,
    radix_sort,
)

_COUNTERS = (
    hbm_sort.LAUNCHES, gather.LAUNCHES, join_scan.LAUNCHES, bitonic_sort.LAUNCHES, radix_sort.LAUNCHES,
    probe.LAUNCHES,
)


def launch_counts() -> dict[str, int]:
    """Kernel launches by the wrappers since the last reset, by kernel."""
    return {name: n for counts in _COUNTERS for name, n in counts.items()}


def reset_launch_counts() -> None:
    build.launches = 0
    for counts in _COUNTERS:
        for name in counts:
            counts[name] = 0
