"""Hand-written CUDA kernels of the main path, with their plain versions."""

from pim_sort_merge_join_tpu_torch.ops.kernels import hbm_sort, join_scan


def launch_counts() -> dict[str, int]:
    """Kernel launches by the wrappers since the last reset, by kernel."""
    return {**hbm_sort.LAUNCHES, **join_scan.LAUNCHES}


def reset_launch_counts() -> None:
    for counts in (hbm_sort.LAUNCHES, join_scan.LAUNCHES):
        for name in counts:
            counts[name] = 0
