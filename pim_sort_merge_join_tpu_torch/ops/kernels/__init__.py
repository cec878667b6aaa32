"""Hand-written CUDA kernels of the port, with their plain versions."""

# Each module declares its kernels when imported, so every one has a count.
from pim_sort_merge_join_tpu_torch.ops.kernels import (
    bitonic_sort,
    build,
    gather,
    hbm_sort,
    join_scan,
    keys,
    probe,
    radix_sort,
)


def launch_counts() -> dict[str, int]:
    """Kernel launches by the wrappers since the last reset, by kernel."""
    return dict(build.launch_counts)


def reset_launch_counts() -> None:
    build.launches = 0
    for name in build.launch_counts:
        build.launch_counts[name] = 0
