"""Sort seam (`ops/sort`, `ops/kernels/hbm_sort`, `bitonic_sort`,
`radix_sort`): device time of the sort kernels inside `run_tables`, ms a
query."""

from benchmark.traced import inside, name_pattern

KERNELS = name_pattern("run_sort_kernel", "merge_kernel", "bitonic_pass_kernel", r"radix_\w+")


def read(tw):
    if "query" not in tw.spans or not tw.queries or not tw.device_ops:
        return None
    ops = [op for op in inside(tw.device_ops, tw.spans["query"]) if KERNELS.search(op[0])]
    return sum(e - s for _, s, e in ops) / 1e3 / tw.queries
