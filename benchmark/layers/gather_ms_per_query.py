"""Row movement (`ops/kernels/gather`, `hbm_sort.gather`): device time of
the row and column gathers inside `run_tables`, ms a query."""

from benchmark.traced import inside, name_pattern

KERNELS = name_pattern("gather_rows_kernel", "gather_kernel")


def read(tw):
    if "query" not in tw.spans or not tw.queries or not tw.device_ops:
        return None
    ops = [op for op in inside(tw.device_ops, tw.spans["query"]) if KERNELS.search(op[0])]
    return sum(e - s for _, s, e in ops) / 1e3 / tw.queries
