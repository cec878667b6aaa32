"""Query core glue (`ops/join`, `ops/filter`, `columnar/dtypes`, the probe
in `engine/pipeline`): device time of every kernel inside `run_tables`
that is not one of the port's own (the names of `csrc/`), ms a query.
Copies and memsets are not kernels and are not counted."""

from benchmark.traced import inside, is_kernel, name_pattern

PORT_KERNELS = name_pattern("run_sort_kernel", "merge_kernel", "bitonic_pass_kernel",
                            r"radix_\w+", "gather_rows_kernel", "gather_kernel",
                            r"join_scan_\w+")


def read(tw):
    if "query" not in tw.spans or not tw.queries or not tw.device_ops:
        return None
    ops = [op for op in inside(tw.device_ops, tw.spans["query"])
           if is_kernel(op[0]) and not PORT_KERNELS.search(op[0])]
    return sum(e - s for _, s, e in ops) / 1e3 / tw.queries
