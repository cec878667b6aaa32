"""Query stages: device time of the ops launched in the span
``smj.unmerge`` inside `run_tables`, ms a query: step 2 of
`ops/join._one_to_one_merged`, the placement kernel
(`join_scan.place_sources`: each output slot's source rows, one pass)."""

from benchmark.stages import stage_ms_per_query


def read(tw):
    return stage_ms_per_query(tw, "unmerge")
