"""Query stages: device time of the ops launched in the span ``smj.merge``
inside `run_tables`, ms a query: step 1 of `ops/join._one_to_one_merged`,
the merge sort of both key columns and the join-rank scan."""

from benchmark.stages import stage_ms_per_query


def read(tw):
    return stage_ms_per_query(tw, "merge")
