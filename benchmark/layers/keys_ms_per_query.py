"""Query stages: device time of the ops launched in the span ``smj.keys``
inside `run_tables`, ms a query: the fused path's key vectors
(`pipeline_core`: both predicate masks, `ops/join.one_to_one_keys`)."""

from benchmark.stages import stage_ms_per_query


def read(tw):
    return stage_ms_per_query(tw, "keys")
