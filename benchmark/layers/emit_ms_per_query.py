"""Query stages: device time of the ops launched in the span ``smj.emit``
inside `run_tables`, ms a query: step 3 of `ops/join._one_to_one_merged`,
the two emit sorts and the row gather into the output."""

from benchmark.stages import stage_ms_per_query


def read(tw):
    return stage_ms_per_query(tw, "emit")
