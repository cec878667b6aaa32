"""Query stages: device time of the ops launched in the span ``smj.emit``
inside `run_tables`, ms a query: step 3 of `ops/join._one_to_one_merged`,
the output buffer and the one row gather of both tables into it."""

from benchmark.stages import stage_ms_per_query


def read(tw):
    return stage_ms_per_query(tw, "emit")
