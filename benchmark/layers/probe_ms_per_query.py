"""Query stages: device time of the ops launched in the span ``smj.probe``
inside `run_tables`, ms a query: the narrow probe
(`QueryPipeline._resolve_narrow_device`: `narrow_extremes` and the
readback of its four values)."""

from benchmark.stages import stage_ms_per_query


def read(tw):
    return stage_ms_per_query(tw, "probe")
