"""Query pipeline: what the host readbacks inside `run_tables` (each marked
``smj.sync``: the narrow probe's extremes, the row count) cost the card,
its idle time from the end of each to its next device op, ms a query."""

from benchmark.stages import sync_idle_ms_per_query


def read(tw):
    return sync_idle_ms_per_query(tw)
