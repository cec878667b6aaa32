"""The 95th percentile of the host-clock latency of every query completed
in the window, from the call until its rows are usable, in ms."""

import statistics


def read(w):
    if len(w.latencies_s) < 2:
        return None
    return statistics.quantiles(w.latencies_s, n=20, method="inclusive")[18] * 1e3
