"""Kernels, whole query: the least time the card could take for the traced
queries (`roofline.least_bytes` over the card's published memory rate)
over the time the card was busy inside `run_tables`, in %."""

from benchmark.traced import busy, overlap


def read(tw):
    spans = tw.spans.get("query")
    if not spans or not tw.device_ops or not tw.peak_bytes_per_s or not tw.least_bytes:
        return None
    busy_s = overlap(busy(tw.device_ops), spans) / 1e6
    if busy_s <= 0:
        return None
    return 100.0 * tw.least_bytes / tw.peak_bytes_per_s / busy_s
