"""Query pipeline (`engine/pipeline.QueryPipeline`): the host-clock span around
`run_tables` less the part of it in which the card was busy, ms a query."""

from benchmark.traced import busy, overlap


def read(tw):
    spans = tw.spans.get("query")
    if not spans or not tw.device_ops:
        return None
    span_us = sum(e - s for s, e in spans)
    return (span_us - overlap(busy(tw.device_ops), spans)) / 1e3 / len(spans)
