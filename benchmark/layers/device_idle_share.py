"""Device: the share of the traced window in which nothing ran on the card
(no kernel, copy or memset), in %."""

from benchmark.traced import busy, overlap


def read(tw):
    if not tw.device_ops or not tw.spans:
        return None
    start, end = tw.window
    return 100.0 * (1.0 - overlap(busy(tw.device_ops), [(start, end)]) / (end - start))
