"""The rows of both input tables, times the queries completed in the
window, over the window's seconds."""


def read(w):
    if not w.latencies_s or w.window_s <= 0:
        return None
    return w.rows_in * len(w.latencies_s) / w.window_s
