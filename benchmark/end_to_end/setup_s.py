"""Seconds from the process's start to the window's: imports, the card's
context, the kernels' build or load, the inputs, the warm-up."""


def read(w):
    return w.setup_s
