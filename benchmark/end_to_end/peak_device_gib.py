"""`torch.cuda.max_memory_allocated()` over the warm-up and the window,
after a reset once the inputs were made, so it counts resident tables; on
a cell of several cards, that of the fullest card."""


def read(w):
    return w.peak_bytes / 2**30 if w.peak_bytes else None
