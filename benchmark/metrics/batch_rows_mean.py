"""Batcher: request rows per dispatched batch over the window
(``BatcherStats.jobs / batches``)."""


def read(win):
    b = win.batcher
    return b["jobs"] / b["batches"] if b["batches"] else None
