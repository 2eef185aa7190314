"""Batcher: rows added to fill a batch up to the batch grid, as a share of
all dispatched rows over the window (``padded_rows / (jobs + padded_rows)``)."""


def read(win):
    b = win.batcher
    rows = b["jobs"] + b["padded_rows"]
    return 100.0 * b["padded_rows"] / rows if rows else None
