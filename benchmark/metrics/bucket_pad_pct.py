"""Planning: padding frames over bucket frames, over every request row the
window dispatched (the rows a micro-batcher adds to fill a batch are
``padded_row_pct``'s)."""


def read(win):
    pad = total = 0
    for b in win.batches:
        for n, real in zip(b["total_len"], b["real"]):
            if real:
                pad += b["bucket"] - n
                total += b["bucket"]
    return 100.0 * pad / total if total else None
