"""Kernels: the attention kernels' share of their roofline over the batches
of the traced span whose kernels all ran in it: the sum of each call's
bound (``flops.attention_bound_s`` of the batch's rows, both CFG halves)
over the sum of the measured attention kernel time."""

from benchmark import flops


def read(win):
    calls = flops.attention_calls_per_batch(win.model)
    bound = measured = 0.0
    for b in (win.trace.batches if win.trace is not None else ()):
        if b["attention_calls"] != calls:
            continue  # not all of this batch's attention ran in the span
        d = b["dispatch"]
        rows = d["total_len"] * 2  # the solve doubles every row for CFG
        bound += calls * flops.attention_bound_s(win.model, rows, d["bucket"])
        measured += b["attention_ns"] / 1e9
    return 100.0 * bound / measured if measured else None
