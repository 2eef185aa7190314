"""Whole step: the model flops that the request rows of the traced span's
whole batches need (``flops.row_flops`` of each row's valid frames: text
embedding, the CFG-doubled solve's DiT evaluations, the vocoder), over the
time those batches took on the device (``trace.Summary.step_ns``: the union
of their spans, first kernel to last) times the card's peak
(``flops.PEAK_FLOPS``)."""

from benchmark import flops


def read(win):
    t = win.trace
    calls = flops.attention_calls_per_batch(win.model)
    whole = [b for b in (t.batches if t is not None else ()) if b["attention_calls"] == calls]
    if not whole or not t.step_ns:
        return None
    work = sum(flops.row_flops(win.model, n)
               for b in whole for n, real in zip(b["dispatch"]["total_len"], b["dispatch"]["real"])
               if real)
    return 100.0 * work / (t.step_ns / 1e9 * flops.PEAK_FLOPS[win.model["compute_dtype"]])
