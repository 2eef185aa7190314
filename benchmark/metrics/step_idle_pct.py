"""Device: the share of the traced span's whole batches' time on the device
(first kernel to last, ``trace.Summary.step_ns``) in which no kernel of
theirs ran: the gaps between the kernels of a step."""


def read(win):
    t = win.trace
    if t is None or not t.step_ns or not t.step_busy_ns:
        return None
    return 100.0 * (1.0 - t.step_busy_ns / t.step_ns)
