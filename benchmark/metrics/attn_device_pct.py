"""DiT and kernels: the attention kernels' device time, by kernel name in
the traced span, over all kernel time there."""


def read(win):
    t = win.trace
    if t is None or not t.kernel_ns or not t.attention_ns:
        return None
    return 100.0 * t.attention_ns / t.kernel_ns
