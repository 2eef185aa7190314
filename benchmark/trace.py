"""A traced span of the window, reduced in memory: the device's busy and idle
time, its operations by name, its idle gaps with the host calls over them,
and each dispatched batch's kernels.

The events come from ``torch.profiler`` (CPU and CUDA activities), read
from the profiler's results without writing a trace file. A batch is found
by the host: every dispatch is recorded with its wall time
(``time.time_ns``, the clock of the profiler's timestamps), the graph
launch inside it is the runtime call that falls in that time, and the
launch's correlation id names the kernels it ran.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# Kernel names of the attention: the fused RoPE attention and the flash
# attention kernels, their rotation passes and the tile kernels they share.
ATTENTION_KERNELS = ("fused_rope_attention", "flash_attention", "rope_bf16_kernel",
                     "rope_f32_kernel", "attention_tile_kernel", "attention_wide_kernel",
                     "attention_tf32_kernel")
GRAPH_LAUNCH = "GraphLaunch"
MATCH_SLACK_NS = 2_000_000


def is_attention(name: str) -> bool:
    return any(k in name for k in ATTENTION_KERNELS)


@dataclass
class Summary:
    window_ns: tuple  # (start, end) of the traced span
    busy_ns: int
    device_ops: list  # [(name, seconds)] most time first
    idle_gaps: list  # [(what the host was doing, seconds)] longest first
    kernel_ns: int  # all kernel time
    attention_ns: int  # attention kernels' time
    batches: list = field(default_factory=list)  # per matched dispatch, see below
    step_ns: int = 0  # the union of those batches' spans, first kernel to last
    step_busy_ns: int = 0  # the part of it in which a kernel of theirs ran

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return self.busy_ns / 1e9


def _events(prof):
    """(device, runtime) event tuples (start_ns, end_ns, name, correlation)."""
    from torch.autograd import DeviceType

    device, runtime, host = [], [], []
    for e in prof.profiler.kineto_results.events():
        item = (e.start_ns(), e.end_ns(), e.name(), e.correlation_id())
        if e.device_type() == DeviceType.CUDA:
            device.append(item)
        elif e.name().startswith("cuda"):
            runtime.append(item)
        else:
            host.append(item)
    return sorted(device), sorted(runtime), host


def summarize(prof, dispatches=(), top: int = 10, span=None) -> Summary:
    """Reduce a stopped profiler (see :func:`summarize_events`)."""
    return summarize_events(*_events(prof), dispatches, top, span)


def _clip(events, lo: int, hi: int) -> list:
    return [(max(s, lo), min(e, hi), name, c) for s, e, name, c in events if e > lo and s < hi]


def summarize_events(device, runtime, host, dispatches=(), top: int = 10, span=None) -> Summary:
    """Reduce event tuples (start_ns, end_ns, name, correlation), device ones
    sorted by start, over ``span`` (start_ns, end_ns; by default all the
    events). ``dispatches`` are the recorder's batches (each with
    ``t_begin_ns``, ``t_end_ns``); those whose graph launch is in the trace
    and whose kernels all ran inside the span get their kernels' times in
    ``Summary.batches`` as dicts with the dispatch, ``correlation``,
    ``attention_ns``, ``attention_calls``, ``first_ns`` and ``last_ns``;
    ``Summary.step_ns`` and ``step_busy_ns`` are the time those batches
    took on the device and the part of it with a kernel of theirs running."""
    every = list(device) + list(runtime) + list(host)
    if not every:
        return Summary((0, 0), 0, [], [], 0, 0)
    if span is None:
        span = (min(s for s, _, _, _ in every), max(e for _, e, _, _ in every))
    whole_device = device
    start, end = span
    device, runtime = _clip(device, start, end), _clip(runtime, start, end)
    busy, edge, gaps = 0, start, []
    by_name: dict = {}
    kernel_ns = attention_ns = 0
    for s, e, name, _ in device:
        by_name[name] = by_name.get(name, 0) + (e - s)
        kernel_ns += e - s
        if is_attention(name):
            attention_ns += e - s
        if e <= edge:
            continue
        if s > edge:
            gaps.append((edge, s))
        busy += e - max(s, edge)
        edge = e
    if edge < end:
        gaps.append((edge, end))
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        over: dict = {}
        for rs, re_, name, _ in runtime:
            if rs < e and re_ > s:
                over[name] = over.get(name, 0) + min(re_, e) - max(rs, s)
        calls = sorted(over, key=lambda n: -over[n])[:2]
        idle.append(("idle; host in " + " + ".join(calls) if calls else "idle; no host call",
                     (e - s) / 1e9))
    summary = Summary((start, end), busy, [(n[:120], t / 1e9) for n, t in ops], idle,
                      kernel_ns, attention_ns)
    summary.batches = [b for b in _match_batches(whole_device, runtime, dispatches)
                       if start <= b["first_ns"] and b["last_ns"] <= end]
    ours = {b["correlation"] for b in summary.batches}
    summary.step_ns = _union_ns((b["first_ns"], b["last_ns"]) for b in summary.batches)
    summary.step_busy_ns = _union_ns((s, e) for s, e, _, c in whole_device if c in ours)
    return summary


def _union_ns(intervals) -> int:
    """The length of the union of (start, end) intervals."""
    total, edge = 0, None
    for s, e in sorted(intervals):
        if edge is None or s > edge:
            total, edge = total + e - s, e
        elif e > edge:
            total, edge = total + e - edge, e
    return total


def _match_batches(device, runtime, dispatches) -> list:
    launches = [(s, c) for s, _, name, c in runtime if GRAPH_LAUNCH in name]
    kernels: dict = {}
    for s, e, name, corr in device:
        k = kernels.setdefault(corr, {"attention_ns": 0, "attention_calls": 0,
                                      "first_ns": s, "last_ns": e})
        k["first_ns"], k["last_ns"] = min(k["first_ns"], s), max(k["last_ns"], e)
        if is_attention(name):
            k["attention_ns"] += e - s
            k["attention_calls"] += 1
    out = []
    for d in dispatches:
        lo, hi = d["t_begin_ns"] - MATCH_SLACK_NS, d["t_end_ns"] + MATCH_SLACK_NS
        hits = [c for s, c in launches if lo <= s <= hi and c in kernels]
        if len(hits) == 1:
            out.append({"dispatch": d, "correlation": hits[0], **kernels[hits[0]]})
    return out
