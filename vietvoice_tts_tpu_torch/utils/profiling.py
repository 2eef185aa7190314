"""Profiling and tracing hooks (port of ``vietvoice_tts_tpu/utils/profiling.py``).

- ``trace(...)``: context manager around ``torch.profiler`` (CPU and CUDA
  activities) that writes a Chrome trace, viewable in Perfetto or
  ``chrome://tracing``;
- ``annotate(name)``: ``torch.profiler.record_function``, so host-side
  pipeline stages show up inside device traces;
- ``device_memory_stats()``: device-memory usage snapshot of one CUDA device.
"""

from __future__ import annotations

import os
import tempfile
from contextlib import contextmanager
from typing import Iterator, Optional

import torch

from .logging import get_logger

log = get_logger("profiling")


@contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace into ``log_dir/trace.json`` (by
    default a ``vietvoice-trace`` directory under the temp dir)."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "vietvoice-trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log.info("Starting profiler trace → %s", log_dir)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
        log.info("Profiler trace written to %s", log_dir)


def annotate(name: str):
    """Named region that appears on the profiler timeline."""
    return torch.profiler.record_function(name)


def device_memory_stats(device: Optional[torch.device | str | int] = None) -> dict:
    """Memory usage for one CUDA device, under the keys the JAX package
    reports: ``bytes_in_use`` and ``peak_bytes_in_use`` (the caching
    allocator's allocated bytes, now and at their peak) and ``bytes_limit``
    (the device's total memory), plus ``bytes_reserved`` (what the allocator
    holds from CUDA) and ``bytes_free`` (what CUDA reports as free).
    Empty dict on a machine without CUDA or for a CPU device."""
    if not torch.cuda.is_available():
        return {}
    if device is not None and torch.device(device).type != "cuda":
        return {}
    try:
        stats = torch.cuda.memory_stats(device)
        free, total = torch.cuda.mem_get_info(device)
    except Exception:  # pragma: no cover — a device that reports nothing
        return {}
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(total),
        "bytes_reserved": int(stats.get("reserved_bytes.all.current", 0)),
        "bytes_free": int(free),
    }


def log_memory(prefix: str = "") -> None:
    stats = device_memory_stats()
    if stats:
        gib = 1024**3
        log.info(
            "%sdevice memory: %.2f GiB in use (peak %.2f / limit %.2f)",
            f"{prefix} " if prefix else "",
            stats.get("bytes_in_use", 0) / gib,
            stats.get("peak_bytes_in_use", 0) / gib,
            stats.get("bytes_limit", 0) / gib,
        )
