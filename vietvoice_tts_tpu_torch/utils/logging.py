"""Structured logging for the framework.

A copy of ``vietvoice_tts_tpu/utils/logging.py`` under this package's logger
root: a thin layer over stdlib ``logging`` with the reference's ``loguru``
call surface (``logger.info/debug/warning/error``) plus per-stage timing
helpers used by the pipeline's observability hooks.
"""

from __future__ import annotations

import logging
import os
import sys
import time
from contextlib import contextmanager

ROOT = "vietvoice_tts_tpu_torch"
_FORMAT = "%(asctime)s | %(levelname)-7s | %(name)s:%(lineno)d - %(message)s"
_configured = False


def _configure_root() -> None:
    global _configured
    if _configured:
        return
    level = os.environ.get("VIETVOICE_LOG_LEVEL", "INFO").upper()
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT))
    root = logging.getLogger(ROOT)
    root.addHandler(handler)
    root.setLevel(getattr(logging, level, logging.INFO))
    root.propagate = False
    _configured = True


def get_logger(name: str = ROOT) -> logging.Logger:
    _configure_root()
    if not name.startswith(ROOT):
        name = f"{ROOT}.{name}"
    return logging.getLogger(name)


logger = get_logger()


class StageTimer:
    """Accumulates wall-clock per named pipeline stage."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> dict[str, float]:
        return dict(self.totals)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()
