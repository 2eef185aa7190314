"""Structured logging for the framework.

A copy of ``vietvoice_tts_tpu/utils/logging.py`` under this package's logger
root: a thin layer over stdlib ``logging`` with the reference's ``loguru``
call surface (``logger.info/debug/warning/error``) plus per-stage timing
helpers used by the pipeline's observability hooks.

``StageTimer`` also keeps request-scoped spans while ``record_spans(True)``
is set (off by default): ``(name, start_ns, end_ns, request_id, batch_id)``
in a bounded deque, both ends on ``time.time_ns()``, the clock of
``torch.profiler``'s event timestamps, so that a span lines up with the
device trace of the same process. Spans end on the REST workers, the
batcher's dispatcher and its fetcher; each is one ``deque.append``, which
is atomic, so no lock is taken. With recording off a span boundary costs
one attribute test. The request id rides a ``ContextVar``, which
``anyio.to_thread`` carries into the worker thread; the batch id is set by
the batcher's dispatcher around the dispatch it stamps.
"""

from __future__ import annotations

import itertools
import logging
import os
import sys
import time
from collections import deque
from contextlib import contextmanager
from contextvars import ContextVar
from typing import NamedTuple, Optional

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


# The request a span belongs to, set only while spans are recorded: by the
# outermost entry (REST route, else TTSEngine.synthesize / _streaming).
REQUEST_ID: ContextVar[Optional[int]] = ContextVar("vietvoice_request_id", default=None)
# The micro-batcher's batch being dispatched, set on its dispatcher thread.
BATCH_ID: ContextVar[Optional[int]] = ContextVar("vietvoice_batch_id", default=None)
MAX_SPANS = 1_000_000


class Span(NamedTuple):
    name: str
    start_ns: int  # time.time_ns()
    end_ns: int
    request_id: Optional[int]
    batch_id: Optional[int]


class StageTimer:
    """Accumulates wall-clock per named pipeline stage, and keeps spans
    while ``record_spans(True)`` is set (see the module docstring)."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.recording = False
        self.spans: deque[Span] = deque(maxlen=MAX_SPANS)
        self._request_ids = itertools.count(1)

    def new_request_id(self) -> int:
        return next(self._request_ids)

    def record_spans(self, on: bool) -> None:
        self.recording = bool(on)

    def span(self, name: str, start_ns: int, end_ns: int,
             request_id: Optional[int] = None, batch_id: Optional[int] = None) -> None:
        self.spans.append(Span(name, start_ns, end_ns, request_id, batch_id))

    @contextmanager
    def stage(self, name: str, span: Optional[str] = None):
        """Time the body into ``name``'s sum; while spans are recorded, also
        keep it as the span ``span`` with the request and batch in scope."""
        t0 = time.perf_counter()
        s0 = time.time_ns() if span and self.recording else 0
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            if s0:
                self.span(span, s0, time.time_ns(), REQUEST_ID.get(), BATCH_ID.get())

    def open_request(self) -> Optional[tuple]:
        """Start a ``request`` span with a new id in scope, unless a request
        is in scope already (an outer entry owns it) → the handle for
        ``close_request``, or None. Call it only while recording."""
        if REQUEST_ID.get() is not None:
            return None
        rid = self.new_request_id()
        return rid, time.time_ns(), REQUEST_ID.set(rid)

    def close_request(self, handle: tuple) -> None:
        rid, start_ns, token = handle
        REQUEST_ID.reset(token)
        self.span("request", start_ns, time.time_ns(), rid)

    def report(self) -> dict[str, float]:
        return dict(self.totals)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()
        self.spans.clear()
