"""Continuous micro-batching for concurrent synthesis requests (port of
``vietvoice_tts_tpu/serving/batcher.py``).

Concurrent requests share the card: chunk jobs from any number of client
threads land in a queue; a dispatcher thread groups jobs with the same frame
bucket into one padded device batch (up to ``max_batch``, waiting at most
``max_wait_ms`` for co-riders) and queues it through
``EngineCore.synthesize_batch_async``; a fetcher thread waits for each
batch's event and resolves the jobs' futures. Per-row seeds keep each
request's noise independent of its batchmates (``models/sampler.py``), so a
row's audio depends on the batch only as far as the matmul library sums in
another order at another batch size.

The scheduling is the JAX batcher's. What differs on a CUDA card:

- A dispatch is not one asynchronous call but the host queueing every kernel
  of a 31-step solve, which takes the dispatcher thread as long as the device
  needs for most of them (CUDA's launch queue is bounded). The fetcher waits
  on a CUDA event, which releases the GIL, so a finished batch reaches its
  callers while the dispatcher is already queueing the next one.
- Both threads leave the current stream alone: all work goes to the default
  stream, in dispatch order, and the kernel wrappers follow it.
- There is no trimmed fetch: a row's PCM is at most 1 MB, tens of
  microseconds over PCIe, so every future resolves to the full device row.
- ``_pending`` is guarded by a lock and futures are resolved only while not
  done: a client thread that loses the race with ``shutdown`` fails the
  queued jobs itself (``submit``), concurrently with the dispatcher.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..config import pad_batch_size
from ..runtime.engine_core import EngineCore
from ..utils.logging import get_logger

log = get_logger("batcher")


@dataclass
class ChunkJob:
    """One frame-bucket-padded chunk ready for the device."""

    bucket: int
    wave: np.ndarray  # [bucket * hop] f32
    ref_len: int
    total_len: int
    text_ids: np.ndarray  # [bucket] int32, -1 padded
    seed: int
    future: Future = field(default_factory=Future)
    attempts: int = 0  # failed dispatch/fetch attempts so far
    ts: float = field(default_factory=time.monotonic)  # arrival (aging guard)


# Retry backoff: attempt k waits RETRY_BASE_S * 2**(k-1), capped. Keeps a
# persistently failing dispatch from hot-looping against a sick device while
# still recovering quickly from a one-off error.
RETRY_BASE_S = 0.05
RETRY_MAX_S = 1.0


@dataclass
class BatcherStats:
    batches: int = 0
    jobs: int = 0
    padded_rows: int = 0
    retries: int = 0  # jobs re-queued after a transient batch failure
    failures: int = 0  # jobs that exhausted retries

    @property
    def mean_batch_size(self) -> float:
        return self.jobs / self.batches if self.batches else 0.0


def _resolve(future: Future, result=None, exc: Optional[BaseException] = None) -> bool:
    """Set a future's outcome unless it already has one (a client thread's
    ``_fail_queued`` may have failed a job that a batch in flight still
    carries). Returns whether this call set it."""
    try:
        if exc is not None:
            future.set_exception(exc)
        else:
            future.set_result(result)
        return True
    except InvalidStateError:
        return False


class MicroBatcher:
    """Queue → bucket-grouped padded batches → ``EngineCore``.

    Futures resolve to full device rows, [bucket · hop] int16; callers cut
    the reference prefix and the padding off (``TTSEngine._slice_output``)."""

    def __init__(
        self,
        engine_core: EngineCore,
        max_batch: Optional[int] = None,
        max_wait_ms: float = 5.0,
        retries: int = 1,
        max_starve_ms: float = 500.0,
        pipeline_depth: int = 1,
    ):
        self.core = engine_core
        self.max_batch = max_batch or engine_core.config.max_batch_size
        self.pipeline_depth = pipeline_depth
        self.max_wait_s = max_wait_ms / 1000.0
        self.max_starve_s = max_starve_ms / 1000.0
        self.retries = retries
        self._queue: "queue.Queue[Optional[ChunkJob]]" = queue.Queue()
        # Jobs pulled off the queue but not yet dispatched (bucket-aware
        # grouping keeps minority buckets here instead of re-queueing them
        # at the tail — see _collect). Read and changed under _pending_lock
        # only, and never rebound: the dispatcher and a client thread in
        # _fail_queued may both be at it.
        self._pending: deque[ChunkJob] = deque()
        self._pending_lock = threading.Lock()
        self._stats = BatcherStats()
        self._running = True
        # Serializes ensure_running/shutdown so two concurrent repair calls
        # never start duplicate thread pairs racing one queue. submit() stays
        # lock-free: _running only ever flips False at shutdown, never during
        # repair, so clients keep enqueueing through a repair window.
        self._lifecycle_lock = threading.Lock()
        # Thread generation. Worker loops capture the generation they were
        # started with and exit as soon as it moves on; a wake-up sentinel
        # (None) read by a CURRENT-generation worker is stale by definition
        # (it was posted to retire a previous generation) and is discarded,
        # so repair never needs to drain queues or guess which consumer died.
        self._gen = 0
        # Failure bookkeeping (surfaced at /api/v1/health): last batch error
        # and its wall-clock time. A failed batch does NOT fail its jobs
        # outright — each rides a fresh dispatch up to ``retries`` times.
        self.last_error: Optional[str] = None
        self.last_error_ts: Optional[float] = None
        # Two-stage pipeline: the dispatcher thread queues device work; the
        # fetcher thread waits for each batch's event. maxsize bounds the
        # batches dispatched BEYOND the one being fetched — dispatch of batch
        # k+1+depth waits until batch k's result has been fetched
        # (backpressure). Depth 1 queues the least work ahead of a newly
        # arriving request and is the default; PERF.md holds the card's
        # submit-to-first-future times at depth 1 and 2.
        self._inflight: "queue.Queue[Optional[tuple]]" = queue.Queue(
            maxsize=max(1, pipeline_depth)
        )
        self._start_threads()

    def _start_threads(self) -> None:
        self._gen += 1
        gen = self._gen
        self._thread = threading.Thread(
            target=self._loop, args=(gen,), daemon=True, name="vv-batcher"
        )
        self._fetcher = threading.Thread(
            target=self._fetch_loop, args=(gen,), daemon=True, name="vv-batcher-fetch"
        )
        self._thread.start()
        self._fetcher.start()

    # -- Client side ---------------------------------------------------------

    def submit(self, job: ChunkJob) -> Future:
        if not self._running:
            raise RuntimeError("MicroBatcher is shut down")
        self._queue.put(job)
        if not self._running:
            # Raced a concurrent shutdown past its queue drain: the job just
            # landed in a queue nobody will ever read — fail it (and any
            # co-stragglers) rather than hang the caller on future.result().
            self._fail_queued()
            raise RuntimeError("MicroBatcher is shut down")
        return job.future

    def _fail_queued(self) -> None:
        """Fail every job still in the queue or pending deque (shutdown)."""
        with self._pending_lock:
            leftovers: list[Optional[ChunkJob]] = list(self._pending)
            self._pending.clear()
        while True:
            try:
                leftovers.append(self._queue.get_nowait())
            except queue.Empty:
                break
        for job in leftovers:
            if job is not None:
                _resolve(job.future, exc=RuntimeError("MicroBatcher is shut down"))

    @property
    def stats(self) -> BatcherStats:
        return self._stats

    @property
    def healthy(self) -> bool:
        """True when both worker threads are alive (and not shut down).

        The loops catch ``Exception``; a thread can still die on a
        non-Exception ``BaseException`` (interpreter teardown, injected
        interrupts). Liveness is therefore observable — load balancers read
        it through ``GET /api/v1/health`` — and repairable via
        ``ensure_running``."""
        return self._running and self._thread.is_alive() and self._fetcher.is_alive()

    def ensure_running(self) -> bool:
        """Restart any dead worker thread; returns post-repair health.

        Queued and in-flight work survives the restart: jobs live in
        ``_queue``/``_pending``/``_inflight``, not in thread state.
        ``_running`` is never flipped during repair, so concurrent ``submit``
        calls keep being accepted. Serialized with ``shutdown`` via the
        lifecycle lock. No-op after ``shutdown`` (returns False)."""
        with self._lifecycle_lock:
            if not self._running:
                return False
            if self._thread.is_alive() and self._fetcher.is_alive():
                return True
            log.warning(
                "Batcher thread death detected (dispatcher=%s fetcher=%s); restarting",
                self._thread.is_alive(),
                self._fetcher.is_alive(),
            )
            # Retire any survivor cleanly before restarting the pair, so two
            # dispatchers never race one queue. Bumping the generation makes
            # the survivor's loop exit at its next wake-up; the sentinel only
            # goes into a queue whose consumer is actually alive (a sentinel
            # for a dead consumer would sit in the queue and kill its
            # freshly-started replacement).
            self._gen += 1
            if self._thread.is_alive():
                self._queue.put(None)
                self._thread.join(timeout=5.0)
            if self._fetcher.is_alive():
                try:
                    # put can block when _inflight is full; the live fetcher
                    # drains it within one fetch, but bound the wait anyway.
                    self._inflight.put(None, timeout=5.0)
                except queue.Full:  # pragma: no cover — fetch wedged
                    pass
                self._fetcher.join(timeout=5.0)
            self._start_threads()
            return self.healthy

    def shutdown(self, timeout: float = 10.0) -> None:
        with self._lifecycle_lock:
            self._running = False
        self._queue.put(None)
        self._thread.join(timeout=timeout)
        try:
            self._inflight.put(None, timeout=timeout)
        except queue.Full:  # pragma: no cover — fetch wedged at shutdown
            pass
        self._fetcher.join(timeout=timeout)
        # Fail (don't hang) futures still queued OR pending at shutdown.
        self._fail_queued()

    # -- Dispatcher ----------------------------------------------------------

    def _largest_group(self) -> int:
        counts: dict[int, int] = {}
        with self._pending_lock:
            for j in self._pending:
                counts[j.bucket] = counts.get(j.bucket, 0) + 1
        return max(counts.values(), default=0)

    def _hold(self, job: ChunkJob) -> None:
        with self._pending_lock:
            self._pending.append(job)

    def _collect(self) -> list[ChunkJob]:
        """Gather one device batch, bucket-aware across the whole queue head.

        1. **The collection window spans device-busy time.** While the
           in-flight pipeline is full the collector keeps draining the queue
           (the dispatch could not proceed anyway), so the batch that goes
           out when a slot frees carries everyone who queued during the
           wait, instead of each late arrival seeding a small straggler
           batch. ``max_wait_ms`` bounds the ADDED latency when the device
           is idle.

        2. **Minority buckets wait here, not at the queue tail.** All drained
           jobs stay in ``_pending``; the dispatched group is the largest
           bucket cohort, unless the oldest waiting job has aged past
           ``max_starve_ms`` — then its bucket goes first (bounded
           worst-case wait for odd buckets under a steady majority
           stream)."""
        with self._pending_lock:
            empty = not self._pending
        if empty:
            first = self._queue.get()
            if first is None:
                return []
            self._hold(first)
        deadline = time.monotonic() + self.max_wait_s
        while True:
            now = time.monotonic()
            blocked = self._inflight.full()
            full = self._largest_group() >= self.max_batch
            if not blocked and (now >= deadline or full):
                break
            # While the pipeline is blocked, poll in short slices so the
            # moment a slot frees we dispatch with everything gathered.
            timeout = 0.005 if blocked else (deadline - now)
            try:
                job = self._queue.get(timeout=timeout)
            except queue.Empty:
                if blocked:
                    continue
                break
            if job is None:
                self._queue.put(None)  # re-post sentinel for shutdown
                break
            self._hold(job)

        # Pick the dispatch group: oldest job's bucket if it is starving,
        # else the largest cohort (ties go to the cohort of the oldest
        # member, preserving arrival order).
        with self._pending_lock:
            if not self._pending:
                return []  # a client thread failed them all meanwhile
            oldest = self._pending[0]
            groups: dict[int, list[ChunkJob]] = {}
            for j in self._pending:
                groups.setdefault(j.bucket, []).append(j)
            if time.monotonic() - oldest.ts > self.max_starve_s:
                bucket = oldest.bucket
            else:
                best = max(len(g) for g in groups.values())
                bucket = next(
                    j.bucket for j in self._pending if len(groups[j.bucket]) == best
                )
            batch = groups[bucket][: self.max_batch]
            taken = set(map(id, batch))
            rest = [j for j in self._pending if id(j) not in taken]
            self._pending.clear()
            self._pending.extend(rest)
        return batch

    def _run_batch(self, jobs: list[ChunkJob]) -> None:
        bucket = jobs[0].bucket
        # Pad the row count up to the batch grid (config.batch_grid) so the
        # device sees a few repeating shapes per bucket: the pinned buffers
        # and library workspaces that warmup took are reused, and the
        # dispatched shape never exceeds the configured cap.
        b = len(jobs)
        padded = pad_batch_size(b, self.max_batch)
        # Padding rows (zero waves, output discarded) take the real rows'
        # smallest ref_len, so they never decide whether the batch can use
        # the voice-conditioning cache.
        fill_ref = min(j.ref_len for j in jobs)
        wave = np.zeros((padded, jobs[0].wave.shape[0]), np.float32)
        ref_len = np.full((padded,), fill_ref, np.int32)
        total_len = np.full((padded,), max(1, min(fill_ref, bucket)), np.int32)
        text_ids = np.full((padded, bucket), -1, np.int32)
        seeds = np.zeros((padded,), np.uint32)
        for row, j in enumerate(jobs):
            wave[row] = j.wave
            ref_len[row] = j.ref_len
            total_len[row] = j.total_len
            text_ids[row] = j.text_ids
            seeds[row] = j.seed
        fetch = self.core.synthesize_batch_async(
            wave, ref_len, text_ids, total_len, seed=seeds
        )
        self._inflight.put((fetch, jobs))
        log.debug("dispatched batch: bucket=%d size=%d padded=%d", bucket, b, padded)

    def _requeue_later(self, job: ChunkJob, delay: float) -> None:
        """Re-queue a failed job after a backoff delay (daemon timer thread).

        If the batcher shut down while the timer was pending, fail the future
        instead of parking the job in a queue nobody will drain."""

        def fire() -> None:
            if self._running:
                self._queue.put(job)
            else:
                _resolve(job.future, exc=RuntimeError("MicroBatcher is shut down"))

        t = threading.Timer(delay, fire)
        t.daemon = True
        t.start()

    def _fail_or_retry(self, jobs: list[ChunkJob], exc: Exception) -> None:
        """Batch failed: re-queue each job for a fresh dispatch while it has
        attempts left (with exponential backoff so a sick device isn't
        hot-looped); fail its future once retries are exhausted. A batch
        failure is recorded either way (health observability)."""
        self.last_error = f"{type(exc).__name__}: {exc}"
        self.last_error_ts = time.time()
        for job in jobs:
            if job.future.done():
                continue
            if self._running and job.attempts < self.retries:
                job.attempts += 1
                self._stats.retries += 1
                delay = min(RETRY_BASE_S * (2 ** (job.attempts - 1)), RETRY_MAX_S)
                log.warning(
                    "Retrying job (attempt %d/%d, backoff %.0f ms) after batch error: %s",
                    job.attempts,
                    self.retries,
                    delay * 1000,
                    exc,
                )
                self._requeue_later(job, delay)
            elif _resolve(job.future, exc=exc):
                self._stats.failures += 1

    def _fetch_loop(self, gen: int) -> None:
        while True:
            item = self._inflight.get()
            if item is None:
                if not self._running or gen != self._gen:
                    return
                continue  # stale sentinel from a previous generation's repair
            fetch, jobs = item
            try:
                out = fetch()
            except Exception as e:  # noqa: BLE001 — retry, then propagate
                self._fail_or_retry(jobs, e)
                continue
            self._stats.batches += 1
            self._stats.jobs += len(jobs)
            self._stats.padded_rows += out.shape[0] - len(jobs)
            # Recovery observability: a successful batch clears the sticky
            # error so /health stops reporting a stale incident.
            self.last_error = None
            self.last_error_ts = None
            for row, job in enumerate(jobs):
                _resolve(job.future, out[row])

    def _loop(self, gen: int) -> None:
        while self._running and gen == self._gen:
            try:
                jobs = self._collect()
                if not jobs:
                    continue  # woken by a sentinel; loop condition re-checked
                try:
                    self._run_batch(jobs)
                except Exception as e:  # noqa: BLE001 — retry, then propagate
                    self._fail_or_retry(jobs, e)
            except Exception as e:  # pragma: no cover — keep dispatcher alive
                log.error("Batcher loop error: %s", e)
