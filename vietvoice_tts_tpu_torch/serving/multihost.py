"""Multi-rank lockstep serving loop.

Port of ``vietvoice_tts_tpu/serving/multihost.py``. On a mesh every rank
must enter the same collectives with the same shapes, so a per-rank server
would deadlock the mesh. The loop is the standard recipe:

- rank 0 (the coordinator) owns the request queue;
- each iteration it drains up to one device batch of chunk jobs and
  **broadcasts** it (or an empty heartbeat) to every rank over the default
  process group: first the shape, then the payload;
- every rank then calls ``EngineCore.synthesize_batch_async`` on the same
  batch, and the core's collectives (tensor, sequence or data parallelism)
  run in lockstep;
- rank 0 settles the waiting futures from the result.

Heartbeats (batches with no job, on the smallest bucket) keep every rank
stepping while traffic is idle; ``max_wait_ms`` bounds the latency they add.
The coordinator's ``stop()`` broadcasts a cluster-stop sentinel (a negative
bucket) so every loop exits at the same protocol step; a broadcast or
dispatch failure stops the loop of the rank that saw it (fail-stop), and a
job that can no longer run gets ``ServingLoopStopped``. A single process
degrades to a plain dispatch loop.

The broadcast runs over gloo: on the default group when that is gloo, else
on a gloo group of all ranks made when the loop is built (the payload is
host data; NCCL would need it on a card first).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import pad_batch_size
from ..parallel import comm
from ..runtime.engine_core import EngineCore
from ..utils.logging import get_logger
from .batcher import ChunkJob, _resolve

log = get_logger("multihost")


@dataclass
class _Batch:
    bucket: int
    wave: np.ndarray
    ref_len: np.ndarray
    total_len: np.ndarray
    text_ids: np.ndarray
    seeds: np.ndarray
    n_real: int  # rows that correspond to actual jobs (rest is padding)


# Broadcast by the coordinator's stop(): every rank's loop exits cleanly at
# the same protocol step (the only coordinated-shutdown channel a lockstep
# SPMD loop can have — any rank stopping on its own desyncs the mesh).
_STOP = object()


class ServingLoopStopped(RuntimeError):
    """Set on the futures of jobs still queued when the loop shuts down,
    and raised by ``submit()`` once a stop has been requested — a caller
    blocked on ``future.result()`` must never hang across shutdown."""


def _payload_layout(b: int, bucket: int, ref_cap: int, hop: int):
    """(name, dtype, shape) of each array of a broadcast batch, in order."""
    return (
        ("wave", np.float16, (b, ref_cap * hop)),
        ("ref_len", np.int32, (b,)),
        ("total_len", np.int32, (b,)),
        ("text_ids", np.int16, (b, bucket)),  # vocab ≤ 32k; −1 pad fits
        ("seeds", np.uint32, (b,)),
    )


def _torch_broadcast(group):
    """One-to-all broadcast of a numpy array from rank 0 over ``group``."""

    def fn(array: np.ndarray) -> np.ndarray:
        t = torch.from_numpy(np.ascontiguousarray(array))
        return comm.broadcast(t, 0, group).numpy()

    return fn


class MultiHostServingLoop:
    """Lockstep dispatcher: identical device programs on every rank."""

    def __init__(
        self,
        engine_core: EngineCore,
        max_batch: Optional[int] = None,
        max_wait_ms: float = 5.0,
        heartbeat_bucket: Optional[int] = None,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
        broadcast_fn=None,
    ):
        """``process_index`` / ``process_count`` / ``broadcast_fn`` default
        to the live ``torch.distributed`` default group (rank 0 of 1
        without one); tests inject fakes to drive the worker's branch
        without processes. ``broadcast_fn(array) -> array`` must have
        one-to-all semantics (rank 0's value wins everywhere). Every rank
        builds its loop at the same point: the gloo group, where one is
        needed, is made here by all of them."""
        live = dist.is_initialized()
        self.core = engine_core
        self.max_batch = max_batch or engine_core.config.max_batch_size
        self.max_wait_s = max_wait_ms / 1000.0
        if process_index is None:
            process_index = dist.get_rank() if live else 0
        if process_count is None:
            process_count = dist.get_world_size() if live else 1
        self.process_index = process_index
        self.n_hosts = process_count
        self.is_coordinator = self.process_index == 0
        if broadcast_fn is None and self.n_hosts > 1:
            group = None if dist.get_backend() == "gloo" else dist.new_group(backend="gloo")
            broadcast_fn = _torch_broadcast(group)
        self._broadcast_fn = broadcast_fn
        self.heartbeat_bucket = heartbeat_bucket or engine_core.config.frame_buckets[0]
        self._queue: "queue.Queue[ChunkJob]" = queue.Queue()
        self._running = False
        self._stop_requested = False
        self._thread: Optional[threading.Thread] = None

    # -- Client side (coordinator only) --------------------------------------

    def submit(self, job: ChunkJob) -> Future:
        if not self.is_coordinator:
            raise RuntimeError("submit() is only valid on rank 0")
        if not self._running or self._stop_requested:
            raise ServingLoopStopped("Serving loop is not running")
        self._queue.put(job)
        if not self._running:
            # Raced a concurrent stop() past the exit drain: the loop will
            # never pick this job up — fail it rather than leave the caller
            # hanging on future.result().
            self._fail_queued()
            raise ServingLoopStopped("Serving loop is not running")
        return job.future

    # -- Loop ----------------------------------------------------------------

    def start(self) -> None:
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True, name="vv-mh-loop")
        self._thread.start()

    def stop(self, timeout: float = 30.0) -> None:
        """Stop the loop; on a multi-rank coordinator, stop the CLUSTER.

        The coordinator broadcasts a stop sentinel on its next iteration so
        every worker's loop exits at the same protocol step — a coordinator
        that just stopped locally would leave workers blocked in a broadcast
        that only fails once the process dies. Workers' own ``stop()``
        remains local-only (their loop normally ends via the sentinel or
        fail-stop)."""
        if self.is_coordinator and self.n_hosts > 1 and self._running:
            self._stop_requested = True  # the loop broadcasts _STOP
            if self._thread:
                self._thread.join(timeout=timeout)
        self._running = False
        if self._thread:
            self._thread.join(timeout=timeout)
        # Jobs submitted but never drained by the loop (including any that
        # raced past the loop's own exit drain) must not hang their callers.
        self._fail_queued()

    def _fail_queued(self) -> None:
        """Resolve every still-queued job with ServingLoopStopped."""
        while True:
            try:
                job = self._queue.get_nowait()
            except queue.Empty:
                return
            _resolve(job.future, exc=ServingLoopStopped("Serving loop stopped before this job ran"))

    def _drain(self) -> tuple[list[ChunkJob], _Batch]:
        """Rank 0: gather up to max_batch same-bucket jobs (or heartbeat)."""
        jobs: list[ChunkJob] = []
        try:
            first = self._queue.get(timeout=self.max_wait_s)
            jobs.append(first)
            spill = []
            while len(jobs) < self.max_batch:
                try:
                    j = self._queue.get_nowait()
                except queue.Empty:
                    break
                (jobs if j.bucket == first.bucket else spill).append(j)
            for j in spill:
                self._queue.put(j)
        except queue.Empty:
            pass

        hop = self.core.config.hop_length
        bucket = jobs[0].bucket if jobs else self.heartbeat_bucket
        # Pad rows to the power-of-two batch grid (config.pad_batch_size),
        # exactly like the MicroBatcher: one queued job costs a 1-row (or
        # 2-row) batch, not a full max_batch one. Heartbeats ride the
        # smallest grid size.
        b = pad_batch_size(max(len(jobs), 1), self.max_batch)
        batch = _Batch(
            bucket=bucket,
            wave=np.zeros((b, bucket * hop), np.float32),
            ref_len=np.zeros((b,), np.int32),
            total_len=np.ones((b,), np.int32),
            text_ids=np.full((b, bucket), -1, np.int32),
            seeds=np.zeros((b,), np.uint32),
            n_real=len(jobs),
        )
        for row, j in enumerate(jobs):
            batch.wave[row] = j.wave
            batch.ref_len[row] = j.ref_len
            batch.total_len[row] = j.total_len
            batch.text_ids[row] = j.text_ids
            batch.seeds[row] = j.seed
        return jobs, batch

    def _broadcast(self, batch: Optional[_Batch], stop: bool = False) -> _Batch:
        """Ship rank 0's batch to every rank, compactly.

        The wave rows carry only the reference-audio prefix (everything past
        ``ref_len·hop`` is zero by construction, ``engine._chunk_row``), so
        the payload is the prefix in float16 plus int16 text ids — not the
        full float32 bucket wave. It goes in two broadcasts: the 4-int64
        shape (bucket, real rows, reference cap, batch rows; a negative
        bucket is the cluster-stop sentinel), then one byte buffer of fixed
        layout (``_payload_layout``). Every rank — coordinator included —
        rebuilds the batch from the broadcast result, so the SPMD inputs are
        bit-identical across ranks."""
        if self.n_hosts == 1:
            return _STOP if stop else batch
        bcast = self._broadcast_fn
        hop = self.core.config.hop_length
        if self.is_coordinator:
            if stop:
                meta = np.array([-1, 0, 0, 0], np.int64)
            else:
                ref_cap = int(batch.ref_len.max()) if batch.n_real else 1
                meta = np.array(
                    [batch.bucket, batch.n_real, ref_cap, batch.wave.shape[0]], np.int64
                )
        else:
            meta = np.zeros(4, np.int64)
        meta = bcast(meta)
        bucket, n_real, ref_cap, b = (int(x) for x in meta)
        if bucket < 0:
            return _STOP

        layout = _payload_layout(b, bucket, ref_cap, hop)
        if self.is_coordinator:
            arrays = {
                "wave": batch.wave[:, : ref_cap * hop],
                "ref_len": batch.ref_len,
                "total_len": batch.total_len,
                "text_ids": batch.text_ids,
                "seeds": batch.seeds,
            }
            payload = np.concatenate(
                [np.ascontiguousarray(arrays[name], dt).view(np.uint8).ravel()
                 for name, dt, _ in layout]
            )
        else:
            size = sum(int(np.prod(shape)) * np.dtype(dt).itemsize for _, dt, shape in layout)
            payload = np.zeros(size, np.uint8)
        payload = bcast(payload)
        out, pos = {}, 0
        for name, dt, shape in layout:
            n = int(np.prod(shape)) * np.dtype(dt).itemsize
            out[name] = payload[pos : pos + n].view(dt).reshape(shape)
            pos += n
        wave = np.zeros((b, bucket * hop), np.float32)
        wave[:, : ref_cap * hop] = out["wave"].astype(np.float32)
        return _Batch(
            bucket=bucket,
            wave=wave,
            ref_len=out["ref_len"].astype(np.int32),
            total_len=out["total_len"].astype(np.int32),
            text_ids=out["text_ids"].astype(np.int32),
            seeds=out["seeds"].astype(np.uint32),
            n_real=n_real,
        )

    def _resolve(self, pending) -> None:
        """Fetch a dispatched batch's result and settle its futures."""
        if pending is None:
            return
        fetch, jobs = pending
        try:
            out = fetch()
            for row, job in enumerate(jobs):
                # A concurrent stop() may have failed the job already.
                _resolve(job.future, out[row])
        except Exception as e:  # noqa: BLE001 — propagate per-job
            log.error("Serving loop batch failed: %s", e)
            for job in jobs:
                _resolve(job.future, exc=e)

    def _loop(self) -> None:
        # One batch stays in flight across iterations: dispatch batch k,
        # then resolve batch k−1, while all ranks still enter the same
        # batches in lockstep.
        pending = None
        while self._running:
            jobs: list[ChunkJob] = []
            batch: Optional[_Batch] = None
            # The stop decision is taken ONCE per iteration: a stop that
            # lands mid-drain still lets this iteration's drained jobs ship.
            stop_now = self._stop_requested
            if self.is_coordinator and not stop_now:
                jobs, batch = self._drain()
                if batch.n_real == 0 and self.n_hosts == 1:
                    self._resolve(pending)
                    pending = None
                    continue  # single rank: no heartbeat needed
            try:
                batch = self._broadcast(batch, stop=stop_now)
            except Exception as e:  # noqa: BLE001 — a lost rank wedges the mesh
                if self._running:
                    log.error("Serving loop broadcast failed, stopping: %s", e)
                self._running = False
                break
            if batch is _STOP:
                log.info(
                    "Cluster stop sentinel received on rank %d; stopping loop",
                    self.process_index,
                )
                self._running = False
                break
            if batch is None:
                self._resolve(pending)
                pending = None
                continue
            try:
                fetch = self.core.synthesize_batch_async(
                    batch.wave, batch.ref_len, batch.text_ids, batch.total_len,
                    seed=batch.seeds,
                )
            except Exception as e:  # noqa: BLE001 — propagate per-job
                log.error("Serving loop dispatch failed: %s", e)
                for job in jobs:
                    _resolve(job.future, exc=e)
                fetch = None
                if self.n_hosts > 1:
                    # Lockstep is broken: this rank skipped a batch the
                    # other ranks entered (or, on the coordinator, workers
                    # entered one it never dispatched results for). A
                    # silently-continuing loop would desync every later
                    # collective — stop loudly instead; supervision restarts
                    # the ranks (the failure contract is fail-stop).
                    log.error(
                        "Dispatch failure on rank %d of %d breaks SPMD "
                        "lockstep; stopping the serving loop.",
                        self.process_index,
                        self.n_hosts,
                    )
                    self._running = False
                    break
            self._resolve(pending)
            pending = (fetch, jobs) if fetch is not None else None
        self._resolve(pending)
        # Whatever is still queued when the loop exits (a stop taken before
        # the drain, or a fail-stop mid-stream) is never going to run.
        if self.is_coordinator:
            self._fail_queued()
