"""The micro-batcher of the PyTorch port (``serving/batcher.py``) and the
engine's batcher branch, on the CPU at ``tiny_config`` sizes in float32.

Carried over from ``tests/test_serving.py`` (single job, co-riders, batched
against solo, mixed buckets, the absolute collection deadline, batch-grid
padding, retry and exhaustion, thread death and repair, shutdown, majority
bucket and starvation), without the trimmed fetch, which the port does not
have. Two races of the JAX batcher are not copied and have a test each. Held
against the JAX package: one scripted sequence of jobs through both
packages' ``MicroBatcher`` over a recording fake core gives the same
dispatches, and ``TTSEngine`` with a batcher attached submits the same jobs.

Tolerance of batched against solo: per-row noise makes a row's inputs the
same in any batch, but the CPU's float32 GEMM sums in another order at
another row count, so the same request through a shared batch and alone
agrees within ``BATCH_TOLERANCE`` = 2 of 32767 per sample (measured: 1, on
some 40 of 32768 samples, with the shipped pack and with opened AdaLN gates),
and is array-equal where both runs dispatch the same row count. What the card
gives in bfloat16 is bounded by ``chip_smoke.py:STREAM_TOLERANCE``.

Every wait has a timeout of its own, so a hung batcher fails one test.
"""

import dataclasses
import threading
import time
from collections import deque

import numpy as np
import pytest
import torch

from test_torch_slice import _open_gates, port_config

import vietvoice_tts_tpu_torch as vt
from vietvoice_tts_tpu.serving import batcher as jbatcher
from vietvoice_tts_tpu_torch.config import batch_grid
from vietvoice_tts_tpu_torch.ops.kernels import build
from vietvoice_tts_tpu_torch.runtime import engine_core as tcore_mod
from vietvoice_tts_tpu_torch.runtime.engine_core import EngineCore
from vietvoice_tts_tpu_torch.serving import batcher as tbatcher
from vietvoice_tts_tpu_torch.serving.batcher import RETRY_BASE_S, ChunkJob, MicroBatcher

WAIT = 60  # seconds: the longest any single wait below may take
BATCH_TOLERANCE = 2  # int16 steps between one row in batches of different sizes


def _assert_close(a, b):
    assert a.shape == b.shape
    assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= BATCH_TOLERANCE


@pytest.fixture(scope="module")
def engine(tiny_pack_dir):
    eng = vt.TTSEngine(port_config(model_cache_dir=tiny_pack_dir))
    yield eng
    eng.cleanup()


@pytest.fixture(scope="module")
def core(engine):
    return engine.engine_core


def _make_job(core, bucket, seed=0, text_val=5, cls=ChunkJob):
    hop = core.config.hop_length
    rng = np.random.default_rng(seed)
    wave = rng.uniform(-0.3, 0.3, bucket * hop).astype(np.float32)
    ids = np.full((bucket,), -1, np.int32)
    ids[:32] = text_val
    return cls(bucket=bucket, wave=wave, ref_len=16, total_len=bucket - 16,
               text_ids=ids, seed=seed)


def _wait_for(cond, timeout=10.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if cond():
            return True
        time.sleep(0.005)
    return False


# -- Through the real core ---------------------------------------------------------


class TestMicroBatcher:
    def test_single_job(self, core):
        b = MicroBatcher(core, max_batch=4, max_wait_ms=5)
        try:
            out = b.submit(_make_job(core, 128)).result(timeout=WAIT)
            assert out.shape == (128 * core.config.hop_length,) and out.dtype == np.int16
            assert not hasattr(_make_job(core, 128), "trimmed")  # full rows only
        finally:
            b.shutdown()

    def test_concurrent_jobs_batch_together(self, core):
        b = MicroBatcher(core, max_batch=4, max_wait_ms=50)
        try:
            futures = [b.submit(_make_job(core, 128, seed=i)) for i in range(4)]
            outs = [f.result(timeout=WAIT) for f in futures]
            assert all(o.shape == (128 * core.config.hop_length,) for o in outs)
            assert b.stats.jobs == 4
            assert b.stats.batches <= 3  # a 50 ms window: some shared a dispatch
            assert b.stats.mean_batch_size > 1
        finally:
            b.shutdown()

    @pytest.mark.parametrize("gates", ["shipped", "opened"])
    def test_batched_equals_solo(self, engine, gates):
        """A request's audio does not depend on its batchmates, beyond the
        GEMM's summation order (BATCH_TOLERANCE, see the module docstring)."""
        core = engine.engine_core
        if gates == "opened":
            mgr = engine.model_session_manager
            core = EngineCore(engine.config, _open_gates(mgr.params), mgr.vocab_size)
        solo = MicroBatcher(core, max_batch=1, max_wait_ms=1)
        try:
            ref = solo.submit(_make_job(core, 128, seed=7)).result(timeout=WAIT)
        finally:
            solo.shutdown()
        shared = MicroBatcher(core, max_batch=4, max_wait_ms=200)
        try:
            futures = [shared.submit(_make_job(core, 128, seed=s)) for s in (7, 1, 2)]
            outs = [f.result(timeout=WAIT) for f in futures]
            assert shared.stats.batches == 1 and shared.stats.padded_rows == 0
        finally:
            shared.shutdown()
        assert np.any(ref)
        _assert_close(ref, outs[0])
        assert np.abs(outs[0].astype(np.int32) - outs[1]).max() > 100  # another row

    def test_mixed_buckets_grouped_separately(self, core):
        b = MicroBatcher(core, max_batch=4, max_wait_ms=30)
        try:
            futures = [b.submit(_make_job(core, bucket, seed=i))
                       for i, bucket in enumerate([128, 256, 128, 256])]
            outs = [f.result(timeout=WAIT) for f in futures]
            hop = core.config.hop_length
            assert [o.shape for o in outs] == [(128 * hop,), (256 * hop,)] * 2
        finally:
            b.shutdown()

    def test_submit_after_shutdown_raises(self, core):
        b = MicroBatcher(core, max_batch=2, max_wait_ms=1)
        assert b.healthy
        b.shutdown()
        assert not b.healthy
        with pytest.raises(RuntimeError, match="shut down"):
            b.submit(_make_job(core, 128))

    def test_engine_integration(self, engine):
        """enable_micro_batching routes synthesize through the batcher and
        gives the audio of direct mode."""
        text = "Một câu để so sánh."
        direct, _ = engine.synthesize(text)
        batcher = engine.enable_micro_batching(max_wait_ms=5)
        try:
            assert engine.enable_micro_batching() is batcher  # attached once
            routed, _ = engine.synthesize(text)
            assert batcher.stats.jobs >= 1
            np.testing.assert_array_equal(direct, routed)
            stream = np.concatenate(list(engine.synthesize_streaming(text)))
            np.testing.assert_array_equal(direct, stream)
        finally:
            engine.batcher.shutdown()
            engine.batcher = None

    def test_long_text_streams_through_the_batcher(self, engine):
        long_text = " ".join(f"Câu số {i} trong đoạn văn dài." for i in range(60))
        direct, _ = engine.synthesize(long_text)
        batcher = engine.enable_micro_batching(max_wait_ms=5)
        try:
            pieces = list(engine.synthesize_streaming(long_text))
            assert len(pieces) >= 2 and batcher.stats.jobs >= 2
            assert batcher.stats.batches < batcher.stats.jobs  # chunks shared batches
            _assert_close(np.concatenate(pieces), direct)
        finally:
            engine.batcher.shutdown()
            engine.batcher = None

    def test_concurrent_engine_requests(self, engine):
        """Concurrent client threads all get the audio they get alone."""
        texts = [f"Câu số {i} trong bài." for i in range(4)]
        alone = [engine.synthesize(t)[0] for t in texts]
        engine.enable_micro_batching(max_wait_ms=20)
        results, errors = {}, []
        start = threading.Barrier(len(texts))

        def worker(i):
            try:
                start.wait(timeout=WAIT)
                results[i] = engine.synthesize(texts[i])[0]
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(texts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
        try:
            assert not errors and len(results) == len(texts)
            for i, ref in enumerate(alone):
                _assert_close(results[i], ref)
            assert engine.batcher.stats.failures == 0
        finally:
            engine.batcher.shutdown()
            engine.batcher = None

    def test_cleanup_shuts_the_batcher_down(self, tiny_pack_dir):
        eng = vt.TTSEngine(port_config(model_cache_dir=tiny_pack_dir))
        batcher = eng.enable_micro_batching()
        assert batcher.healthy
        eng.cleanup()
        assert eng.batcher is None and not batcher.healthy
        with pytest.raises(RuntimeError, match="shut down"):
            batcher.submit(_make_job(eng.engine_core, 128))

    def test_engine_warmup_runs_the_batch_grid(self, engine, monkeypatch):
        shapes = []
        dispatch = engine.engine_core.synthesize_batch_async

        def spy(wave, ref_len, *rest, **kw):
            shapes.append((wave.shape[0], wave.shape[1] // engine.config.hop_length,
                           int(ref_len[0])))
            return dispatch(wave, ref_len, *rest, **kw)

        monkeypatch.setattr(engine.engine_core, "synthesize_batch_async", spy)
        engine.warmup(buckets=(128,))
        grid = engine.config.batch_grid()
        assert grid == batch_grid(engine.config.max_batch_size) == (1, 2, 3, 4)
        # The cached route per shape; at batch 1 also a reference too long for
        # the cache window, which takes the waveform route.
        assert shapes == [(1, 128, 8), (1, 128, 126)] + [(b, 128, 8) for b in grid[1:]]


# -- Over stub cores: queueing, padding, failure ------------------------------


class _StubCore:
    """Instant fake EngineCore that records dispatched row counts."""

    def __init__(self, config):
        self.config = config
        self.dispatched_rows: list[int] = []

    def synthesize_batch_async(self, wave, ref_len, text_ids, total_len, seed):
        self.dispatched_rows.append(wave.shape[0])
        out = np.zeros((wave.shape[0], wave.shape[1]), np.int16)
        return lambda: out


class TestBatcherLatencyAndPadding:
    def test_collect_wait_is_absolute_deadline(self, core):
        """Co-riders arriving inside the window do not extend it: the added
        latency is bounded by max_wait_ms, not max_batch × max_wait_ms."""
        stub = _StubCore(core.config)
        b = MicroBatcher(stub, max_batch=8, max_wait_ms=250)
        try:
            jobs = [_make_job(core, 128, seed=i) for i in range(4)]
            t0 = time.monotonic()
            futures = [b.submit(jobs[0])]

            def trickle():
                for j in jobs[1:]:
                    time.sleep(0.08)
                    futures.append(b.submit(j))

            t = threading.Thread(target=trickle)
            t.start()
            futures[0].result(timeout=10)
            elapsed = time.monotonic() - t0
            t.join(timeout=10)
            for f in futures:
                f.result(timeout=10)
            # Cumulative waiting would take ≥ 3 × 80 ms + 250 ms ≈ 0.49 s.
            assert elapsed < 0.45, f"collect wait not bounded: {elapsed:.3f}s"
        finally:
            b.shutdown()

    @pytest.mark.parametrize("n_jobs, max_batch, want_rows", [
        (5, 6, 6),  # never past max_batch (a power-of-two ladder would give 8)
        (3, 8, 3),  # the 3·2^k midpoints are on the grid
        (5, 8, 6),
        (7, 8, 8),
        (1, 8, 1),
    ])
    def test_padding_follows_batch_grid(self, core, n_jobs, max_batch, want_rows):
        stub = _StubCore(core.config)
        b = MicroBatcher(stub, max_batch=max_batch, max_wait_ms=150)
        try:
            futures = [b.submit(_make_job(core, 128, seed=i)) for i in range(n_jobs)]
            for f in futures:
                f.result(timeout=10)
            assert stub.dispatched_rows == [want_rows]
            assert want_rows in batch_grid(max_batch)
            assert b.stats.padded_rows == want_rows - n_jobs
        finally:
            b.shutdown()


class _FlakyCore(_StubCore):
    """Fails the first ``fail_first`` fetches, then succeeds."""

    def __init__(self, config, fail_first=1):
        super().__init__(config)
        self.fail_first = fail_first
        self.calls = 0

    def synthesize_batch_async(self, wave, ref_len, text_ids, total_len, seed):
        self.calls += 1
        if self.calls <= self.fail_first:
            self.dispatched_rows.append(wave.shape[0])

            def bad_fetch():
                raise RuntimeError("transient transfer error")

            return bad_fetch
        return super().synthesize_batch_async(wave, ref_len, text_ids, total_len, seed)


class _DispatchFailCore(_StubCore):
    """Always fails at dispatch time (before any fetch exists)."""

    def synthesize_batch_async(self, *a, **k):
        raise ValueError("bad batch shape")


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
class TestFailureRecovery:
    """Transient batch errors retry on a fresh dispatch; persistent errors
    fail the future after ``retries``; dead worker threads show in
    ``healthy`` and ``ensure_running`` repairs them."""

    def test_transient_fetch_failure_retries_and_succeeds(self, core):
        flaky = _FlakyCore(core.config, fail_first=1)
        b = MicroBatcher(flaky, max_batch=2, max_wait_ms=5, retries=1)
        try:
            out = b.submit(_make_job(core, 128)).result(timeout=10)
            assert out.shape == (128 * core.config.hop_length,)
            assert b.stats.retries == 1 and b.stats.failures == 0
            assert b.last_error is None  # cleared by the eventual success
        finally:
            b.shutdown()

    def test_persistent_dispatch_failure_exhausts_retries(self, core):
        b = MicroBatcher(_DispatchFailCore(core.config), max_batch=2, max_wait_ms=5, retries=2)
        try:
            fut = b.submit(_make_job(core, 128))
            with pytest.raises(ValueError, match="bad batch shape"):
                fut.result(timeout=10)
            assert b.stats.retries == 2 and b.stats.failures == 1
            assert "bad batch shape" in b.last_error and b.last_error_ts is not None
        finally:
            b.shutdown()

    def test_zero_retries_fails_immediately(self, core):
        b = MicroBatcher(_FlakyCore(core.config, fail_first=1), max_batch=2,
                         max_wait_ms=5, retries=0)
        try:
            fut = b.submit(_make_job(core, 128))
            with pytest.raises(RuntimeError, match="transient"):
                fut.result(timeout=10)
            assert b.stats.failures == 1
        finally:
            b.shutdown()

    def test_retry_backoff_and_error_clearing(self, core):
        flaky = _FlakyCore(core.config, fail_first=2)
        b = MicroBatcher(flaky, max_batch=2, max_wait_ms=5, retries=2)
        try:
            t0 = time.monotonic()
            out = b.submit(_make_job(core, 128)).result(timeout=20)
            elapsed = time.monotonic() - t0
            assert out.shape == (128 * core.config.hop_length,)
            assert b.stats.retries == 2
            # attempt 1 waits RETRY_BASE_S, attempt 2 waits 2·RETRY_BASE_S.
            assert elapsed >= 3 * RETRY_BASE_S * 0.8, elapsed
            assert b.last_error is None and b.last_error_ts is None
        finally:
            b.shutdown()

    def _kill_dispatcher(self, b):
        """A non-Exception thread death (the loops only catch Exception):
        swap in a _collect that raises SystemExit."""
        orig = b._collect

        def boom():
            raise SystemExit("injected thread death")

        b._collect = boom
        b._queue.put(_make_job(b.core, 128))  # wake the dispatcher
        assert _wait_for(lambda: not b._thread.is_alive(), 5), "dispatcher should have died"
        b._collect = orig

    def _kill_fetcher(self, b):
        def lethal_fetch():
            raise SystemExit("injected fetcher death")

        b._inflight.put((lethal_fetch, []))
        assert _wait_for(lambda: not b._fetcher.is_alive(), 5), "fetcher should have died"

    def test_thread_death_detected_and_restarted(self, core):
        b = MicroBatcher(_StubCore(core.config), max_batch=2, max_wait_ms=5)
        try:
            assert b.healthy
            self._kill_dispatcher(b)
            assert not b.healthy
            assert b.ensure_running() and b.healthy
            out = b.submit(_make_job(core, 128)).result(timeout=10)
            assert out.shape == (128 * core.config.hop_length,)
        finally:
            b.shutdown()

    def test_ensure_running_noop_when_healthy_or_shutdown(self, core):
        b = MicroBatcher(_StubCore(core.config), max_batch=2, max_wait_ms=5)
        t0, f0 = b._thread, b._fetcher
        assert b.ensure_running()
        assert (b._thread, b._fetcher) == (t0, f0)  # no gratuitous restart
        b.shutdown()
        assert not b.ensure_running() and not b.healthy

    def test_shutdown_fails_pending_futures(self, core):
        b = MicroBatcher(_StubCore(core.config), max_batch=2, max_wait_ms=5)
        self._kill_dispatcher(b)
        fut = b.submit(_make_job(core, 128))  # queued, never dispatched
        b.shutdown()
        with pytest.raises(RuntimeError, match="shut down"):
            fut.result(timeout=5)

    def test_fetcher_death_detected_and_restarted(self, core):
        """Repair retires the live dispatcher without wedging on _inflight
        and leaves no sentinel that would end the replacement fetcher."""
        b = MicroBatcher(_StubCore(core.config), max_batch=2, max_wait_ms=5)
        try:
            self._kill_fetcher(b)
            assert not b.healthy and b._thread.is_alive()
            assert b.ensure_running() and b.healthy
            out = b.submit(_make_job(core, 128)).result(timeout=10)
            assert out.shape == (128 * core.config.hop_length,) and b.healthy
        finally:
            b.shutdown()

    def test_submit_accepted_while_degraded_and_served_after_repair(self, core):
        b = MicroBatcher(_StubCore(core.config), max_batch=2, max_wait_ms=5)
        try:
            self._kill_fetcher(b)
            fut = b.submit(_make_job(core, 128))  # must not raise "shut down"
            assert b.ensure_running()
            assert fut.result(timeout=10).shape == (128 * core.config.hop_length,)
        finally:
            b.shutdown()

    def test_concurrent_ensure_running_single_restart(self, core):
        b = MicroBatcher(_StubCore(core.config), max_batch=2, max_wait_ms=5)
        try:
            self._kill_dispatcher(b)
            results = []
            threads = [threading.Thread(target=lambda: results.append(b.ensure_running()))
                       for _ in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=15)
            assert all(results) and len(results) == 4 and b.healthy
            assert b._gen == 3  # one repair (retire, restart), not four
            out = b.submit(_make_job(core, 128)).result(timeout=10)
            assert out.shape == (128 * core.config.hop_length,)
        finally:
            b.shutdown()


# -- Scheduling over a recording fake core, in both packages -------------------------


class _FakeCore:
    """Stand-in for either package's EngineCore: records every dispatched
    batch (bucket, padded rows, the rows' seeds in order); the first fetch can
    block on an event so a test holds the pipeline full while the collector
    runs. Takes the JAX batcher's trim arguments too."""

    class _Cfg:
        max_batch_size = 8
        hop_length = 4

    def __init__(self, block_first_fetch=False):
        self.config = self._Cfg()
        self.dispatches: list[dict] = []
        self.release = threading.Event()
        self._block_first = block_first_fetch
        self._lock = threading.Lock()

    def pick_trim(self, batch, n_frames, ref_len):
        return 0

    def synthesize_batch_async(self, wave, ref_len, text_ids, total_len,
                               seed=None, trim_ref_frames=0):
        with self._lock:
            idx = len(self.dispatches)
            self.dispatches.append({
                "rows": int(wave.shape[0]),
                "bucket": int(text_ids.shape[1]),
                "seeds": [int(s) for s in seed],
                "ref_len": [int(r) for r in ref_len],
                "total_len": [int(t) for t in total_len],
            })
        out = np.zeros((wave.shape[0], text_ids.shape[1] * 4), np.int16)

        def fetch():
            if self._block_first and idx == 0:
                assert self.release.wait(timeout=30)
            return out

        return fetch


def _fake_job(bucket, seed=0, cls=ChunkJob, ref_len=16):
    return cls(bucket=bucket, wave=np.zeros(bucket * 4, np.float32), ref_len=ref_len,
               total_len=bucket - 16, text_ids=np.full((bucket,), -1, np.int32), seed=seed)


class TestSchedulerQueueing:
    def test_collect_spans_device_busy_window(self):
        """Jobs arriving while the in-flight pipeline is full ride ONE batch
        when a slot frees, not a straggler batch each."""
        core = _FakeCore(block_first_fetch=True)
        b = MicroBatcher(core, max_batch=8, max_wait_ms=5, pipeline_depth=2)
        try:
            futs = []
            for s in range(3):  # one in the fetcher, two fill the depth-2 queue
                futs.append(b.submit(_fake_job(128, seed=s)))
                assert _wait_for(lambda: len(core.dispatches) == s + 1)
            for s in range(3, 8):
                futs.append(b.submit(_fake_job(128, seed=s)))
            time.sleep(0.1)  # the collector drains them
            assert len(core.dispatches) == 3  # nothing dispatched while full
            core.release.set()
            for f in futs:
                f.result(timeout=30)
            assert len(core.dispatches) == 4
            assert core.dispatches[3]["rows"] == 6  # 5 jobs, padded on the grid
            assert core.dispatches[3]["seeds"][:5] == [3, 4, 5, 6, 7]
        finally:
            core.release.set()
            b.shutdown()

    def test_majority_bucket_dispatches_first(self):
        core = _FakeCore()
        b = MicroBatcher(core, max_batch=8, max_wait_ms=150)
        try:
            futs = [b.submit(_fake_job(128, seed=0))]
            futs += [b.submit(_fake_job(256, seed=s)) for s in (1, 2, 3)]
            for f in futs:
                f.result(timeout=30)
            assert [d["bucket"] for d in core.dispatches] == [256, 128]
            assert [d["rows"] for d in core.dispatches] == [3, 1]
        finally:
            b.shutdown()

    def test_starving_job_jumps_the_majority(self):
        core = _FakeCore()
        b = MicroBatcher(core, max_batch=8, max_wait_ms=150, max_starve_ms=0.0)
        try:
            futs = [b.submit(_fake_job(128, seed=0))]
            futs += [b.submit(_fake_job(256, seed=s)) for s in (1, 2, 3)]
            for f in futs:
                f.result(timeout=30)
            assert [d["bucket"] for d in core.dispatches] == [128, 256]
        finally:
            b.shutdown()

    def test_pending_jobs_fail_cleanly_at_shutdown(self):
        core = _FakeCore(block_first_fetch=True)
        b = MicroBatcher(core, max_batch=2, max_wait_ms=5)
        try:
            futs = [b.submit(_fake_job(128, seed=s)) for s in range(8)]
            # depth 1: batch 0 blocks in fetch, batch 1 fills the pipeline;
            # the rest accumulate in _pending until shutdown.
            assert _wait_for(lambda: len(core.dispatches) >= 2)
        finally:
            core.release.set()
            b.shutdown()
        done = [f for f in futs if f.done()]
        assert len(done) == len(futs)  # none hangs
        failed = [f for f in futs if f.exception(timeout=1) is not None]
        assert all("shut down" in str(f.exception()) for f in failed)
        assert len(failed) >= 1


# -- The two races the port does not copy --------------------------------------


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
class TestRaces:
    def test_fetcher_survives_a_job_failed_by_a_client_thread(self):
        """``submit`` losing the race with ``shutdown`` fails queued jobs
        from the client's thread; a job among them may already ride a batch
        in flight. Resolving it again must not end the fetcher (an unguarded
        ``set_result`` raises InvalidStateError outside any ``try``)."""
        core = _FakeCore(block_first_fetch=True)
        b = MicroBatcher(core, max_batch=2, max_wait_ms=5)
        try:
            first, second = _fake_job(128, seed=0), _fake_job(128, seed=1)
            b.submit(first)
            assert _wait_for(lambda: len(core.dispatches) == 1)  # in flight
            first.future.set_exception(RuntimeError("MicroBatcher is shut down"))
            core.release.set()
            out = b.submit(second).result(timeout=10)  # the fetcher still serves
            assert out.shape == (128 * 4,)
            assert b.healthy and b._fetcher.is_alive()
            assert b.stats.batches == 2
            with pytest.raises(RuntimeError, match="shut down"):
                first.future.result(timeout=1)  # the first outcome stands
        finally:
            core.release.set()
            b.shutdown()

    def test_pending_is_not_cleared_under_the_dispatcher(self):
        """``_fail_queued`` (a client thread) and ``_collect`` (the
        dispatcher) both work on ``_pending``. With the pipeline full the
        dispatcher walks it every few milliseconds; clearing it in the middle
        of a walk raises "deque mutated during iteration" in the dispatcher
        and can dispatch jobs that were already failed. The deque below walks
        slowly and notes a ``clear`` that lands inside another thread's walk."""

        class SlowDeque(deque):
            """Walks slowly; ``clear`` gives another thread 0.3 s to be found
            in the middle of a walk. Under the port's lock none can be."""

            def __init__(self):
                super().__init__()
                self.walkers, self.walks, self.cleared_mid_walk = set(), 0, False

            def __iter__(self):
                me = threading.get_ident()
                self.walkers.add(me)
                self.walks += 1
                try:
                    for item in deque.__iter__(self):
                        time.sleep(0.002)
                        yield item
                finally:
                    self.walkers.discard(me)

            def clear(self):
                others = lambda: self.walkers - {threading.get_ident()}  # noqa: E731
                if _wait_for(others, 0.3):
                    self.cleared_mid_walk = True
                    while others():  # let the walk end: the deque would raise in it
                        time.sleep(0.001)
                deque.clear(self)

        core = _FakeCore(block_first_fetch=True)
        b = MicroBatcher(core, max_batch=8, max_wait_ms=5)
        try:
            # Batch 0 blocks in its fetch, batch 1 fills the depth-1 pipeline.
            held = []
            for s in range(2):
                held.append(b.submit(_fake_job(128, seed=s)))
                assert _wait_for(lambda: len(core.dispatches) == s + 1)
            # The dispatcher now waits on the empty queue with nothing pending.
            pending = SlowDeque()
            b._pending = pending
            queued = [b.submit(_fake_job(128, seed=10 + s)) for s in range(12)]
            assert _wait_for(lambda: len(pending) == 12 and pending.walks >= 2)
            # A client thread's clean-up lands while the dispatcher polls.
            b._fail_queued()
            assert not pending.cleared_mid_walk
            assert b._pending is pending  # never rebound behind the lock's back
            for f in queued:
                with pytest.raises(RuntimeError, match="shut down"):
                    f.result(timeout=5)
            core.release.set()
            for f in held:
                f.result(timeout=10)
            # Nothing that was failed got dispatched afterwards, and the
            # dispatcher lives on.
            time.sleep(0.05)
            assert len(core.dispatches) == 2 and b.healthy
            out = b.submit(_fake_job(128, seed=99)).result(timeout=10)
            assert out.shape == (128 * 4,)
        finally:
            core.release.set()
            b.shutdown()


# -- Held against the JAX package ----------------------------------------------


def _scripted_dispatches(module):
    """One scripted sequence through ``module.MicroBatcher`` over a
    recording fake core → its dispatches. The pipeline (depth 1) is held
    full while jobs of three buckets arrive, so what goes out afterwards is
    decided by the scheduler alone: cohort sizes, arrival order, the batch
    grid and max_batch."""
    core = _FakeCore(block_first_fetch=True)
    b = module.MicroBatcher(core, max_batch=4, max_wait_ms=30, max_starve_ms=60_000)
    job = lambda bucket, seed, ref_len=16: _fake_job(  # noqa: E731
        bucket, seed, cls=module.ChunkJob, ref_len=ref_len)
    try:
        futs = [b.submit(job(128, 0))]
        assert _wait_for(lambda: len(core.dispatches) == 1)
        futs.append(b.submit(job(256, 1)))
        assert _wait_for(lambda: len(core.dispatches) == 2)
        # Full pipeline: 6 × bucket 128 (more than max_batch), 3 × 256,
        # 1 × 384, interleaved, with differing reference lengths.
        script = [(128, 2, 20), (256, 3, 16), (128, 4, 24), (384, 5, 16), (128, 6, 18),
                  (128, 7, 30), (256, 8, 40), (128, 9, 22), (128, 10, 26), (256, 11, 16)]
        for bucket, seed, ref_len in script:
            futs.append(b.submit(job(bucket, seed, ref_len)))
        assert _wait_for(lambda: b._queue.qsize() == 0)
        time.sleep(0.05)
        core.release.set()
        for f in futs:
            f.result(timeout=30)
        return core.dispatches
    finally:
        core.release.set()
        b.shutdown()


def test_same_dispatches_as_the_jax_batcher():
    ours = _scripted_dispatches(tbatcher)
    theirs = _scripted_dispatches(jbatcher)
    assert ours == theirs
    assert [(d["bucket"], d["rows"]) for d in ours] == [
        (128, 1), (256, 1), (128, 4), (256, 3), (128, 2), (384, 1)]
    assert ours[2]["seeds"] == [2, 4, 6, 7] and ours[4]["seeds"] == [9, 10]
    # Padding rows take the real rows' smallest reference length.
    assert ours[3]["ref_len"] == [16, 40, 16] and ours[3]["rows"] == 3


def test_batch_grid_and_retry_constants_match_jax():
    from vietvoice_tts_tpu import config as jconfig
    from vietvoice_tts_tpu_torch import config as tconfig

    for max_batch in range(1, 33):
        assert tconfig.batch_grid(max_batch) == jconfig.batch_grid(max_batch)
        for b in range(1, 40):
            assert tconfig.pad_batch_size(b, max_batch) == jconfig.pad_batch_size(b, max_batch)
    assert (tbatcher.RETRY_BASE_S, tbatcher.RETRY_MAX_S) == (
        jbatcher.RETRY_BASE_S, jbatcher.RETRY_MAX_S)
    ours = {f.name for f in dataclasses.fields(tbatcher.ChunkJob)}
    theirs = {f.name for f in dataclasses.fields(jbatcher.ChunkJob)}
    # No trimmed fetch; the port's own fields are its request-scoped spans'.
    assert theirs - ours == {"trimmed"}
    assert ours - theirs == {"request_id", "batch_id", "span_ns"}
    assert [f.name for f in dataclasses.fields(tbatcher.BatcherStats)] == [
        f.name for f in dataclasses.fields(jbatcher.BatcherStats)]


class _RecordingBatcher:
    """Takes the engine's jobs, notes their fields, resolves them at once."""

    def __init__(self, hop):
        self.jobs, self.hop = [], hop

    def submit(self, job):
        self.jobs.append(job)
        job.future.set_result(np.zeros(job.bucket * self.hop, np.int16))
        return job.future

    def shutdown(self):
        pass


@pytest.mark.parametrize("streaming", [False, True])
def test_engine_submits_the_same_jobs_as_the_jax_engine(engine, tiny_engine, streaming):
    text = " ".join(f"Câu số {i} trong đoạn văn dài." for i in range(40))
    recorded = []
    for eng in (engine, tiny_engine):
        rec = _RecordingBatcher(eng.config.hop_length)
        eng.batcher = rec
        try:
            if streaming:
                list(eng.synthesize_streaming(text))
            else:
                eng.synthesize(text)
        finally:
            eng.batcher = None
        recorded.append(rec.jobs)
    ours, theirs = recorded
    assert len(ours) == len(theirs) >= 2
    for a, b in zip(ours, theirs):
        assert (a.bucket, a.ref_len, a.total_len, a.seed) == (
            b.bucket, b.ref_len, b.total_len, b.seed)
        assert a.wave.dtype == b.wave.dtype and np.array_equal(a.wave, b.wave)
        assert np.array_equal(a.text_ids, b.text_ids)
    assert [j.seed for j in ours] == list(range(len(ours)))


# -- First use under threads ---------------------------------------------------


def test_first_use_build_runs_once_under_threads(tmp_path, monkeypatch):
    """Eight threads ask for one library at once (the dispatcher's first
    launch and direct callers): one compile, one load, one object."""
    compiles, loads = [], []

    def fake_nvcc(cmd, **kw):
        compiles.append(cmd)
        time.sleep(0.05)
        out = cmd[cmd.index("-o") + 1]
        with open(out, "wb") as fh:
            fh.write(b"\x7fELF")

        class Done:
            returncode, stderr, stdout = 0, "ptxas info    : Used 32 registers", ""

        return Done()

    def fake_cdll(path):
        loads.append(path)
        return object()

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "run", fake_nvcc)
    monkeypatch.setattr(build.ctypes, "CDLL", fake_cdll)
    monkeypatch.setattr(build, "_libraries", {})
    monkeypatch.setattr(build, "_build_locks", {})

    start = threading.Barrier(8)
    got, errors = [], []

    def worker(name):
        try:
            start.wait(timeout=10)
            got.append((name, build.load_library(name)))
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    names = ["flash_attention"] * 6 + ["fused_rope_attention"] * 2
    threads = [threading.Thread(target=worker, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errors and len(got) == 8
    assert len(compiles) == 2 and len(loads) == 2  # one per library
    for name in set(names):
        assert len({id(lib) for n, lib in got if n == name}) == 1
    assert sorted(p.name for p in (tmp_path / "build").glob("*.so")) == sorted(
        build.library_path(n).name for n in set(names))  # no temporary left


def test_two_threads_leave_the_tf32_flags_as_they_found_them(engine, monkeypatch):
    """The float32 parity mode flips two process-wide flags around each
    batch; batches are queued one at a time, so a second thread neither sees
    the other's restore in the middle of its batch nor saves the flipped
    value as "the caller's"."""
    core = engine.engine_core
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = [f.allow_tf32 for f in flags]
    seen_inside = []
    sample = core._sample_latent

    def slow_sample(*args, **kw):
        seen_inside.append(any(f.allow_tf32 for f in flags))
        time.sleep(0.05)
        out = sample(*args, **kw)
        seen_inside.append(any(f.allow_tf32 for f in flags))
        return out

    monkeypatch.setattr(core, "_numerics", tcore_mod._true_float32)  # as on CUDA in f32
    monkeypatch.setattr(core, "_sample_latent", slow_sample)
    job = _make_job(core, 128)
    args = (job.wave[None], np.array([16]), job.text_ids[None], np.array([112]))
    errors = []

    def worker():
        try:
            for _ in range(3):
                core.synthesize_batch(*args)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    try:
        for f in flags:
            f.allow_tf32 = True
        threads = [threading.Thread(target=worker) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
        assert not errors and len(seen_inside) == 12
        assert not any(seen_inside)  # TF32 stayed off inside every batch
        assert all(f.allow_tf32 for f in flags)  # and came back on after
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v
