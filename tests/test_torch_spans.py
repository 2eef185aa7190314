"""Request-scoped spans of the PyTorch port (``utils/logging.py:StageTimer``):
the recorder itself, the micro-batcher's ``job.queue`` / ``job.device``
spans over a stand-in core, and one REST request at ``tiny_config`` sizes
whose id crosses anyio's thread hop into the batcher's jobs.

Every wait has a timeout of its own, so a hung batcher fails one test.
"""

import asyncio
import importlib
import sys
import threading
from collections import Counter, defaultdict
from types import SimpleNamespace

import numpy as np
import pytest

from test_torch_slice import port_config

from vietvoice_tts_tpu_torch.api import tts_engine as te
from vietvoice_tts_tpu_torch.api.testing import AsyncTestClient
from vietvoice_tts_tpu_torch.serving.batcher import ChunkJob, MicroBatcher
from vietvoice_tts_tpu_torch.utils import logging as logging_mod
from vietvoice_tts_tpu_torch.utils.logging import REQUEST_ID, Span, StageTimer

app_module = importlib.import_module("vietvoice_tts_tpu_torch.api.app")
WAIT = 60
TEXTS = ("Xin chào thế giới.", "Một hai ba bốn năm sáu bảy tám.")


def run(coro):
    return asyncio.get_event_loop_policy().new_event_loop().run_until_complete(coro)


def _by_name(spans) -> dict:
    out = defaultdict(list)
    for s in spans:
        out[s.name].append(s)
    return out


# -- The recorder ----------------------------------------------------------------


def test_recorder_off_records_nothing():
    timer = StageTimer()
    assert timer.recording is False
    with timer.stage("chunk_dispatch", span="batch.dispatch"):
        pass
    assert list(timer.spans) == []
    assert timer.counts == {"chunk_dispatch": 1}  # the sums are kept either way


def test_recorder_stage_span_carries_request_and_batch():
    timer = StageTimer()
    timer.record_spans(True)
    token = REQUEST_ID.set(41)
    try:
        with timer.stage("chunk_dispatch", span="batch.dispatch"):
            pass
        with timer.stage("chunk_fetch"):  # a stage without a span name
            pass
    finally:
        REQUEST_ID.reset(token)
    (s,) = timer.spans
    assert isinstance(s, Span) and tuple(s) == ("batch.dispatch", s.start_ns, s.end_ns, 41, None)
    assert 0 < s.start_ns <= s.end_ns
    timer.reset()
    assert list(timer.spans) == [] and timer.totals == {}


def test_recorder_loses_no_span_under_64_threads():
    timer = StageTimer()
    timer.record_spans(True)
    start = threading.Barrier(64)

    def work(k):
        start.wait(timeout=WAIT)
        for i in range(1000):
            timer.span("job.queue", i, i + 1, k, i)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(64)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(timer.spans) == 64_000
    assert Counter(s.request_id for s in timer.spans) == {k: 1000 for k in range(64)}


def test_recorder_bound_keeps_the_newest(monkeypatch):
    monkeypatch.setattr(logging_mod, "MAX_SPANS", 100)
    timer = StageTimer()
    for i in range(250):
        timer.span("request", i, i + 1, i)
    assert len(timer.spans) == 100
    assert [s.request_id for s in timer.spans] == list(range(150, 250))


def test_open_request_is_owned_by_the_outermost_entry():
    timer = StageTimer()
    timer.record_spans(True)
    outer = timer.open_request()
    rid = REQUEST_ID.get()
    assert rid is not None and timer.open_request() is None  # an inner entry opens none
    timer.close_request(outer)
    assert REQUEST_ID.get() is None
    (s,) = timer.spans
    assert (s.name, s.request_id) == ("request", rid)


# -- The micro-batcher over a stand-in core -----------------------------------------


class _SpanStubCore:
    """Instant stand-in for EngineCore: times its dispatch as the real core
    does (``chunk_dispatch``, span ``batch.dispatch``); its first
    ``fail_fetches`` fetches raise."""

    def __init__(self, fail_fetches=0):
        self.config = SimpleNamespace(max_batch_size=4)
        self.timer = StageTimer()
        self.fail_fetches = fail_fetches
        self.lock = threading.Lock()

    def synthesize_batch_async(self, wave, ref_len, text_ids, total_len, seed):
        with self.timer.stage("chunk_dispatch", span="batch.dispatch"):
            out = np.zeros(wave.shape, np.int16)

        def fetch():
            with self.lock:
                fail, self.fail_fetches = self.fail_fetches > 0, max(0, self.fail_fetches - 1)
            if fail:
                raise RuntimeError("transient fetch failure")
            return out

        return fetch


def _job(bucket, request_id, seed=0):
    return ChunkJob(bucket=bucket, wave=np.zeros(bucket * 4, np.float32), ref_len=2,
                    total_len=bucket - 2, text_ids=np.zeros(bucket, np.int32), seed=seed,
                    request_id=request_id)


def _serve(core, jobs, **kw):
    b = MicroBatcher(core, max_batch=4, max_wait_ms=20, **kw)
    try:
        for j in jobs:
            b.submit(j)
        for j in jobs:
            j.future.result(timeout=WAIT)
    finally:
        b.shutdown()
    return b


def _check_job_spans(spans, jobs, attempts):
    """Each job: one job.queue and one job.device span per attempt, in that
    order, both with its request id and a batch id that a batch.dispatch
    span carries; its queue span ends at the start of its batch, before
    the dispatch; the device span starts after the dispatch ends."""
    named = _by_name(spans)
    dispatch = {s.batch_id: s for s in named["batch.dispatch"]}
    assert len(dispatch) == len(named["batch.dispatch"])  # one dispatch a batch
    queue_end_of_batch = {}
    for j in jobs:
        queue = [s for s in named["job.queue"] if s.request_id == j.request_id]
        device = [s for s in named["job.device"] if s.request_id == j.request_id]
        assert len(queue) == len(device) == attempts
        for q, d in zip(queue, device):
            assert q.batch_id == d.batch_id and q.batch_id in dispatch
            disp = dispatch[q.batch_id]
            assert q.start_ns <= q.end_ns <= disp.start_ns <= disp.end_ns <= d.start_ns <= d.end_ns
            assert queue_end_of_batch.setdefault(q.batch_id, q.end_ns) == q.end_ns
        assert len({q.batch_id for q in queue}) == attempts  # every attempt a batch of its own


def test_batcher_job_spans_one_pair_per_job():
    core = _SpanStubCore()
    core.timer.record_spans(True)
    jobs = [_job(128 if i % 3 else 256, request_id=100 + i, seed=i) for i in range(10)]
    b = _serve(core, jobs)
    _check_job_spans(core.timer.spans, jobs, attempts=1)
    assert b.stats.jobs == 10


def test_batcher_job_spans_one_pair_per_attempt():
    core = _SpanStubCore(fail_fetches=1)
    core.timer.record_spans(True)
    jobs = [_job(128, request_id=7, seed=0)]
    b = _serve(core, jobs, retries=1)
    assert b.stats.retries == 1
    _check_job_spans(core.timer.spans, jobs, attempts=2)


def test_batcher_records_nothing_while_off():
    core = _SpanStubCore()
    jobs = [_job(128, request_id=None, seed=i) for i in range(5)]
    _serve(core, jobs)
    assert list(core.timer.spans) == []
    assert all(j.span_ns == 0 and j.batch_id is None for j in jobs)
    assert core.timer.counts["chunk_dispatch"] >= 2


# -- One REST request, through the real engine --------------------------------------


@pytest.fixture(scope="module")
def rest_timer(tiny_pack_dir):
    """The app over a small engine on the CPU with its micro-batcher
    (``settings.MICRO_BATCHING`` is on by default), loaded before any
    request so that the timer can record; → the engine's timer."""
    old = te._engine_config
    te.reset_engine()
    te._engine_config = port_config(model_cache_dir=tiny_pack_dir)
    try:
        api = te.get_tts_engine()
        assert api.engine.batcher is not None
        yield api.engine.engine_core.timer
    finally:
        te.reset_engine()
        te._engine_config = old


def _post_all(texts):
    client = AsyncTestClient(app_module.app)

    async def go():
        return await asyncio.gather(*(client.post("/api/v1/synthesize", json={"text": t})
                                      for t in texts))

    return run(go())


def _assert_nested(spans):
    """Every job span lies inside the request span of its id, and its
    batch's dispatch span in between its queue and device spans."""
    named = _by_name(spans)
    requests = {s.request_id: s for s in named["request"]}
    for s in named["job.queue"] + named["job.device"]:
        r = requests[s.request_id]
        assert r.start_ns <= s.start_ns <= s.end_ns <= r.end_ns
    dispatch = {s.batch_id: s for s in named["batch.dispatch"]}
    for q, d in zip(sorted(named["job.queue"], key=lambda s: (s.request_id, s.start_ns)),
                    sorted(named["job.device"], key=lambda s: (s.request_id, s.start_ns))):
        assert q.batch_id == d.batch_id
        assert q.end_ns <= dispatch[q.batch_id].start_ns
        assert dispatch[q.batch_id].end_ns <= d.start_ns


def test_rest_request_span_and_its_jobs_share_the_id(rest_timer):
    rest_timer.reset()
    rest_timer.record_spans(True)
    try:
        (resp,) = _post_all(TEXTS[:1])
    finally:
        rest_timer.record_spans(False)
    assert resp.status_code == 200
    named = _by_name(rest_timer.spans)
    (req,) = named["request"]
    assert req.request_id is not None and req.batch_id is None
    # The jobs were built on anyio's worker thread: the id crossed the hop.
    assert named["job.queue"] and named["job.device"]
    assert {s.request_id for s in named["job.queue"] + named["job.device"]} == {req.request_id}
    _assert_nested(rest_timer.spans)
    assert REQUEST_ID.get() is None


def test_rest_concurrent_requests_keep_their_own_ids(rest_timer):
    rest_timer.reset()
    rest_timer.record_spans(True)
    try:
        resps = _post_all(TEXTS)
    finally:
        rest_timer.record_spans(False)
    assert [r.status_code for r in resps] == [200, 200]
    named = _by_name(rest_timer.spans)
    ids = [s.request_id for s in named["request"]]
    assert len(ids) == len(set(ids)) == 2
    for name in ("job.queue", "job.device"):
        assert Counter(s.request_id for s in named[name]) == {i: 1 for i in ids}
    _assert_nested(rest_timer.spans)


def test_library_calls_open_their_own_ids(rest_timer):
    engine = te.get_tts_engine().engine
    rest_timer.reset()
    rest_timer.record_spans(True)
    try:
        engine.synthesize(TEXTS[0])
        pieces = list(engine.synthesize_streaming(TEXTS[1]))
    finally:
        rest_timer.record_spans(False)
    assert pieces
    named = _by_name(rest_timer.spans)
    (req,) = named["request"]  # the stream route's first-piece span is not kept
    stream_ids = {s.request_id for s in named["job.queue"]} - {req.request_id}
    assert len(stream_ids) == 1 and None not in stream_ids
    assert {s.request_id for s in named["job.device"]} == {req.request_id} | stream_ids


def test_rest_records_nothing_while_off(rest_timer):
    rest_timer.reset()
    (resp,) = _post_all(TEXTS[:1])
    assert resp.status_code == 200
    assert list(rest_timer.spans) == [] and rest_timer.counts["chunk_dispatch"] >= 1
