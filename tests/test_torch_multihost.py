"""The port's lockstep serving loop (``serving/multihost.py``) on the CPU.

Carried over from ``tests/test_serving.py::TestMultiHostLoop`` (one rank:
dispatch and result, equal to a direct batch, submit before start, stop
fails queued jobs) and ``tests/test_multihost_2proc.py`` (two real ranks:
lockstep with a clean cluster stop, and the coordinator's death
fail-stopping the worker), plus the broadcast through an injected
one-to-all function (a coordinator and a worker in one process) and the
guarded ``set_result`` (a job failed by ``stop()`` while its batch is in
flight). The two-rank tests spawn ranks on gloo
(``tests/torch_parallel_proc.py``) that serve through tensor parallelism
(TP 2), so the ranks' engine cores run their collectives in lockstep; each
records a SHA-1 of every real batch's PCM, and both must match bit for bit.
"""

import queue
from pathlib import Path

import numpy as np
import pytest

from test_torch_slice import port_config
from torch_parallel_proc import run_ranks, serving

from vietvoice_tts_tpu_torch.runtime import serialization as tser
from vietvoice_tts_tpu_torch.runtime.engine_core import EngineCore
from vietvoice_tts_tpu_torch.serving import MultiHostServingLoop, ServingLoopStopped
from vietvoice_tts_tpu_torch.serving.batcher import ChunkJob

WAIT = 60  # seconds: the longest any single wait below may take


@pytest.fixture(scope="module")
def core(tiny_pack_dir):
    pack = Path(tiny_pack_dir) / "vietvoice-tpu-v1"
    params = tser.load_params(pack / "params.msgpack")
    vocab = len((pack / "vocab.txt").read_text().splitlines())
    return EngineCore(port_config(model_cache_dir=tiny_pack_dir), params, vocab)


def _make_job(core, bucket, seed=0):
    hop = core.config.hop_length
    rng = np.random.default_rng(seed)
    wave = np.zeros(bucket * hop, np.float32)
    wave[: 16 * hop] = rng.uniform(-0.3, 0.3, 16 * hop)
    ids = np.full((bucket,), -1, np.int32)
    ids[:32] = 5
    return ChunkJob(bucket=bucket, wave=wave, ref_len=16, total_len=bucket - 16,
                    text_ids=ids, seed=seed)


class TestMultiHostLoop:
    """One rank: the loop degrades to a plain dispatch loop."""

    def test_dispatch_and_result(self, core):
        loop = MultiHostServingLoop(core, max_batch=2, max_wait_ms=20)
        loop.start()
        try:
            futures = [loop.submit(_make_job(core, 128, seed=i)) for i in range(3)]
            outs = [f.result(timeout=WAIT) for f in futures]
            assert all(o.shape == (128 * core.config.hop_length,) for o in outs)
        finally:
            loop.stop()

    def test_matches_direct_batcher(self, core):
        loop = MultiHostServingLoop(core, max_batch=2, max_wait_ms=5)
        loop.start()
        try:
            out_loop = loop.submit(_make_job(core, 128, seed=42)).result(timeout=WAIT)
        finally:
            loop.stop()
        job = _make_job(core, 128, seed=42)
        direct = core.synthesize_batch(
            job.wave[None], np.array([16], np.int32), job.text_ids[None],
            np.array([128 - 16], np.int32), seed=np.array([42], np.uint32),
        )
        np.testing.assert_array_equal(out_loop, direct[0])

    def test_submit_before_start_raises(self, core):
        loop = MultiHostServingLoop(core)
        with pytest.raises(RuntimeError):
            loop.submit(_make_job(core, 128))

    def test_stop_fails_queued_jobs_instead_of_hanging(self, core):
        """Jobs still in the queue at shutdown have their futures resolved
        (ServingLoopStopped), never left pending, and submit() after stop
        is rejected."""
        loop = MultiHostServingLoop(core, max_batch=2, max_wait_ms=20)
        # A loop whose thread never drains (stop racing start): mark it
        # running without a worker thread, enqueue, then stop.
        loop._running = True
        fut = loop.submit(_make_job(core, 128))
        loop.stop()
        with pytest.raises(ServingLoopStopped):
            fut.result(timeout=5)
        with pytest.raises(ServingLoopStopped):
            loop.submit(_make_job(core, 128))


class _RecordingCore:
    """A core that records every dispatched batch and returns zeros."""

    def __init__(self, config):
        self.config = config
        self.batches = []

    def synthesize_batch_async(self, wave, ref_len, text_ids, total_len, seed=0):
        self.batches.append(dict(wave=wave.copy(), ref_len=ref_len.copy(),
                                 text_ids=text_ids.copy(), total_len=total_len.copy(),
                                 seeds=np.asarray(seed).copy()))
        return lambda: np.zeros((wave.shape[0], wave.shape[1]), np.int16)


class _FakeGroup:
    """One-to-all broadcast between a coordinator and one worker in one
    process: the coordinator publishes, the worker takes in order."""

    def __init__(self):
        self.wire = queue.Queue()
        self.sent = []

    def coordinator(self, array):
        self.sent.append(array.copy())
        self.wire.put(array.copy())
        return array

    def worker(self, array):
        got = self.wire.get(timeout=WAIT)
        assert got.shape == array.shape and got.dtype == array.dtype
        return got


def test_broadcast_rebuilds_the_batch_on_the_worker(tiny_pack_dir):
    """Two loops wired by an injected broadcast: the worker dispatches the
    coordinator's batch bit for bit (the wave prefix rounded to float16 on
    both), in two broadcasts per step, and the cluster stop ends both."""
    config = port_config(model_cache_dir=tiny_pack_dir)
    group = _FakeGroup()
    lead_core, worker_core = _RecordingCore(config), _RecordingCore(config)
    lead = MultiHostServingLoop(lead_core, max_batch=2, max_wait_ms=5, process_index=0,
                                process_count=2, broadcast_fn=group.coordinator)
    worker = MultiHostServingLoop(worker_core, max_batch=2, max_wait_ms=5, process_index=1,
                                  process_count=2, broadcast_fn=group.worker)
    worker.start()
    lead.start()
    try:
        futures = [lead.submit(_make_job(lead_core, 128, seed=s)) for s in (3, 4)]
        for f in futures:
            assert f.result(timeout=WAIT).shape == (128 * config.hop_length,)
    finally:
        lead.stop(timeout=WAIT)
    worker._thread.join(timeout=WAIT)
    assert not worker._thread.is_alive() and not worker._running
    real = [b for b in lead_core.batches if (b["ref_len"] > 0).any()]
    assert real and len(worker_core.batches) == len(lead_core.batches)
    for a, b in zip(lead_core.batches, worker_core.batches):
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
    job = _make_job(lead_core, 128, seed=3)
    np.testing.assert_array_equal(
        real[0]["wave"][0], job.wave.astype(np.float16).astype(np.float32)
    )
    # Shape first (4 int64, the last step the stop sentinel), then bytes.
    assert group.sent[-1].tolist() == [-1, 0, 0, 0]
    assert all(s.dtype == np.int64 for s in group.sent[0::2])
    assert all(s.dtype == np.uint8 for s in group.sent[1:-1:2])


def test_set_result_is_guarded_against_a_job_already_failed(core):
    """A stop() that fails a job whose batch is in flight must not make the
    loop's own set_result raise (InvalidStateError) and kill its thread."""
    loop = MultiHostServingLoop(core, max_batch=2, max_wait_ms=5)
    job = _make_job(core, 128)
    job.future.set_exception(ServingLoopStopped("failed by stop()"))
    loop._resolve((lambda: np.zeros((1, 4), np.int16), [job]))
    loop._resolve((lambda: (_ for _ in ()).throw(RuntimeError("x")), [job]))
    with pytest.raises(ServingLoopStopped):
        job.future.result(timeout=0)


# -- Two real ranks -------------------------------------------------------------------


def _two_rank_data(tiny_pack_dir, mode, workdir):
    pack = Path(tiny_pack_dir) / "vietvoice-tpu-v1"
    bucket, hop = 64, 256
    rng = np.random.default_rng(7)
    jobs = []
    for i in range(3):
        wave = np.zeros((bucket * hop,), np.float32)
        wave[: 20 * hop] = rng.standard_normal(20 * hop).astype(np.float32) * 0.1
        ids = np.full((bucket,), -1, np.int32)
        ids[:30] = (np.arange(30) % 50) + 1
        jobs.append(dict(bucket=bucket, wave=wave, ref_len=20, total_len=50, text_ids=ids, seed=i))
    config = port_config(model_cache_dir=tiny_pack_dir, frame_buckets=(bucket,),
                         voice_cond_cache=False)
    return dict(mode=mode, bucket=bucket, jobs=jobs, config=config.to_dict(), dir=str(workdir),
                params=tser.load_params(pack / "params.msgpack"),
                vocab=len((pack / "vocab.txt").read_text().splitlines()))


def test_two_rank_lockstep_and_clean_cluster_stop(tiny_pack_dir, tmp_path):
    results, codes = run_ranks(serving, 2, tmp_path,
                               _two_rank_data(tiny_pack_dir, "clean", tmp_path))
    lead, worker = results
    assert codes == [0, 0]
    # The same real batches, bit-identical PCM on both ranks.
    assert lead["hashes"] and lead["hashes"] == worker["hashes"]
    assert len(lead["waves"]) == 3 and all(w.dtype == np.int16 for w in lead["waves"])
    # The worker's loop ended at the cluster-stop sentinel, not a crash.
    assert worker["stopped"] is True


def test_coordinator_death_failstops_the_worker(tiny_pack_dir, tmp_path):
    """Rank 0 dies without stopping the cluster: the worker's loop stops
    (a broadcast or collective fails) instead of hanging the mesh."""
    results, codes = run_ranks(serving, 2, tmp_path,
                               _two_rank_data(tiny_pack_dir, "crash", tmp_path), check=False)
    lead, worker = results
    assert codes == [1, 0], codes
    assert worker is not None and worker["stopped"] is True
    assert lead["hashes"]
    # The worker ran the same real batches before rank 0 died.
    assert worker["hashes"] == lead["hashes"][: len(worker["hashes"])]
    assert worker["hashes"]
