"""Streaming synthesis, the asynchronous batch dispatch and the deterministic
setup of the PyTorch port.

The numpy streaming cross-fade and the first-chunk cap are held against the
JAX package's (array-equal, equal plans). Streaming against blocking runs
through the port's own ``TTSEngine`` on the CPU in float32: streaming
dispatches each chunk as a batch of one, blocking one batch per bucket, and
per-row noise makes their inputs equal. On the CPU the two are byte-identical
with the shipped pack (zero AdaLN gates) and with opened gates alike, so the
tests assert equality; what the card gives is stated by ``chip_smoke.py``.
Direct streaming's order of dispatches, fetches and pieces is held against
the JAX engine's ``_iter_chunk_waves`` on spy cores.
"""

import dataclasses
import os
import random
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_slice import _open_gates, port_config

import vietvoice_tts_tpu_torch as vt
from vietvoice_tts_tpu.pipeline import audio as jaudio
from vietvoice_tts_tpu.pipeline import engine as jengine
from vietvoice_tts_tpu_torch import deterministic
from vietvoice_tts_tpu_torch.pipeline import audio as taudio
from vietvoice_tts_tpu_torch.runtime.engine_core import EngineCore

LONG = " ".join(f"Câu số {i} trong đoạn văn dài." for i in range(60))


@pytest.fixture(scope="module")
def engine(tiny_pack_dir):
    eng = vt.TTSEngine(port_config(model_cache_dir=tiny_pack_dir))
    yield eng
    eng.cleanup()


# -- The streaming cross-fade ------------------------------------------------------


def _chunks(lengths, seed=0, scale=0.6):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(-scale, scale, n) * 32767).astype(np.int16) for n in lengths]


@pytest.mark.parametrize("fade", [0.0, 0.01, 0.1])
@pytest.mark.parametrize("lengths", [
    (24000, 30000, 26000),
    (5000, 300, 7000),  # a chunk shorter than the fade window
    (24000,),
    (),
])
def test_stream_with_crossfade_matches_jax(monkeypatch, lengths, fade):
    # The numpy paths of both packages (the native library has its own test,
    # within 1 LSB: tests/test_torch_native.py).
    monkeypatch.setattr(jaudio, "_native_dsp", lambda: None)
    monkeypatch.setattr(taudio, "_native_dsp", lambda: None)
    chunks = _chunks(lengths)
    ref = list(jaudio.AudioProcessor.stream_with_crossfade(iter(chunks), fade, 24000))
    out = list(taudio.AudioProcessor.stream_with_crossfade(iter(chunks), fade, 24000))
    assert len(out) == len(ref)
    for ours, theirs in zip(out, ref):
        assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)


def test_stream_crossfade_equals_batch_concatenation():
    chunks = _chunks((24000, 30000, 26000))
    batch = taudio.AudioProcessor.concatenate_with_crossfade_improved(
        [c.copy() for c in chunks], 0.1, 24000
    )
    pieces = list(taudio.AudioProcessor.stream_with_crossfade(iter(chunks), 0.1, 24000))
    assert len(pieces) == 4  # three bodies and the last fade window
    np.testing.assert_array_equal(np.concatenate(pieces), batch)
    # Loud chunks go through the clip repair on both paths.
    loud = _chunks((24000, 24000), seed=1, scale=1.0)
    loud[1][:10] = 32767
    np.testing.assert_array_equal(
        np.concatenate(list(taudio.AudioProcessor.stream_with_crossfade(iter(loud), 0.1, 24000))),
        taudio.AudioProcessor.concatenate_with_crossfade_improved(loud, 0.1, 24000),
    )


def test_stream_crossfade_is_lazy():
    """A piece is yielded as soon as its chunk arrives, before the next
    chunk is pulled."""
    pulled = []

    def source():
        for i, c in enumerate(_chunks((24000, 24000, 24000))):
            pulled.append(i)
            yield c

    stream = taudio.AudioProcessor.stream_with_crossfade(source(), 0.1, 24000)
    first = next(stream)
    assert pulled == [0] and len(first) == 24000 - 2400


# -- Planning ------------------------------------------------------------------------


@pytest.mark.parametrize("cap", [None, 0.5, 2.0, 4.0, 30.0])
def test_first_chunk_cap_plans_match_jax(engine, tiny_engine, cap):
    ref_audio, ref_text = engine.model_session_manager.select_sample()
    ref = engine._load_ref(ref_audio).astype(np.float32) / 32768.0
    for text in (LONG, "Một câu ngắn.", "Một câu rất dài " + "không có dấu phẩy " * 40):
        ours = engine._plan_chunks(ref, ref_text, text, first_chunk_cap=cap)
        theirs = tiny_engine._plan_chunks(ref, ref_text, text, first_chunk_cap=cap)
        assert [dataclasses.asdict(p) for p in ours] == [dataclasses.asdict(p) for p in theirs]


def test_first_chunk_cap_shortens_first_piece(engine):
    ref_audio, ref_text = engine.model_session_manager.select_sample()
    ref = engine._load_ref(ref_audio).astype(np.float32) / 32768.0
    base_plans = engine._plan_chunks(ref, ref_text, LONG)
    sr, hop = engine.config.sample_rate, engine.config.hop_length
    head_target_s = (base_plans[0].total_len - base_plans[0].ref_len) * hop / sr
    cap = head_target_s / 2
    cap_plans = engine._plan_chunks(ref, ref_text, LONG, first_chunk_cap=cap)
    assert len(cap_plans) > len(base_plans)
    assert (cap_plans[0].total_len - cap_plans[0].ref_len) < (
        base_plans[0].total_len - base_plans[0].ref_len)
    base = list(engine.synthesize_streaming(LONG))
    capped = list(engine.synthesize_streaming(LONG, first_chunk_duration=cap))
    assert len(capped) > len(base) and len(capped[0]) < len(base[0])
    assert 0.7 < sum(map(len, capped)) / sum(map(len, base)) < 1.3
    assert all(p.dtype == np.int16 for p in capped)
    # The config field is the default of the argument.
    engine.config.streaming_first_chunk_duration = cap
    try:
        from_config = list(engine.synthesize_streaming(LONG))
    finally:
        engine.config.streaming_first_chunk_duration = None
    assert [len(p) for p in from_config] == [len(p) for p in capped]


@pytest.mark.parametrize("cap,max_chunk", [
    (-1.0, 20.0), (0.0, 20.0), (20.5, 20.0), (15.0, 10.0), (float("nan"), 20.0)])
def test_an_invalid_head_cap_raises(engine, cap, max_chunk):
    """The JAX package takes any cap: a negative one always cuts an
    8-character head, one above the chunk limit never engages. The port
    takes None or (0, max_chunk_duration], in the config and per call."""
    with pytest.raises(ValueError, match="streaming_first_chunk_duration"):
        port_config(streaming_first_chunk_duration=cap, max_chunk_duration=max_chunk)
    if max_chunk == engine.config.max_chunk_duration:
        with pytest.raises(ValueError, match="first_chunk_duration"):
            engine.synthesize_streaming(LONG, first_chunk_duration=cap)
    assert port_config(streaming_first_chunk_duration=max_chunk,
                       max_chunk_duration=max_chunk).streaming_first_chunk_duration == max_chunk


def test_a_valid_head_cap_splits_the_head_as_jax_plans_it(engine, tiny_engine, monkeypatch):
    ref_audio, ref_text = engine.model_session_manager.select_sample()
    ref = engine._load_ref(ref_audio).astype(np.float32) / 32768.0
    planned = []
    plan = engine._plan_chunks
    monkeypatch.setattr(engine, "_plan_chunks", lambda *a, **k: planned.append(plan(*a, **k))
                        or planned[-1])
    # The plan is what is checked: no chunk is synthesized.
    monkeypatch.setattr(engine, "_iter_chunk_waves",
                        lambda plans, ref, request_id=None: iter([np.zeros(len(plans), np.int16)]))
    assert len(list(engine.synthesize_streaming(LONG, first_chunk_duration=2.0))) == 1
    theirs = tiny_engine._plan_chunks(ref, ref_text, LONG, first_chunk_cap=2.0)
    assert [dataclasses.asdict(p) for p in planned[0]] == [dataclasses.asdict(p) for p in theirs]
    assert len(theirs) > len(tiny_engine._plan_chunks(ref, ref_text, LONG))


# -- Streaming against blocking --------------------------------------------------------


def test_stream_equals_blocking_multichunk(engine):
    assert engine.config.streaming_first_chunk_duration is None
    wave, _ = engine.synthesize(LONG)
    pieces = list(engine.synthesize_streaming(LONG))
    assert len(pieces) >= 2 and all(p.dtype == np.int16 for p in pieces)
    np.testing.assert_array_equal(np.concatenate(pieces), wave)


def test_stream_equals_blocking_single_chunk(engine):
    wave, _ = engine.synthesize("Một câu ngắn.")
    pieces = list(engine.synthesize_streaming("Một câu ngắn."))
    np.testing.assert_array_equal(np.concatenate(pieces), wave)


def test_stream_equals_blocking_with_opened_gates(tiny_pack_dir):
    """With opened gates attention and the FFNs reach the audio, and the
    batch-of-one and batched solves still agree byte for byte on the CPU
    (float32; largest sample difference measured: 0)."""
    eng = vt.TTSEngine(port_config(model_cache_dir=tiny_pack_dir))
    mgr = eng.model_session_manager
    eng.engine_core = EngineCore(eng.config, _open_gates(mgr.params), mgr.vocab_size)
    wave, _ = eng.synthesize(LONG)
    closed, _ = vt.TTSEngine(port_config(model_cache_dir=tiny_pack_dir)).synthesize(LONG)
    assert wave.shape == closed.shape and not np.array_equal(wave, closed)
    stream = np.concatenate(list(eng.synthesize_streaming(LONG)))
    np.testing.assert_array_equal(stream, wave)


class _SpyCore:
    """An engine core that records ``("dispatch", i)`` when chunk i's
    single-row batch is dispatched and ``("fetch", i)`` when its result is
    fetched. With ``dispatch`` it runs the real batch; else it returns a row
    of i's."""

    def __init__(self, events, dispatch=None):
        self.events, self.dispatch = events, dispatch

    def synthesize_batch_async(self, *args, **kw):
        index = int(np.asarray(kw["seed"])[0])
        assert args[0].shape[0] == 1
        self.events.append(("dispatch", index))
        run = (self.dispatch(*args, **kw) if self.dispatch
               else lambda: np.full((1, 4), index, np.int16))

        def fetch():
            self.events.append(("fetch", index))
            return run()

        return fetch

    def pick_trim(self, *args):
        return 0


def _drive(iter_chunk_waves, engine, plans, ref, events):
    """Consume the generator, recording ``("piece", i)`` as chunk i arrives."""
    pieces = []
    for p, wave in zip(plans, iter_chunk_waves(engine, plans, ref), strict=True):
        events.append(("piece", p.index))
        pieces.append(wave)
    return pieces


def _stub_engine(core):
    return types.SimpleNamespace(
        batcher=None, engine_core=core,
        _chunk_row=lambda p, ref: (np.zeros(4, np.float32), np.zeros(4, np.int32)),
        _slice_output=lambda p, out, trim=0: out)


@pytest.mark.parametrize("n_chunks", [1, 2, 3, 5])
def test_direct_streaming_dispatches_as_jax_does(n_chunks):
    """Direct mode's dispatches, fetches and yielded pieces come in the JAX
    engine's order: up to three single-row dispatches queued, the oldest
    fetched and yielded when a third is queued, then the rest in order."""
    plans = [types.SimpleNamespace(index=i, ref_len=8, total_len=16, bucket=32)
             for i in range(n_chunks)]
    ref = np.zeros(64, np.float32)
    ours, theirs = [], []
    got = _drive(vt.TTSEngine._iter_chunk_waves, _stub_engine(_SpyCore(ours)), plans, ref, ours)
    _drive(jengine.TTSEngine._iter_chunk_waves, _stub_engine(_SpyCore(theirs)), plans, ref,
           theirs)
    assert ours == theirs
    assert [int(w[0]) for w in got] == list(range(n_chunks))
    if n_chunks == 5:
        assert ours[:4] == [("dispatch", 0), ("dispatch", 1), ("dispatch", 2), ("fetch", 0)]


def test_each_streamed_chunk_equals_its_blocking_run(engine, monkeypatch):
    """On the port's engine: JAX's order (as the stub above records it) and,
    chunk by chunk, the blocking batched run's output."""
    events = []
    core = engine.engine_core
    monkeypatch.setattr(core, "synthesize_batch_async",
                        _SpyCore(events, core.synthesize_batch_async).synthesize_batch_async)
    ref_audio, ref_text = engine.model_session_manager.select_sample()
    ref = engine._load_ref(ref_audio).astype(np.float32) / 32768.0
    plans = engine._plan_chunks(ref, ref_text, LONG)
    assert len(plans) >= 3
    streamed = _drive(type(engine)._iter_chunk_waves, engine, plans, ref, events)
    want = []
    _drive(jengine.TTSEngine._iter_chunk_waves, _stub_engine(_SpyCore(want)), plans, ref, want)
    assert events == want
    for got, blocking in zip(streamed, engine._run_chunks(plans, ref), strict=True):
        assert got.dtype == np.int16 and got.size
        np.testing.assert_array_equal(got, blocking)


def test_async_batch_equals_blocking_batch(engine):
    rng = np.random.default_rng(3)
    n = 128
    wave = (0.2 * rng.standard_normal((2, n * 256))).astype(np.float32)
    args = (wave, np.array([40, 60]), rng.integers(0, 150, (2, n)), np.array([100, n]))
    core = engine.engine_core
    fetch = core.synthesize_batch_async(*args, seed=np.array([0, 1]))
    out = fetch()
    assert out.dtype == np.int16 and out.shape == (2, n * 256)
    np.testing.assert_array_equal(out, core.synthesize_batch(*args, seed=np.array([0, 1])))
    np.testing.assert_array_equal(fetch(), out)  # fetch may be called again


def test_client_streaming_passthrough(tiny_pack_dir):
    with vt.TTSApi(port_config(model_cache_dir=tiny_pack_dir)) as api:
        pieces = list(api.synthesize_streaming("Xin chào."))
        assert pieces and all(p.dtype == np.int16 for p in pieces)
        wave, _ = api.synthesize("Xin chào.")
        np.testing.assert_array_equal(np.concatenate(pieces), wave)
        with pytest.raises(ValueError):
            api.synthesize_streaming(None)
        with pytest.raises(ValueError):
            list(api.synthesize_streaming("Xin chào.", gender="robot"))


# -- deterministic.py ------------------------------------------------------------------


@pytest.fixture
def restored_global_state():
    """setup_deterministic_tts changes process-wide state; put it back."""
    saved = (random.getstate(), np.random.get_state(), torch.get_rng_state(),
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.benchmark,
             {k: os.environ.get(k) for k in ("PYTHONHASHSEED", "CUBLAS_WORKSPACE_CONFIG")})
    yield
    random.setstate(saved[0])
    np.random.set_state(saved[1])
    torch.set_rng_state(saved[2])
    torch.use_deterministic_algorithms(saved[3], warn_only=saved[4])
    torch.backends.cudnn.benchmark = saved[5]
    for key, value in saved[6].items():
        if value is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = value


def test_deterministic_setup_two_runs_same_audio(tiny_pack_dir, restored_global_state):
    """Under strict deterministic algorithms (an op without a deterministic
    implementation would raise) two engines give the same audio, whatever
    the global RNGs did in between."""
    waves = []
    for _ in range(2):
        vt.setup_deterministic_tts()
        assert torch.are_deterministic_algorithms_enabled()
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
        with vt.TTSApi(port_config(model_cache_dir=tiny_pack_dir)) as api:
            waves.append(api.synthesize("Xin chào, hôm nay trời rất đẹp.")[0])
        torch.rand(7), np.random.rand(7), random.random()  # disturb the globals
    assert waves[0].size and np.array_equal(waves[0], waves[1])


def test_freeze_all_seeds(restored_global_state):
    def draw():
        return random.random(), np.random.rand(3).tolist(), torch.rand(3).tolist()

    deterministic.freeze_all_seeds()
    first = draw()
    assert os.environ["PYTHONHASHSEED"] == str(vt.config.DETERMINISTIC_SEED)
    deterministic.freeze_all_seeds()
    assert draw() == first
    deterministic.freeze_all_seeds(1)
    assert draw() != first
    assert {"freeze_all_seeds", "setup_deterministic_tts"} <= set(vt.__all__)
    assert not torch.are_deterministic_algorithms_enabled()  # importing sets nothing


def test_package_import_sets_no_global_state():
    """Unlike the JAX module, nothing is seeded when the port is imported."""
    source = (Path(vt.__file__).parent / "deterministic.py").read_text()
    assert "\nfreeze_all_seeds()" not in source
