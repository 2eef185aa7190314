"""The voice-conditioning cache of the PyTorch port (``EngineCore._cond_handles``),
counterpart of ``tests/test_cond_cache.py``.

The reference prefix's log-mel depends only on the voice audio, so it is kept
on the device and neither the waveform nor the mel front end is needed again
for a known voice. Tolerances:

- cached route against waveform route, the port against itself in float32 on
  the CPU: **array-equal** int16 PCM. The mel front end multiplies in tiles
  of 8 frames, so a frame's mel has the same bits whatever batch it is
  computed in (``ops/stft.py``).
- the cached log-mel against the JAX core's ``_cond_handles`` at the same
  waves: max-abs ≤ 1e-4, the figure ``tests/test_torch_modules.py`` holds the
  mel front end to.
"""

import numpy as np
import pytest
import torch

from conftest import tiny_config
from test_torch_slice import port_config

import vietvoice_tts_tpu_torch as vt
from vietvoice_tts_tpu.runtime.engine_core import EngineCore as JaxEngineCore
from vietvoice_tts_tpu_torch.ops.stft import MelFrontend

MEL_TOLERANCE = 1e-4


def _batch(core, b=2, n=128, ref_frames=16, seed=3):
    hop = core.config.hop_length
    rng = np.random.default_rng(seed)
    wave = np.zeros((b, n * hop), np.float32)
    for i in range(b):
        wave[i, : ref_frames * hop] = rng.uniform(-0.4, 0.4, ref_frames * hop)
    ref_len = np.full((b,), ref_frames, np.int32)
    total = np.full((b,), n - 8, np.int32)
    ids = np.full((b, n), -1, np.int32)
    ids[:, : n // 2] = 7
    return wave, ref_len, ids, total


@pytest.fixture
def core(tiny_pack_dir):
    engine = vt.TTSEngine(port_config(model_cache_dir=tiny_pack_dir))
    yield engine.engine_core
    engine.cleanup()


def _without_cache(core, *args, **kw):
    core.config.voice_cond_cache = False
    try:
        return core.synthesize_batch(*args, **kw)
    finally:
        core.config.voice_cond_cache = True


class TestCondCache:
    @pytest.mark.parametrize("b, n, ref_frames", [(2, 128, 16), (3, 256, 100), (1, 128, 60)])
    def test_cached_route_is_bit_equal_to_waveform_route(self, core, b, n, ref_frames):
        wave, ref_len, ids, total = _batch(core, b=b, n=n, ref_frames=ref_frames)
        cached = core.synthesize_batch(wave, ref_len, ids, total, seed=1)
        assert core.cond_cache_misses == b
        hit = core.synthesize_batch(wave, ref_len, ids, total, seed=1)
        assert core.cond_cache_hits == b
        direct = _without_cache(core, wave, ref_len, ids, total, seed=1)
        assert cached.dtype == np.int16 and np.abs(cached).max() > 100
        np.testing.assert_array_equal(cached, direct)
        np.testing.assert_array_equal(hit, direct)

    def test_async_dispatch_takes_the_cached_route_too(self, core):
        wave, ref_len, ids, total = _batch(core)
        out = core.synthesize_batch_async(wave, ref_len, ids, total, seed=1)()
        assert core.cond_cache_misses == 2
        np.testing.assert_array_equal(out, _without_cache(core, wave, ref_len, ids, total, seed=1))

    def test_hits_and_misses_counted(self, core):
        wave, ref_len, ids, total = _batch(core, b=2)
        out1 = core.synthesize_batch(wave, ref_len, ids, total, seed=1)
        assert (core.cond_cache_hits, core.cond_cache_misses) == (0, 2)  # two voices
        out2 = core.synthesize_batch(wave, ref_len, ids, total, seed=1)
        assert (core.cond_cache_hits, core.cond_cache_misses) == (2, 2)
        np.testing.assert_array_equal(out1, out2)

    def test_rows_sharing_a_voice_share_one_entry(self, core):
        wave, ref_len, ids, total = _batch(core, b=2)
        wave[1] = wave[0]
        core.synthesize_batch(wave, ref_len, ids, total)
        assert (core.cond_cache_hits, core.cond_cache_misses) == (1, 1)
        assert len(core._cond_cache) == 1

    def test_lru_eviction(self, core):
        core.config.voice_cond_cache_size = 2
        try:
            batches = [_batch(core, b=1, seed=10 + s) for s in range(3)]
            for args in batches:
                core.synthesize_batch(*args)
            assert len(core._cond_cache) == 2 and core.cond_cache_misses == 3
            core.synthesize_batch(*batches[2])  # newest: still there
            assert core.cond_cache_hits == 1
            core.synthesize_batch(*batches[1])  # touch: now the most recent
            core.synthesize_batch(*batches[0])  # evicted first: a miss, evicts 2
            assert (core.cond_cache_hits, core.cond_cache_misses) == (2, 4)
            core.synthesize_batch(*batches[1])
            assert (core.cond_cache_hits, core.cond_cache_misses) == (3, 4)
            core.synthesize_batch(*batches[2])
            assert core.cond_cache_misses == 5
        finally:
            core.config.voice_cond_cache_size = 64

    def test_long_reference_takes_the_waveform_route(self, core):
        """ref_len + margin past the cache window: the cache is not asked."""
        n = 128
        wave, ref_len, ids, total = _batch(core, b=1, n=n, ref_frames=n - 2)
        total[:] = n
        assert not core._cond_eligible(ref_len, n)
        assert core._cond_eligible(np.array([n - 4]), n)  # margin of 4 frames
        out = core.synthesize_batch(wave, ref_len, ids, total)
        assert out.shape == (1, n * core.config.hop_length)
        assert (core.cond_cache_hits, core.cond_cache_misses) == (0, 0)
        assert len(core._cond_cache) == 0

    def test_one_long_reference_sends_the_whole_batch_to_the_waveform_route(self, core):
        wave, ref_len, ids, total = _batch(core, b=2, ref_frames=16)
        ref_len[1] = 126
        core.synthesize_batch(wave, ref_len, ids, total)
        assert core.cond_cache_misses == 0

    def test_disabled_cache_is_never_filled(self, core):
        wave, ref_len, ids, total = _batch(core)
        _without_cache(core, wave, ref_len, ids, total)
        assert len(core._cond_cache) == 0 and core.cond_cache_misses == 0

    def test_window_is_capped_by_config(self, tiny_pack_dir):
        cfg = port_config(model_cache_dir=tiny_pack_dir, voice_cond_frames=64)
        core = vt.TTSEngine(cfg).engine_core
        assert core._cond_cap_frames == 64
        assert core._cond_eligible(np.array([60]), 128)
        assert not core._cond_eligible(np.array([61]), 128)
        wave, ref_len, ids, total = _batch(core, b=1, ref_frames=40)
        cached = core.synthesize_batch(wave, ref_len, ids, total)  # window < bucket: padded
        assert core.cond_cache_misses == 1
        assert next(iter(core._cond_cache.values())).shape == (64, cfg.n_mels)
        np.testing.assert_array_equal(cached, _without_cache(core, wave, ref_len, ids, total))

    def test_output_independent_of_junk_beyond_reference(self, core):
        """Samples past the hashed reference window do not reach the output
        (they only feed masked-out mel rows)."""
        wave, ref_len, ids, total = _batch(core, b=1)
        out1 = core.synthesize_batch(wave, ref_len, ids, total)
        junk = wave.copy()
        junk[0, (int(ref_len[0]) + 4) * core.config.hop_length:] = 0.123
        out2 = core.synthesize_batch(junk, ref_len, ids, total)
        assert core.cond_cache_hits == 1
        np.testing.assert_array_equal(out1, out2)

    def test_engine_requests_hit_after_the_first(self, tiny_pack_dir, tmp_path):
        """Requests for one voice share one entry whatever their text. (Half
        second clips: with a longer reference these texts outgrow this
        config's buckets and the engine trims the reference, each text to
        another length, which is another prefix.)"""
        from vietvoice_tts_tpu_torch.utils.wavio import write_wav

        t = np.arange(12000) / 24000.0
        clips = []
        for name, hz in (("voice.wav", 220.0), ("other.wav", 330.0)):
            clips.append(str(tmp_path / name))
            write_wav((0.4 * np.sin(2 * np.pi * hz * t)).astype(np.float32), clips[-1], 24000)
        engine = vt.TTSEngine(port_config(model_cache_dir=tiny_pack_dir))
        core = engine.engine_core
        voice = dict(reference_audio=clips[0], reference_text="Xin chào.")
        first, _ = engine.synthesize("Xin chào thế giới.", **voice)
        assert (core.cond_cache_hits, core.cond_cache_misses) == (0, 1)
        second, _ = engine.synthesize("Xin chào thế giới.", **voice)
        assert (core.cond_cache_hits, core.cond_cache_misses) == (1, 1)
        np.testing.assert_array_equal(first, second)
        engine.synthesize("Hẹn gặp lại.", **voice)  # another text, another bucket
        assert (core.cond_cache_hits, core.cond_cache_misses) == (2, 1)
        engine.synthesize("Giọng khác.", reference_audio=clips[1], reference_text="Xin chào.")
        assert (core.cond_cache_hits, core.cond_cache_misses) == (2, 2)


class TestAgainstJax:
    def test_cached_mel_matches_the_jax_cores(self, tiny_pack_dir, core):
        """The same waves through both cores' ``_cond_handles``."""
        params = vt.runtime.serialization.load_params(
            f"{tiny_pack_dir}/vietvoice-tpu-v1/params.msgpack")
        jcore = JaxEngineCore(
            tiny_config(model_cache_dir=tiny_pack_dir, transfer_dtype="float32"),
            params, core.vocab_size)
        wave, ref_len, _, _ = _batch(core, b=3, n=256, ref_frames=90, seed=21)
        ours = core._cond_handles(wave, ref_len, 256)
        theirs = jcore._cond_handles(wave, ref_len, 256)
        assert len(ours) == len(theirs) == 3
        assert jcore._cond_cap_frames == core._cond_cap_frames == 256
        assert list(core._cond_cache) == list(jcore._cond_cache)  # the same keys
        for a, b, r in zip(ours, theirs, ref_len):
            a, b = a.numpy(), np.asarray(b)
            assert a.shape == b.shape == (256, 100) and a.dtype == np.float32
            assert np.abs(a[:r]).max() > 1.0
            assert np.abs(a[:r] - b[:r]).max() <= MEL_TOLERANCE
        assert (jcore.cond_cache_hits, jcore.cond_cache_misses) == (
            core.cond_cache_hits, core.cond_cache_misses) == (0, 3)
        for name in ("voice_cond_cache", "voice_cond_cache_size", "voice_cond_frames"):
            assert getattr(core.config, name) == getattr(jcore.config, name)

    def test_eligibility_matches_the_jax_cores(self, tiny_pack_dir, core):
        params = vt.runtime.serialization.load_params(
            f"{tiny_pack_dir}/vietvoice-tpu-v1/params.msgpack")
        jcore = JaxEngineCore(tiny_config(model_cache_dir=tiny_pack_dir), params, core.vocab_size)
        for n in (128, 256):
            for ref in (1, 16, n - 5, n - 4, n - 3, n - 1):
                for other in (8, n - 2):
                    ref_len = np.array([ref, other], np.int32)
                    assert core._cond_eligible(ref_len, n) == jcore._cond_eligible(ref_len, n)


@pytest.mark.parametrize("n_frames", [13, 16, 128, 440])
def test_mel_frames_do_not_depend_on_their_batch(n_frames):
    """A frame's mel is the same bits alone, in a batch, and in a longer
    zero-padded wave (what makes the cache exact), for any wave of more than
    one tile of 8 frames, which every frame bucket is."""
    fe = MelFrontend()
    rng = np.random.default_rng(n_frames)
    wave = torch.from_numpy(rng.uniform(-0.5, 0.5, (3, n_frames * 256)).astype(np.float32))
    both = fe(wave)
    assert both.shape == (3, n_frames, 100)
    assert torch.equal(both[1], fe(wave[1:2])[0])
    longer = torch.zeros((1, (n_frames + 64) * 256))
    longer[0, : n_frames * 256] = wave[2]
    # Frames that end before the waves part (a frame reaches 2 hops ahead).
    assert torch.equal(both[2, : n_frames - 2], fe(longer)[0, : n_frames - 2])
