"""C++ audio DSP library of the PyTorch port (``vietvoice_tts_tpu_torch/native/``):
the JAX package's ``tests/test_native.py`` case for case — built on demand,
numerically the numpy path within 1 LSB — plus the first-use build, the join
counter and the streamed join."""

import numpy as np
import pytest

from vietvoice_tts_tpu_torch.native import audio_native, build as native_build
from vietvoice_tts_tpu_torch.pipeline.audio import AudioProcessor


@pytest.fixture(scope="module")
def native():
    if native_build.find_gxx() is None:
        pytest.skip("no C++ toolchain available")
    assert audio_native.available()
    return audio_native


def _numpy_crossfade(waves, dur, sr):
    """The numpy path, with the native hook disabled."""
    import vietvoice_tts_tpu_torch.pipeline.audio as pa

    orig = pa._native_dsp
    pa._native_dsp = lambda: None
    try:
        return AudioProcessor.concatenate_with_crossfade_improved(waves, dur, sr)
    finally:
        pa._native_dsp = orig


class TestNativeCrossfade:
    def _waves(self, n, length=24000, seed=0):
        rng = np.random.default_rng(seed)
        return [
            (rng.uniform(-0.4, 0.4, length) * 32767).astype(np.int16)
            for _ in range(n)
        ]

    def test_matches_numpy_within_1_lsb(self, native):
        waves = self._waves(4)
        nat = native.crossfade_concat(waves, 0.1, 24000)
        ref = _numpy_crossfade(waves, 0.1, 24000)
        assert len(nat) == len(ref)
        assert np.abs(nat.astype(np.int32) - ref.astype(np.int32)).max() <= 1

    def test_single_wave(self, native):
        waves = self._waves(1)
        nat = native.crossfade_concat(waves, 0.1, 24000)
        np.testing.assert_array_equal(nat, waves[0])

    def test_clipped_input_rescaled(self, native):
        w = np.full(24000, 32767, np.int16)
        nat = native.crossfade_concat([w, self._waves(1)[0]], 0.1, 24000)
        assert np.abs(nat[:1000].astype(np.int32)).max() <= 26215

    def test_quiet_overlap_skips_rms_matching(self, native):
        quiet = np.zeros(24000, np.int16)
        waves = [quiet, self._waves(1)[0]]
        nat = native.crossfade_concat(waves, 0.1, 24000)
        ref = _numpy_crossfade(waves, 0.1, 24000)
        assert np.abs(nat.astype(np.int32) - ref.astype(np.int32)).max() <= 1

    def test_engine_path_uses_native(self, native):
        """AudioProcessor dispatches to the native lib when built."""
        waves = self._waves(3, seed=1)
        out = AudioProcessor.concatenate_with_crossfade_improved(waves, 0.05, 24000)
        ref = _numpy_crossfade(waves, 0.05, 24000)
        assert np.abs(out.astype(np.int32) - ref.astype(np.int32)).max() <= 1

    def test_stream_uses_native_and_equals_batch(self, native):
        """The streamed pairwise join goes through the library and gives the
        all-at-once result bit for bit; the join counter moves by one per
        pair."""
        waves = self._waves(3, seed=2)
        before = native.joins
        pieces = list(AudioProcessor.stream_with_crossfade(iter(waves), 0.1, 24000))
        assert native.joins - before == 2
        batch = AudioProcessor.concatenate_with_crossfade_improved(waves, 0.1, 24000)
        assert native.joins - before == 4
        np.testing.assert_array_equal(np.concatenate(pieces), batch)


class TestBuild:
    def test_library_keyed_by_source_and_flags(self, tmp_path, monkeypatch):
        """An edited source builds a new library beside the old one; an
        unchanged one is reused without a compile."""
        if native_build.find_gxx() is None:
            pytest.skip("no C++ toolchain available")
        src = tmp_path / "audio_kernels.cpp"
        src.write_text(native_build.SRC.read_text())
        monkeypatch.setattr(native_build, "SRC", src)
        monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "build")
        first = native_build.build()
        assert first.exists() and first.parent == tmp_path / "build"
        mtime = first.stat().st_mtime_ns
        assert native_build.build() == first and first.stat().st_mtime_ns == mtime
        src.write_text(src.read_text() + "\n// edited\n")
        second = native_build.build()
        assert second != first and second.exists()

    def test_failed_build_raises(self, tmp_path, monkeypatch):
        """With g++ present a broken source raises instead of letting numpy
        stand in silently."""
        if native_build.find_gxx() is None:
            pytest.skip("no C++ toolchain available")
        src = tmp_path / "audio_kernels.cpp"
        src.write_text("this is not C++\n")
        monkeypatch.setattr(native_build, "SRC", src)
        monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "build")
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            native_build.build()
        assert not list((tmp_path / "build").glob("*.so"))

    def test_without_gxx_numpy_serves(self, tmp_path, monkeypatch):
        """No compiler (and no built library): available() is False and the
        cross-fade runs in numpy."""
        monkeypatch.setattr(native_build, "find_gxx", lambda: None)
        monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "none")
        monkeypatch.setattr(audio_native, "_lib", None)
        monkeypatch.setattr(audio_native, "_loaded", False)
        assert not audio_native.available()
        before = audio_native.joins
        rng = np.random.default_rng(3)
        waves = [(rng.uniform(-0.4, 0.4, 24000) * 32767).astype(np.int16) for _ in range(2)]
        out = AudioProcessor.concatenate_with_crossfade_improved(waves, 0.1, 24000)
        assert len(out) == 48000 - 2400 and audio_native.joins == before
