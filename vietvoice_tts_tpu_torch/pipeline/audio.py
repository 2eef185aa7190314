"""Audio I/O and host-side DSP.

A copy of ``vietvoice_tts_tpu/pipeline/audio.py``. The cross-fade runs in
the C++ host library (``native/``, built with ``g++`` at first use) and in
numpy where the host has no ``g++``; the two agree within 1 LSB. Behavioral
parity with the reference's ``AudioProcessor``
(``vietvoicetts/core/audio_processor.py:12-193``): load/mono/resample →
int16 normalize, clipped-audio repair, WAV save, the linear cross-fade
(``concatenate_with_crossfade``) and the equal-power cross-fade with RMS
matching, all at once
(``concatenate_with_crossfade_improved``) or chunk by chunk as a stream
(``stream_with_crossfade``).
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..utils.logging import get_logger
from ..utils.wavio import read_wav, write_wav

log = get_logger("audio")

INT16_MAX = 32767.0
PEAK_TARGET = 29491.0  # 90% of int16 range (reference audio_processor.py:39)
CLIP_RESCALE = 26214.0  # 80% of int16 range (reference audio_processor.py:56)


def _native_dsp():
    """The ctypes-bound C++ DSP module, or None where the host has no g++
    (a library that fails to build raises)."""
    from ..native import audio_native

    return audio_native if audio_native.available() else None


def _crossfade_pair(prev: np.ndarray, nxt: np.ndarray, n_fade: int) -> np.ndarray:
    """Join two int16 waves with an equal-power cross-fade over at most
    ``n_fade`` samples, after matching ``nxt``'s RMS to ``prev``'s in the
    overlap (ratio clamped to [0.7, 1.5])."""
    n = min(n_fade, len(prev), len(nxt))
    if n <= 0:
        return np.concatenate([prev, nxt])
    prev_overlap = prev[-n:].astype(np.float32)
    next_overlap = nxt[:n].astype(np.float32)
    prev_rms = np.sqrt(np.mean(prev_overlap**2))
    next_rms = np.sqrt(np.mean(next_overlap**2))
    if prev_rms > 100 and next_rms > 100:
        ratio = float(np.clip(prev_rms / next_rms, 0.7, 1.5))
        nxt = (nxt.astype(np.float32) * ratio).astype(np.int16)
        next_overlap = nxt[:n].astype(np.float32)
    theta = np.linspace(0.0, np.pi / 2, n)
    overlap = (
        prev_overlap * np.cos(theta) ** 2 + next_overlap * np.sin(theta) ** 2
    ).astype(np.int16)
    return np.concatenate([prev[:-n], overlap, nxt[n:]])


class AudioProcessor:
    """Host-side audio operations (all static methods, like the reference)."""

    @staticmethod
    def load_audio(path_or_bytes: str | bytes, sample_rate: int) -> np.ndarray:
        """Load any supported audio → mono, resampled, int16-normalized."""
        samples, sr = read_wav(path_or_bytes)
        mono = samples.mean(axis=1)
        if sr != sample_rate:
            from math import gcd

            # Imported here: scipy.signal takes seconds to import, and every
            # rank of a mesh imports this module.
            from scipy.signal import resample_poly

            g = gcd(sr, sample_rate)
            mono = resample_poly(mono, sample_rate // g, sr // g).astype(np.float32)
        return AudioProcessor.normalize_to_int16(mono)

    @staticmethod
    def normalize_to_int16(audio: np.ndarray) -> np.ndarray:
        """DC-offset removal + peak scaling to 90% of int16 range
        (reference audio_processor.py:29-44)."""
        audio = np.asarray(audio, dtype=np.float32)
        audio = audio - audio.mean()
        max_val = np.abs(audio).max() if audio.size else 0.0
        if max_val > 0:
            audio = audio * (PEAK_TARGET / max_val)
        return audio.astype(np.int16)

    @staticmethod
    def fix_clipped_audio(audio: np.ndarray) -> np.ndarray:
        """NaN/Inf → 0; rescale to 80% range when clipped
        (reference audio_processor.py:47-58)."""
        audio = np.nan_to_num(audio, nan=0.0, posinf=0.0, neginf=0.0)
        max_val = np.abs(audio).max() if audio.size else 0.0
        if max_val >= INT16_MAX:
            return (audio * (CLIP_RESCALE / max_val)).astype(np.int16)
        return audio

    @staticmethod
    def save_audio(audio: np.ndarray, file_path: str, sample_rate: int) -> None:
        """Write 16-bit PCM WAV, creating parent dirs
        (reference audio_processor.py:61-67)."""
        write_wav(np.asarray(audio).reshape(-1), file_path, sample_rate)

    @staticmethod
    def concatenate_with_crossfade(
        generated_waves: List[np.ndarray],
        cross_fade_duration: float,
        sample_rate: int,
    ) -> np.ndarray:
        """Linear-fade concatenation (reference audio_processor.py:70-120)."""
        if not generated_waves:
            return np.array([])
        waves = [np.asarray(w).reshape(-1) for w in generated_waves]
        if len(waves) == 1:
            return waves[0]
        if cross_fade_duration <= 0:
            return np.concatenate(waves)
        final = waves[0]
        for nxt in waves[1:]:
            n = min(int(cross_fade_duration * sample_rate), len(final), len(nxt))
            if n <= 0:
                final = np.concatenate([final, nxt])
                continue
            fade_out = np.linspace(1.0, 0.0, n)
            fade_in = np.linspace(0.0, 1.0, n)
            overlap = final[-n:] * fade_out + nxt[:n] * fade_in
            final = np.concatenate([final[:-n], overlap, nxt[n:]])
        return final

    @staticmethod
    def concatenate_with_crossfade_improved(
        generated_waves: List[np.ndarray],
        cross_fade_duration: float,
        sample_rate: int,
    ) -> np.ndarray:
        """Equal-power cross-fade with per-chunk clip repair and RMS volume
        matching clamped to [0.7, 1.5] (reference audio_processor.py:123-193).
        """
        if not generated_waves:
            return np.array([])
        waves = [
            AudioProcessor.fix_clipped_audio(np.asarray(w).reshape(-1))
            for w in generated_waves
        ]
        if len(waves) == 1:
            return waves[0]
        if cross_fade_duration <= 0:
            return np.concatenate(waves)

        native = _native_dsp()
        if native is not None:
            return native.crossfade_concat(waves, cross_fade_duration, sample_rate)

        final = waves[0]
        for nxt in waves[1:]:
            final = _crossfade_pair(final, nxt, int(cross_fade_duration * sample_rate))
        return final

    @staticmethod
    def stream_with_crossfade(chunks, cross_fade_duration: float, sample_rate: int):
        """Incremental equal-power cross-fade: the same math as
        ``concatenate_with_crossfade_improved`` (and bit-identical output for
        chunks longer than twice the fade window, i.e. any real chunk:
        ``min_target_duration`` is 1 s against a 0.1 s fade), but yields
        audio as each chunk arrives. Each emitted piece is final: only the
        fade window is held back, and it is exactly what the next pairwise
        join needs.

        ``chunks`` is any iterable of int16 arrays (typically a generator
        pulling completed device batches). Yields int16 arrays."""
        n_fade = int(cross_fade_duration * sample_rate)
        native = _native_dsp()
        tail: np.ndarray | None = None
        for raw in chunks:
            w = AudioProcessor.fix_clipped_audio(np.asarray(raw).reshape(-1))
            if tail is None:
                merged = w
            elif native is not None and min(n_fade, len(tail), len(w)) > 0:
                # Pairwise native join (the same C++ fold as the batch path).
                merged = native.crossfade_concat([tail, w], cross_fade_duration, sample_rate)
            else:
                merged = _crossfade_pair(tail, w, n_fade)
            hold = min(n_fade, len(merged))
            if len(merged) > hold:
                yield merged[: len(merged) - hold]
            tail = merged[len(merged) - hold :]
        if tail is not None and len(tail):
            yield tail
