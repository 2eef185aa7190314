"""High-level client API (port of ``vietvoice_tts_tpu/client.py``).

Mirrors the reference ``TTSApi``: lazy engine, context manager,
``synthesize`` / ``synthesize_streaming`` / ``synthesize_to_file`` /
``synthesize_to_bytes`` / ``validate_configuration``; WAV bytes are encoded
in memory.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .config import ModelConfig
from .pipeline.engine import TTSEngine
from .utils.wavio import wav_bytes


class TTSApi:
    """High-level API for VietVoice TTS on PyTorch."""

    def __init__(self, config: Optional[ModelConfig] = None):
        self.config = config or ModelConfig()
        self._engine: Optional[TTSEngine] = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.cleanup()

    @property
    def engine(self) -> TTSEngine:
        if self._engine is None:
            self._engine = TTSEngine(self.config)
        return self._engine

    def synthesize(
        self,
        text: str,
        gender: Optional[str] = None,
        group: Optional[str] = None,
        area: Optional[str] = None,
        emotion: Optional[str] = None,
        sample_iteration: Optional[int] = None,
        output_path: Optional[str] = None,
        reference_audio: Optional[str] = None,
        reference_text: Optional[str] = None,
        speed: Optional[float] = None,
    ) -> Tuple[np.ndarray, float]:
        """Synthesize speech → (int16 waveform, generation_time_seconds)."""
        if text is None:
            raise ValueError("Text cannot be None")
        return self.engine.synthesize(
            text=text,
            gender=gender,
            group=group,
            area=area,
            emotion=emotion,
            sample_iteration=sample_iteration,
            output_path=output_path,
            reference_audio=reference_audio,
            reference_text=reference_text,
            speed=speed,
        )

    def synthesize_streaming(
        self,
        text: str,
        gender: Optional[str] = None,
        group: Optional[str] = None,
        area: Optional[str] = None,
        emotion: Optional[str] = None,
        sample_iteration: Optional[int] = None,
        reference_audio: Optional[str] = None,
        reference_text: Optional[str] = None,
        speed: Optional[float] = None,
        first_chunk_duration: Optional[float] = None,
    ):
        """Stream synthesis: yields int16 waveform pieces as chunks finish.

        The concatenated pieces are ``synthesize()``'s waveform (see
        ``TTSEngine.synthesize_streaming`` for how exactly); the first piece
        arrives after one chunk's latency. ``first_chunk_duration`` caps the
        head chunk for a faster first piece; the chunking then differs from
        the blocking output's."""
        if text is None:
            raise ValueError("Text cannot be None")
        return self.engine.synthesize_streaming(
            text=text,
            gender=gender,
            group=group,
            area=area,
            emotion=emotion,
            sample_iteration=sample_iteration,
            reference_audio=reference_audio,
            reference_text=reference_text,
            speed=speed,
            first_chunk_duration=first_chunk_duration,
        )

    def synthesize_to_file(
        self,
        text: str,
        output_path: str,
        gender: Optional[str] = None,
        group: Optional[str] = None,
        area: Optional[str] = None,
        emotion: Optional[str] = None,
        sample_iteration: Optional[int] = None,
        reference_audio: Optional[str] = None,
        reference_text: Optional[str] = None,
    ) -> float:
        """Synthesize and save to ``output_path`` → generation time (s)."""
        _, generation_time = self.synthesize(
            text=text,
            output_path=output_path,
            gender=gender,
            group=group,
            area=area,
            emotion=emotion,
            sample_iteration=sample_iteration,
            reference_audio=reference_audio,
            reference_text=reference_text,
        )
        return generation_time

    def synthesize_to_bytes(
        self,
        text: str,
        gender: Optional[str] = None,
        group: Optional[str] = None,
        area: Optional[str] = None,
        emotion: Optional[str] = None,
        sample_iteration: Optional[int] = None,
        reference_audio: Optional[str] = None,
        reference_text: Optional[str] = None,
        speed: Optional[float] = None,
    ) -> Tuple[bytes, float]:
        """Synthesize → (WAV bytes, generation_time_seconds), fully in memory."""
        wave, generation_time = self.synthesize(
            text=text,
            gender=gender,
            group=group,
            area=area,
            emotion=emotion,
            sample_iteration=sample_iteration,
            reference_audio=reference_audio,
            reference_text=reference_text,
            speed=speed,
        )
        return wav_bytes(wave, self.config.sample_rate), generation_time

    def validate_configuration(self, reference_audio: Optional[str] = None) -> bool:
        return self.engine.validate_configuration(reference_audio)

    def cleanup(self) -> None:
        if self._engine:
            self._engine.cleanup()
            self._engine = None
