"""Async engine wrapper for the REST API (port of
``vietvoice_tts_tpu/api/tts_engine.py``).

A lazily-initialized process-wide ``TTSApi`` singleton, with the blocking
synthesis call moved off the event loop via ``anyio.to_thread``. Speed is a
per-request argument (the shared config is never mutated around a call) and
the duration is computed from the decoded sample count.

The engine runs on ``settings.DEVICE`` (``VIETVOICE_DEVICE``, default
``cuda``): without a card the configuration raises, and so does the first
request and the server's start. With ``settings.MICRO_BATCHING`` (default
on) the engine gets its micro-batcher as it loads, so concurrent requests
share device batches.
"""

from __future__ import annotations

import threading
from typing import Optional

from anyio import to_thread

from ..client import TTSApi
from ..config import ModelConfig
from ..utils.logging import get_logger
from .schemas import Area, Emotion, Gender, Group
from .settings import settings as _settings

log = get_logger("api.engine")

_engine: Optional[TTSApi] = None
_engine_lock = threading.Lock()
# Built at first use, not at import: asking for CUDA on a machine without it
# raises, and importing the app must not. Tests set it to a small config.
_engine_config: Optional[ModelConfig] = None


def get_engine_config() -> ModelConfig:
    """The server's model configuration.

    Server-side default: refuse synthetic packs unless
    ``VIETVOICE_ALLOW_SYNTHETIC`` opts in (api/settings.py) — a server
    quietly producing random-weight noise with HTTP 200 is worse than one
    that fails to start."""
    global _engine_config
    if _engine_config is None:
        _engine_config = ModelConfig(
            allow_synthetic_pack=_settings.ALLOW_SYNTHETIC, device=_settings.DEVICE
        )
    return _engine_config


def get_tts_engine() -> TTSApi:
    """Lazily-initialized singleton (model loads on first request; gathered
    first requests load it once)."""
    global _engine
    with _engine_lock:
        if _engine is None:
            log.info("Initializing TTS engine for the first time...")
            try:
                api = TTSApi(get_engine_config())
                if _settings.MICRO_BATCHING:
                    api.engine.enable_micro_batching()
            except Exception as e:  # noqa: BLE001 — startup boundary
                log.error("Fatal error during TTS engine initialization: %s", e)
                raise RuntimeError(f"Could not initialize TTS Engine: {e}") from e
            _engine = api
            log.info("TTS engine initialized successfully on %s.", api.config.device)
        return _engine


def reset_engine() -> None:
    """Drop the singleton (used by tests and reload)."""
    global _engine
    if _engine is not None:
        _engine.cleanup()
    _engine = None


def _voice(engine: TTSApi, gender, group, area, emotion) -> dict:
    cfg = engine.config
    return dict(
        gender=gender.value if gender else cfg.gender,
        group=group.value if group else cfg.group,
        area=area.value if area else cfg.area,
        emotion=emotion.value if emotion else cfg.emotion,
    )


async def synthesize_async(
    text: str,
    speed: float,
    gender: Gender | None,
    group: Group | None,
    area: Area | None,
    emotion: Emotion | None,
    sample_iteration: int | None,
) -> tuple[bytes, int, float]:
    """Synthesize on a worker thread → (wav_bytes, sample_rate, duration_s)."""
    try:

        def _call():
            # The first request loads the model: off the event loop too.
            engine = get_tts_engine()
            return engine, engine.synthesize_to_bytes(
                text,
                **_voice(engine, gender, group, area, emotion),
                sample_iteration=sample_iteration,
                speed=speed,
            )

        engine, (audio_bytes, _gen_time) = await to_thread.run_sync(_call)
        sample_rate = engine.config.sample_rate
        # 16-bit PCM mono with a 44-byte header.
        duration_seconds = max(len(audio_bytes) - 44, 0) / (sample_rate * 2)
        return audio_bytes, sample_rate, duration_seconds
    except Exception as e:  # noqa: BLE001 — handler converts to 500
        log.error("Error during synthesis: %s", e)
        raise


async def synthesize_stream_async(
    text: str,
    speed: float,
    gender: Gender | None,
    group: Group | None,
    area: Area | None,
    emotion: Emotion | None,
    sample_iteration: int | None,
    first_chunk_duration: float | None = None,
):
    """Async byte stream: a streaming-WAV header, then PCM pieces as each
    chunk finishes on the device. Each blocking ``next()`` on the underlying
    generator runs on a worker thread, so the event loop serves other
    requests between pieces."""
    from ..utils.wavio import wav_stream_header

    engine = await to_thread.run_sync(get_tts_engine)
    gen = engine.synthesize_streaming(
        text,
        **_voice(engine, gender, group, area, emotion),
        sample_iteration=sample_iteration,
        speed=speed,
        first_chunk_duration=first_chunk_duration,
    )
    yield wav_stream_header(engine.config.sample_rate)
    sentinel = object()
    while True:
        try:
            piece = await to_thread.run_sync(next, gen, sentinel)
        except Exception as e:  # noqa: BLE001 — mid-stream failure
            log.error("Error during streaming synthesis: %s", e)
            raise
        if piece is sentinel:
            break
        yield piece.astype("<i2").tobytes()
