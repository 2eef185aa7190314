"""REST API application (port of ``vietvoice_tts_tpu/api/app.py``): the
reference's five routes on our ASGI framework, plus streaming, stats, voices
and Prometheus metrics.

Route-for-route parity with ``vietvoicetts/api/app.py``:

- ``GET  /api/v1/health``                (:37) status + uptime
- ``POST /api/v1/synthesize``            (:43) stream WAV bytes inline
- ``POST /api/v1/synthesize/file``       (:68) write temp file, return URL
- ``GET  /api/v1/download/{file_id}``    (:104) download, 404 when expired
- ``POST /api/v1/synthesize/download``   (:121) attachment stream + cleanup
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from time import monotonic
from typing import Any, Dict
from uuid import uuid4

import anyio

from ..utils.logging import get_logger
from .asgi import App, File, HTTPException, NotFoundException, Response, Stream
from .schemas import (
    HealthResponse,
    StatsResponse,
    SynthesizeFileResponse,
    StreamSynthesizeRequest,
    SynthesizeRequest,
    VoiceEntry,
    VoicesResponse,
)
from .settings import settings
from .tts_engine import synthesize_async

from ..deterministic import freeze_all_seeds

freeze_all_seeds()  # at import, like the reference

log = get_logger("api.app")

TMP_DIR = settings.TMP_DIR_PATH
TMP_DIR.mkdir(parents=True, exist_ok=True)
FILE_LIFESPAN = settings.FILE_LIFESPAN_SECONDS

# In-memory file registry (reference app.py:28-31 carries the same
# restart-loses-state caveat; swap for redis/etc. in a multi-worker deploy).
_file_cache: Dict[str, Dict[str, Any]] = {}
_server_start_time = monotonic()

app = App()


def _warmup_in_background() -> None:
    """Load the engine and run every (batch, bucket) shape once off the
    request path. Enabled with WARMUP_ON_START=1; first requests then pay
    neither the model load nor the kernels' build and the libraries' first
    use."""
    import threading

    def work():
        try:
            from .tts_engine import get_tts_engine

            get_tts_engine().engine.warmup()
            log.info("Warmup complete: every serving shape has run once")
        except Exception as e:  # noqa: BLE001 — warmup is best-effort
            log.error("Warmup failed: %s", e)

    threading.Thread(target=work, daemon=True, name="vv-warmup").start()


if settings.WARMUP_ON_START:  # pragma: no cover — deploy-time switch
    _warmup_in_background()


@app.get("/schema/openapi.json")
async def openapi_document() -> Response:
    """Machine-readable OpenAPI 3.1 description of this API (the surface
    Litestar auto-generates for the reference at ``/schema``,
    ``vietvoicetts/api/app.py:166-168``)."""
    import json as _json

    from .asgi import openapi_schema

    doc = openapi_schema(
        app,
        title="VietVoice TTS API",
        version="1.0.0",
        description="Vietnamese text-to-speech synthesis (PyTorch / CUDA serving stack).",
    )
    return Response(_json.dumps(doc), media_type="application/json")


@app.get("/schema")
async def schema_page() -> Response:
    """Human-visiting entry for the API docs: points at the JSON document
    (the reference's Litestar serves interactive docs here; this build has
    no CDN assets, so the document itself is the interface)."""
    return Response(
        "<html><body><h1>VietVoice TTS API</h1>"
        '<p>OpenAPI 3.1 document: <a href="/schema/openapi.json">'
        "/schema/openapi.json</a></p></body></html>",
        media_type="text/html",
    )


@app.get("/api/v1/health")
async def health() -> HealthResponse:
    """Health check for load balancers and monitors."""
    import torch

    from . import tts_engine as te

    device_type = torch.device(settings.DEVICE).type
    synthetic = None
    batcher_healthy = None
    last_error = None
    if te._engine is not None and te._engine._engine is not None:
        engine = te._engine._engine
        device_type = engine.engine_core.device.type
        synthetic = engine.model_session_manager.is_synthetic
        if engine.batcher is not None:
            # Self-healing probe: a dead worker thread is restarted off the
            # event loop (repair joins threads for up to ~10 s — blocking the
            # loop would freeze every other request), and THIS response
            # reports degraded so monitors see the incident even though
            # recovery is already underway.
            batcher_healthy = engine.batcher.healthy
            if not batcher_healthy:
                await anyio.to_thread.run_sync(engine.batcher.ensure_running)
            last_error = engine.batcher.last_error
    return HealthResponse(
        status="healthy" if batcher_healthy in (None, True) else "degraded",
        uptime=int(monotonic() - _server_start_time),
        backend=device_type,
        device_count=torch.cuda.device_count() if device_type == "cuda" else 1,
        engine_loaded=te._engine is not None,
        synthetic_weights=synthetic,
        batcher_healthy=batcher_healthy,
        last_error=last_error,
    )


@app.get("/api/v1/stats")
async def stats() -> StatsResponse:
    """Per-stage wall time, micro-batcher efficiency, the voice-conditioning
    cache's counters and the device's memory (``hbm``, the key the JAX
    package's route has; ``None`` on the CPU)."""
    from ..utils.profiling import device_memory_stats
    from . import tts_engine as te

    stage, batcher, cond_cache = {}, None, None
    if te._engine is not None and te._engine._engine is not None:
        engine = te._engine._engine
        stage = engine.engine_core.timer.report()
        core = engine.engine_core
        cond_cache = {
            "hits": core.cond_cache_hits,
            "misses": core.cond_cache_misses,
            "entries": len(core._cond_cache),
        }
        if engine.batcher is not None:
            b = engine.batcher.stats
            batcher = {
                "batches": b.batches,
                "jobs": b.jobs,
                "padded_rows": b.padded_rows,
                "mean_batch_size": round(b.mean_batch_size, 2),
                "retries": b.retries,
                "failures": b.failures,
            }
    return StatsResponse(
        stage_seconds={k: round(v, 3) for k, v in stage.items()},
        batcher=batcher,
        cond_cache=cond_cache,
        hbm=device_memory_stats() or None,
    )


@app.get("/api/v1/voices")
async def voices(query) -> VoicesResponse:
    """Browse the bundled voice catalog over HTTP (beyond-reference: the
    reference only documents the four enums; the real 239-row catalog is
    bundled in-repo). Query filters: ``gender``, ``group``, ``area``,
    ``emotion`` (case-insensitive exact match), ``limit``/``offset`` for
    paging. ``clip_available`` says whether the audio clip exists locally
    (clips arrive with the weight tarball)."""
    from ..reference_samples import (
        catalog_audio_bases,
        filter_samples,
        get_sample_path,
        load_reference_samples,
    )

    filters = {
        k: query[k] for k in ("gender", "group", "area", "emotion") if query.get(k)
    }
    try:
        limit = max(0, min(int(query.get("limit", 50)), 500))
        offset = max(0, int(query.get("offset", 0)))
    except ValueError:
        raise HTTPException(422, "limit/offset must be integers")
    samples = filter_samples(load_reference_samples(), **filters)
    page = samples[offset : offset + limit]
    bases = catalog_audio_bases()  # one cache glob per request, not per row
    return VoicesResponse(
        total=len(samples),
        filters=filters,
        voices=[
            VoiceEntry(
                filename=s.filename,
                gender=s.gender,
                group=s.group,
                area=s.area,
                emotion=s.emotion,
                text=s.text,
                clip_available=get_sample_path(s, bases).exists(),
            )
            for s in page
        ],
    )


@app.get("/metrics")
async def metrics() -> Response:
    """Prometheus text exposition of the serving counters.

    The same numbers `/api/v1/stats` reports, in the scrape format, so a
    standard Prometheus + alerting stack works against the server with zero
    adapters."""
    from ..utils.profiling import device_memory_stats
    from . import tts_engine as te

    lines = [
        "# HELP vietvoice_uptime_seconds Server uptime.",
        "# TYPE vietvoice_uptime_seconds gauge",
        f"vietvoice_uptime_seconds {monotonic() - _server_start_time:.1f}",
    ]

    def emit(name: str, help_text: str, value) -> None:
        # Prometheus TYPE by naming convention: *_total are monotonic
        # counters, everything else (cache entries, health bits, device memory) is a
        # gauge — values that can go down must not carry counter semantics.
        lines.append(f"# HELP vietvoice_{name} {help_text}")
        kind = "counter" if name.endswith("_total") else "gauge"
        lines.append(f"# TYPE vietvoice_{name} {kind}")
        lines.append(f"vietvoice_{name} {value}")

    engine_loaded = te._engine is not None and te._engine._engine is not None
    emit("engine_loaded", "1 when the model is resident.", int(engine_loaded))
    if engine_loaded:
        engine = te._engine._engine
        stages = engine.engine_core.timer.report()
        if stages:
            lines.append(
                "# HELP vietvoice_stage_seconds_total Cumulative seconds per pipeline stage."
            )
            lines.append("# TYPE vietvoice_stage_seconds_total counter")
            for stage, seconds in stages.items():
                lines.append(
                    f'vietvoice_stage_seconds_total{{stage="{stage}"}} {seconds:.3f}'
                )
        core = engine.engine_core
        emit("cond_cache_hits_total", "Voice-conditioning cache hits.", core.cond_cache_hits)
        emit("cond_cache_misses_total", "Voice-conditioning cache misses.", core.cond_cache_misses)
        emit("cond_cache_entries", "Voice-conditioning cache entries.", len(core._cond_cache))
        b = engine.batcher
        if b is not None:
            s = b.stats
            emit("batches_total", "Dispatched device batches.", s.batches)
            emit("batch_jobs_total", "Jobs served through batches.", s.jobs)
            emit("batch_padded_rows_total", "Padding rows dispatched.", s.padded_rows)
            emit("batch_retries_total", "Jobs re-queued after batch errors.", s.retries)
            emit("batch_failures_total", "Jobs failed after retries.", s.failures)
            emit("batcher_healthy", "1 when both worker threads live.", int(b.healthy))
        hbm = device_memory_stats()
        if hbm:
            for k, v in hbm.items():
                if isinstance(v, (int, float)):
                    emit(f"hbm_{k}", f"Device memory stat {k}.", v)
    return Response(
        "\n".join(lines) + "\n", media_type="text/plain; version=0.0.4"
    )


@app.post("/api/v1/synthesize")
async def synthesize_stream(data: SynthesizeRequest) -> Stream:
    """Synthesize and stream the audio bytes inline."""
    audio_bytes, _, _ = await synthesize_async(
        text=data.text,
        speed=data.speed,
        gender=data.gender,
        group=data.group,
        area=data.area,
        emotion=data.emotion,
        sample_iteration=data.sample_iteration,
    )
    return Stream(
        content=iter([audio_bytes]),
        media_type=f"audio/{data.output_format}",
        headers={
            "Content-Disposition": f'inline; filename="speech.{data.output_format}"'
        },
    )


@app.post("/api/v1/synthesize/stream")
async def synthesize_stream_chunks(data: StreamSynthesizeRequest) -> Stream:
    """Stream audio chunk-by-chunk as synthesis progresses (beyond-reference
    route): a streaming-WAV header followed by PCM pieces, so long texts
    start playing after the FIRST chunk's latency instead of the whole
    utterance's. Chunked transfer; the total PCM is /synthesize's payload
    (``TTSEngine.synthesize_streaming`` says how exactly) unless
    ``first_chunk_duration`` re-chunks the head for a faster first piece."""
    from .tts_engine import synthesize_stream_async

    return Stream(
        content=synthesize_stream_async(
            text=data.text,
            speed=data.speed,
            gender=data.gender,
            group=data.group,
            area=data.area,
            emotion=data.emotion,
            sample_iteration=data.sample_iteration,
            first_chunk_duration=data.first_chunk_duration,
        ),
        media_type="audio/wav",
        headers={"Content-Disposition": 'inline; filename="speech.wav"'},
    )


@app.post("/api/v1/synthesize/file")
async def synthesize_to_file(data: SynthesizeRequest) -> SynthesizeFileResponse:
    """Synthesize to a temp file and return a download URL + metadata."""
    audio_bytes, sr, dur = await synthesize_async(
        text=data.text,
        speed=data.speed,
        gender=data.gender,
        group=data.group,
        area=data.area,
        emotion=data.emotion,
        sample_iteration=data.sample_iteration,
    )
    file_id = uuid4().hex[:10]
    file_path = TMP_DIR / f"{file_id}.{data.output_format}"
    # Off the event loop — parity with the reference's aiofiles write
    # (vietvoicetts/api/app.py:83-94); the only blocking I/O otherwise left
    # in the async path.
    await anyio.to_thread.run_sync(file_path.write_bytes, audio_bytes)
    _file_cache[file_id] = {"path": file_path, "format": data.output_format}
    return SynthesizeFileResponse(
        download_url=f"/api/v1/download/{file_id}",
        duration_seconds=round(dur, 2),
        sample_rate=sr,
        format=data.output_format,
        file_size_bytes=len(audio_bytes),
    )


@app.get("/api/v1/download/{file_id}")
async def download_file(file_id: str) -> File:
    """Serve a previously generated file; 404 when unknown or expired."""
    cached = _file_cache.get(file_id)
    if not cached or not cached["path"].exists():
        raise NotFoundException(f"File with ID '{file_id}' not found or has expired.")
    return File(
        path=cached["path"],
        media_type=f"audio/{cached['format']}",
        filename=f"speech_{file_id}.{cached['format']}",
        content_disposition_type="attachment",
    )


@app.post("/api/v1/synthesize/download")
async def synthesize_and_download(data: SynthesizeRequest) -> Stream:
    """Synthesize and stream as an attachment; cleans old files afterwards."""
    audio_bytes, _, _ = await synthesize_async(
        text=data.text,
        speed=data.speed,
        gender=data.gender,
        group=data.group,
        area=data.area,
        emotion=data.emotion,
        sample_iteration=data.sample_iteration,
    )

    async def cleanup_task():
        await cleanup_old_files(TMP_DIR)

    return Stream(
        content=iter([audio_bytes]),
        media_type=f"audio/{data.output_format}",
        headers={"Content-Disposition": 'attachment; filename="synthesis_result.wav"'},
        background=cleanup_task,
    )


async def cleanup_old_files(directory: Path) -> None:
    """Delete files older than FILE_LIFESPAN seconds."""
    log.info("Running cleanup task on directory: %s", directory)
    now = time.time()
    for filename in os.listdir(directory):
        file_path = directory / filename
        if file_path.is_file():
            try:
                if now - os.path.getmtime(file_path) > FILE_LIFESPAN:
                    os.remove(file_path)
                    log.info("Deleted old file: %s", file_path)
            except (OSError, FileNotFoundError) as e:
                log.warning("Error deleting file %s: %s", file_path, e)
