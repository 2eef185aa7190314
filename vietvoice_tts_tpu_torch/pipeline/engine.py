"""TTS synthesis orchestrator (port of ``vietvoice_tts_tpu/pipeline/engine.py``).

Same public surface as the JAX ``TTSEngine`` (and the reference's): the
constructor/context-manager/cleanup, ``synthesize(...)`` returning
``(int16 waveform, generation_time)``, and the same duration estimation and
chunking policy (speaking rate from the reference clip, 20 s chunk cap, 1 s
safety margin, recursive re-split). Chunks are padded into frame buckets and
run through :class:`EngineCore`. In direct mode they go as batches for
``synthesize`` and as single rows, one after the other, for
``synthesize_streaming``; with ``enable_micro_batching`` every chunk is a job
of the shared :class:`~..serving.batcher.MicroBatcher`, which batches the
chunks of concurrent requests together. Under a mesh (``mesh=``) every
rank runs the same ``synthesize`` call and dispatches the same batches; a
bucket's chunks go in batches that the data axis divides.
"""

from __future__ import annotations

import hashlib
import os
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..config import ModelConfig
from ..runtime.engine_core import EngineCore
from ..runtime.session import ModelSessionManager
from ..utils.logging import get_logger
from .audio import AudioProcessor
from .text import TextProcessor

log = get_logger("engine")


@dataclass
class ChunkPlan:
    """One synthesis chunk, padded into a frame bucket."""

    index: int
    text: str
    ref_len: int  # reference frames
    total_len: int  # reference + target frames (un-padded)
    bucket: int  # padded frame count


class TTSEngine:
    """Main TTS engine."""

    def __init__(self, config: Optional[ModelConfig] = None, mesh=None):
        self.config = config or ModelConfig()
        self.model_session_manager = ModelSessionManager(self.config)
        self.model_session_manager.load_models()

        if not self.model_session_manager.vocab_path:
            raise RuntimeError("Vocabulary file not found in weight pack")

        self.text_processor = TextProcessor(self.model_session_manager.vocab_path)
        self.audio_processor = AudioProcessor()
        self.mesh = mesh
        self.engine_core = EngineCore(
            self.config,
            self.model_session_manager.params,
            self.model_session_manager.vocab_size,
            mesh=mesh,
        )
        # Host-side cache of decoded reference audio (int16 @ sample_rate),
        # keyed by path or content hash.
        self.sample_cache: dict = {}
        # Optional shared micro-batching dispatcher (serving mode). When set,
        # chunks from concurrent requests share padded device batches.
        self.batcher = None

    def enable_micro_batching(self, max_batch=None, max_wait_ms: float = 5.0,
                              pipeline_depth: int = 1):
        """Attach a continuous micro-batcher so concurrent requests share
        device batches (see serving/batcher.py). Returns the batcher."""
        from ..serving.batcher import MicroBatcher

        if self.batcher is None:
            self.batcher = MicroBatcher(
                self.engine_core, max_batch=max_batch, max_wait_ms=max_wait_ms,
                pipeline_depth=pipeline_depth,
            )
        return self.batcher

    def warmup(self, batches=None, buckets=None) -> None:
        """Run the serving shape grid once, at deploy time, so that no
        request pays a first use (see ``EngineCore.warmup`` for what that
        is in eager PyTorch: kernel builds, library handles, buffers).

        The default batch grid is exactly the set of padded row counts the
        micro-batcher dispatches (``config.batch_grid``); the default
        buckets are all of ``config.frame_buckets``."""
        self.engine_core.warmup(
            batches=batches or self.config.batch_grid(), buckets=buckets
        )

    # -- Lifecycle -----------------------------------------------------------

    def cleanup(self) -> None:
        if self.batcher is not None:
            self.batcher.shutdown()
            self.batcher = None
        if self.model_session_manager:
            self.model_session_manager.cleanup()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.cleanup()

    def _load_ref(self, ref_audio) -> np.ndarray:
        """Decoded reference audio (int16 @ sample_rate), cached per voice.

        Path keys include (mtime_ns, size) so a reference file edited in
        place is re-decoded; at most 64 voices are kept, least recently
        used evicted first."""
        if isinstance(ref_audio, str):
            try:
                st = os.stat(ref_audio)
                key = (ref_audio, st.st_mtime_ns, st.st_size)
            except OSError:
                key = (ref_audio, 0, 0)
        else:
            key = hashlib.sha1(ref_audio).hexdigest()
        hit = self.sample_cache.get(key)
        if hit is None:
            hit = self.audio_processor.load_audio(ref_audio, self.config.sample_rate)
            while len(self.sample_cache) >= 64:
                self.sample_cache.pop(next(iter(self.sample_cache)))
            self.sample_cache[key] = hit
        else:
            # dict preserves insertion order — re-insert to mark recency.
            self.sample_cache.pop(key)
            self.sample_cache[key] = hit
        return hit

    # -- Input preparation (policy parity with the reference :43-131) --------

    def _plan_chunks(
        self,
        ref_audio_f32: np.ndarray,
        reference_text: str,
        target_text: str,
        speed: Optional[float] = None,
        first_chunk_cap: Optional[float] = None,
    ) -> List[ChunkPlan]:
        cfg = self.config
        tp = self.text_processor
        speed = cfg.speed if speed is None else speed

        reference_text = tp.clean_text(reference_text)
        target_text = tp.clean_text(target_text)

        ref_text_len = tp.calculate_text_length(reference_text, cfg.pause_punctuation)
        ref_audio_len = len(ref_audio_f32) // cfg.hop_length + 1
        ref_audio_duration = len(ref_audio_f32) / cfg.sample_rate
        speaking_rate = (
            ref_text_len / ref_audio_duration if ref_audio_duration > 0 else 100.0
        )

        target_text_len = tp.calculate_text_length(target_text, cfg.pause_punctuation)
        target_duration = max(
            target_text_len / speaking_rate / speed, cfg.min_target_duration
        )
        total_estimated = ref_audio_duration + target_duration

        if total_estimated <= cfg.max_chunk_duration:
            chunks = [target_text]
            log.info(
                "Single chunk: estimated %.1fs (ref %.1fs + target %.1fs)",
                total_estimated,
                ref_audio_duration,
                target_duration,
            )
        else:
            safety_margin = 1.0
            available = cfg.max_chunk_duration - ref_audio_duration - safety_margin
            if available <= 0:
                raise ValueError(
                    f"Reference audio duration ({ref_audio_duration:.1f}s) exceeds "
                    f"max chunk duration ({cfg.max_chunk_duration}s)"
                )
            max_chars = int(speaking_rate * available * speed)
            raw_chunks = tp.chunk_text(target_text, max_chars=max_chars)
            chunks = []
            for chunk in raw_chunks:
                c_len = tp.calculate_text_length(chunk, cfg.pause_punctuation)
                c_dur = max(c_len / speaking_rate / speed, cfg.min_target_duration)
                if ref_audio_duration + c_dur <= cfg.max_chunk_duration:
                    chunks.append(chunk)
                else:
                    log.warning(
                        "Chunk too long (%.1fs), splitting further...",
                        ref_audio_duration + c_dur,
                    )
                    smaller = int(len(chunk) * available / c_dur * 0.9)
                    chunks.extend(tp.chunk_text(chunk, max_chars=smaller))
            log.info(
                "Long text (est. %.1fs): %d chunks, %.1fs available per chunk",
                total_estimated,
                len(chunks),
                available,
            )

        if first_chunk_cap and chunks:
            # Streaming policy: time to first audio is one chunk's latency,
            # so cap the first chunk's target duration and plan the rest
            # with the normal budget. Same chunking rules, a smaller budget
            # for the head; it engages only when it meaningfully helps.
            head_len = tp.calculate_text_length(chunks[0], cfg.pause_punctuation)
            head_dur = max(head_len / speaking_rate / speed, cfg.min_target_duration)
            if head_dur > first_chunk_cap * 1.25:
                head_chars = max(8, int(speaking_rate * first_chunk_cap * speed))
                head_split = tp.chunk_text(chunks[0], max_chars=head_chars)
                if len(head_split) > 1:
                    rest_avail = max(
                        cfg.max_chunk_duration - ref_audio_duration - 1.0,
                        first_chunk_cap,
                    )
                    rest_chars = int(speaking_rate * rest_avail * speed)
                    rest_text = " ".join(head_split[1:])
                    rest = tp.chunk_text(rest_text, max_chars=rest_chars)
                    chunks = [head_split[0], *rest, *chunks[1:]]
                    log.info(
                        "Streaming first-chunk cap %.1fs: head %d chars, "
                        "%d chunks total",
                        first_chunk_cap,
                        len(head_split[0]),
                        len(chunks),
                    )

        plans: List[ChunkPlan] = []
        for i, chunk in enumerate(chunks):
            c_len = tp.calculate_text_length(chunk, cfg.pause_punctuation)
            c_dur = max(c_len / speaking_rate / speed, cfg.min_target_duration)
            target_frames = int(c_dur * cfg.sample_rate) // cfg.hop_length + 1
            total_len = ref_audio_len + target_frames
            bucket = cfg.frame_bucket_for(total_len)
            ref_len_eff = ref_audio_len
            if total_len > bucket:
                # Largest bucket overflow: keep the target region intact and
                # truncate the reference prefix so output is never empty.
                target_frames = min(target_frames, bucket - 1)
                ref_len_eff = min(ref_audio_len, bucket - target_frames)
                total_len = ref_len_eff + target_frames
                log.warning(
                    "Chunk %d exceeds largest bucket %d; ref %d→%d frames, "
                    "target %d frames",
                    i,
                    bucket,
                    ref_audio_len,
                    ref_len_eff,
                    target_frames,
                )
            plans.append(
                ChunkPlan(
                    index=i,
                    text=reference_text + chunk,
                    ref_len=ref_len_eff,
                    total_len=total_len,
                    bucket=bucket,
                )
            )
            log.info(
                "Chunk %d/%d: %d chars, %d frames (ref %d) → bucket %d",
                i + 1,
                len(chunks),
                len(chunk),
                total_len,
                ref_audio_len,
                bucket,
            )
        return plans

    # -- Batched execution ---------------------------------------------------

    def _batch_sizes(self, n: int) -> List[int]:
        """Split n chunks into device batches ≤ max_batch_size, a multiple of
        the data-parallel axis when a mesh is active (``EngineCore`` pads the
        last one to it)."""
        step = self.config.max_batch_size
        if self.mesh is not None:
            dp = self.mesh.data
            step = max(step - step % dp, dp)
        sizes = []
        while n > 0:
            sizes.append(min(step, n))
            n -= sizes[-1]
        return sizes

    def _chunk_row(self, plan: ChunkPlan, ref_audio_f32: np.ndarray):
        """Build one device row (wave, text_ids) for a chunk plan."""
        hop = self.config.hop_length
        wave = np.zeros((plan.bucket * hop,), np.float32)
        n_ref = min(len(ref_audio_f32), plan.bucket * hop)
        wave[:n_ref] = ref_audio_f32[:n_ref]
        ids, _ = self.text_processor.encode_padded(plan.text, plan.bucket)
        return wave, ids

    def _slice_output(self, plan: ChunkPlan, row: np.ndarray) -> np.ndarray:
        """Trim the reference prefix + padding from a device int16 row."""
        hop = self.config.hop_length
        return row[plan.ref_len * hop : plan.total_len * hop]

    def _submit_chunks(self, plans: List[ChunkPlan], ref_audio_f32: np.ndarray):
        """Hand every chunk to the shared micro-batcher → [(plan, job)]."""
        from ..serving.batcher import ChunkJob

        jobs = []
        for p in plans:
            wave, ids = self._chunk_row(p, ref_audio_f32)
            job = ChunkJob(
                bucket=p.bucket,
                wave=wave,
                ref_len=p.ref_len,
                total_len=p.total_len,
                text_ids=ids,
                seed=p.index,
            )
            self.batcher.submit(job)
            jobs.append((p, job))
        return jobs

    def _run_chunks_batched(
        self, plans: List[ChunkPlan], ref_audio_f32: np.ndarray
    ) -> List[np.ndarray]:
        """Route chunks through the shared micro-batcher (serving mode)."""
        return [
            self._slice_output(p, j.future.result())
            for p, j in self._submit_chunks(plans, ref_audio_f32)
        ]

    def _run_chunks(
        self, plans: List[ChunkPlan], ref_audio_f32: np.ndarray
    ) -> List[np.ndarray]:
        """Execute all chunk plans, grouped by frame bucket, batched."""
        if self.batcher is not None:
            return self._run_chunks_batched(plans, ref_audio_f32)
        hop = self.config.hop_length
        results: dict[int, np.ndarray] = {}

        by_bucket: dict[int, List[ChunkPlan]] = {}
        for p in plans:
            by_bucket.setdefault(p.bucket, []).append(p)

        for bucket, group in sorted(by_bucket.items()):
            pos = 0
            for bsz in self._batch_sizes(len(group)):
                batch_plans = group[pos : pos + bsz]
                pos += bsz
                wave = np.zeros((bsz, bucket * hop), np.float32)
                ref_len = np.zeros((bsz,), np.int32)
                total_len = np.ones((bsz,), np.int32)
                text_ids = np.full((bsz, bucket), -1, np.int32)
                seeds = np.zeros((bsz,), np.uint32)
                for row, p in enumerate(batch_plans):
                    wave[row], text_ids[row] = self._chunk_row(p, ref_audio_f32)
                    ref_len[row] = p.ref_len
                    total_len[row] = p.total_len
                    seeds[row] = p.index
                out = self.engine_core.synthesize_batch(
                    wave, ref_len, text_ids, total_len, seed=seeds
                )
                for row, p in enumerate(batch_plans):
                    results[p.index] = self._slice_output(p, out[row])

        return [results[i] for i in sorted(results)]

    def _iter_chunk_waves(self, plans: List[ChunkPlan], ref_audio_f32: np.ndarray):
        """Yield each chunk's trimmed int16 wave in order, as it completes.

        Batcher mode submits everything up front: the batcher's dispatcher
        thread queues the batches and its fetcher resolves each at its
        event, so chunks of one bucket that ride one batch come together.
        Direct mode runs single-row dispatches, one at a time: chunk k is
        handed to the caller before chunk k+1 is dispatched. The JAX engine keeps two in
        flight, where a dispatch is one asynchronous call. Here it is some
        17,000 kernel launches and CUDA's launch queue holds about a
        thousand, so the host could not queue chunk k+1 behind a running
        chunk k anyway: it would sit in the queue until chunk k+1 was nearly
        done, and chunk k would reach the caller a whole chunk late (measured
        on an H100, ``PERF.md``). The device waits only the milliseconds
        between a fetch and the next dispatch's first kernels."""
        if self.batcher is not None:
            for p, j in self._submit_chunks(plans, ref_audio_f32):
                yield self._slice_output(p, j.future.result())
            return
        for p in plans:
            wave, ids = self._chunk_row(p, ref_audio_f32)
            fetch = self.engine_core.synthesize_batch_async(
                wave[None],
                np.asarray([p.ref_len], np.int32),
                ids[None],
                np.asarray([p.total_len], np.int32),
                seed=np.asarray([p.index], np.uint32),
            )
            yield self._slice_output(p, fetch()[0])

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
        """Stream synthesis: yields int16 waveform pieces as chunks complete.

        Same planning, per-chunk seeds and RMS-matched equal-power
        cross-fade (applied incrementally) as ``synthesize()``, but the first
        piece arrives after one chunk's latency instead of the whole
        utterance's. Each chunk runs as a batch of one where ``synthesize()``
        batches a bucket's chunks together; per-row noise makes the inputs
        equal, and the concatenated pieces equal ``synthesize()``'s output
        as far as the matmul library picks the same algorithm at both batch
        sizes (byte for byte in float32 on the CPU, see
        ``tests/test_torch_streaming.py``; ``chip_smoke.py`` states the
        tolerance on the card).

        ``first_chunk_duration`` (or ``config.streaming_first_chunk_duration``)
        also caps the first chunk's target audio length so playback starts
        sooner on long texts, at the cost of one more cross-fade boundary;
        the chunking then differs from the blocking output's."""
        ref_audio, ref_text = self.model_session_manager.select_sample(
            gender, group, area, emotion, sample_iteration, reference_audio, reference_text
        )
        ref_int16 = self._load_ref(ref_audio)
        ref_f32 = ref_int16.astype(np.float32) / 32768.0
        cap = (
            first_chunk_duration
            if first_chunk_duration is not None
            else self.config.streaming_first_chunk_duration
        )
        plans = self._plan_chunks(
            ref_f32, ref_text, text, speed=speed, first_chunk_cap=cap
        )
        yield from self.audio_processor.stream_with_crossfade(
            self._iter_chunk_waves(plans, ref_f32),
            self.config.cross_fade_duration,
            self.config.sample_rate,
        )

    # -- Public API (parity with the reference :189-257) ---------------------

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
        """Synthesize speech → (int16 waveform, generation_time_seconds).

        ``speed`` overrides ``config.speed`` per request."""
        start_time = time.time()

        ref_audio, ref_text = self.model_session_manager.select_sample(
            gender, group, area, emotion, sample_iteration, reference_audio, reference_text
        )

        try:
            ref_int16 = self._load_ref(ref_audio)
            ref_f32 = ref_int16.astype(np.float32) / 32768.0

            plans = self._plan_chunks(ref_f32, ref_text, text, speed=speed)
            generated_waves = self._run_chunks(plans, ref_f32)

            if len(generated_waves) > 1:
                log.info(
                    "Concatenating %d chunks with cross-fade (%.2fs)...",
                    len(generated_waves),
                    self.config.cross_fade_duration,
                )
            final_wave = self.audio_processor.concatenate_with_crossfade_improved(
                generated_waves, self.config.cross_fade_duration, self.config.sample_rate
            )

            generation_time = time.time() - start_time

            if output_path:
                self.audio_processor.save_audio(
                    final_wave, output_path, self.config.sample_rate
                )
                log.info("Audio saved to: %s", output_path)

            return final_wave, generation_time
        except Exception as e:
            raise RuntimeError(f"Speech synthesis failed: {str(e)}") from e

    def validate_configuration(self, reference_audio: Optional[str] = None) -> bool:
        """Validate configuration with reference audio (reference :259-268)."""
        if reference_audio is None:
            log.info("Configuration valid: using built-in voice samples")
            return True
        return self.config.validate_with_reference_audio(reference_audio)
