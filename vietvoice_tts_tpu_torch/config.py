"""Configuration for the PyTorch / CUDA port of VietVoice TTS.

A copy of ``vietvoice_tts_tpu/config.py`` (the JAX package cannot be
imported without JAX) with the same model, sampler, audio and chunking
fields and defaults, so ``model_meta.json`` and ``config_from_pack`` read the
same in both packages. Differences:

- ``device`` (default ``"cuda"``) says where the model runs; asking for CUDA
  on a machine without it raises instead of silently running on the CPU.
- ``use_pallas`` is ``use_kernels``: the hand-written CUDA kernels
  (``ops/kernels/``), used on CUDA tensors only.
- Fields that existed only for the TPU (transfer dtype, XLA compile cache,
  trimmed-fetch warmup, sampler-state donation) are absent. The port's
  counterpart of a program compiled per shape is a CUDA graph captured per
  shape, in memory, at ``warmup`` or at a shape's first batch
  (``runtime/graphs.py``); no field turns it off.
- ``streaming_first_chunk_duration`` is checked: None, or in (0,
  ``max_chunk_duration``] (the JAX config takes any value).
- The mesh axes (``mesh_data_axis``, ``mesh_model_axis``,
  ``sequence_parallel``) have the JAX defaults; a mesh is a group of
  ``torch.distributed`` ranks (``parallel/mesh.py``).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import torch

# Voice metadata constants — same taxonomy as the reference
# (vietvoicetts/core/model_config.py:15-18).
MODEL_GENDER = ["male", "female"]
MODEL_GROUP = ["story", "news", "audiobook", "interview", "review"]
MODEL_AREA = ["northern", "southern", "central"]
MODEL_EMOTION = ["neutral", "serious", "monotone", "sad", "surprised", "happy", "angry"]

DETERMINISTIC_SEED = 9527

COMPUTE_DTYPES = ("float32", "bfloat16")


def check_first_chunk_duration(cap: Optional[float], max_chunk_duration: float,
                               name: str = "first_chunk_duration") -> None:
    """Raise ``ValueError`` unless the streaming head cap is None (no head
    split) or in (0, ``max_chunk_duration``] seconds. The planner's split
    (``TTSEngine._plan_chunks``, JAX's line for line) would otherwise cut
    an 8-character head for any cap of 0 or below, and never engage above
    the chunk limit."""
    if cap is not None and not 0 < cap <= max_chunk_duration:
        raise ValueError(
            f"{name} must be None or in (0, max_chunk_duration = {max_chunk_duration}] "
            f"seconds, got {cap}")


@dataclass
class ModelConfig:
    """Config for TTS inference with PyTorch."""

    # ---- Sampling / synthesis settings (reference-compatible) ----
    nfe_step: int = 32
    # Unroll factor of the JAX solve's scan; the port's solve is a Python loop
    # of steps (captured whole in a CUDA graph on the card), so the value
    # changes nothing here (kept for config round-trips).
    fuse_nfe: int = 1
    # Sampler caches (models/sampler.py), mutually exclusive, 1 = exact: the
    # CFG cache refreshes the unconditional velocity every k-th eval; the
    # deep-block cache runs the full DiT depth every r-th eval and only the
    # first nfe_deep_cache_blocks blocks in between.
    nfe_uncond_interval: int = 1
    nfe_deep_cache_interval: int = 1
    nfe_deep_cache_blocks: int = 7
    sample_rate: int = 24000
    speed: float = 0.9
    random_seed: int = DETERMINISTIC_SEED
    hop_length: int = 256
    cfg_strength: float = 2.0
    sway_sampling_coef: float = -1.0

    # ---- Sample selection defaults (reference model_config.py:37-40) ----
    gender: Optional[str] = "female"
    area: Optional[str] = "northern"
    emotion: Optional[str] = "neutral"
    group: Optional[str] = "audiobook"

    # ---- Text processing ----
    pause_punctuation: str = r".,?!:"

    # ---- Audio / chunking (reference model_config.py:46-48) ----
    cross_fade_duration: float = 0.1
    max_chunk_duration: float = 20.0
    min_target_duration: float = 1.0
    # Streaming only: cap (seconds of target audio) on the first chunk of
    # synthesize_streaming, for a faster first piece. None = no cap.
    streaming_first_chunk_duration: Optional[float] = None

    # ---- Mel front-end (Vocos-style, F5-TTS family) ----
    n_mels: int = 100
    n_fft: int = 1024
    win_length: int = 1024

    # ---- DiT architecture ----
    dit_dim: int = 1024
    dit_depth: int = 22
    dit_heads: int = 8
    dit_ff_mult: int = 2
    text_dim: int = 512
    text_conv_layers: int = 4
    vocab_size: int = 256  # overridden by the vocab file at load time

    # ---- Vocoder (ConvNeXt + iSTFT head) ----
    vocoder_dim: int = 512
    vocoder_intermediate_dim: int = 1536
    vocoder_num_layers: int = 8

    # ---- Runtime policy ----
    compute_dtype: str = "bfloat16"  # matmul/activation dtype of DiT + vocoder
    # LayerNorm statistics dtype inside the DiT blocks (float32 default).
    norm_dtype: str = "float32"
    param_dtype: str = "float32"  # dtype of the weight pack on disk
    # Mel-frame buckets: every chunk is padded up to one of these, so a
    # request's shape, and with it its noise and its output, does not
    # depend on what else is batched with it.
    frame_buckets: tuple[int, ...] = (
        256, 384, 440, 448, 512, 544, 576, 640, 704, 768, 1024, 2048
    )
    max_batch_size: int = 8
    # Hand-written CUDA kernels on CUDA tensors (ops/kernels/). With False
    # the plain PyTorch versions run everywhere.
    use_kernels: bool = True
    # Where the model runs: "cuda", "cuda:<index>" or "cpu".
    device: str = "cuda"
    # Voice-conditioning cache: the reference clip's log-mel depends only on
    # the voice, not the request, so it is kept on the device keyed by the
    # audio bytes; a hit sends no waveform and runs no mel front end.
    voice_cond_cache: bool = True
    voice_cond_cache_size: int = 64  # LRU entries
    voice_cond_frames: int = 1024  # cached mel length cap (frames)
    # Serve only packs converted from real weights: when False, loading a
    # pack whose model_meta.json carries "synthetic": true raises instead of
    # serving random-weight noise.
    allow_synthetic_pack: bool = True

    # ---- Mesh / parallelism (parallel/mesh.py: one rank per process) ----
    mesh_data_axis: int = 1  # utterance/chunk batch parallelism
    mesh_model_axis: int = 1  # tensor parallelism for DiT + vocoder
    # Spend the model axis on the mel-frame (sequence) dimension instead of
    # tensor parallelism: the DiT's residual stream holds N/sp frames per
    # rank, attention runs Ulysses or the ring (parallel/sequence.py), and
    # every rank holds all the weights.
    sequence_parallel: bool = False

    # ---- Weight store ----
    model_cache_dir: str = field(
        default_factory=lambda: os.environ.get("VIETVOICE_TPU_CACHE", "models")
    )
    model_name: str = "vietvoice-tpu-v1"
    # Optional path to the reference's ONNX tarball for weight conversion /
    # numerics golden tests; unused when absent.
    onnx_model_path: Optional[str] = None
    # URL the tarball is fetched from when ensure_model_downloaded() runs
    # (reference model_config.py:26). Construction never touches the
    # network: conversion is an explicit step.
    model_url: Optional[str] = None

    def __post_init__(self) -> None:
        # Same validation ranges as the reference (model_config.py:57-63).
        if not 0.1 <= self.speed <= 5.0:
            raise ValueError("Speed must be between 0.1 and 5.0")
        if not 1 <= self.nfe_step <= 100:
            raise ValueError("NFE step must be between 1 and 100")
        if not 1 <= self.nfe_uncond_interval <= 8:
            raise ValueError("nfe_uncond_interval must be between 1 and 8")
        if not 1 <= self.nfe_deep_cache_interval <= 8:
            raise ValueError("nfe_deep_cache_interval must be between 1 and 8")
        if self.nfe_uncond_interval > 1 and self.nfe_deep_cache_interval > 1:
            raise ValueError(
                "nfe_uncond_interval and nfe_deep_cache_interval are "
                "mutually exclusive — enable at most one cache"
            )
        if self.nfe_deep_cache_interval > 1 and not (
            1 <= self.nfe_deep_cache_blocks < self.dit_depth
        ):
            raise ValueError(
                "nfe_deep_cache_blocks must be in [1, dit_depth)"
            )
        if self.dit_dim % self.dit_heads != 0:
            raise ValueError("dit_dim must be divisible by dit_heads")
        if self.n_fft % self.hop_length != 0:
            raise ValueError("n_fft must be a multiple of hop_length")
        if tuple(self.frame_buckets) != tuple(sorted(self.frame_buckets)):
            raise ValueError("frame_buckets must be sorted ascending")
        for name in ("compute_dtype", "norm_dtype"):
            if getattr(self, name) not in COMPUTE_DTYPES:
                raise ValueError(f"{name} must be one of {COMPUTE_DTYPES}")
        check_first_chunk_duration(
            self.streaming_first_chunk_duration, self.max_chunk_duration,
            "streaming_first_chunk_duration")
        device = torch.device(self.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device={self.device!r} but no CUDA device is available "
                "(torch.cuda.is_available() is False); pass device='cpu' "
                "(--device cpu on the command line) to run on the CPU"
            )
        if device.type not in ("cuda", "cpu"):
            raise ValueError(f"device must be cuda or cpu, got {self.device!r}")

    # -- Derived properties --------------------------------------------------

    @property
    def head_dim(self) -> int:
        return self.dit_dim // self.dit_heads

    @property
    def model_path(self) -> str:
        """Directory holding the converted/initialized weight pack."""
        return str(Path(self.model_cache_dir).expanduser() / self.model_name)

    @property
    def max_frames(self) -> int:
        return self.frame_buckets[-1]

    def frame_bucket_for(self, n_frames: int) -> int:
        """Smallest bucket that fits ``n_frames`` (clamps to max)."""
        for b in self.frame_buckets:
            if n_frames <= b:
                return b
        return self.frame_buckets[-1]

    def batch_grid(self) -> tuple[int, ...]:
        """Padded batch sizes actually dispatched to the device (see module
        function :func:`batch_grid`)."""
        return batch_grid(self.max_batch_size)

    def ensure_model_downloaded(self) -> str:
        """Fetch the reference ONNX tarball into the cache; return its path.

        Parity with ``reference model_config.py:71-104`` (progress logging,
        cache reuse) plus atomic staging and HTTP-Range resume
        (``models/download.py``). Never called implicitly: configs are
        built freely without network access, and conversion day calls it
        (or the download CLI) explicitly. Sets ``onnx_model_path`` to the
        fetched tarball."""
        from .models.download import DEFAULT_MODEL_URL, ensure_model_downloaded

        if self.onnx_model_path and Path(self.onnx_model_path).exists():
            return self.onnx_model_path
        path = ensure_model_downloaded(
            url=self.model_url or DEFAULT_MODEL_URL,
            dest=Path(self.model_cache_dir).expanduser() / "model-bin.pt",
        )
        self.onnx_model_path = str(path)
        return self.onnx_model_path

    # -- Validation against a reference audio file ---------------------------

    def validate_with_reference_audio(self, reference_audio_path: str) -> bool:
        """Check that a reference clip leaves room for ``min_target_duration``
        inside ``max_chunk_duration`` (reference model_config.py:114-141)."""
        from .utils.logging import get_logger
        from .utils.wavio import read_wav

        log = get_logger("config")
        try:
            samples, sr = read_wav(reference_audio_path)
            ref_duration = samples.shape[0] / float(sr)
            safety_margin = 1.0
            required = ref_duration + safety_margin + self.min_target_duration
            if self.max_chunk_duration < required:
                log.error(
                    "Configuration error: reference audio %.1fs needs "
                    "max_chunk_duration > %.1fs (current %.1fs)",
                    ref_duration,
                    required,
                    self.max_chunk_duration,
                )
                return False
            log.info(
                "Configuration valid: reference %.1fs, max chunk %.1fs, "
                "available target %.1fs",
                ref_duration,
                self.max_chunk_duration,
                self.max_chunk_duration - ref_duration - safety_margin,
            )
            return True
        except Exception as exc:  # noqa: BLE001 — mirror reference behavior
            log.error("Error validating reference audio: %s", exc)
            return False

    # -- Dict round-trip (reference model_config.py:143-153) -----------------

    @classmethod
    def from_dict(cls, config_dict: dict) -> "ModelConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in config_dict.items() if k in known})

    def to_dict(self) -> dict:
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out[f.name] = tuple(v) if isinstance(v, (list, tuple)) else v
        return out


# Backward-compatibility alias, as in the reference (model_config.py:157).
TTSConfig = ModelConfig


def batch_grid(max_batch: int) -> tuple[int, ...]:
    """Padded batch sizes actually dispatched to the device: powers of two up
    to ``max_batch``, their 3·2^k midpoints (3, 6, 12, …), and ``max_batch``
    itself (never exceeding it). The micro-batcher pads every dispatch up to
    a grid element and warmup runs exactly this grid, so the shapes the
    device sees repeat: pinned buffers and library workspaces are reused.

    Padded rows burn real device work: a pure power-of-two ladder caps
    worst-case row efficiency at ~50% (5 jobs → batch 8); with the midpoints
    the worst case is ~75% (5 jobs → batch 6)."""
    grid = {g for g in (1 << i for i in range(max_batch.bit_length())) if g <= max_batch}
    grid |= {3 * g for g in grid if 3 * g <= max_batch}
    grid.add(max_batch)
    return tuple(sorted(grid))


def pad_batch_size(b: int, max_batch: int) -> int:
    """Smallest batch-grid element ≥ b (clamps to ``max_batch``)."""
    for g in batch_grid(max_batch):
        if b <= g:
            return g
    return max_batch
