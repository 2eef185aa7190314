#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``vietvoice_tts_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card, ``nvcc`` (PATH, $CUDA_HOME or /usr/local/cuda) and
no network. It exits non-zero, before printing any result, when CUDA is
unavailable or the package is not beside it. Phases, in order (any failed
check raises):

1. The card's name and power limit, as ``nvidia-smi`` reports them.
2. Build every CUDA kernel of the serving path from ``csrc/``.
3. Each kernel against its plain PyTorch version on the card, at the shapes
   the serving path gives it, in float32 (max-abs ≤ 1e-4: both sides are
   true f32 with TF32 off) and bfloat16 (max-abs ≤ 1e-2, about one bf16 ulp
   of an output below 2), with kernel and plain times.
4. Whole-path parity at the full width of the default model: the mel latent
   of ``EngineCore.mel_latent_batch`` from one injected noise, with the
   kernel and with the plain path, on a seeded pack whose AdaLN gates are
   opened (the shipped pack's zero gates would multiply attention by 0), in
   float32 (max-abs ≤ 1e-2, the BASELINE mel gate) and in the serving
   bfloat16 (bounded by its measured noise floor, see MEL_TOLERANCE), with
   exactly 22 × 31 = 682 launches per kernel solve.
5. Serving through ``TTSApi``: a short sentence twice (must be identical),
   a voice clone from a WAV written here, and a long text that plans to ≥ 2
   chunks in one batch; launches must be 682 per chunk batch.

The last lines are the kernels' JSON record, the ``nvidia-smi`` line, and
``{"ok": true, "device": {...}}``. Weights are random, made from a seed, and
kept under ``build/chip_smoke/`` in the checkout.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"

# Phase-3 shapes (B, N, H, D): B = 2 × batch for CFG; N from the frame
# buckets; 8×128 is the default model, 16×64 a converted F5 model; 448 is
# the batch-1 latency shape, 437 an N that is not a multiple of 8.
KERNEL_SHAPES = [
    (2, 512, 8, 128),
    (2, 512, 16, 64),
    (2, 448, 8, 128),
    (16, 1024, 8, 128),
    (2, 2048, 8, 128),
    (2, 437, 8, 128),
]
LATENCY_SHAPE = (2, 448, 8, 128)
TOLERANCE = {"float32": 1e-4, "bfloat16": 1e-2}
# Std of the AdaLN gate perturbation (blocks.ada, final_ada) at dim 1024:
# gates of std ≈ 0.01·|t_emb| — open enough that every block's attention
# reaches the output (opening them moved the bf16 latent by 1.04 max-abs on
# an H100), small enough that the 31-step solve stays bounded.
ADA_STD = 0.01
# Whole-path mel-latent tolerance (max-abs, mean-abs) per compute dtype.
# float32 (TF32 off) is held to the repo's BASELINE mel gate, 1e-2 max-abs.
# In bfloat16 the 31-step solve amplifies any change of float32 summation
# order: on an H100 (700 W) the plain path against itself with the P·V sum
# split in two differed by 1.1e-2..1.7e-2 max-abs and 1.7e-3..2.8e-3
# mean-abs (gate std 0.0025..0.01), as much as the kernel does. The bf16
# bound is about three times that floor.
MEL_TOLERANCE = {"float32": (1e-2, 1e-3), "bfloat16": (5e-2, 1e-2)}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, samples: int = 10, calls: int = 10) -> float:
    """Device time of one ``fn()`` in ms: the median over ``samples`` CUDA-event
    timings of ``calls`` back-to-back calls each (after a warm-up), so host
    launch gaps between calls are amortized."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def phase_build() -> None:
    from vietvoice_tts_tpu_torch.ops.kernels.build import load_library

    t0 = time.perf_counter()
    load_library("fused_rope_attention")
    log(f"[2] built fused_rope_attention in {time.perf_counter() - t0:.2f} s")


def phase_kernels(card: str) -> dict:
    """Kernel vs plain version at every shape and dtype; returns the record."""
    import torch

    from vietvoice_tts_tpu_torch.ops.kernels import fused_rope_attention as fra
    from vietvoice_tts_tpu_torch.ops.rope import rope_tables

    dev = torch.device("cuda")
    worst = 0.0
    timing = {}
    for b, n, heads, d in KERNEL_SHAPES:
        for dtype_name, tol in TOLERANCE.items():
            dtype = getattr(torch, dtype_name)
            rng = np.random.default_rng(b * 100003 + n * 17 + heads)
            qkv = torch.from_numpy(
                rng.standard_normal((b, n, 3 * heads * d)).astype(np.float32)
            ).to(dev, dtype)
            # Rows alternate between fully valid and ~30% padded keys.
            valid = [n if i % 2 else n - max(1, (3 * n) // 10) for i in range(b)]
            mask = torch.from_numpy(
                np.arange(n)[None, :] < np.asarray(valid)[:, None]
            ).to(dev)
            cos, sin = (torch.from_numpy(t).to(dev) for t in rope_tables(n, d))
            out = fra.fused_qkv_rope_attention(qkv, cos, sin, mask, heads)
            ref = fra.fused_qkv_rope_attention_reference(qkv, cos, sin, mask, heads)
            torch.cuda.synchronize()
            err = max(
                (out[i, :v].float() - ref[i, :v].float()).abs().max().item()
                for i, v in enumerate(valid)
            )
            if not np.isfinite(err) or err > tol:
                raise AssertionError(
                    f"kernel vs plain at B={b} N={n} H={heads} D={d} "
                    f"{dtype_name}: max-abs {err:.3e} > {tol:.0e}"
                )
            worst = max(worst, err)
            ms = cuda_ms(lambda: fra.fused_qkv_rope_attention(qkv, cos, sin, mask, heads))
            plain_ms = cuda_ms(
                lambda: fra.fused_qkv_rope_attention_reference(qkv, cos, sin, mask, heads)
            )
            timing[(b, n, heads, d, dtype_name)] = (ms, plain_ms)
            log(
                f"[3] B={b} N={n} H={heads} D={d} {dtype_name}: max-abs {err:.3e} "
                f"(tol {tol:.0e}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
                f"[{card}]"
            )
    ms, plain_ms = timing[(*LATENCY_SHAPE, "bfloat16")]
    return {
        "name": "fused_qkv_rope_attention",
        "route": "cuda",
        "source": "vietvoice_tts_tpu_torch/csrc/fused_rope_attention.cu",
        "replaces": "vietvoice_tts_tpu/ops/pallas/fused_rope_attention.py:123",
        "launches": None,
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain_ms,
    }


def _perturbed_gates(params: dict, seed: int = 1) -> dict:
    """Copy of the pack tree with blocks.ada and final_ada drawn N(0, ADA_STD²)."""
    rng = np.random.default_rng(seed)
    dit = dict(params["dit"])
    blocks = dict(dit["blocks"])
    blocks["ada"] = {
        k: rng.normal(0.0, ADA_STD, v.shape).astype(np.float32)
        for k, v in blocks["ada"].items()
    }
    dit["blocks"] = blocks
    dit["final_ada"] = {
        k: rng.normal(0.0, ADA_STD, v.shape).astype(np.float32)
        for k, v in dit["final_ada"].items()
    }
    return {**params, "dit": dit}


def phase_whole_path(cfg, card: str) -> None:
    import torch

    from vietvoice_tts_tpu_torch.ops.kernels import fused_rope_attention as fra
    from vietvoice_tts_tpu_torch.runtime.engine_core import EngineCore
    from vietvoice_tts_tpu_torch.runtime.session import ModelSessionManager

    t0 = time.perf_counter()
    mgr = ModelSessionManager(cfg)
    mgr.load_models()
    params = _perturbed_gates(mgr.params)
    log(f"[4] pack ready in {time.perf_counter() - t0:.1f} s (ada std {ADA_STD})")

    hop = cfg.hop_length
    b, n, ref_len, total_len = 1, 448, 188, 439
    rng = np.random.default_rng(4)
    ref_audio, _ = mgr.select_sample()
    from vietvoice_tts_tpu_torch.pipeline.audio import AudioProcessor

    ref = AudioProcessor.load_audio(ref_audio, cfg.sample_rate).astype(np.float32) / 32768.0
    wave = np.zeros((b, n * hop), np.float32)
    wave[0, : min(len(ref), n * hop)] = ref[: n * hop]
    ids = np.full((b, n), -1, np.int32)
    ids[:, :120] = rng.integers(0, mgr.vocab_size, (b, 120))
    x0 = rng.standard_normal((b, n, cfg.n_mels)).astype(np.float32)
    args = (wave, np.array([ref_len]), ids, np.array([total_len]))

    for dtype, (max_tol, mean_tol) in MEL_TOLERANCE.items():
        latents = {}
        for use_kernels in (True, False):
            run_cfg = dataclasses.replace(cfg, compute_dtype=dtype, use_kernels=use_kernels)
            core = EngineCore(run_cfg, params, mgr.vocab_size)
            fra.launches = 0
            t0 = time.perf_counter()
            lat = core.mel_latent_batch(*args, x0=x0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = fra.launches
            want = cfg.dit_depth * (cfg.nfe_step - 1) if use_kernels else 0
            if launches != want:
                raise AssertionError(
                    f"{dtype} use_kernels={use_kernels}: {launches} launches, want {want}"
                )
            if lat.shape != (b, n, cfg.n_mels) or not np.isfinite(lat).all():
                raise AssertionError(f"bad {dtype} latent: shape {lat.shape}")
            latents[use_kernels] = lat[:, :total_len]
            log(f"[4] {dtype} mel latent, use_kernels={use_kernels}: {wall * 1e3:.1f} ms "
                f"(first solve of a fresh core), {launches} launches, "
                f"max |latent| {np.abs(lat).max():.3f} [{card}]")
            del core
            torch.cuda.empty_cache()
        diff = np.abs(latents[True] - latents[False])
        err, mean = float(diff.max()), float(diff.mean())
        log(f"[4] {dtype} whole-path mel latent, kernel vs plain: max-abs {err:.3e} "
            f"(tol {max_tol:.0e}), mean-abs {mean:.3e} (tol {mean_tol:.0e}) "
            f"on {total_len} valid frames")
        if not (err <= max_tol and mean <= mean_tol):
            raise AssertionError(f"{dtype} whole-path kernel vs plain outside tolerance")


def _write_clone_wav(path: Path, sample_rate: int) -> None:
    from vietvoice_tts_tpu_torch.utils.wavio import write_wav

    t = np.arange(3 * sample_rate) / sample_rate
    f0 = 180.0 * (1.0 + 0.05 * np.sin(2 * np.pi * 0.7 * t))
    sig = sum(a * np.sin(2 * np.pi * f0 * h * t) for h, a in ((1, 1.0), (2, 0.5), (3, 0.25)))
    env = 0.6 + 0.4 * np.sin(2 * np.pi * 2.5 * t) ** 2
    write_wav((0.5 * sig / np.abs(sig).max() * env).astype(np.float32), path, sample_rate)


def _chunk_batches(engine, text: str, **voice) -> tuple[int, int]:
    """(device batches, chunks) the engine will run for this request."""
    ref_audio, ref_text = engine.model_session_manager.select_sample(**voice)
    ref = engine._load_ref(ref_audio).astype(np.float32) / 32768.0
    plans = engine._plan_chunks(ref, ref_text, text)
    buckets: dict[int, int] = {}
    for p in plans:
        buckets[p.bucket] = buckets.get(p.bucket, 0) + 1
    return sum(len(engine._batch_sizes(c)) for c in buckets.values()), len(plans)


def phase_serving(cfg, card: str, smi: str) -> int:
    import torch

    from vietvoice_tts_tpu_torch import TTSApi
    from vietvoice_tts_tpu_torch.ops.kernels import fused_rope_attention as fra

    clone_wav = WORK / "clone_voice.wav"
    _write_clone_wav(clone_wav, cfg.sample_rate)
    short = "Xin chào, hôm nay trời rất đẹp."
    # 16 equal sentences plan to three chunks that share the 2048 bucket.
    long_text = " ".join(
        ["Nguoi dan thanh pho thuc day som de chuan bi cho mot ngay lam viec moi."] * 16
    )
    requests = [
        ("short", short, {}),
        ("short-again", short, {}),
        ("clone", "Đây là giọng nói được nhân bản từ tệp âm thanh.",
         {"reference_audio": str(clone_wav),
          "reference_text": "Xin chào, đây là giọng nói của tôi."}),
        ("long", long_text, {}),
    ]
    api = TTSApi(cfg)
    engine = api.engine  # loads the pack before the counted run
    expected = 0
    for name, text, voice in requests:
        n_batches, n_chunks = _chunk_batches(engine, text, **voice)
        expected += n_batches * cfg.dit_depth * (cfg.nfe_step - 1)
        if name == "long" and not (n_chunks >= 2 and n_batches == 1):
            raise AssertionError(
                f"long text plans to {n_chunks} chunks in {n_batches} batches; "
                "want ≥ 2 chunks in one batch"
            )
        log(f"[5] {name}: {n_chunks} chunk(s) in {n_batches} batch(es)")

    outputs = {}
    fra.launches = 0  # count the main path's run only
    for name, text, voice in requests:
        t0 = time.perf_counter()
        wave, _ = api.synthesize(text, **voice)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if wave.dtype != np.int16 or wave.size == 0 or not np.any(wave):
            raise AssertionError(f"{name}: bad audio dtype={wave.dtype} size={wave.size}")
        secs = wave.size / cfg.sample_rate
        outputs[name] = wave
        log(f"[5] {name}: {wall * 1e3:.1f} ms wall, {secs:.2f} s audio, "
            f"{secs / wall:.2f} audio-s/s [{smi}]")
    launches = fra.launches
    if launches != expected:
        raise AssertionError(f"serving ran {launches} kernel launches, want {expected}")
    if not np.array_equal(outputs["short"], outputs["short-again"]):
        raise AssertionError("the same short request gave different audio")
    log(f"[5] serving: {launches} kernel launches (682 per chunk batch), "
        "short request deterministic")
    api.cleanup()
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import vietvoice_tts_tpu_torch  # noqa: F401 — fails outside a checkout
    from vietvoice_tts_tpu_torch.config import ModelConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    WORK.mkdir(parents=True, exist_ok=True)

    smi = nvidia_smi_line()
    card = f"{torch.cuda.get_device_name(0)}, {smi.split(',')[-1].strip()}"
    log(f"[1] {smi}")
    phase_build()
    torch.cuda.synchronize()
    record = phase_kernels(card)
    torch.cuda.synchronize()
    cfg = ModelConfig(device="cuda", model_cache_dir=str(WORK / "models"))
    phase_whole_path(cfg, card)
    torch.cuda.synchronize()
    record["launches"] = phase_serving(cfg, card, smi)
    torch.cuda.synchronize()

    print(json.dumps({"kernels": [record]}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
