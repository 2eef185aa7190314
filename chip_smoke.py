#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``vietvoice_tts_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card, ``nvcc`` (PATH, $CUDA_HOME or /usr/local/cuda) and
no network. It exits non-zero, before printing any result, when CUDA is
unavailable or the package is not beside it. Phases, in order (any failed
check raises):

1. The card's name and power limit, as ``nvidia-smi`` reports them.
2. Build every CUDA kernel of the package from ``csrc/``, all at once; then
   count the ``HGMMA`` instructions (the machine code of ``wgmma``) in each
   library's SASS, which must not be zero: the bfloat16 paths are on the
   tensor cores.
3. Each kernel against its plain PyTorch version on the card, at the shapes
   the serving path gives it, in float32 (max-abs ≤ 1e-4: both sides are
   true f32 with TF32 off) and bfloat16 (max-abs ≤ 1e-2, about one bf16 ulp
   of an output below 2), with the variant that ran (``wgmma`` or ``simt``)
   and kernel and plain times; for
   ``flash_attention`` also with v as a strided view of a packed projection
   (the DiT's layout) and beside ``scaled_dot_product_attention``, a
   yardstick that the package never calls.
4. Whole-path parity at full width, for both attention routes of the DiT:
   the default model (8 heads × 128, the fused RoPE kernel) and the same
   widths split 32 × 32 (the split-heads route, ``flash_attention``). The
   mel latent of ``EngineCore.mel_latent_batch`` from one injected noise,
   with the kernel and with the plain path, on a seeded pack whose AdaLN
   gates are opened (the shipped pack's zero gates would multiply attention
   by 0), in float32 (max-abs ≤ 1e-2, the BASELINE mel gate) and in the
   serving bfloat16 (bounded by its measured noise floor, see
   MEL_TOLERANCE), with exactly 22 × 31 = 682 launches of the route's kernel
   per solve and none of the other. Then the sampler caches at 32 × 32, each
   against its own plain-path run: the CFG cache (682 launches) and the
   deep-block cache (16 × 22 + 15 × 7 = 457).
5. Serving through ``TTSApi``: a short sentence twice (must be identical),
   a voice clone from a WAV written here, and a long text that plans to ≥ 2
   chunks in one batch (682 launches per chunk batch); the long text again
   through ``synthesize_streaming`` (≥ 2 pieces, 682 launches per chunk,
   held against the blocking output within STREAM_TOLERANCE); and a short
   request on the 32 × 32 model.

The last lines are the kernels' JSON record, the ``nvidia-smi`` line, and
``{"ok": true, "device": {...}}``. Weights are random, made from a seed, and
kept under ``build/chip_smoke/`` in the checkout.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import re
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
# the batch-1 latency shape, 437 an N that is not a multiple of 8, and
# B = 6 at 2048 the long text's three chunks as one blocking batch.
KERNEL_SHAPES = [
    (2, 512, 8, 128),
    (2, 512, 16, 64),
    (2, 448, 8, 128),
    (16, 1024, 8, 128),
    (2, 2048, 8, 128),
    (6, 2048, 8, 128),
    (2, 437, 8, 128),
]
LATENCY_SHAPE = (2, 448, 8, 128)
# Phase-3 shapes of flash_attention, (B, H, N, D): 32×32 is the default
# model's width split into heads the fused kernel does not take (its batch-1
# latency shape first); the rest cover every head_dim the kernel has.
FLASH_SHAPES = [
    (2, 32, 448, 32),
    (2, 32, 2048, 32),
    (16, 32, 1024, 32),
    (2, 16, 512, 64),
    (2, 8, 437, 128),
    (2, 4, 448, 256),
    (2, 8, 512, 96),
]
FLASH_LATENCY_SHAPE = (2, 32, 448, 32)
# Published peaks of one H100 SXM (NVIDIA's data sheet; dense): device
# memory bytes/s, and flop/s by input type (bf16 on the tensor cores,
# float32 on the SIMT pipes, which is what true-float32 parity runs on).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
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
# Streaming against blocking synthesis of the same text, in int16 samples
# (of 32767): (largest difference, mean absolute difference). Streaming runs
# each chunk as a batch of one where blocking runs a bucket's chunks as one
# batch, and cuBLAS may sum in another order at another batch size; bf16
# rounding carries that through 31 steps and the vocoder. Measured on an
# H100 (700 W) on the three-chunk text below: 14 and 0.50; the bound is
# about four times that. (In float32 at small widths the largest difference
# is 2, tests/test_torch_cuda.py.)
STREAM_TOLERANCE = (64, 2.0)


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
    """Device time of one ``fn()`` in ms: ``calls`` back-to-back calls are
    captured into a CUDA graph (after a warm-up) and the median over
    ``samples`` CUDA-event timings of its replay is divided by ``calls``. A
    replay has no host work between the kernels, so a kernel of a few tens of
    microseconds is timed by the device and not by how fast Python enqueues
    it. The inputs stay in the L2 cache between calls, as they do in the DiT,
    where the projection that wrote them ran just before."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def phase_build() -> None:
    """Build every kernel, one ``nvcc`` per source, all started together;
    then show that each library's bfloat16 path is on the tensor cores."""
    from vietvoice_tts_tpu_torch.ops.kernels.build import (
        build_report, count_sass, load_library)

    names = ("fused_rope_attention", "flash_attention")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(load_library, names))
    log(f"[2] built {', '.join(names)} in {time.perf_counter() - t0:.2f} s")
    for name in names:
        hgmma = count_sass(name, "HGMMA")
        report = build_report(name)
        spills = sum(
            int(m) for m in re.findall(r"(\d+) bytes spill (?:stores|loads)", report))
        registers = [int(m) for m in re.findall(r"Used (\d+) registers", report)]
        log(f"[2] {name}: {hgmma} HGMMA instructions in the SASS; ptxas: "
            f"{len(registers)} kernels, at most {max(registers, default=0)} registers, "
            f"{spills} bytes of spills")
        if hgmma == 0:
            raise AssertionError(f"{name}: no HGMMA in the SASS, wgmma path missing")


def bound(tensors, flops: float, dtype_name: str) -> tuple[float, str]:
    """(least ms the card could take, "bytes" or "operations"): each input
    read once and each output written once at the memory rate, against the
    operations at the peak rate for the inputs' type."""
    n_bytes = sum(t.numel() * t.element_size() for t in tensors)
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _valid_lengths(b: int, n: int) -> list[int]:
    """Rows alternate between ~30% padded keys and fully valid."""
    return [n if i % 2 else n - max(1, (3 * n) // 10) for i in range(b)]


def phase_kernels(card: str) -> dict:
    """The fused RoPE kernel vs its plain version at every shape and dtype;
    returns the record."""
    import torch

    from vietvoice_tts_tpu_torch.ops.kernels import fused_rope_attention as fra
    from vietvoice_tts_tpu_torch.ops.rope import rope_tables

    dev = torch.device("cuda")
    worst = 0.0
    measured = {}
    for b, n, heads, d in KERNEL_SHAPES:
        for dtype_name, tol in TOLERANCE.items():
            dtype = getattr(torch, dtype_name)
            rng = np.random.default_rng(b * 100003 + n * 17 + heads)
            qkv = torch.from_numpy(
                rng.standard_normal((b, n, 3 * heads * d)).astype(np.float32)
            ).to(dev, dtype)
            valid = _valid_lengths(b, n)
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
            # Valid keys only: a padded key gets no weight.
            flops = 4.0 * heads * d * n * sum(valid)
            bound_ms, bound_by = bound((qkv, cos, sin, mask, out), flops, dtype_name)
            measured[(b, n, heads, d, dtype_name)] = (ms, plain_ms, bound_ms, bound_by)
            log(
                f"[3] fused_rope B={b} N={n} H={heads} D={d} {dtype_name} "
                f"{fra.kernel_variant(dtype, d)}: max-abs "
                f"{err:.3e} (tol {tol:.0e}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"bound {bound_ms:.5f} ms ({bound_by}) [{card}]"
            )
    ms, plain_ms, bound_ms, bound_by = measured[(*LATENCY_SHAPE, "bfloat16")]
    return {
        "name": "fused_qkv_rope_attention",
        "route": "cuda",
        "source": "vietvoice_tts_tpu_torch/csrc/fused_rope_attention.cu",
        "replaces": "vietvoice_tts_tpu/ops/pallas/fused_rope_attention.py:123",
        "launches": None,
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call does RoPE plus attention
    }


def phase_flash_kernel(card: str) -> dict:
    """flash_attention vs ``ops.attention.attention`` at every shape, dtype
    and layout; returns the record (times at the latency shape, bf16, v as
    the DiT passes it)."""
    import torch
    import torch.nn.functional as F

    from vietvoice_tts_tpu_torch.ops.attention import NEG_INF, attention
    from vietvoice_tts_tpu_torch.ops.kernels import flash_attention as fa

    dev = torch.device("cuda")
    worst = 0.0
    measured = {}
    for b, heads, n, d in FLASH_SHAPES:
        for dtype_name, tol in TOLERANCE.items():
            dtype = getattr(torch, dtype_name)
            rng = np.random.default_rng(b * 100003 + n * 17 + heads)
            qkv = torch.from_numpy(
                rng.standard_normal((b, n, 3 * heads * d)).astype(np.float32)
            ).to(dev, dtype)
            valid = _valid_lengths(b, n)
            mask = torch.from_numpy(
                np.arange(n)[None, :] < np.asarray(valid)[:, None]
            ).to(dev)
            views = [t.reshape(b, n, heads, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1)]
            layouts = {
                "contiguous": tuple(t.contiguous() for t in views),
                # The DiT's split-heads route: q and k fresh after RoPE, v a
                # view into the packed projection.
                "packed-v": (views[0].contiguous(), views[1].contiguous(), views[2]),
            }
            for layout, (q, k, v) in layouts.items():
                out = fa.flash_attention(q, k, v, mask)
                ref = attention(q, k, v, mask)
                torch.cuda.synchronize()
                err = max(
                    (out[i, :, :nv].float() - ref[i, :, :nv].float()).abs().max().item()
                    for i, nv in enumerate(valid)
                )
                if not np.isfinite(err) or err > tol:
                    raise AssertionError(
                        f"flash kernel vs plain at B={b} H={heads} N={n} D={d} "
                        f"{dtype_name} {layout}: max-abs {err:.3e} > {tol:.0e}"
                    )
                worst = max(worst, err)
                ms = cuda_ms(lambda: fa.flash_attention(q, k, v, mask))
                plain_ms = cuda_ms(lambda: attention(q, k, v, mask))
                bias = torch.zeros((b, 1, 1, n), dtype=dtype, device=dev)
                bias = bias.masked_fill(~mask[:, None, None, :], NEG_INF)
                library_ms = cuda_ms(
                    lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
                )
                flops = 4.0 * heads * d * n * sum(valid)
                bound_ms, bound_by = bound((q, k, v, mask, out), flops, dtype_name)
                measured[(b, heads, n, d, dtype_name, layout)] = (
                    ms, plain_ms, library_ms, bound_ms, bound_by)
                log(
                    f"[3] flash B={b} H={heads} N={n} D={d} {dtype_name} {layout} "
                    f"{fa.kernel_variant(dtype, d)}: max-abs {err:.3e} (tol {tol:.0e}); kernel {ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {bound_ms:.5f} ms "
                    f"({bound_by}) [{card}]"
                )
    ms, plain_ms, library_ms, bound_ms, bound_by = measured[
        (*FLASH_LATENCY_SHAPE, "bfloat16", "packed-v")]
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "vietvoice_tts_tpu_torch/csrc/flash_attention.cu",
        "replaces": "vietvoice_tts_tpu/ops/pallas/flash_attention.py:53",
        "launches": None,
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
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


def _reset_launches() -> None:
    from vietvoice_tts_tpu_torch.ops.kernels import flash_attention as fa
    from vietvoice_tts_tpu_torch.ops.kernels import fused_rope_attention as fra

    fra.launches = fa.launches = 0


def _launches() -> dict:
    from vietvoice_tts_tpu_torch.ops.kernels import flash_attention as fa
    from vietvoice_tts_tpu_torch.ops.kernels import fused_rope_attention as fra

    return {"fused_rope": fra.launches, "flash": fa.launches}


def _kernel_vs_plain_latent(label, cfg, params, vocab_size, args, x0, total_len,
                            route, want_launches, card) -> None:
    """One config's mel latent with the kernel and with the plain path, in
    both dtypes; ``route`` names the kernel that must do all the launches."""
    import torch

    from vietvoice_tts_tpu_torch.runtime.engine_core import EngineCore

    for dtype, (max_tol, mean_tol) in MEL_TOLERANCE.items():
        latents = {}
        for use_kernels in (True, False):
            run_cfg = dataclasses.replace(cfg, compute_dtype=dtype, use_kernels=use_kernels)
            core = EngineCore(run_cfg, params, vocab_size)
            _reset_launches()
            t0 = time.perf_counter()
            lat = core.mel_latent_batch(*args, x0=x0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = _launches()
            want = {k: (want_launches if use_kernels and k == route else 0) for k in got}
            if got != want:
                raise AssertionError(
                    f"{label} {dtype} use_kernels={use_kernels}: launches {got}, want {want}"
                )
            if lat.shape != x0.shape or not np.isfinite(lat).all():
                raise AssertionError(f"{label}: bad {dtype} latent, shape {lat.shape}")
            latents[use_kernels] = lat[:, :total_len]
            log(f"[4] {label} {dtype} mel latent, use_kernels={use_kernels}: "
                f"{wall * 1e3:.1f} ms (first solve of a fresh core), launches {got}, "
                f"max |latent| {np.abs(lat).max():.3f} [{card}]")
            del core
            torch.cuda.empty_cache()
        diff = np.abs(latents[True] - latents[False])
        err, mean = float(diff.max()), float(diff.mean())
        log(f"[4] {label} {dtype} whole-path mel latent, kernel vs plain: max-abs "
            f"{err:.3e} (tol {max_tol:.0e}), mean-abs {mean:.3e} (tol {mean_tol:.0e}) "
            f"on {total_len} valid frames")
        if not (err <= max_tol and mean <= mean_tol):
            raise AssertionError(f"{label} {dtype} whole-path kernel vs plain outside tolerance")


def phase_whole_path(cfg, cfg32, card: str) -> None:
    from vietvoice_tts_tpu_torch.pipeline.audio import AudioProcessor
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
    ref = AudioProcessor.load_audio(ref_audio, cfg.sample_rate).astype(np.float32) / 32768.0
    wave = np.zeros((b, n * hop), np.float32)
    wave[0, : min(len(ref), n * hop)] = ref[: n * hop]
    ids = np.full((b, n), -1, np.int32)
    ids[:, :120] = rng.integers(0, mgr.vocab_size, (b, 120))
    x0 = rng.standard_normal((b, n, cfg.n_mels)).astype(np.float32)
    args = (wave, np.array([ref_len]), ids, np.array([total_len]))

    depth, evals = cfg.dit_depth, cfg.nfe_step - 1
    shallow = 7
    full_evals = -(-evals // 2)  # every second eval, the first included
    runs = [
        # The default model: the fused RoPE kernel in every block and step.
        ("8x128", cfg, "fused_rope", depth * evals),
        # The same widths split 32 × 32: the split-heads route.
        ("32x32", cfg32, "flash", depth * evals),
        # CFG cache: doubled and cond-only evals alike launch once per block.
        ("32x32 uncond_interval=2",
         dataclasses.replace(cfg32, nfe_uncond_interval=2), "flash", depth * evals),
        # Deep-block cache: full depth every second eval, 7 blocks between.
        ("32x32 deep_cache_interval=2",
         dataclasses.replace(cfg32, nfe_deep_cache_interval=2, nfe_deep_cache_blocks=shallow),
         "flash", full_evals * depth + (evals - full_evals) * shallow),
    ]
    for label, run_cfg, route, want in runs:
        _kernel_vs_plain_latent(label, run_cfg, params, mgr.vocab_size, args, x0,
                                total_len, route, want, card)


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


def _timed_request(name, cfg, smi, synthesize):
    """Run one blocking request, check its audio, log its wall time."""
    import torch

    t0 = time.perf_counter()
    wave, _ = synthesize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if wave.dtype != np.int16 or wave.size == 0 or not np.any(wave):
        raise AssertionError(f"{name}: bad audio dtype={wave.dtype} size={wave.size}")
    secs = wave.size / cfg.sample_rate
    log(f"[5] {name}: {wall * 1e3:.1f} ms wall, {secs:.2f} s audio, "
        f"{secs / wall:.2f} audio-s/s [{smi}]")
    return wave


def phase_serving(cfg, cfg32, smi: str) -> dict:
    """Serve through ``TTSApi`` on both models; returns each kernel's launch
    count over the requests (counters set to 0 just before, read just after)."""
    import torch

    from vietvoice_tts_tpu_torch import TTSApi

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
    per_batch = cfg.dit_depth * (cfg.nfe_step - 1)
    api = TTSApi(cfg)
    engine = api.engine  # loads the pack before the counted run
    expected = 0
    for name, text, voice in requests:
        n_batches, n_chunks = _chunk_batches(engine, text, **voice)
        expected += n_batches * per_batch
        log(f"[5] {name}: {n_chunks} chunk(s) in {n_batches} batch(es)")
        if name == "long":
            if not (n_chunks >= 2 and n_batches == 1):
                raise AssertionError(
                    f"long text plans to {n_chunks} chunks in {n_batches} batches; "
                    "want ≥ 2 chunks in one batch"
                )
            # Streaming (run twice) dispatches every chunk as a batch of one.
            expected += 2 * n_chunks * per_batch

    _reset_launches()  # count the main path's run only
    outputs = {
        name: _timed_request(name, cfg, smi, lambda: api.synthesize(text, **voice))
        for name, text, voice in requests
    }
    if not np.array_equal(outputs["short"], outputs["short-again"]):
        raise AssertionError("the same short request gave different audio")

    # Twice: the first streaming request allocates its pinned host buffers.
    timer = engine.engine_core.timer
    for name in ("streaming long", "streaming long again"):
        timer.reset()
        t0 = time.perf_counter()
        pieces, first = [], None
        for piece in api.synthesize_streaming(long_text):
            if first is None:
                first = time.perf_counter() - t0
            pieces.append(piece)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stream, blocking = np.concatenate(pieces), outputs["long"]
        if len(pieces) < 2 or any(p.dtype != np.int16 for p in pieces):
            raise AssertionError(f"{name} gave {len(pieces)} piece(s)")
        if stream.shape != blocking.shape:
            raise AssertionError(f"{name}: {stream.shape} vs blocking {blocking.shape} samples")
        diff = np.abs(stream.astype(np.int32) - blocking.astype(np.int32))
        max_diff, mean_diff = int(diff.max()), float(diff.mean())
        log(f"[5] {name}: {len(pieces)} pieces, first after {first * 1e3:.1f} ms, "
            f"all after {wall * 1e3:.1f} ms ({timer.totals['chunk_dispatch'] * 1e3:.1f} ms "
            f"of it dispatching, {timer.totals['chunk_fetch'] * 1e3:.1f} ms fetching); "
            f"against blocking: largest sample difference "
            f"{max_diff} (tol {STREAM_TOLERANCE[0]}), mean {mean_diff:.4f} "
            f"(tol {STREAM_TOLERANCE[1]}) of 32767 [{smi}]")
        if max_diff > STREAM_TOLERANCE[0] or mean_diff > STREAM_TOLERANCE[1]:
            raise AssertionError(f"{name} differs from blocking beyond STREAM_TOLERANCE")

    launches = _launches()
    if launches != {"fused_rope": expected, "flash": 0}:
        raise AssertionError(f"8x128 serving launched {launches}, want {expected} fused_rope")
    log(f"[5] 8x128 serving: {expected} fused_rope launches ({per_batch} per chunk "
        "batch and per streamed chunk), short request deterministic")
    api.cleanup()

    # The same pack served with 32 heads of 32: the split-heads route.
    api32 = TTSApi(cfg32)
    n_batches, n_chunks = _chunk_batches(api32.engine, short)
    _reset_launches()
    _timed_request("short 32x32", cfg32, smi, lambda: api32.synthesize(short))
    launches32 = _launches()
    if launches32 != {"fused_rope": 0, "flash": n_batches * per_batch}:
        raise AssertionError(f"32x32 serving launched {launches32}")
    log(f"[5] 32x32 serving: {launches32['flash']} flash launches")
    api32.cleanup()
    return {"fused_rope": launches["fused_rope"], "flash": launches32["flash"]}


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
    fused_record = phase_kernels(card)
    flash_record = phase_flash_kernel(card)
    torch.cuda.synchronize()
    cfg = ModelConfig(device="cuda", model_cache_dir=str(WORK / "models"))
    # The default model's widths with a head split the fused kernel does not
    # take (head_dim 32); the weights do not depend on the split.
    cfg32 = dataclasses.replace(cfg, dit_heads=32)
    phase_whole_path(cfg, cfg32, card)
    torch.cuda.synchronize()
    launches = phase_serving(cfg, cfg32, smi)
    torch.cuda.synchronize()
    fused_record["launches"] = launches["fused_rope"]
    flash_record["launches"] = launches["flash"]
    if not all(launches.values()):
        raise AssertionError(f"a kernel was never launched on the main path: {launches}")

    print(json.dumps({"kernels": [fused_record, flash_record]}))
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
