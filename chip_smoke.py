#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``vietvoice_tts_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card, ``nvcc`` (PATH, $CUDA_HOME or /usr/local/cuda) and
no network. It exits non-zero, before printing any result, when CUDA is
unavailable or the package is not beside it. Phases, in order (any failed
check raises):

1. The card's name and power limit, as ``nvidia-smi`` reports them.
2. Build every CUDA source of the package from ``csrc/``, all at once (the
   two attention kernels, ``adaln_norm.cu`` and ``graph_fill.cu``, the fill
   kernel that stands in for the captured graphs' memset nodes); then count
   the ``HGMMA`` instructions (the machine code of ``wgmma``) in each
   attention library's SASS, which must not be zero: the bfloat16 paths are
   on the tensor cores.
3. Each kernel against its plain PyTorch version on the card, at the shapes
   the serving path gives it (KERNEL_CASES, FLASH_CASES: the head widths
   each kernel took before and those from 256 for kernel 1, 72, 96 and 320
   for kernel 2), in float32 (max-abs ≤ 1e-4: both sides are
   true f32 with TF32 off) and bfloat16 (max-abs ≤ 1e-2, about one bf16 ulp
   of an output below 2), with the variant that ran (``wgmma`` in bfloat16,
   ``tf32x3`` in float32: both on the tensor cores; the wrapper's and the
   library's must agree) and kernel and plain times; in float32 also
   against the plain emulation of the kernel's split-TF32 products
   (``attention_tf32x3``, ``fused_qkv_rope_attention_tf32x3``), and the q
   and k that kernel 1's rotation pass writes equal the plain rotation bit
   for bit (both dtypes, wherever a call runs two passes); for
   ``flash_attention`` also with v as a strided view of a packed projection
   (the DiT's layout) and beside ``scaled_dot_product_attention`` (and the
   backend PyTorch picks for it), a yardstick that the package never calls.
   The kernels' record lists, shape by shape (``shapes``), every float32
   case and the bfloat16 widths beyond kernel 1's 64 and 128 and kernel
   2's 32, 64 and 128. Then the AdaLN kernel (``csrc/adaln_norm.cu``, the
   DiT block's gated residual and modulated LayerNorm) against its plain
   version, the eager chain, at ADALN_SHAPES (the benchmark cell's 1,408
   rows × 1024 in bfloat16 first) in its forms (b), (a), (c) and the
   final float32 norm: h' bit for bit, u within one ulp (two for float32
   outputs) of the largest |u|; kernel, plain and byte bound times.
4. Whole-path parity at full width, for both attention routes of the DiT:
   the default model (8 heads × 128, the fused RoPE kernel) and the same
   widths split 32 × 32 (the split-heads route, ``flash_attention``). The
   mel latent of ``EngineCore.mel_latent_batch`` from one injected noise,
   with the kernel and with the plain path, on a seeded pack whose AdaLN
   gates are opened (the shipped pack's zero gates would multiply attention
   by 0), in float32 (max-abs ≤ 1e-2, the BASELINE mel gate) and in the
   serving bfloat16 (bounded by its measured noise floor, see
   MEL_TOLERANCE), with exactly 22 × 31 = 682 launches of the route's kernel
   per solve and none of the other, and 31 × (1 + 2 × 22) = 1,395 of the
   AdaLN kernel (none on the plain path). Then the sampler caches at 32 ×
   32, each against its own plain-path run: the CFG cache (682 launches)
   and the deep-block cache (16 × 22 + 15 × 7 = 457; AdaLN 16 × 46 + 15 ×
   16 = 976, a split forward's segments each ending in a residual alone). The kernel's solve is one
   graph replay; the plain path runs eagerly (a comparison), and on both
   routes the kernel's replay is also held against the eager program
   bodies of the same core (LATENT_TOLERANCE).
15. (Run right after phase 4.) The head shapes of HEAD_SHAPES, each a DiT
    at full depth with the default widths otherwise: 4 × 256, 3 × 384 and
    2 × 512 (kernel 1, JAX's fused-kernel widths) and 12 × 96 and 16 × 72
    (kernel 2, JAX's XLA route; 16 × 72 are DiT-XL/2's heads), width 1152 on
    a seeded pack of its own: one short request through ``TTSApi`` (int16
    PCM with sound in it, each chunk batch one graph replay with 682
    launches of the route's kernel and none of the other), then the
    whole-path mel latent, kernel against plain, gates opened, in bfloat16
    and, for 2 × 512 and 16 × 72, in float32, within MEL_TOLERANCE.
5. Serving through ``TTSApi``: a short sentence twice (must be identical),
   a voice clone from a WAV written here, and a long text that plans to ≥ 2
   chunks in one batch (682 launches per chunk batch); the long text again
   through ``synthesize_streaming`` (≥ 2 pieces, 682 launches per chunk,
   held against the blocking output within STREAM_TOLERANCE); and a short
   request on the 32 × 32 model.
6. Concurrent serving through the micro-batcher: one ``TTSApi`` with
   ``enable_micro_batching`` and ``warmup`` of the shapes used; eight client
   threads with one short sentence each, released together (twice); the long
   text and two short requests together; the long text streamed through the
   batcher; then 24 jobs at once with ``pipeline_depth`` 1 and 2, in the
   order 1, 2, 2, 1 (time from submit to the first, median and last
   resolved future; depth 2 against depth 1). The phase-5 ``short`` and ``long``
   must come back within STREAM_TOLERANCE of their solo outputs, with no
   retry and no failure, more than one job per batch, 682 launches of the
   fused kernel per dispatched batch and none of the other, cache hits for
   the shared voice, and a batcher that refuses work after ``cleanup``. Then
   four threads on the 32 × 32 model (682 ``flash_attention`` launches per
   batch).
7. The command line: ``python -m vietvoice_tts_tpu_torch`` as a subprocess
   with no ``--device``, default voice and a cloned voice: exit code 0, a
   24 kHz mono int16 WAV with sound in it, and in its output the device
   (``cuda``) and 682 launches of the fused kernel.
8. The REST app in process (``AsyncTestClient``), engine on the card with the
   batcher: health reports CUDA and one device; four ``/synthesize`` posts
   gathered at once return four WAVs; ``/synthesize/stream`` yields a header
   and ≥ 2 pieces for the long text; ``/stats`` holds device memory and the
   batcher's numbers; ``/metrics`` parses.
9. Training at the default model's full width (8 heads × 128, bfloat16
   compute, float32 master weights) on a copy of the seeded pack under
   ``build/chip_smoke/train/`` (``train()`` exports into the pack it trains):
   (a) ``train()`` in process, batch 8 for 8 steps with checkpoints every 4,
   then resumed to step 12 — finite losses, the right final steps, **no**
   kernel launch (neither kernel has a backward), every step a CUDA graph's
   capture or replay (one capture per (batch, frames) key, a replay for
   every other step), a moved ``blocks.*.ada``;
   after each run the latest checkpoint, loaded into a DiT and optimizer
   that ``init_train_state`` builds on the card, holds float32 weights and
   Adam moments on the card at the run's step, and the ``dit`` tree the run
   exported from its trained module is bit-equal to ``to_jax_tree`` of it;
   with the step time (data loading excluded), tokens/s,
   6·P·tokens against the bf16 peak and peak memory; (b) one float32 step
   at dim 1024, depth 2, card against CPU with TF32 off (loss within 1e-5
   relative, each gradient leaf within 1e-4 of its max-abs); (c) ``TTSApi``
   on the trained pack serves a short request (682 fused-kernel launches);
   (d) ``python -m vietvoice_tts_tpu_torch.training`` as a subprocess with no
   ``--device``, on a seeded pack of 2 layers at the full widths: exit code
   0, ``cuda`` and a finite final loss; (e) the train step as graph replays
   against eager steps from one state, full width, batch 8 × 256, a new
   learning rate every step, in bf16 and in f32 (TF32 off): 8 steps
   bit-identical in every loss, parameter and Adam moment, with each mode's
   step ms, tokens/s, 6·P·tokens against the peak, traced device time and
   idle share, peak memory, and the graph's capture wall, nodes by type (no
   memset; 14 (c) times the launch of graphs of the same steps) and pool.
10. Conversion day at the F5 widths (``models/f5_fixture.py:FixtureSpec``:
    dim 1024, 16 heads × 64 — kernel 1's head shape — ff_mult 2, text 512 ×
    4 conv layers, 100 mels, vocab 211, vocoder 512/1536/8), from a synthetic
    F5-shaped ``model-bin.pt`` (three ONNX graphs; no real weights offline):
    (a) the rehearsal cut to depth 2 and NFE 8 — the fixture, the port's
    ``preflight_report`` (ok, kernel 1), ``convert_reference_tarball`` (no
    unresolved leaf), the golden reference side through the numpy evaluator,
    then on the card the golden torch side: float32 (TF32 off) mel MAE
    < 1e-4 and allclose at 1e-2, bfloat16 max-abs ≤ 5e-2, exactly
    depth × (NFE − 1) = 14 kernel-1 launches per solve and none of kernel 2,
    the same pack with ``use_kernels=False`` within 1e-2 (f32) and 5e-2
    (bf16) of the kernel's latent, and ``decode.onnx`` through the evaluator
    against the port's vocoder in float32 within 1 LSB of int16; (b) the whole
    depth (22 layers, ~336 M parameters) through the entry points: the
    fixture, preflight and convert command lines as timed subprocesses, then
    ``TTSApi`` on the converted pack, which is not synthetic and loads with
    ``allow_synthetic_pack=False``, serves the short sentence in bfloat16
    cold and warm with 682 kernel-1 launches per dispatched batch; (c) the
    native cross-fade (``native/``, built with ``g++``) on a three-chunk text,
    blocking and streamed: the join counter moves, every join within 1 LSB
    of the numpy cross-fade of the same chunks, and their times side by side.
11. ``parallel/`` at the default model's widths and 4 of its 22 layers
    (``P11_DEPTH``, a seeded pack of its own), as ranks (processes started
    here) that share the card over gloo (NCCL refuses two ranks on one
    device), each against one rank in this process, gates opened:
    (a) tensor parallelism, TP 2, ``EngineCore.mel_latent_batch`` at bucket
    384 from one injected noise — 8 × 128 in float32 (TF32 off, ≤ 1e-2) and
    bfloat16 (≤ MEL_TOLERANCE), 16 × 64 and 32 × 32 in bfloat16 — with 4 × 31
    = 124 launches per rank of kernel 1 at 4 × 128 and 8 × 64 and of kernel 2
    at 16 × 32; (b) Ulysses, sequence parallel 2, bucket 2048, bfloat16, 124
    kernel-1 launches per rank on all 2048 frames at 4 heads; (c) the ring,
    sequence parallel 3 (8 heads do not split over 3), bucket 384, float32,
    no kernel;
    (d) data parallelism, four rows at bucket 256 split 2 + 2, PCM within 64
    of 32767; (e) two float32 train steps of DP 2 and of TP 2, batch 8 ×
    256, loss within 1e-5 relative and every parameter leaf within 1e-4 of
    its max-abs, no launch; (f) ``MultiHostServingLoop`` on TP 2 in float32:
    rank 0 submits the short request's chunk and the long text's first
    chunk, both ranks dispatch in lockstep (124 launches per dispatch), the
    served PCM within STREAM_TOLERANCE, and rank 0's stop ends both loops. Every
    tensor at a collective and every DiT and vocoder output must be on the
    card. The ranks' collectives are staged through host memory: no time
    of this phase is a scaling number.

12. The golden harness's sweeps (``golden.py`` in the package) on 10 (b)'s
    converted pack (16 × 64, 22 layers, NFE 32, kernel 1): (a)
    ``precision_drift`` at the JAX harness's buckets 384, 448, 512, 704 —
    per bucket a float32 solve (TF32 off) and a bf16 one, mel MAE, max-abs
    and relative MAE logged, a breach of 5e-2 reported and not gated —
    with exactly 8 × 682 kernel-1 launches; then the sweeps' reference
    solve below (bucket 448) with kernel 1 and without, in float32 within
    1e-2 max-abs (the BASELINE mel gate at full depth) and in bf16 within
    MEL_TOLERANCE, each bf16 latent also against the float32 one (kernel or
    bf16 arithmetic: which one drifts); (b) ``deep_cache_sweep`` at its default
    settings (1, 7), (2, 7), (2, 11), (3, 7), bf16, one untimed and two
    timed solves each, at bucket 448 from the pack's reference clip, the
    golden text and seeded noise, against the port's own float32 exact
    latent (so ``mel_mae_vs_onnx`` there is "vs float32 exact"): exactly
    3 × Σ 22·⌈31/r⌉ + j·(31 − ⌈31/r⌉) = 6,114 launches, which proves the
    shallow evaluations skip blocks; (c) ``cfg_cache_sweep`` 1, 2, 4 alike:
    682 launches a solve at every k (a cond-only evaluation is still one
    launch a block), 6,138; (d) ``python -m vietvoice_tts_tpu_torch.golden
    --cfg-cache-sweep 1,2`` on 10 (a)'s depth-2 pack and its ONNX reference
    side (one JSON line, k=1 within the f32 golden gate), and
    ``--deep-cache-sweep 2:1`` exits 2 (no exact baseline); (e) the bf16
    settings of (b) and (c) on one core, timed over five rounds
    in an order rotated each round (medians), then one solve each under
    ``torch.profiler``: its device kernel time, and the device's idle share
    of the median — 7 × 3,402 = 23,814 launches.
13. The port's bench harness (``vietvoice_tts_tpu_torch/bench.py``, the root
    ``bench.py``'s configs) on phase 5's seeded pack: (a) ``python -m
    vietvoice_tts_tpu_torch.bench --skip-rest`` as a subprocess, started
    before phase 11 and awaited after it (to keep the script's time; it
    measures nothing here) — exit 0, a
    last line with the root harness's compact keys, ``backend`` ``cuda``, a
    value above 0, its full record under ``build/chip_smoke/bench/``, and
    682 kernel-1 launches per dispatched batch in that record; (b) the REST
    sweep in this process at 16 requests a point, through the bench's own
    ``_rest_sweep_point`` (c = 6, and c = 12 with a batch cap of 12) and
    ``_rest_open_loop_point`` (12 req/s): no failed request, a mean batch
    size above 1 in each closed-loop point, 682 launches per dispatched
    batch; (c) row 0 of a batch of 32 at 512 frames, dispatched as
    ``bench_batched`` dispatches it, against the same row alone at batch 1
    with the same seed, within STREAM_TOLERANCE.
14. The captured chunk programs (``runtime/graphs.py``; run after phase 8,
    before phase 9, on an idle card and before any ``torch.profiler``
    session, which leaves CUPTI attached and slows every later graph
    launch), on a seeded pack with opened gates: (a) each batch through its
    CUDA graph twice against the eager program bodies of the same core on
    the same inputs — the short sentence (bucket 384) and the voice clone
    (768) on both routes (cached conditioning, waveform) and batch 8 × 1024
    — as int16 PCM within STREAM_TOLERANCE, the largest difference printed
    either way (phase 4 holds the mel latent of both routes in float32 and
    bfloat16 within LATENT_TOLERANCE, 10 (b) the 16 × 64 pack and 13 (c)
    batch 32 × 512 the same way); (b) five batches of three shapes
    dispatched out of capture order, three of one shape outstanding,
    fetched in reverse, each equal to its own eager run; (c) each of a DiT
    block's four GEMMs captured alone at 1 × 2048, 8 × 1024 and 1 × 384
    (2 · batch rows), with the memset nodes cuBLAS put into the capture,
    then rewritten: no memset left, replays and the eager call
    bit-identical, and both replays' device µs; per graph of the phase (the
    serving grid of the short sentence's bucket, bucket 2048 at batch 1
    and 8, and (a)'s),
    then per train step graph at 9 (e)'s shape (bf16 and f32, captured
    here), its capture wall, nodes by type, nodes rewritten, attention
    launches, replay device ms and the host's ms to launch it — no memset
    node and a median launch within HOST_LAUNCH_MS (2 ms), or the phase
    fails — and the device memory reserved before and after the warm-up;
    (d) batch 1, eager against graph, interleaved over P14_ROUNDS: the
    short request, its chunk, the chunk's host dispatch and
    ``compute_ms_b1``; interleaved over P14_STREAM_ROUNDS, the long text's
    first streamed piece with the port's order, JAX's (up to three chunks
    queued), against one chunk at a time: its median no later than one at
    a time's median plus spread; (e), after phase 13, one traced chunk in
    each mode (device kernel time, the device's idle share of (d)'s median)
    and the chunk graph's launch after those traces.

Phases 2-4, 15, 10 (a) and 12 (a) hold each kernel against its plain
version; the main path whose launches the kernels' record counts is every
serving request of phases 5-11 and 15, every solve of phase 12 and every
batch of phase 13
(counters set to 0 just before, read just after; in phase 11 each rank
counts its own, in 13 (a) the bench's process, and the record sums them).
Every such check counts the AdaLN kernel beside the attention kernels:
1 + 2·depth launches a forward wherever the attention kernels run (1,395 a
chunk batch at 22 layers), also on phase 11's ring, where neither attention
kernel does, and none in training or on the plain path (``_forwards``).
On a core without a mesh every chunk batch is one CUDA-graph replay: the
wrappers count at capture, the capture takes its counts back, and every
replay adds the launches it recorded; phases 4-10, 12 and 13 check that
each batch of the window was one replay (phase 11's ranks run eagerly,
under a mesh). Each phase's wall time is logged, and all of them at the end.

The last lines are the kernels' JSON record, the ``nvidia-smi`` line, and
``{"ok": true, "device": {...}}``. Weights are random, made from a seed, and
kept under ``build/chip_smoke/`` in the checkout.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import wave as wave_file
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
TRAIN_WORK = WORK / "train"  # a copy of the seeded pack, trained and served by phase 9

# Phase-3 shapes (B, N, H, D): B = 2 × batch for CFG; N from the frame
# buckets; 8×128 is the default model, 16×64 a converted F5 model; 448 is
# the batch-1 latency shape, 437 an N that is not a multiple of 8, and
# B = 6 at 2048 the long text's three chunks as one blocking batch. The
# next three are a rank's heads in phase 11: 8×128 and 16×64 split over
# tensor parallelism 2 at bucket 384, and Ulysses 2's 4 heads on the whole
# 2048 frames. The last four are phase 12's at 16×64: the precision_drift
# buckets 384, 448 and 704 (448 and 704 end on a half-empty 128-row query
# block), and batch 1 at 448, the CFG cache's cond-only evaluations. Then
# the bench's (vietvoice_tts_tpu_torch/bench.py, phase 13) at 8×128: the
# breakdown's and the REST sweep's bucket 384, the short sentence's 440
# (tail block of 56 rows), the warm-up's 544, the streamed 4 s head chunk's
# 640, the voice clone's 704, the long text's two chunks at 2048 in one
# batch, the sweep's batch cap of 12 at 384, batch 32 and batch 64 at 512.
KERNEL_SHAPES = [
    (2, 512, 8, 128),
    (2, 512, 16, 64),
    (2, 448, 8, 128),
    (16, 1024, 8, 128),
    (2, 2048, 8, 128),
    (6, 2048, 8, 128),
    (2, 437, 8, 128),
    (2, 384, 4, 128),
    (2, 384, 8, 64),
    (2, 2048, 4, 128),
    (2, 384, 16, 64),
    (2, 448, 16, 64),
    (2, 704, 16, 64),
    (1, 448, 16, 64),
    (2, 384, 8, 128),
    (2, 440, 8, 128),
    (2, 544, 8, 128),
    (2, 640, 8, 128),
    (2, 704, 8, 128),
    (4, 2048, 8, 128),
    (24, 384, 8, 128),
    (64, 512, 8, 128),
    (128, 512, 8, 128),
]
LATENCY_SHAPE = (2, 448, 8, 128)
# Phase-3 cases of each kernel: (shape, dtypes). Every shape above in both
# dtypes; then the head widths from 256 up, which the fused kernel serves in
# two passes in bfloat16 too (q and k rotated into scratch, then the wide
# kernel): phase 15's heads at the short sentence's batch-1 bucket 448
# (4 × 256, 3 × 384, 2 × 512, both dtypes) and 2 × 512 as the long text's
# three chunks at 2048 in one batch.
KERNEL_CASES = [(shape, ("float32", "bfloat16")) for shape in KERNEL_SHAPES] + [
    ((2, 448, 4, 256), ("float32", "bfloat16")),
    ((2, 448, 3, 384), ("float32", "bfloat16")),
    ((2, 448, 2, 512), ("float32", "bfloat16")),
    ((6, 2048, 2, 512), ("bfloat16",)),
]
# Phase-3 shapes of flash_attention, (B, H, N, D): 32×32 is the default
# model's width split into heads the fused kernel does not take (its batch-1
# latency shape first); then 16×64, and one shape at each of 128, 256 and
# 96; the last is a rank's 16 heads of 32×32 under phase 11's tensor
# parallelism 2 at bucket 384. The kernel takes every multiple of 8 up to
# 1024: FLASH_CASES adds phase 15's split-heads widths at bucket 448,
# 16 × 72 (DiT-XL/2's heads) and 12 × 96, and 4 × 320, a width above 256
# (the wide kernel, two column blocks of 192).
FLASH_SHAPES = [
    (2, 32, 448, 32),
    (2, 32, 2048, 32),
    (16, 32, 1024, 32),
    (2, 16, 512, 64),
    (2, 8, 437, 128),
    (2, 4, 448, 256),
    (2, 8, 512, 96),
    (2, 16, 384, 32),
]
FLASH_CASES = [(shape, ("float32", "bfloat16")) for shape in FLASH_SHAPES] + [
    ((2, 16, 448, 72), ("float32", "bfloat16")),
    ((2, 12, 448, 96), ("float32", "bfloat16")),
    ((2, 4, 448, 320), ("float32", "bfloat16")),
]
FLASH_LATENCY_SHAPE = (2, 32, 448, 32)
# Published peaks of one H100 SXM (NVIDIA's data sheet; dense): device
# memory bytes/s, and flop/s by input type, both on the tensor cores:
# bfloat16 at 989 TFLOP/s; float32 as the kernels take it, in split TF32,
# three TF32 products (495 TFLOP/s) for every float32 one, so 495 / 3 = 165
# TFLOP/s of float32 work (the SIMT pipes' 67 would let a tensor-core kernel
# read above 100% of its bound).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12 / 3}
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


# Phase 10: the F5 fixture (FixtureSpec's defaults are the F5 widths). The
# rehearsal's numpy reference side is what costs, so it is cut in depth and
# steps; the served pack has the whole depth.
F5_WORK = WORK / "f5"
F5_PACK = F5_WORK / "full" / "packs" / "vietvoice-tpu-v1"  # phase 10 (b)'s, served by 12
REHEARSAL_PACK = F5_WORK / "rehearsal" / "pack"
REHEARSAL_REF = F5_WORK / "rehearsal" / "ref.npz"  # 10 (a)'s reference side, for 12 (d)
REHEARSAL_DEPTH, REHEARSAL_NFE = 2, 8
GOLDEN_F32 = (1e-4, 1e-2)  # mel MAE, allclose atol: the golden gate in float32
GOLDEN_BF16_MAX = 5e-2  # the port's bf16 bound (MEL_TOLERANCE)
GOLDEN_TEXT = "Xin chào Việt Nam."


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
    # graph_fill.cu holds the fill kernel that stands in for the captured
    # graphs' memset nodes (runtime/graphs.py), adaln_norm.cu the DiT block's
    # gated residual and modulated norm; neither has a tensor-core path.
    others = ("adaln_norm", "graph_fill")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names) + len(others)) as pool:
        list(pool.map(load_library, (*names, *others)))
    log(f"[2] built {', '.join(names + others)} in {time.perf_counter() - t0:.2f} s")
    for name in (*names, "adaln_norm"):
        report = build_report(name)
        spills = sum(
            int(m) for m in re.findall(r"(\d+) bytes spill (?:stores|loads)", report))
        registers = [int(m) for m in re.findall(r"Used (\d+) registers", report)]
        sass = ""
        if name in names:
            hgmma = count_sass(name, "HGMMA")
            if hgmma == 0:
                raise AssertionError(f"{name}: no HGMMA in the SASS, wgmma path missing")
            sass = f"{hgmma} HGMMA instructions in the SASS; "
        log(f"[2] {name}: {sass}ptxas: {len(registers)} kernels, at most "
            f"{max(registers, default=0)} registers, {spills} bytes of spills")


def bound(tensors, flops: float, dtype_name: str) -> tuple[float, str]:
    """(least ms the card could take, "bytes" or "operations"): each input
    read once and each output written once at the memory rate, against the
    operations at the peak rate for the inputs' type."""
    n_bytes = sum(t.numel() * t.element_size() for t in tensors)
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _c_variant(module, dtype_name: str, d: int) -> str | None:
    """The variant the kernel's library itself takes for (dtype, head_dim)."""
    import ctypes

    from vietvoice_tts_tpu_torch.ops.kernels.build import load_library

    fn = getattr(load_library(module.KERNEL), f"vv_{module.KERNEL}_variant")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    return {1: "wgmma", 2: "tf32x3"}.get(fn(d, {"float32": 0, "bfloat16": 1}[dtype_name]))


def _checked_variant(module, dtype_name: str, d: int) -> str:
    """The variant that serves (dtype, head_dim), the same from the wrapper
    and from the library: ``wgmma`` in bfloat16, ``tf32x3`` in float32."""
    import torch

    variant = module.kernel_variant(getattr(torch, dtype_name), d)
    if _c_variant(module, dtype_name, d) != variant:
        raise AssertionError(f"{module.KERNEL} D={d} {dtype_name}: the library's variant "
                             f"{_c_variant(module, dtype_name, d)}, the wrapper's {variant}")
    want = {"bfloat16": "wgmma", "float32": "tf32x3"}[dtype_name]
    if variant != want:
        raise AssertionError(f"{module.KERNEL} D={d}: {dtype_name} on the {variant} variant")
    return variant


def _valid_lengths(b: int, n: int) -> list[int]:
    """Rows alternate between ~30% padded keys and fully valid."""
    return [n if i % 2 else n - max(1, (3 * n) // 10) for i in range(b)]


def _valid_max_abs(out, ref, valid, frame_axis: int) -> float:
    """max-abs over each batch row's valid frames (frame_axis of a row)."""
    return max((out[i].narrow(frame_axis, 0, v).float()
                - ref[i].narrow(frame_axis, 0, v).float()).abs().max().item()
               for i, v in enumerate(valid))


def _rotation_pass(fra, qkv, cos, sin, mask, heads: int):
    """The rotated q and k [B, H, N, D] that kernel 1's first pass writes,
    read from a scratch buffer handed to the library's entry point (a
    comparison: no launch is counted)."""
    import torch

    b, n, three_hd = qkv.shape
    d = three_hd // (3 * heads)
    scratch = torch.empty((2, b, n, heads, d), dtype=qkv.dtype, device=qkv.device)
    out = torch.empty((b, n, heads * d), dtype=qkv.dtype, device=qkv.device)
    cos_t, sin_t = (t.to(qkv.dtype).contiguous() for t in (cos, sin))
    err = fra._kernel_entry()(
        qkv.data_ptr(), cos_t.data_ptr(), sin_t.data_ptr(),
        mask.contiguous().view(torch.uint8).data_ptr(), out.data_ptr(), scratch.data_ptr(),
        b, n, heads, d, {torch.float32: 0, torch.bfloat16: 1}[qkv.dtype],
        torch.cuda.current_stream(qkv.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_rope_attention launch failed: CUDA error {err}")
    torch.cuda.synchronize()
    return scratch[0].transpose(1, 2), scratch[1].transpose(1, 2)


def _check_rotation(fra, qkv, cos, sin, mask, heads: int, label: str) -> None:
    """The first pass's q and k equal the plain rotation (``apply_rope`` in
    float32, rounded once to the input type) bit for bit."""
    import torch

    from vietvoice_tts_tpu_torch.ops.rope import apply_rope

    b, n, three_hd = qkv.shape
    d = three_hd // (3 * heads)
    c, s_ = cos.to(qkv.dtype).float(), sin.to(qkv.dtype).float()
    for name, got, t in zip("qk", _rotation_pass(fra, qkv, cos, sin, mask, heads),
                            qkv.chunk(3, dim=-1)[:2]):
        want = apply_rope(t.reshape(b, n, heads, d).transpose(1, 2).float(), c, s_)
        if not torch.equal(got, want.to(qkv.dtype)):
            raise AssertionError(f"{label}: the rotation pass's {name} differs from the plain "
                                 f"rotation (max-abs {(got.float() - want).abs().max().item():.3e})")


def phase_kernels(card: str) -> dict:
    """The fused RoPE kernel vs its plain version at every shape and dtype
    (and, in float32, vs the emulation of its split-TF32 products); returns
    the record."""
    import torch

    from vietvoice_tts_tpu_torch.ops.kernels import fused_rope_attention as fra
    from vietvoice_tts_tpu_torch.ops.rope import rope_tables

    dev = torch.device("cuda")
    worst = 0.0
    measured = {}
    shapes = []
    for (b, n, heads, d), dtypes in KERNEL_CASES:
        for dtype_name in dtypes:
            tol = TOLERANCE[dtype_name]
            dtype = getattr(torch, dtype_name)
            variant = _checked_variant(fra, dtype_name, d)
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
            err = _valid_max_abs(out, ref, valid, 0)
            label = f"B={b} N={n} H={heads} D={d} {dtype_name}"
            emu_err = None
            if dtype_name == "float32":
                emu = fra.fused_qkv_rope_attention_tf32x3(qkv, cos, sin, mask, heads)
                emu_err = _valid_max_abs(out, emu, valid, 0)
                del emu
            for what, e in (("plain", err), ("its emulation", emu_err)):
                if e is not None and (not np.isfinite(e) or e > tol):
                    raise AssertionError(
                        f"kernel vs {what} at {label}: max-abs {e:.3e} > {tol:.0e}")
            if d >= fra.SCRATCH_FROM[dtype]:
                _check_rotation(fra, qkv, cos, sin, mask, heads, f"fused_rope {label}")
            worst = max(worst, err)
            ms = cuda_ms(lambda: fra.fused_qkv_rope_attention(qkv, cos, sin, mask, heads))
            plain_ms = cuda_ms(
                lambda: fra.fused_qkv_rope_attention_reference(qkv, cos, sin, mask, heads)
            )
            # Valid keys only: a padded key gets no weight.
            flops = 4.0 * heads * d * n * sum(valid)
            bound_ms, bound_by = bound((qkv, cos, sin, mask, out), flops, dtype_name)
            measured[(b, n, heads, d, dtype_name)] = (ms, plain_ms, bound_ms, bound_by)
            if dtype_name == "float32" or d not in (64, 128):  # into the record
                shapes.append({"shape": [b, n, heads, d], "dtype": dtype_name,
                               "variant": variant, "max_abs_err": err,
                               "emulation_max_abs_err": emu_err, "ms": ms,
                               "plain_ms": plain_ms, "bound_ms": bound_ms,
                               "bound_by": bound_by})
            emu_note = "" if emu_err is None else f", vs emulation {emu_err:.3e}"
            log(
                f"[3] fused_rope B={b} N={n} H={heads} D={d} {dtype_name} "
                f"{variant}: max-abs "
                f"{err:.3e}{emu_note} (tol {tol:.0e}); kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}) [{card}]"
            )
            # The plain version's scores at (128, 512, 8, 128) in f32 take
            # 1 GiB: hand every block back before the next shape.
            del qkv, mask, cos, sin, out, ref
            torch.cuda.empty_cache()
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
        "shapes": shapes,
    }


def phase_flash_kernel(card: str) -> dict:
    """flash_attention vs ``ops.attention.attention`` at every shape, dtype
    and layout (and, in float32, vs the emulation of its split-TF32
    products); returns the record (times at the latency shape, bf16, v as
    the DiT passes it)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend

    from vietvoice_tts_tpu_torch.ops.attention import NEG_INF, attention
    from vietvoice_tts_tpu_torch.ops.kernels import flash_attention as fa

    dev = torch.device("cuda")
    worst = 0.0
    measured = {}
    shapes = []
    for (b, heads, n, d), dtypes in FLASH_CASES:
        for dtype_name in dtypes:
            tol = TOLERANCE[dtype_name]
            dtype = getattr(torch, dtype_name)
            variant = _checked_variant(fa, dtype_name, d)
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
                err = _valid_max_abs(out, ref, valid, 1)
                emu_err = None
                if dtype_name == "float32":
                    emu_err = _valid_max_abs(out, fa.attention_tf32x3(q, k, v, mask), valid, 1)
                for what, e in (("plain", err), ("its emulation", emu_err)):
                    if e is not None and (not np.isfinite(e) or e > tol):
                        raise AssertionError(
                            f"flash kernel vs {what} at B={b} H={heads} N={n} D={d} "
                            f"{dtype_name} {layout}: max-abs {e:.3e} > {tol:.0e}")
                worst = max(worst, err)
                ms = cuda_ms(lambda: fa.flash_attention(q, k, v, mask))
                plain_ms = cuda_ms(lambda: attention(q, k, v, mask))
                bias = torch.zeros((b, 1, 1, n), dtype=dtype, device=dev)
                bias = bias.masked_fill(~mask[:, None, None, :], NEG_INF)
                library_ms = cuda_ms(
                    lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
                )
                # The backend PyTorch's dispatcher picks for that call.
                backend = SDPBackend(
                    torch._fused_sdp_choice(q, k, v, bias, 0.0, False)).name
                flops = 4.0 * heads * d * n * sum(valid)
                bound_ms, bound_by = bound((q, k, v, mask, out), flops, dtype_name)
                measured[(b, heads, n, d, dtype_name, layout)] = (
                    ms, plain_ms, library_ms, bound_ms, bound_by)
                if dtype_name == "float32" or d not in (32, 64, 128):  # into the record
                    shapes.append({"shape": [b, heads, n, d], "dtype": dtype_name,
                                   "layout": layout, "variant": variant, "max_abs_err": err,
                                   "emulation_max_abs_err": emu_err, "ms": ms,
                                   "plain_ms": plain_ms, "bound_ms": bound_ms,
                                   "bound_by": bound_by, "library_ms": library_ms,
                                   "library_backend": backend})
                emu_note = "" if emu_err is None else f", vs emulation {emu_err:.3e}"
                log(
                    f"[3] flash B={b} H={heads} N={n} D={d} {dtype_name} {layout} "
                    f"{variant}: max-abs {err:.3e}{emu_note} (tol {tol:.0e}); kernel {ms:.4f} "
                    f"ms, plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms ({backend}), bound "
                    f"{bound_ms:.5f} ms ({bound_by}) [{card}]"
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
        "shapes": shapes,
    }


# Phase-3 shapes of the AdaLN kernel, (B, N, dim, dtype): the benchmark cell's
# chunk (F5 v1 Base, CFG-doubled batch 1 at bucket 704: 1,408 rows × 1024),
# first; F5 Small's width at the same rows; the default model's batch-1
# latency shape in float32; batch 32 × 512 (64 rows of the doubled batch);
# width 1152 (phase 15's pack); one row.
ADALN_SHAPES = [
    (2, 704, 1024, "bfloat16"),
    (2, 704, 768, "bfloat16"),
    (2, 448, 1024, "float32"),
    (64, 512, 1024, "bfloat16"),
    (2, 448, 1152, "bfloat16"),
    (1, 1, 1024, "bfloat16"),
]


# phase_adaln's gate on u, kernel against the plain chain, in ulps of u's
# type at the largest |u|. A bfloat16 u rounds once from the same float32
# value the chain rounds, whose statistics differ in their summation order
# only: on an H100 it read 0.03-0.42. A float32 u (the float32 model, and
# the final norm) shows that order's difference unrounded: 1.0-1.67.
ADALN_ULPS = {"bfloat16": 1.0, "float32": 2.0}


def phase_adaln(card: str) -> dict:
    """The AdaLN kernel against its plain version (the eager chain) at
    ADALN_SHAPES, in each of its forms: (b) residual then norm, the one a
    block launches twice, (a) norm only, (c) residual only (where a
    deep-cache segment stops) and the final float32 norm; h' bit for bit,
    u within ADALN_ULPS of the plain chain's (the full gates are in
    tests/test_torch_adanorm.py). Times each against its byte bound (h and
    x read, h' and u written once, and the modulation rows) and against
    the plain chain; returns the record, times of (b) at the cell's shape
    and the largest |u| error over all shapes as ``max_abs_err``."""
    import torch

    from vietvoice_tts_tpu_torch.ops.kernels import adaln_norm as an

    dev = torch.device("cuda")
    measured = {}
    shapes = []
    worst = 0.0
    for b, n, dim, dtype_name in ADALN_SHAPES:
        dtype = getattr(torch, dtype_name)
        rng = np.random.default_rng(b * 7919 + n * 31 + dim)
        h, x = (torch.from_numpy(rng.standard_normal((b, n, dim)).astype(np.float32))
                .to(dev, dtype) for _ in range(2))
        # One block's six rows of the hoisted modulations [depth, 1, 6·dim].
        mods = torch.from_numpy(rng.normal(0.0, 0.3, (22, 1, 6 * dim)).astype(np.float32))
        sh, sc, g = mods.to(dev)[5].chunk(6, dim=-1)[:3]
        threads, vpt = an.launch_shape(dim, dtype)
        label = f"B={b} N={n} dim={dim} {dtype_name} ({threads} threads × {vpt} vectors)"
        forms = {
            "(b)": (lambda: an.adaln_norm(h, g, x, sc, sh),
                    lambda: an.adaln_norm_reference(h, g, x, sc, sh)),
            "(a)": (lambda: an.adaln_norm(h, scale=sc, shift=sh),
                    lambda: an.adaln_norm_reference(h, scale=sc, shift=sh)),
            "(c)": (lambda: an.adaln_norm(h, g, x), lambda: an.adaln_norm_reference(h, g, x)),
            "final": (lambda: an.adaln_norm(h, g, x, sc, sh, out_dtype=torch.float32),
                      lambda: an.adaln_norm_reference(h, g, x, sc, sh,
                                                      out_dtype=torch.float32)),
        }
        for form, (kernel, plain) in forms.items():
            (h_k, u_k), (h_p, u_p) = kernel(), plain()
            torch.cuda.synchronize()
            if not torch.equal(h_k, h_p) or (u_k is None) != (u_p is None):
                raise AssertionError(f"adaln {form} at {label}: h' equal "
                                     f"{torch.equal(h_k, h_p)}, u {u_k is None} / {u_p is None}")
            err = ulps = None
            if u_p is not None:
                # In units of one ulp of the largest |u|.
                err = (u_k.float() - u_p.float()).abs().max().item()
                ulps = err / (torch.finfo(u_p.dtype).eps * u_p.float().abs().max().item())
                gate = ADALN_ULPS[str(u_p.dtype).removeprefix("torch.")]
                if not ulps <= gate:
                    raise AssertionError(f"adaln {form} at {label}: u off by {ulps:.2f} ulps, "
                                         f"gate {gate}")
                worst = max(worst, err)
            ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
            moved = {"(a)": (h, u_k, sc, sh), "(c)": (h, x, h_k, g)}.get(
                form, (h, x, h_k, u_k, g, sc, sh))
            bound_ms, bound_by = bound(moved, 0.0, dtype_name)
            measured[(b, n, dim, dtype_name, form)] = (ms, plain_ms, bound_ms, bound_by)
            shapes.append({"shape": [b, n, dim], "dtype": dtype_name, "form": form,
                           "threads": threads, "vectors_per_thread": vpt,
                           "max_abs_err": err, "max_u_ulps": ulps, "ms": ms,
                           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by})
            u_note = "no u" if ulps is None else f"u within {ulps:.2f} ulps ({err:.3e})"
            log(f"[3] adaln {form} {label}: h' bit for bit, {u_note}; "
                f"kernel {ms:.4f} ms ({100 * bound_ms / ms:.1f}% of the bound), plain "
                f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}) [{card}]")
            del h_k, u_k, h_p, u_p
    ms, plain_ms, bound_ms, bound_by = measured[(*ADALN_SHAPES[0], "(b)")]
    return {
        "name": "adaln_norm",
        "route": "cuda",
        "source": "vietvoice_tts_tpu_torch/csrc/adaln_norm.cu",
        "replaces": None,  # no TPU kernel: XLA fuses the chain there
        "launches": None,
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call does the gated residual and norm
        "shapes": shapes,
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
    """Set the kernels' launch counters and the graphs' capture and replay
    counters to 0."""
    from vietvoice_tts_tpu_torch.ops.kernels import adaln_norm as an
    from vietvoice_tts_tpu_torch.ops.kernels import flash_attention as fa
    from vietvoice_tts_tpu_torch.ops.kernels import fused_rope_attention as fra
    from vietvoice_tts_tpu_torch.runtime import graphs

    fra.launches = fa.launches = an.launches = 0
    graphs.captures = graphs.replays = 0


def _check_replays(label: str, batches: int) -> None:
    """Every chunk batch since ``_reset_launches`` was one CUDA-graph replay:
    the launches those checks count came through replays, and a batch that
    ran eagerly would have launched without one."""
    from vietvoice_tts_tpu_torch.runtime import graphs

    if graphs.replays != batches:
        raise AssertionError(f"{label}: {graphs.replays} graph replays for {batches} batches")


# A CUDA graph's replay against the eager program bodies, max-abs of the mel
# latent (the same kernels in the same order: 0 on an H100, PERF.md).
LATENT_TOLERANCE = {"float32": 1e-4, "bfloat16": 5e-2}


@contextlib.contextmanager
def _eager(core):
    """The core's chunk programs run eagerly inside: its graphs set aside."""
    graphs, core.graphs = core.graphs, None
    try:
        yield
    finally:
        core.graphs = graphs


def _pcm_gap(tag: str, label: str, got, want, card: str) -> None:
    """A graph replay's int16 PCM against the eager program bodies', held to
    STREAM_TOLERANCE (the batched-vs-alone gate); printed either way."""
    if got.shape != want.shape:
        raise AssertionError(f"{tag} {label}: {got.shape} samples, eager {want.shape}")
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    max_diff, mean_diff = int(diff.max()), float(diff.mean())
    log(f"{tag} {label}, graph replay vs eager int16 PCM: largest difference {max_diff} "
        f"(tol {STREAM_TOLERANCE[0]}), mean {mean_diff:.4f} (tol {STREAM_TOLERANCE[1]}) "
        f"[{card}]")
    if max_diff > STREAM_TOLERANCE[0] or mean_diff > STREAM_TOLERANCE[1]:
        raise AssertionError(f"{tag} {label}: replay outside STREAM_TOLERANCE of eager")


def _launches() -> dict:
    """Each kernel's launches since ``_reset_launches``."""
    from vietvoice_tts_tpu_torch.ops.kernels import adaln_norm as an
    from vietvoice_tts_tpu_torch.ops.kernels import flash_attention as fa
    from vietvoice_tts_tpu_torch.ops.kernels import fused_rope_attention as fra

    return {"fused_rope": fra.launches, "flash": fa.launches, "adaln": an.launches}


# What ``_launches`` reads where no kernel may run: training, the plain path.
NO_LAUNCHES = {"fused_rope": 0, "flash": 0, "adaln": 0}


def _forwards(depth: int, n: int, route: str | None = "fused_rope") -> dict:
    """What ``_launches`` reads after ``n`` DiT forwards of ``depth`` blocks
    on the kernel path: ``depth`` launches a forward of ``route``'s attention
    kernel (None: attention by neither kernel, as on the ring), and 1 +
    2·depth of the AdaLN kernel's (the opening norm, then a residual and norm
    after each of a block's two products, the final norm in the last)."""
    want = dict(NO_LAUNCHES, adaln=n * (1 + 2 * depth))
    if route is not None:
        want[route] = n * depth
    return want


def _solves(cfg, n: int, route: str | None = "fused_rope") -> dict:
    """What ``_launches`` reads after ``n`` solves (chunk batches, streamed
    chunks) of ``cfg``: a full forward at each of its ``nfe_step - 1``
    evaluations (a CFG-cached cond-only evaluation is one forward too)."""
    return _forwards(cfg.dit_depth, n * (cfg.nfe_step - 1), route)


def _deep_cache_launches(depth: int, steps: int, r: int, j: int,
                         route: str = "fused_rope") -> dict:
    """What ``_launches`` reads after one solve with the deep-block cache
    at interval ``r`` over ``j`` shallow blocks: at r = 1 every step is a
    whole forward; else each forward is split after block j, and each
    segment that stops there ends in a residual alone, one AdaLN launch
    more: 2 + 2·depth on the ⌈steps/r⌉ recording steps, 2 + 2·j on the
    others."""
    if r == 1:
        return _forwards(depth, steps, route)
    full = -(-steps // r)
    return dict(NO_LAUNCHES, **{route: _deep_cache_evals(depth, steps, r, j),
                                "adaln": full * (2 + 2 * depth) + (steps - full) * (2 + 2 * j)})


def _sum_launches(*parts: dict) -> dict:
    return {k: sum(p[k] for p in parts) for k in NO_LAUNCHES}


def _kernel_vs_plain_latent(label, cfg, params, vocab_size, args, x0, total_len,
                            want_launches, card, against_eager=False,
                            dtypes=tuple(MEL_TOLERANCE), tag="[4]") -> None:
    """One config's mel latent with the kernels (one graph replay, the main
    path) and with the plain path (eager, a comparison), in each of
    ``dtypes``; the kernels must launch as ``want_launches`` says, and none
    on the plain path. With ``against_eager`` the kernels' replay is also
    held against the eager program bodies of the same core
    (LATENT_TOLERANCE)."""
    import torch

    from vietvoice_tts_tpu_torch.runtime.engine_core import EngineCore

    for dtype in dtypes:
        max_tol, mean_tol = MEL_TOLERANCE[dtype]
        latents = {}
        # One core for both routes: the DiT picks kernel or plain version
        # from its config at each call, and the weights are the same.
        core = EngineCore(dataclasses.replace(cfg, compute_dtype=dtype), params, vocab_size)
        for use_kernels in (True, False):
            core.dit.cfg = dataclasses.replace(core.dit.cfg, use_kernels=use_kernels)
            _reset_launches()
            t0 = time.perf_counter()
            with contextlib.nullcontext() if use_kernels else _eager(core):
                lat = core.mel_latent_batch(*args, x0=x0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = _launches()
            want = want_launches if use_kernels else NO_LAUNCHES
            if got != want:
                raise AssertionError(
                    f"{label} {dtype} use_kernels={use_kernels}: launches {got}, want {want}"
                )
            _check_replays(f"{label} {dtype} use_kernels={use_kernels}", int(use_kernels))
            if use_kernels and against_eager:
                with _eager(core):
                    eager = core.mel_latent_batch(*args, x0=x0)
                err = float(np.abs(lat - eager).max())
                log(f"{tag} {label} {dtype} mel latent, graph replay vs eager program: max-abs "
                    f"{err:.3e} (tol {LATENT_TOLERANCE[dtype]:.0e}) [{card}]")
                if not err <= LATENT_TOLERANCE[dtype]:
                    raise AssertionError(f"{label} {dtype}: replay vs eager {err:.3e}")
            if lat.shape != x0.shape or not np.isfinite(lat).all():
                raise AssertionError(f"{label}: bad {dtype} latent, shape {lat.shape}")
            latents[use_kernels] = lat[:, :total_len]
            log(f"{tag} {label} {dtype} mel latent, use_kernels={use_kernels}: "
                f"{wall * 1e3:.1f} ms ({'the capture and a replay' if use_kernels else 'eager'}"
                f"), launches {got}, max |latent| {np.abs(lat).max():.3f} [{card}]")
        del core
        torch.cuda.empty_cache()
        diff = np.abs(latents[True] - latents[False])
        err, mean = float(diff.max()), float(diff.mean())
        log(f"{tag} {label} {dtype} whole-path mel latent, kernel vs plain: max-abs "
            f"{err:.3e} (tol {max_tol:.0e}), mean-abs {mean:.3e} (tol {mean_tol:.0e}) "
            f"on {total_len} valid frames")
        if not (err <= max_tol and mean <= mean_tol):
            raise AssertionError(f"{label} {dtype} whole-path kernel vs plain outside tolerance")


def _latent_inputs(mgr, cfg) -> tuple[tuple, np.ndarray, int]:
    """(mel_latent_batch's arguments, the injected noise, valid frames): one
    row at bucket 448, the pack's reference clip and 120 seeded text ids."""
    from vietvoice_tts_tpu_torch.pipeline.audio import AudioProcessor

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
    return (wave, np.array([ref_len]), ids, np.array([total_len])), x0, total_len


def phase_whole_path(cfg, cfg32, card: str) -> None:
    from vietvoice_tts_tpu_torch.runtime.session import ModelSessionManager

    t0 = time.perf_counter()
    mgr = ModelSessionManager(cfg)
    mgr.load_models()
    params = _perturbed_gates(mgr.params)
    log(f"[4] pack ready in {time.perf_counter() - t0:.1f} s (ada std {ADA_STD})")
    args, x0, total_len = _latent_inputs(mgr, cfg)

    shallow = 7
    runs = [
        # The default model: the fused RoPE kernel in every block and step.
        ("8x128", cfg, _solves(cfg, 1), True),
        # The same widths split 32 × 32: the split-heads route.
        ("32x32", cfg32, _solves(cfg32, 1, "flash"), True),
        # CFG cache: doubled and cond-only evals alike launch once per block.
        ("32x32 uncond_interval=2",
         dataclasses.replace(cfg32, nfe_uncond_interval=2), _solves(cfg32, 1, "flash"), False),
        # Deep-block cache: full depth every second eval, 7 blocks between.
        ("32x32 deep_cache_interval=2",
         dataclasses.replace(cfg32, nfe_deep_cache_interval=2, nfe_deep_cache_blocks=shallow),
         _deep_cache_launches(cfg.dit_depth, cfg.nfe_step - 1, 2, shallow, "flash"), False),
    ]
    for label, run_cfg, want, against_eager in runs:
        _kernel_vs_plain_latent(label, run_cfg, params, mgr.vocab_size, args, x0,
                                total_len, want, card, against_eager)


# Phase 15: the head shapes the DiT serves since both attention kernels take
# every width JAX's DiT serves (label, DiT width, heads, the kernel that must
# take every launch, whether the float32 solve is held too). 4 × 256, 3 ×
# 384 and 2 × 512 are JAX's fused-kernel widths (D % 128 == 0), now kernel 1
# in two passes; 12 × 96 and 16 × 72 (DiT-XL/2's heads) JAX's XLA route,
# kernel 2 on padded tensor-core tiles. The default widths otherwise, full
# depth; width 1152 has a seeded pack of its own, and the head split is not
# in the weights, so each width's pack serves all its splits.
HEAD_SHAPES = [
    ("h4x256", 1024, 4, "fused_rope", False),
    ("h3x384", 1152, 3, "fused_rope", False),
    ("h2x512", 1024, 2, "fused_rope", True),
    ("h12x96", 1152, 12, "flash", False),
    ("h16x72", 1152, 16, "flash", True),
]


def phase_head_shapes(cfg, card: str, smi: str) -> dict:
    """Each of HEAD_SHAPES through ``TTSApi``: one short request (int16 PCM
    with sound in it, every chunk batch one graph replay, 682 launches of
    the route's kernel a batch, none of the other and 1,395 of the AdaLN
    kernel), then the whole-path
    mel latent, kernel against plain, gates opened, in bfloat16 (and in
    float32 where marked) within MEL_TOLERANCE. Returns each kernel's
    launches over the requests."""
    import torch

    from vietvoice_tts_tpu_torch import TTSApi

    launches = dict(NO_LAUNCHES)
    packs = {}
    for label, dim, heads, route, with_f32 in HEAD_SHAPES:
        t0 = time.perf_counter()
        models = WORK / ("models" if dim == cfg.dit_dim else f"models_{dim}")
        run_cfg = dataclasses.replace(cfg, dit_dim=dim, dit_heads=heads,
                                      model_cache_dir=str(models))
        api = TTSApi(run_cfg)
        engine = api.engine  # loads (or first makes) the pack before the counted run
        n_batches, n_chunks = _chunk_batches(engine, SHORT_TEXT)
        _reset_launches()
        _timed_request(f"{label} short ({n_chunks} chunk(s), {n_batches} batch(es))", run_cfg,
                       smi, lambda: api.synthesize(SHORT_TEXT), tag="[15]")
        got = _launches()
        want = _solves(run_cfg, n_batches, route)
        if got != want:
            raise AssertionError(f"{label} serving launched {got}, want {want}")
        _check_replays(f"{label} serving", n_batches)
        launches = _sum_launches(launches, got)
        if dim not in packs:
            mgr = engine.model_session_manager
            packs[dim] = (_perturbed_gates(mgr.params), mgr.vocab_size,
                          _latent_inputs(mgr, run_cfg))
        api.cleanup()
        del api, engine
        torch.cuda.empty_cache()
        params, vocab_size, (args, x0, total_len) = packs[dim]
        _kernel_vs_plain_latent(
            label, run_cfg, params, vocab_size, args, x0, total_len,
            _solves(run_cfg, 1, route), card,
            dtypes=("float32", "bfloat16") if with_f32 else ("bfloat16",), tag="[15]")
        log(f"[15] {label}: {dim} = {heads} x {dim // heads}, {route}, "
            f"{time.perf_counter() - t0:.1f} s [{smi}]")
    return launches


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


def _timed_request(name, cfg, smi, synthesize, tag="[5]"):
    """Run one blocking request, check its audio, log its wall time."""
    import torch

    t0 = time.perf_counter()
    wave, _ = synthesize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if wave.dtype != np.int16 or wave.size == 0 or not np.any(wave):
        raise AssertionError(f"{name}: bad audio dtype={wave.dtype} size={wave.size}")
    secs = wave.size / cfg.sample_rate
    log(f"{tag} {name}: {wall * 1e3:.1f} ms wall, {secs:.2f} s audio, "
        f"{secs / wall:.2f} audio-s/s [{smi}]")
    return wave


SHORT_TEXT = "Xin chào, hôm nay trời rất đẹp."
# 16 equal sentences plan to three chunks that share the 2048 bucket.
LONG_TEXT = " ".join(
    ["Nguoi dan thanh pho thuc day som de chuan bi cho mot ngay lam viec moi."] * 16
)
# The REST schema takes at most 1000 characters: 13 of the sentences (two chunks or more).
REST_LONG_TEXT = LONG_TEXT[: 13 * 72 - 1]
CLONE_TEXT = "Đây là giọng nói được nhân bản từ tệp âm thanh."
CLONE_REFERENCE_TEXT = "Xin chào, đây là giọng nói của tôi."


def phase_serving(cfg, cfg32, smi: str) -> tuple[dict, dict]:
    """Serve through ``TTSApi`` on both models; returns each kernel's launch
    count over the requests (counters set to 0 just before, read just after)
    and the 8×128 outputs by request name."""
    import torch

    from vietvoice_tts_tpu_torch import TTSApi

    clone_wav = WORK / "clone_voice.wav"
    _write_clone_wav(clone_wav, cfg.sample_rate)
    short, long_text = SHORT_TEXT, LONG_TEXT
    requests = [
        ("short", short, {}),
        ("short-again", short, {}),
        ("clone", CLONE_TEXT,
         {"reference_audio": str(clone_wav), "reference_text": CLONE_REFERENCE_TEXT}),
        ("long", long_text, {}),
    ]
    api = TTSApi(cfg)
    engine = api.engine  # loads the pack before the counted run
    solves = 0
    for name, text, voice in requests:
        n_batches, n_chunks = _chunk_batches(engine, text, **voice)
        solves += n_batches
        log(f"[5] {name}: {n_chunks} chunk(s) in {n_batches} batch(es)")
        if name == "long":
            if not (n_chunks >= 2 and n_batches == 1):
                raise AssertionError(
                    f"long text plans to {n_chunks} chunks in {n_batches} batches; "
                    "want ≥ 2 chunks in one batch"
                )
            # Streaming (run twice) dispatches every chunk as a batch of one.
            solves += 2 * n_chunks

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
    if launches != _solves(cfg, solves):
        raise AssertionError(f"8x128 serving launched {launches}, want {_solves(cfg, solves)}")
    _check_replays("8x128 serving", solves)
    log(f"[5] 8x128 serving: launches {launches} ({_solves(cfg, 1)} per chunk batch and "
        "per streamed chunk), short request deterministic")
    api.cleanup()

    # The same pack served with 32 heads of 32: the split-heads route.
    api32 = TTSApi(cfg32)
    n_batches, n_chunks = _chunk_batches(api32.engine, short)
    _reset_launches()
    _timed_request("short 32x32", cfg32, smi, lambda: api32.synthesize(short))
    launches32 = _launches()
    if launches32 != _solves(cfg32, n_batches, "flash"):
        raise AssertionError(f"32x32 serving launched {launches32}")
    _check_replays("32x32 serving", n_batches)
    log(f"[5] 32x32 serving: launches {launches32}")
    api32.cleanup()
    return _sum_launches(launches, launches32), outputs


# Candidates for phase 6's short requests: those that plan to SHORT_TEXT's
# frame bucket are used.
SHORT_CANDIDATES = [
    SHORT_TEXT,
    "Xin chào, hôm nay trời rất ấm.",
    "Chào bạn, hôm nay trời rất mát.",
    "Xin chào, chiều nay trời khá đẹp.",
    "Chào anh, sáng nay trời rất đẹp.",
    "Xin mời, hôm nay quán rất vắng.",
    "Cảm ơn, hôm nay tôi rất khỏe.",
    "Xin lỗi, hôm nay tôi đến muộn.",
    "Chào chị, tối nay trời rất lạnh.",
    "Vâng ạ, ngày mai tôi sẽ đến.",
    "Xin chào, tuần này tôi khá bận.",
    "Chào em, hôm qua trời mưa to.",
]


def _check_wave(name: str, wave) -> None:
    if wave.dtype != np.int16 or wave.size == 0 or not np.any(wave):
        raise AssertionError(f"{name}: bad audio dtype={wave.dtype} size={wave.size}")


def _check_against_solo(name: str, wave, solo) -> None:
    if wave.shape != solo.shape:
        raise AssertionError(f"{name}: {wave.shape} samples, solo {solo.shape}")
    diff = np.abs(wave.astype(np.int32) - solo.astype(np.int32))
    max_diff, mean_diff = int(diff.max()), float(diff.mean())
    log(f"[6] {name} against its solo run: largest sample difference {max_diff} "
        f"(tol {STREAM_TOLERANCE[0]}), mean {mean_diff:.4f} (tol {STREAM_TOLERANCE[1]}) of 32767")
    if max_diff > STREAM_TOLERANCE[0] or mean_diff > STREAM_TOLERANCE[1]:
        raise AssertionError(f"{name} through the batcher differs from solo beyond STREAM_TOLERANCE")


def _concurrent_round(label, api, texts, smi, route):
    """Release one client thread per text together; check and log the round.
    Returns ({text: waveform}, wall seconds, the kernels' launches,
    (batches, jobs))."""
    import torch

    engine = api.engine
    stats, core = engine.batcher.stats, engine.engine_core
    before = dataclasses.replace(stats)
    hits0, misses0 = core.cond_cache_hits, core.cond_cache_misses
    start = threading.Barrier(len(texts) + 1)
    waves, walls, errors = {}, {}, []

    def client(text):
        try:
            start.wait(timeout=60)
            t0 = time.perf_counter()
            waves[text], _ = api.synthesize(text)
            walls[text] = time.perf_counter() - t0
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,)) for t in texts]
    for t in threads:
        t.start()
    _reset_launches()
    start.wait(timeout=60)
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=300)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = _launches()
    if errors or len(waves) != len(texts):
        raise AssertionError(f"{label}: {len(waves)} of {len(texts)} requests came back: {errors}")
    for text, w in waves.items():
        _check_wave(f"{label} {text[:24]!r}", w)
    batches = stats.batches - before.batches
    jobs = stats.jobs - before.jobs
    padded = stats.padded_rows - before.padded_rows
    if stats.failures or stats.retries:
        raise AssertionError(f"{label}: {stats.failures} failures, {stats.retries} retries")
    if got != _solves(api.config, batches, route):
        raise AssertionError(
            f"{label}: launches {got}, want {_solves(api.config, batches, route)}")
    _check_replays(label, batches)
    secs = sum(w.size for w in waves.values()) / api.config.sample_rate
    log(f"[6] {label}: {len(texts)} requests in {wall * 1e3:.1f} ms wall, {secs:.2f} s audio, "
        f"{secs / wall:.2f} audio-s/s; {batches} batches, mean batch size "
        f"{jobs / batches:.2f}, {padded} padded rows; slowest request "
        f"{max(walls.values()) * 1e3:.1f} ms, median {statistics.median(walls.values()) * 1e3:.1f} ms; "
        f"cond cache +{core.cond_cache_hits - hits0} hits +{core.cond_cache_misses - misses0} "
        f"misses; launches {got} [{smi}]")
    return waves, wall, got, (batches, jobs)


def _depth_round(engine, text, n_jobs, depth, smi) -> tuple[dict, list]:
    """Submit ``n_jobs`` copies of one short request at once to a fresh
    batcher of the given depth; log the time to the first resolved future and
    to the last. Returns the kernels' launches and the times (s) from submit
    to each resolved future, sorted."""
    from vietvoice_tts_tpu_torch.serving.batcher import MicroBatcher

    ref_audio, ref_text = engine.model_session_manager.select_sample()
    ref = engine._load_ref(ref_audio).astype(np.float32) / 32768.0
    plans = engine._plan_chunks(ref, ref_text, text) * n_jobs
    engine.batcher = MicroBatcher(engine.engine_core, pipeline_depth=depth)
    try:
        _reset_launches()
        t0 = time.perf_counter()
        jobs = engine._submit_chunks(plans, ref)
        done = {}
        for _, job in jobs:
            job.future.add_done_callback(
                lambda f: done.setdefault(id(f), time.perf_counter() - t0))
        for _, job in jobs:
            _check_wave(f"depth {depth}", job.future.result(timeout=300))
        _check_replays(f"depth {depth}", engine.batcher.stats.batches)
        times = sorted(done.values())
        stats = engine.batcher.stats
        if stats.failures or stats.retries or stats.jobs != n_jobs:
            raise AssertionError(f"depth {depth}: {stats}")
        log(f"[6] pipeline_depth={depth}: {n_jobs} jobs submitted at once, {stats.batches} "
            f"batches; first future after {times[0] * 1e3:.1f} ms, median "
            f"{statistics.median(times) * 1e3:.1f} ms, last {times[-1] * 1e3:.1f} ms [{smi}]")
        return _launches(), times
    finally:
        engine.batcher.shutdown()
        engine.batcher = None


def phase_batcher(cfg, cfg32, smi: str, solo: dict) -> dict:
    """Concurrent requests through the micro-batcher on both models; returns
    each kernel's launches over the rounds (counters set to 0 just before
    each round and read just after; the warmups do not count)."""
    import torch

    from vietvoice_tts_tpu_torch import TTSApi
    from vietvoice_tts_tpu_torch.serving.batcher import ChunkJob

    api = TTSApi(cfg)
    engine = api.engine
    ref_audio, ref_text = engine.model_session_manager.select_sample()
    ref = engine._load_ref(ref_audio).astype(np.float32) / 32768.0

    def bucket_of(text):
        plans = engine._plan_chunks(ref, ref_text, text)
        return plans[0].bucket if len(plans) == 1 else None

    short_bucket = bucket_of(SHORT_TEXT)
    texts = [t for t in SHORT_CANDIDATES if bucket_of(t) == short_bucket][:8]
    if len(texts) < 8:
        raise AssertionError(f"only {len(texts)} short texts plan to bucket {short_bucket}")
    long_bucket = engine._plan_chunks(ref, ref_text, LONG_TEXT)[0].bucket

    batcher = engine.enable_micro_batching()
    t0 = time.perf_counter()
    engine.warmup(buckets=(short_bucket,))
    engine.warmup(batches=(1, 2, 3), buckets=(long_bucket,))
    torch.cuda.synchronize()
    log(f"[6] 8x128: batcher attached (max_batch {batcher.max_batch}, depth "
        f"{batcher.pipeline_depth}), warmup of bucket {short_bucket} × {cfg.batch_grid()} and "
        f"bucket {long_bucket} × (1, 2, 3) in {time.perf_counter() - t0:.1f} s")
    total = dict(NO_LAUNCHES)

    # (a) Eight short requests at once, twice: the second round finds every
    # buffer of its shapes taken already and must not be slower for it. With
    # the default window (5 ms) a client thread slow to submit splits a round
    # into batches of other sizes (6 + 2 rows), whose device time is not that
    # of one batch of 8, so the two walls would not compare. Eight is
    # max_batch, and a full batch goes the moment its eighth job arrives: the
    # window is widened for (a) alone, both rounds run one batch of eight,
    # and their walls compare like for like. (b), (c) and the 32 × 32 round
    # keep the default window.
    window_s, batcher.max_wait_s = batcher.max_wait_s, 1.0
    try:
        first = _concurrent_round("(a) eight short", api, texts, smi, "fused_rope")
        again = _concurrent_round("(a) eight short, again", api, texts, smi, "fused_rope")
    finally:
        batcher.max_wait_s = window_s
    for waves, wall, launched, (batches, jobs) in (first, again):
        total = _sum_launches(total, launched)
        if (batches, jobs) != (1, len(texts)):
            raise AssertionError(f"(a): {jobs} jobs in {batches} batches, want one batch of "
                                 f"{len(texts)}")
        _check_against_solo("(a) short", waves[SHORT_TEXT], solo["short"])
    if again[1] > 1.5 * first[1]:
        raise AssertionError(
            f"(a): {again[1]:.3f} s in the second round against {first[1]:.3f} s in the first")
    core = engine.engine_core
    if not core.cond_cache_hits >= 15:  # 16 requests share the default voice
        raise AssertionError(f"cond cache: {core.cond_cache_hits} hits after 16 requests")

    # (b) The long text (three chunks) with two short requests.
    waves, _, launched, _ = _concurrent_round(
        "(b) long + two short", api, [LONG_TEXT, *texts[:2]], smi, "fused_rope")
    total = _sum_launches(total, launched)
    _check_against_solo("(b) long", waves[LONG_TEXT], solo["long"])
    _check_against_solo("(b) short", waves[SHORT_TEXT], solo["short"])

    # (c) The long text streamed with the batcher attached.
    before = batcher.stats.batches
    _reset_launches()
    t0 = time.perf_counter()
    pieces, first_piece = [], None
    for piece in api.synthesize_streaming(LONG_TEXT):
        if first_piece is None:
            first_piece = time.perf_counter() - t0
        pieces.append(piece)
    wall = time.perf_counter() - t0
    got = _launches()
    batches = batcher.stats.batches - before
    if len(pieces) < 2 or got != _solves(cfg, batches):
        raise AssertionError(f"(c): {len(pieces)} pieces, {batches} batches, launches {got}")
    _check_replays("(c) long streamed", batches)
    total = _sum_launches(total, got)
    log(f"[6] (c) long streamed through the batcher: {len(pieces)} pieces, first after "
        f"{first_piece * 1e3:.1f} ms, all after {wall * 1e3:.1f} ms, {batches} batch(es) [{smi}]")
    _check_against_solo("(c) long streamed", np.concatenate(pieces), solo["long"])
    if batcher.stats.failures or batcher.stats.retries:
        raise AssertionError(f"8x128 batcher: {batcher.stats}")

    # After cleanup the batcher refuses work.
    api.cleanup()
    if batcher.healthy:
        raise AssertionError("batcher still healthy after cleanup()")
    try:
        batcher.submit(ChunkJob(bucket=short_bucket, wave=np.zeros(1, np.float32), ref_len=1,
                                total_len=2, text_ids=np.zeros(1, np.int32), seed=0))
    except RuntimeError:
        pass
    else:
        raise AssertionError("submit after cleanup() did not raise")

    # Submit-to-future at depth 1 and 2, three batches of eight, in the
    # order 1, 2, 2, 1.
    engine = TTSApi(cfg).engine
    engine.warmup(batches=(8,), buckets=(short_bucket,))
    depth_times = {1: [], 2: []}
    for depth in (1, 2, 2, 1):
        launched, times = _depth_round(engine, SHORT_TEXT, 24, depth, smi)
        if launched != _solves(cfg, 3):
            raise AssertionError(f"depth {depth}: launches {launched}, want {_solves(cfg, 3)}")
        total = _sum_launches(total, launched)
        depth_times[depth].append(times)
    engine.cleanup()
    legs = {"first": 0, "median": None, "last": -1}
    med = {(d, leg): statistics.median(
               (statistics.median(t) if i is None else t[i]) * 1e3 for t in runs)
           for d, runs in depth_times.items() for leg, i in legs.items()}
    log("[6] pipeline_depth 2 against 1 (medians of 2 rounds each, order 1, 2, 2, 1): "
        + "; ".join(f"{leg} future {med[2, leg]:.1f} against {med[1, leg]:.1f} ms "
                    f"({med[2, leg] / med[1, leg]:.3f})" for leg in legs) + f" [{smi}]")

    # The 32 × 32 model: four threads, flash_attention.
    api32 = TTSApi(cfg32)
    api32.engine.enable_micro_batching()
    api32.engine.warmup(batches=(1, 2, 3, 4), buckets=(short_bucket,))
    waves, _, launched32, (batches, jobs) = _concurrent_round(
        "32x32 four short", api32, texts[:4], smi, "flash")
    if not jobs / batches > 1:
        raise AssertionError(f"32x32: mean batch size {jobs / batches} is not above 1")
    api32.cleanup()
    return _sum_launches(total, launched32)


def phase_cli(cfg, smi: str) -> None:
    """The command line as a user starts it: no ``--device``, so on the card."""
    clone_wav = WORK / "clone_voice.wav"
    want = _solves(cfg, 1)
    runs = [
        ("default voice", SHORT_TEXT, []),
        ("cloned voice", CLONE_TEXT,
         ["--reference-audio", str(clone_wav), "--reference-text", CLONE_REFERENCE_TEXT]),
    ]
    for name, text, extra in runs:
        out = WORK / f"cli_{name.split()[0]}.wav"
        out.unlink(missing_ok=True)
        cmd = [sys.executable, "-m", "vietvoice_tts_tpu_torch", text, str(out),
               "--model-cache-dir", str(WORK / "models"), *extra]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600,
                              env={**os.environ, "VIETVOICE_LOG_LEVEL": "WARNING"})
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"CLI ({name}) exited {proc.returncode}:\n{proc.stderr[-2000:]}")
        device = re.search(r"^Device: (\w+)", proc.stdout, re.M)
        launched = re.search(
            r"fused_qkv_rope_attention=(\d+), flash_attention=(\d+), adaln_norm=(\d+)",
            proc.stdout)
        took = re.search(r"Generation took ([\d.]+)s", proc.stdout)
        graphed = re.search(r"Chunk graphs: (\d+) captured, (\d+) replays", proc.stdout)
        if not (device and launched and took and graphed):
            raise AssertionError(f"CLI ({name}) printed no device report:\n{proc.stdout[-2000:]}")
        if device.group(1) != "cuda" or launched.groups() != tuple(
                str(want[k]) for k in ("fused_rope", "flash", "adaln")):
            raise AssertionError(f"CLI ({name}): device {device.group(1)}, launches {launched.groups()}")
        if graphed.groups() != ("1", "1"):
            raise AssertionError(f"CLI ({name}): graphs {graphed.group(0)}, want one of each")
        with wave_file.open(str(out), "rb") as fh:
            fmt = (fh.getframerate(), fh.getnchannels(), fh.getsampwidth())
            pcm = np.frombuffer(fh.readframes(fh.getnframes()), "<i2")
        if fmt != (cfg.sample_rate, 1, 2) or pcm.size == 0 or not np.any(pcm):
            raise AssertionError(f"CLI ({name}): WAV {fmt}, {pcm.size} samples")
        log(f"[7] CLI, {name}: exit 0 in {wall:.1f} s wall (generation {took.group(1)} s), "
            f"device cuda, {launched.group(1)} fused_rope and {launched.group(3)} AdaLN "
            f"launches in one graph replay, "
            f"{pcm.size / cfg.sample_rate:.2f} s of 24 kHz mono int16 [{smi}]")


async def _stream_pieces(app, path: str, body: dict) -> tuple[int, list[bytes]]:
    """POST to the ASGI app directly → (status, the body messages as sent)."""
    status, pieces = [], []
    messages = [{"type": "http.request", "body": json.dumps(body).encode(), "more_body": False}]

    async def receive():
        return messages.pop(0) if messages else {"type": "http.disconnect"}

    async def send(message):
        if message["type"] == "http.response.start":
            status.append(message["status"])
        elif message["type"] == "http.response.body" and message.get("body"):
            pieces.append(message["body"])

    await app({"type": "http", "method": "POST", "path": path, "query_string": b""}, receive, send)
    return status[0], pieces


def phase_rest(cfg, smi: str) -> dict:
    """The REST app in process, its engine on the card behind the batcher;
    returns the kernels' launches."""
    os.environ["VIETVOICE_ALLOW_SYNTHETIC"] = "1"
    os.environ["VIETVOICE_TPU_CACHE"] = str(WORK / "models")
    os.environ["TMP_DIR_PATH"] = str(WORK / "rest_tmp")
    import importlib

    app_module = importlib.import_module("vietvoice_tts_tpu_torch.api.app")
    from vietvoice_tts_tpu_torch.api import tts_engine as te
    from vietvoice_tts_tpu_torch.api.testing import AsyncTestClient

    client = AsyncTestClient(app_module.app)
    texts = SHORT_CANDIDATES[:4]

    async def drive():
        health = (await client.get("/api/v1/health")).json()
        if (health["status"], health["backend"], health["device_count"]) != ("healthy", "cuda", 1):
            raise AssertionError(f"health: {health}")
        t0 = time.perf_counter()
        posts = await asyncio.gather(
            *(client.post("/api/v1/synthesize", json={"text": t}) for t in texts))
        wall = time.perf_counter() - t0
        for resp in posts:
            if resp.status_code != 200 or resp.content[:4] != b"RIFF":
                raise AssertionError(f"/synthesize: {resp.status_code} {resp.content[:80]!r}")
            pcm = np.frombuffer(resp.content[44:], "<i2")
            _check_wave("/synthesize", pcm)
        status, pieces = await _stream_pieces(
            app_module.app, "/api/v1/synthesize/stream", {"text": REST_LONG_TEXT})
        if status != 200 or pieces[0][:4] != b"RIFF" or len(pieces) < 3:
            raise AssertionError(
                f"/synthesize/stream: {status}, {len(pieces)} body messages: {pieces[:1]}")
        _check_wave("/synthesize/stream", np.frombuffer(b"".join(pieces[1:]), "<i2"))
        health = (await client.get("/api/v1/health")).json()
        if not (health["engine_loaded"] and health["batcher_healthy"] and health["synthetic_weights"]):
            raise AssertionError(f"health after load: {health}")
        stats = (await client.get("/api/v1/stats")).json()
        batcher = stats["batcher"]
        if not stats["hbm"] or not stats["hbm"].get("bytes_in_use"):
            raise AssertionError(f"/stats hbm: {stats['hbm']}")
        if not batcher or batcher["failures"] or batcher["retries"] or batcher["jobs"] < 7:
            raise AssertionError(f"/stats batcher: {batcher}")
        metrics = (await client.get("/metrics")).text
        samples = [ln for ln in metrics.splitlines() if ln and not ln.startswith("#")]
        for line in samples:
            float(line.rsplit(" ", 1)[1])  # raises on a line that does not parse
        if not any(ln.startswith("vietvoice_batches_total ") for ln in samples):
            raise AssertionError("/metrics lacks the batcher's counters")
        return wall, len(pieces) - 1, batcher, stats

    _reset_launches()
    try:
        wall, n_pieces, batcher, stats = asyncio.run(drive())
    finally:
        te.reset_engine()
    got = _launches()
    if got != _solves(cfg, batcher["batches"]):
        raise AssertionError(f"REST: launches {got} for {batcher['batches']} batches")
    _check_replays("REST", batcher["batches"])
    log(f"[8] REST in process: health cuda / 1 device; four /synthesize posts gathered in "
        f"{wall * 1e3:.1f} ms (engine load and first use included); /synthesize/stream "
        f"{n_pieces} pieces; batcher {batcher}; cond cache {stats['cond_cache']}; "
        f"{stats['hbm']['bytes_in_use'] / 2**30:.2f} GiB in use; /metrics parses; "
        f"launches {got} [{smi}]")
    return got


def _train_run(label, model_cfg, train_cfg, run, smi) -> dict:
    """One ``train()`` in process with no kernel launch allowed, every step a
    graph's capture or replay: one capture per (batch, frames) key the run
    met, a replay for every other step. Returns its summary with the run's
    peak memory."""
    import torch

    from vietvoice_tts_tpu_torch.training.loop import train

    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    summary = train(model_cfg, train_cfg, run)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if _launches() != NO_LAUNCHES:
        raise AssertionError(f"{label}: training launched kernels {_launches()}")
    losses = summary["losses"]
    if summary["final_step"] != run.steps or not losses or not np.all(np.isfinite(losses)):
        raise AssertionError(f"{label}: {summary}")
    keys = sorted(set(summary["step_shapes"]))
    graphs = summary["graph_captures"], summary["graph_replays"]
    if graphs != (len(keys), len(losses) - len(keys)):
        raise AssertionError(f"{label}: {graphs} graph captures and replays for "
                             f"{len(losses)} steps of the keys {keys}")
    log(f"[9] {label}: steps to {summary['final_step']} in {wall:.1f} s wall (pack load, "
        f"data, checkpoints included); losses {[round(x, 3) for x in losses]}; "
        f"{graphs[0]} graphs captured for the (batch, frames) keys {keys}, {graphs[1]} "
        f"replays; step ms {' '.join(f'{t * 1e3:.1f}' for t in summary['step_seconds'])}; "
        f"peak memory {peak / 2**30:.2f} GiB; kernel launches 0 [{smi}]")
    summary["peak_bytes"] = peak
    return summary


def _check_trained(label, cfg, train_cfg, ckpt_dir, pack, init_tree, step) -> int:
    """Load the latest checkpoint into a DiT and optimizer that
    ``init_train_state`` builds on the card, as a resumed run does, and hold
    it against what ``train()`` left: the checkpoint is at ``step``, its
    weights and Adam moments are float32 and land on cuda, every moment has
    made ``step`` updates, and the ``dit`` tree ``train()`` exported into
    ``pack`` is bit-equal to ``to_jax_tree`` of the restored module (the
    export is of the module in memory, so the checkpoint holds the trained
    weights). Returns the parameter count."""
    import torch

    from vietvoice_tts_tpu_torch.models.dit import DiTConfig
    from vietvoice_tts_tpu_torch.models.params import to_jax_tree
    from vietvoice_tts_tpu_torch.runtime.serialization import load_params
    from vietvoice_tts_tpu_torch.training import train as ttrain
    from vietvoice_tts_tpu_torch.training.checkpoint import CheckpointManager

    model_state, opt_state, saved_step = CheckpointManager(ckpt_dir).restore()
    if saved_step != step:
        raise AssertionError(f"{label}: latest checkpoint is step {saved_step}, want {step}")
    if not all(v.dtype == torch.float32 for v in model_state.values()):
        raise AssertionError(f"{label}: checkpointed weights are not float32")
    vocab = json.loads((pack / "model_meta.json").read_text())["vocab_size"]
    dcfg = DiTConfig(dim=cfg.dit_dim, depth=cfg.dit_depth, heads=cfg.dit_heads,
                     ff_mult=cfg.dit_ff_mult, n_mels=cfg.n_mels, text_dim=cfg.text_dim,
                     text_conv_layers=cfg.text_conv_layers, vocab_size=vocab)
    dit, opt = ttrain.init_train_state(init_tree, dcfg, train_cfg, "cuda")
    dit.load_state_dict(model_state)
    opt.load_state_dict(opt_state)
    params = list(dit.parameters())
    if not all(p.dtype == torch.float32 and p.is_cuda for p in params):
        raise AssertionError(f"{label}: parameters are not float32 on cuda")
    states = [opt.state[p] for p in params]
    moments = [s[k] for s in states for k in ("exp_avg", "exp_avg_sq")]
    if len(moments) != 2 * len(params) or not all(
            m.dtype == torch.float32 and m.is_cuda for m in moments):
        raise AssertionError(f"{label}: Adam moments are not float32 on cuda")
    if ttrain.update_count(opt) != step or any(int(s["step"]) != step for s in states):
        raise AssertionError(f"{label}: the optimizer state has not made {step} updates")
    exported = load_params(pack / "params.msgpack")["dit"]
    for path, ref in _leaves(to_jax_tree(dit)):
        got = _leaf(exported, path)
        if got.dtype != ref.dtype or not np.array_equal(got, ref):
            raise AssertionError(f"{label}: exported {path} differs from the checkpoint's")
    return sum(p.numel() for p in params)


def _f32_card_against_cpu(vocab_size: int, smi: str) -> None:
    """One f32 train step's loss and gradients, card against CPU, at dim
    1024, depth 2, batch 2, bucket 256, TF32 off, gates opened."""
    import torch

    from vietvoice_tts_tpu_torch.models.dit import DiTConfig, init_dit_params
    from vietvoice_tts_tpu_torch.models.params import to_jax_tree
    from vietvoice_tts_tpu_torch.runtime.engine_core import _true_float32
    from vietvoice_tts_tpu_torch.training import train as ttrain

    dcfg = DiTConfig(depth=2, vocab_size=vocab_size)
    tree = _perturbed_gates({"dit": init_dit_params(np.random.default_rng(9), dcfg)}, seed=9)["dit"]
    tcfg = ttrain.TrainConfig(compute_dtype="float32")
    rng = np.random.default_rng(10)
    b, n = 2, 256
    batch = (rng.standard_normal((b, n, dcfg.n_mels)).astype(np.float32) - 5.0,
             rng.integers(-1, vocab_size, (b, n)).astype(np.int32),
             np.array([n, 180], np.int32))
    draws = ttrain.draw(torch.Generator().manual_seed(11), b, n, dcfg.n_mels, tcfg)
    def loss_and_grads(device):
        dit, _ = ttrain.init_train_state(tree, dcfg, tcfg, device)
        with _true_float32():
            loss = ttrain.flow_matching_loss(
                dit, *ttrain.as_tensors(*batch, device), draws.to(device))
            loss.backward()
        return loss.item(), to_jax_tree({k: p.grad for k, p in dit.named_parameters()})

    t0 = time.perf_counter()
    (loss_gpu, g_gpu), (loss_cpu, g_cpu) = loss_and_grads("cuda"), loss_and_grads("cpu")
    wall = time.perf_counter() - t0
    rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    worst, zeros = 0.0, 0
    for path, ref in _leaves(g_cpu):
        got = _leaf(g_gpu, path)
        scale = float(np.abs(ref).max())
        if scale == 0.0:
            zeros += 1
            if np.abs(got).max() > 1e-7:
                raise AssertionError(f"(b) {path}: 0 on the CPU, {np.abs(got).max():.3e} on the card")
            continue
        worst = max(worst, float(np.abs(got - ref).max()) / scale)
    log(f"[9] (b) f32 train step, card against CPU (dim 1024, depth 2, batch 2, bucket 256, "
        f"TF32 off): loss {loss_gpu:.6f} vs {loss_cpu:.6f}, rel {rel:.3e} (tol 1e-5); worst "
        f"gradient leaf {worst:.3e} of its max-abs (tol 1e-4); {zeros} leaves exactly 0 on "
        f"the CPU; {wall:.1f} s wall for both [{smi}]")
    if not (rel <= 1e-5 and worst <= 1e-4):
        raise AssertionError("(b) card and CPU disagree beyond tolerance")


# 9 (e): steps of each run, the first P9_TIMED on the host's clock (the
# graph's first is its capture), the rest under torch.profiler.
P9_GRAPH_STEPS = 8
P9_TIMED = 5


def _train_graph_against_eager(tree: dict, vocab_size: int, smi: str) -> None:
    """(e) The train step as graph replays against eager steps from the same
    state, at full width, batch 8 × 256 (187 valid frames, as the seeded
    pack's 2 s clips), ``warmup_steps=2`` (a new learning rate at every
    step), in bf16 and in f32 (TF32 off): every loss, parameter and Adam
    moment bit-identical after P9_GRAPH_STEPS steps; one capture, no kernel
    launch; step ms (median of steps 2..P9_TIMED), tokens/s, 6·P·tokens
    against the dtype's peak, the device's kernel time and idle share (the
    last steps traced), the capture's wall, the graph's nodes by type (no
    memset: ``runtime/graphs.py`` rewrites them), the pool and each run's
    peak. The host's ms to
    launch a replay is 14 (c)'s: after a ``torch.profiler`` session every
    launch in the process is slower (PROFILED_LAUNCH)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vietvoice_tts_tpu_torch.models.dit import DiTConfig
    from vietvoice_tts_tpu_torch.training import train as ttrain

    dcfg = DiTConfig(vocab_size=vocab_size)
    b, n, valid = 8, 256, 187
    rng = np.random.default_rng(12)
    ids = np.full((b, n), -1, np.int32)
    ids[:, :50] = rng.integers(0, vocab_size, (b, 50))
    batch = ttrain.as_tensors(rng.normal(-4.0, 2.0, (b, n, dcfg.n_mels)).astype(np.float32),
                              ids, np.full((b,), valid, np.int32), "cuda")
    for dtype in ("bfloat16", "float32"):
        tcfg = ttrain.TrainConfig(compute_dtype=dtype, warmup_steps=2)
        draws = [ttrain.draw(torch.Generator().manual_seed(i), b, n, dcfg.n_mels, tcfg).to("cuda")
                 for i in range(P9_GRAPH_STEPS)]
        runs = {}
        for mode in ("graph", "eager"):
            _reset_launches()
            dit, opt = ttrain.init_train_state(tree, dcfg, tcfg, "cuda")
            step = ttrain.make_train_step(dcfg, tcfg)
            if mode == "eager":
                step.graphs = None
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            losses, ms = [], []
            for d in draws[:P9_TIMED]:
                t0 = time.perf_counter()
                losses.append(step(dit, opt, d, *batch).item())
                ms.append((time.perf_counter() - t0) * 1e3)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for d in draws[P9_TIMED:]:
                    losses.append(step(dit, opt, d, *batch).item())
            kernels = [e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and e.self_device_time_total > 0
                       and not getattr(e, "is_user_annotation", False) and "#" not in e.key]
            traced = P9_GRAPH_STEPS - P9_TIMED
            runs[mode] = dict(
                dit=dit, opt=opt, step=step, losses=losses, ms=statistics.median(ms[1:]),
                first_ms=ms[0], peak=torch.cuda.max_memory_allocated(),
                device_ms=sum(e.self_device_time_total for e in kernels) / 1e3 / traced,
                device_launches=sum(e.count for e in kernels) / traced)
            if _launches() != NO_LAUNCHES:
                raise AssertionError(f"(e) {dtype} {mode}: kernels launched {_launches()}")
        g, e = runs["graph"], runs["eager"]
        graphs = g["step"].graphs
        if (graphs.captures, graphs.replays) != (1, P9_GRAPH_STEPS - 1):
            raise AssertionError(f"(e) {dtype}: {graphs.captures} captures, {graphs.replays} "
                                 f"replays for {P9_GRAPH_STEPS} steps of one shape")
        if g["losses"] != e["losses"] or not np.all(np.isfinite(g["losses"])):
            raise AssertionError(f"(e) {dtype}: losses {g['losses']} against eager {e['losses']}")
        params = list(zip(g["dit"].named_parameters(), e["dit"].parameters(), strict=True))
        for (name, p), q in params:
            if not torch.equal(p, q):
                raise AssertionError(f"(e) {dtype}: parameter {name} differs from eager")
            for k in ("exp_avg", "exp_avg_sq"):
                if not torch.equal(g["opt"].state[p][k], e["opt"].state[q][k]):
                    raise AssertionError(f"(e) {dtype}: {k} of {name} differs from eager")
        entry = next(iter(graphs.entries.values()))
        pool = graphs.pool_bytes()
        n_params = sum(p.numel() for (_, p), _ in params)
        flops = 6.0 * n_params * b * n
        lines = []
        for mode, r in runs.items():
            idle = 100 * (1 - r["device_ms"] / r["ms"]) if r["device_ms"] else float("nan")
            lines.append(
                f"{mode} {r['ms']:.1f} ms a step (first {r['first_ms']:.1f}), "
                f"{b * n / r['ms'] * 1e3:.0f} tokens/s, {flops / r['ms'] / 1e9:.1f} TFLOP/s = "
                f"{100 * flops / r['ms'] / 1e9 / PEAK_FLOPS[dtype] * 1e12:.1f}% of the "
                f"{PEAK_FLOPS[dtype] / 1e12:.0f} TFLOP/s {dtype} peak, device kernels "
                f"{r['device_ms']:.1f} ms in {r['device_launches']:.0f} a step (traced), idle "
                f"{idle:.1f}%, peak memory {r['peak'] / 2**30:.2f} GiB")
        log(f"[9] (e) {dtype} train step at full width, batch {b} × {n}, graph replays against "
            f"eager from one state: {P9_GRAPH_STEPS} steps bit-identical in every loss, all "
            f"{len(params)} parameters and both Adam moments (losses "
            f"{[round(x, 4) for x in g['losses']]}); 1 capture, {graphs.replays} replays, 0 "
            f"kernel launches; {'; '.join(lines)}; eager/graph {e['ms'] / g['ms']:.2f}; capture "
            f"{entry.capture_s:.2f} s wall (the eager run included), nodes "
            f"{entry.graph.node_types} (rewritten as kernels: {entry.graph.rewritten}; 14 (c) "
            f"times the launch); pool {pool[0] / 2**30:.2f} GiB reserved, "
            f"{pool[1] / 2**30:.2f} GiB allocated [{smi}]")
        if entry.graph.node_types["memset"]:
            raise AssertionError(f"(e) {dtype}: memset nodes left {entry.graph.node_types}")
        del runs, g, e, params, graphs, entry
        torch.cuda.empty_cache()


def _leaves(tree, prefix=()):
    """(path, array) for every leaf of a pack tree."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


P9_CLI_DEPTH = 2  # DiT layers of the pack 9 (d)'s training command line trains


def phase_training(cfg, smi: str) -> dict:
    """The trainer at full width on a copy of the seeded pack; returns the
    kernels' launches of the request served from the trained pack."""
    import shutil

    import torch

    from vietvoice_tts_tpu_torch import TTSApi
    from vietvoice_tts_tpu_torch.runtime.serialization import load_params
    from vietvoice_tts_tpu_torch.runtime.session import ModelSessionManager
    from vietvoice_tts_tpu_torch.training.loop import TrainRunConfig
    from vietvoice_tts_tpu_torch.training.train import TrainConfig

    # train() exports into the pack it trains from: train a copy.
    shutil.rmtree(TRAIN_WORK, ignore_errors=True)
    src = Path(cfg.model_path)
    shutil.copytree(src, TRAIN_WORK / "models" / src.name)
    tcfg = dataclasses.replace(cfg, model_cache_dir=str(TRAIN_WORK / "models"))
    pack = Path(tcfg.model_path)
    ckpt_dir = TRAIN_WORK / "ckpt"
    train_cfg = TrainConfig(compute_dtype="bfloat16", warmup_steps=2)
    before = load_params(pack / "params.msgpack")["dit"]

    # (a) 8 steps, then resumed to 12.
    def run(steps):
        return TrainRunConfig(steps=steps, batch_size=8, checkpoint_dir=str(ckpt_dir),
                              checkpoint_every=4, log_every=4)

    first = _train_run("(a) bf16 compute, f32 masters, batch 8", tcfg, train_cfg, run(8), smi)
    n_params = _check_trained("(a)", cfg, train_cfg, ckpt_dir, pack, before, 8)
    trained = load_params(pack / "params.msgpack")["dit"]
    if not np.any(trained["blocks"]["ada"]["w"] != before["blocks"]["ada"]["w"]):
        raise AssertionError("(a) no blocks.*.ada leaf moved")
    bucket = cfg.frame_bucket_for(int(2.0 * cfg.sample_rate) // cfg.hop_length)
    tokens = 8 * bucket
    step_s = statistics.median(first["step_seconds"][2:])
    flops = 6.0 * n_params * tokens
    log(f"[9] (a) step time {step_s * 1e3:.1f} ms (median of steps 3-8; a step of the "
        f"42-clip catalogue's last, 2-row batch included; data loading excluded), "
        f"{tokens / step_s:.0f} tokens/s "
        f"(8 × {bucket} frames a step); 6·P·tokens = {flops:.3e} with P = {n_params:,}: "
        f"{flops / step_s / 1e12:.1f} TFLOP/s, {100 * flops / step_s / PEAK_FLOPS['bfloat16']:.1f}% "
        f"of the 989 TFLOP/s bf16 peak; peak memory {first['peak_bytes'] / 2**30:.2f} GiB; "
        f"checkpoint at step 8 restores to f32 weights and moments on cuda, bit-equal to "
        f"the exported dit tree [{smi}]")
    torch.cuda.empty_cache()

    second = _train_run("(a) resumed from step 8", tcfg, train_cfg, run(12), smi)
    if len(second["losses"]) != 4:
        raise AssertionError(f"(a) resumed run took {len(second['losses'])} steps, want 4")
    _check_trained("(a) resumed", cfg, train_cfg, ckpt_dir, pack, before, 12)
    log("[9] (a) resumed to step 12: exported params.msgpack dit tree bit-equal to "
        "to_jax_tree of the step-12 checkpoint")
    torch.cuda.empty_cache()

    # (b) f32, card against CPU.
    vocab = json.loads((pack / "model_meta.json").read_text())["vocab_size"]
    _f32_card_against_cpu(vocab, smi)

    # (c) The trained pack served on the card.
    t0 = time.perf_counter()
    api = TTSApi(tcfg)
    n_batches, _ = _chunk_batches(api.engine, SHORT_TEXT)
    _reset_launches()
    wave, _ = api.synthesize(SHORT_TEXT)
    got = _launches()
    api.cleanup()
    _check_wave("(c) trained pack", wave)
    if got != _solves(cfg, n_batches):
        raise AssertionError(f"(c) serving the trained pack launched {got}")
    _check_replays("(c) trained pack", n_batches)
    log(f"[9] (c) TTSApi on the trained pack: {wave.size / cfg.sample_rate:.2f} s of int16, "
        f"peak |sample| {int(np.abs(wave.astype(np.int32)).max())}, launches {got}; "
        f"{time.perf_counter() - t0:.1f} s wall with the pack's load "
        f"[{smi}]")

    # (d) The entry point as a user starts it: no --device, so on the card;
    # on a seeded pack of 2 layers at the full widths (the pack decides the
    # model): loading, checkpointing and exporting the whole pack were most
    # of this run's time, and (a) trains the whole depth.
    cli_cfg = dataclasses.replace(cfg, dit_depth=P9_CLI_DEPTH,
                                  model_cache_dir=str(TRAIN_WORK / "cli_models"))
    ModelSessionManager(cli_cfg).load_models()
    cmd = [sys.executable, "-m", "vietvoice_tts_tpu_torch.training", "--steps", "2",
           "--batch-size", "8", "--model-cache-dir", cli_cfg.model_cache_dir,
           "--checkpoint-dir", str(TRAIN_WORK / "cli_ckpt")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600,
                          env={**os.environ, "VIETVOICE_LOG_LEVEL": "WARNING"})
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"training CLI exited {proc.returncode}:\n{proc.stderr[-2000:]}")
    final = re.search(r"'final_step': (\d+), 'final_loss': ([-\d.e+]+)", proc.stdout)
    if not (re.search(r"^Device: cuda", proc.stdout, re.M) and final and final.group(1) == "2"
            and np.isfinite(float(final.group(2)))):
        raise AssertionError(f"training CLI printed:\n{proc.stdout[-2000:]}")
    log(f"[9] (d) python -m vietvoice_tts_tpu_torch.training --steps 2 --batch-size 8 on a "
        f"{P9_CLI_DEPTH}-layer pack: exit 0 in {wall:.1f} s wall, device cuda, f32, final loss "
        f"{float(final.group(2)):.4f} [{smi}]")
    shutil.rmtree(TRAIN_WORK, ignore_errors=True)  # ~20 GB of checkpoints

    # (e) Graph replays against eager steps.
    _train_graph_against_eager(_perturbed_gates({"dit": before}, seed=12)["dit"], vocab, smi)
    return got


# 6 of LONG_TEXT's sentences plan to three chunks in one batch with the F5
# fixture's voice (a 2 s clip).
F5_LONG_TEXT = " ".join([LONG_TEXT.split(". ")[0] + "."] * 6)


def _run_cli(label: str, args: list, smi: str, timeout: float) -> subprocess.CompletedProcess:
    """``python -m <args>`` from the checkout's root, timed; raises on a
    non-zero exit."""
    env = {**os.environ, "VIETVOICE_LOG_LEVEL": "WARNING"}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{label}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
    log(f"[10] (b) {label}: {wall:.1f} s wall [{smi}]")
    return proc


def _f5_rehearsal(smi: str) -> None:
    """Phase 10 (a): the F5 widths at depth 2 and NFE 8, converted and held
    against the ONNX graphs through the golden harness."""
    import tarfile

    import torch

    from vietvoice_tts_tpu_torch.golden import (
        _as_latent_layout, compare_latents, reference_side, torch_latent)
    from vietvoice_tts_tpu_torch.models.convert import convert_reference_tarball
    from vietvoice_tts_tpu_torch.models.f5_fixture import FixtureSpec, write_fixture_tarball
    from vietvoice_tts_tpu_torch.models.onnx_eval import EvalSession
    from vietvoice_tts_tpu_torch.models.params import from_jax_tree
    from vietvoice_tts_tpu_torch.models.preflight import preflight_report
    from vietvoice_tts_tpu_torch.models.vocoder import Vocoder, VocoderConfig
    from vietvoice_tts_tpu_torch.runtime.engine_core import _true_float32
    from vietvoice_tts_tpu_torch.runtime.serialization import load_params

    root = F5_WORK / "rehearsal"
    shutil.rmtree(root, ignore_errors=True)
    spec = FixtureSpec(depth=REHEARSAL_DEPTH, nfe_step=REHEARSAL_NFE)
    t0 = time.perf_counter()
    tar, name_map, _ = write_fixture_tarball(root / "model-bin.pt", spec, seed=0)
    log(f"[10] (a) fixture dim {spec.dim}, {spec.heads} heads × {spec.head_dim}, depth "
        f"{spec.depth}, NFE {spec.nfe_step}: {tar.stat().st_size / 2**20:.1f} MiB in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    report = preflight_report(tar, name_map=name_map)
    route = report["architecture"].get("attention_route", {})
    log(f"[10] (a) preflight: ok={report['ok']}, {route.get('advice')} "
        f"({time.perf_counter() - t0:.1f} s)")
    if not report["ok"] or route.get("kernel") != 1:
        raise AssertionError(f"preflight: {report['blockers'][:5]}, route {route}")
    pack = REHEARSAL_PACK
    t0 = time.perf_counter()
    conv = convert_reference_tarball(tar, pack, name_map=name_map)
    weights = conv["weights"]
    log(f"[10] (a) convert: {weights['resolved']} leaves, unresolved "
        f"{len(weights['unresolved'])} ({time.perf_counter() - t0:.1f} s)")
    if weights["unresolved"]:
        raise AssertionError(f"convert left leaves unresolved: {weights['unresolved'][:5]}")
    t0 = time.perf_counter()
    ref = reference_side(str(tar), GOLDEN_TEXT, nfe_step=spec.nfe_step)
    log(f"[10] (a) reference side (numpy evaluator, {os.cpu_count()} host cores): "
        f"{time.perf_counter() - t0:.1f} s for {ref['noise'].shape} noise, "
        f"{ref['ref_signal_len']} reference frames")
    np.savez(REHEARSAL_REF, **{k: np.asarray(v) for k, v in ref.items() if k != "combined_text"},
             combined_text=np.asarray(str(ref["combined_text"])))  # as --save-ref writes it

    want = _forwards(spec.depth, spec.nfe_step - 1)
    bounds = {"float32": 1e-2, "bfloat16": GOLDEN_BF16_MAX}  # kernel vs plain
    for dtype, plain_tol in bounds.items():
        latents = {}
        for use_kernels in (True, False):
            _reset_launches()
            t0 = time.perf_counter()
            latent, info = torch_latent(pack, ref, device="cuda", compute_dtype=dtype,
                                        use_kernels=use_kernels)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = _launches()
            expect = want if use_kernels else NO_LAUNCHES
            if got != expect:
                raise AssertionError(f"(a) {dtype} use_kernels={use_kernels}: launches "
                                     f"{got}, want {expect}")
            _check_replays(f"(a) {dtype} use_kernels={use_kernels}", 1)
            if not np.isfinite(latent).all():
                raise AssertionError(f"(a) {dtype}: latent not finite")
            latents[use_kernels] = latent
            rep = compare_latents(latent, info["ref_mel"], info["ref_len"], GOLDEN_F32[1])
            log(f"[10] (a) torch side {dtype} use_kernels={use_kernels}: mel MAE "
                f"{rep['mel_mae']:.3e}, max-abs {rep['mel_max_abs']:.3e}, allclose "
                f"{rep['allclose']} over {rep['frames'] - rep['ref_frames']} frames; launches "
                f"{got}; {wall:.1f} s with the engine's build [{smi}]")
            if use_kernels and dtype == "float32" and not (
                    rep["mel_mae"] < GOLDEN_F32[0] and rep["allclose"]):
                raise AssertionError(f"(a) float32 golden gate failed: {rep}")
            if use_kernels and dtype == "bfloat16" and rep["mel_max_abs"] > GOLDEN_BF16_MAX:
                raise AssertionError(f"(a) bfloat16 max-abs over {GOLDEN_BF16_MAX}: {rep}")
        valid = slice(info["ref_len"], info["n_frames"])
        err = float(np.abs(latents[True][0, valid] - latents[False][0, valid]).max())
        log(f"[10] (a) {dtype} latent, kernel vs plain: max-abs {err:.3e} (tol {plain_tol:.0e})")
        if err > plain_tol:
            raise AssertionError(f"(a) {dtype} kernel vs plain {err:.3e} > {plain_tol}")

    # decode.onnx through the evaluator against the port's vocoder on the card.
    with tarfile.open(tar) as t:
        decode = EvalSession(t.extractfile("decode.onnx").read())
    latent = _as_latent_layout(ref["ref_mel"], spec.n_mels)
    ref_len = int(ref["ref_signal_len"])
    t0 = time.perf_counter()
    onnx_pcm = decode.run(None, {"noise": latent,
                                 "ref_signal_len": np.asarray([ref_len], np.int64)})[0]
    eval_s = time.perf_counter() - t0
    voc_cfg = VocoderConfig(dim=spec.voc_dim, intermediate_dim=spec.voc_inter,
                            num_layers=spec.voc_layers, n_mels=spec.n_mels,
                            n_fft=spec.n_fft, hop_length=spec.hop_length,
                            compute_dtype=torch.float32)
    _, voc_state = from_jax_tree(load_params(pack / "params.msgpack"), torch.float32)
    with torch.device("meta"):
        vocoder = Vocoder(voc_cfg)
    vocoder.load_state_dict(voc_state, assign=True)
    vocoder = vocoder.to("cuda").eval()
    with torch.inference_mode(), _true_float32():
        wav = vocoder(torch.from_numpy(latent[:, ref_len:]).cuda()).cpu().numpy()
    pcm = (np.clip(wav, -1, 1) * 32767.0).astype(np.int16)
    if onnx_pcm.shape != pcm.shape:
        raise AssertionError(f"(a) decode shape {onnx_pcm.shape} vs vocoder {pcm.shape}")
    lsb = int(np.abs(onnx_pcm.astype(np.int32) - pcm.astype(np.int32)).max())
    log(f"[10] (a) decode.onnx (evaluator, {eval_s:.1f} s) vs the port's vocoder on the "
        f"card, float32: {pcm.size} samples, largest difference {lsb} LSB (tol 1), "
        f"peak {int(np.abs(pcm).max())}")
    if lsb > 1:
        raise AssertionError(f"(a) decode differs by {lsb} LSB")
    del vocoder
    torch.cuda.empty_cache()


def _native_crossfade(api, smi: str) -> dict:
    """Phase 10 (c): the long text blocking and streamed through the native
    cross-fade; returns the kernels' launches."""
    import vietvoice_tts_tpu_torch.pipeline.audio as audio
    from vietvoice_tts_tpu_torch.native import audio_native, build as native_build

    t0 = time.perf_counter()
    if not audio_native.available():
        raise AssertionError("(c) the native audio library is not available (no g++?)")
    log(f"[10] (c) native library {native_build.library_path().name} ready in "
        f"{time.perf_counter() - t0:.2f} s")
    batches, chunks = _chunk_batches(api.engine, F5_LONG_TEXT)
    if chunks < 2:
        raise AssertionError(f"(c) the long text planned to {chunks} chunk(s)")
    calls = []
    join = audio_native.crossfade_concat

    def recording(waves, duration, sample_rate):
        out = join(waves, duration, sample_rate)
        calls.append(([np.array(w) for w in waves], int(duration * sample_rate), out))
        return out

    audio_native.crossfade_concat = recording
    joins = audio_native.joins
    try:
        _reset_launches()
        t0 = time.perf_counter()
        blocking, _ = api.synthesize(F5_LONG_TEXT)
        block_s = time.perf_counter() - t0
        blocking_launches = _launches()
        blocking_joins = audio_native.joins - joins
        t0 = time.perf_counter()
        pieces = list(api.synthesize_streaming(F5_LONG_TEXT))
        stream_s = time.perf_counter() - t0
        launches = _launches()
    finally:
        audio_native.crossfade_concat = join
    stream_joins = audio_native.joins - joins - blocking_joins
    log(f"[10] (c) long text, {chunks} chunks in {batches} batch(es): blocking "
        f"{block_s * 1e3:.1f} ms, {blocking_joins} native joins; streamed {len(pieces)} "
        f"pieces {stream_s * 1e3:.1f} ms, {stream_joins} native joins; launches "
        f"{launches} [{smi}]")
    if blocking_joins != chunks - 1 or stream_joins != chunks - 1:
        raise AssertionError(f"(c) native joins {blocking_joins}, {stream_joins}; "
                             f"want {chunks - 1} each")
    run_cfg = api.engine.config
    _check_replays("(c) blocking and streamed", batches + chunks)
    # Streaming dispatches a chunk a batch.
    if (blocking_launches != _solves(run_cfg, batches)
            or launches != _solves(run_cfg, batches + chunks)):
        raise AssertionError(f"(c) launches {blocking_launches}, {launches}")
    _check_wave("(c) blocking", blocking)
    stream = np.concatenate(pieces)
    diff = np.abs(stream.astype(np.int32) - blocking.astype(np.int32))
    if stream.shape != blocking.shape or diff.max() > STREAM_TOLERANCE[0]:
        raise AssertionError(f"(c) streamed vs blocking: {stream.shape} {blocking.shape}, "
                             f"max {diff.max() if diff.size else None}")
    worst = 0
    for waves, n_fade, out in calls:
        fixed = [audio.AudioProcessor.fix_clipped_audio(w) for w in waves]
        ref = fixed[0]
        for nxt in fixed[1:]:
            ref = audio._crossfade_pair(ref, nxt, n_fade)
        if ref.shape != out.shape:
            raise AssertionError(f"(c) native join length {out.shape} vs numpy {ref.shape}")
        worst = max(worst, int(np.abs(ref.astype(np.int32) - out.astype(np.int32)).max()))
    log(f"[10] (c) {len(calls)} native cross-fade calls against numpy on the same chunks: "
        f"largest difference {worst} LSB (tol 1)")
    if worst > 1:
        raise AssertionError(f"(c) native cross-fade differs from numpy by {worst} LSB")
    chunk_waves = calls[0][0]
    native_ms, numpy_ms = [], []
    saved = audio._native_dsp
    for _ in range(20):
        t0 = time.perf_counter()
        audio.AudioProcessor.concatenate_with_crossfade_improved(chunk_waves, 0.1, 24000)
        native_ms.append((time.perf_counter() - t0) * 1e3)
        audio._native_dsp = lambda: None
        try:
            t0 = time.perf_counter()
            audio.AudioProcessor.concatenate_with_crossfade_improved(chunk_waves, 0.1, 24000)
            numpy_ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            audio._native_dsp = saved
    log(f"[10] (c) cross-fade of {len(chunk_waves)} chunks "
        f"({sum(len(w) for w in chunk_waves)} samples), median of 20 on the host: numpy "
        f"{statistics.median(numpy_ms):.3f} ms, native {statistics.median(native_ms):.3f} ms, "
        f"against {block_s * 1e3:.1f} ms for the request [{smi}]")
    return launches


def phase_conversion(smi: str) -> dict:
    """Phase 10: conversion day at the F5 widths; returns the kernels'
    launches over the requests served from the converted pack."""
    import torch

    import vietvoice_tts_tpu_torch as vt
    from vietvoice_tts_tpu_torch.runtime.session import config_from_pack

    t_phase = time.perf_counter()
    _f5_rehearsal(smi)
    log(f"[10] (a) done in {time.perf_counter() - t_phase:.1f} s")

    # (b) The whole depth, through the command lines.
    t_b = time.perf_counter()
    root = F5_WORK / "full"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    tar = root / "model-bin.pt"
    _run_cli("fixture CLI (FixtureSpec(), 22 layers)",
             ["vietvoice_tts_tpu_torch.models.f5_fixture", str(tar)], smi, 600)
    log(f"[10] (b) tarball {tar.stat().st_size / 2**30:.2f} GiB")
    _run_cli("preflight CLI", ["vietvoice_tts_tpu_torch.models.preflight", str(tar),
                               "--out", str(root / "preflight.json")], smi, 600)
    report = json.loads((root / "preflight.json").read_text())
    route = report["architecture"].get("attention_route", {})
    log(f"[10] (b) preflight: ok={report['ok']}, {route.get('advice')}, "
        f"{report['weights']['leaves_total']} leaves, {len(report['warnings'])} warnings")
    if not report["ok"] or route.get("kernel") != 1:
        raise AssertionError(f"(b) preflight: {report['blockers'][:5]}, route {route}")
    pack = F5_PACK
    proc = _run_cli("convert CLI", ["vietvoice_tts_tpu_torch.models.convert", str(tar),
                                    str(pack)], smi, 600)
    conv = json.loads(proc.stdout)
    meta = json.loads((pack / "model_meta.json").read_text())
    log(f"[10] (b) convert: {conv['weights']['resolved']} leaves, unresolved "
        f"{len(conv['weights']['unresolved'])}, synthetic {meta['synthetic']}, "
        f"heads {meta['dit']['heads']}")
    if conv["weights"]["unresolved"] or meta["synthetic"]:
        raise AssertionError(f"(b) conversion incomplete: {conv['weights']}")
    del proc, conv

    # Served from the converted pack: its own widths, real-weights gate on.
    cfg = config_from_pack(pack, allow_synthetic_pack=False)
    if (cfg.dit_heads, cfg.head_dim, cfg.dit_depth, cfg.device) != (16, 64, 22, "cuda"):
        raise AssertionError(f"(b) pack config {cfg.dit_heads}×{cfg.head_dim}, "
                             f"depth {cfg.dit_depth}, {cfg.device}")
    launches_total = dict(NO_LAUNCHES)
    with vt.TTSApi(cfg) as api:
        t0 = time.perf_counter()
        api.engine  # noqa: B018 — loads the pack
        log(f"[10] (b) TTSApi loaded the converted pack in {time.perf_counter() - t0:.1f} s "
            f"(synthetic {api.engine.model_session_manager.is_synthetic})")
        batches, _ = _chunk_batches(api.engine, SHORT_TEXT)
        per_batch = cfg.dit_depth * (cfg.nfe_step - 1)
        if per_batch != 682:
            raise AssertionError(f"(b) {per_batch} DiT evaluations per solve, want 22 × 31")
        waves = []
        for label in ("cold", "warm"):
            _reset_launches()
            t0 = time.perf_counter()
            wave, _ = api.synthesize(SHORT_TEXT)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = _launches()
            if got != _solves(cfg, batches):
                raise AssertionError(f"(b) {label}: launches {got}, want "
                                     f"{_solves(cfg, batches)}")
            _check_replays(f"(b) {label}", batches)
            _check_wave(f"(b) {label}", wave)
            launches_total = _sum_launches(launches_total, got)
            waves.append(wave)
            log(f"[10] (b) short sentence at 16 × 64, full depth, bf16, {label}: "
                f"{wall * 1e3:.1f} ms wall, {wave.size / cfg.sample_rate:.2f} s audio, "
                f"peak {int(np.abs(wave).max())}, launches {got} [{smi}]")
        if not np.array_equal(waves[0], waves[1]):
            raise AssertionError("(b) the same request twice gave different audio")
        # Phase 14 (a) at the F5 head shape: the replay against the eager
        # program bodies of the same core.
        with _eager(api.engine.engine_core):
            eager, _ = api.synthesize(SHORT_TEXT)
        _pcm_gap("[10] (b)", "16x64 F5 pack short sentence", waves[1], eager, smi)
        log(f"[10] (b) done in {time.perf_counter() - t_b:.1f} s")
        launches_total = _sum_launches(launches_total, _native_crossfade(api, smi))
    log(f"[10] done in {time.perf_counter() - t_phase:.1f} s [{smi}]")
    return launches_total


# ---------------------------------------------------------------------------
# Phase 11: parallel/ on one card. The ranks are processes that share cuda:0
# over gloo (NCCL refuses two ranks on one device), and gloo's collectives
# go through pinned host memory (parallel/comm.py): every time below is of
# ranks taking turns on one card over a host-staged transport, so none of
# them is a scaling number.
# ---------------------------------------------------------------------------

P11_WORK = WORK / "parallel"
# The ranks' DiT depth: every width of the default model, 4 of its 22
# layers, on a seeded pack of their own (P11_WORK / "models"). A solve's
# collectives go through host memory, so depth is what this phase's time
# scales with; the launch checks are per layer and scale with it.
P11_DEPTH = 4
P11_TIMEOUT = 600.0  # seconds a launch of ranks may take before it is killed
P11_THREADS = 2  # host threads per rank (8 cores, up to 3 ranks)
P11_TRAIN = dict(compute_dtype="float32", warmup_steps=1)  # (e): the 2nd update moves
P11_A_RUNS = [  # (label, heads, dtype, route) of (a), TP 2, bucket 384
    ("8x128", 8, "float32", "fused_rope"),
    ("8x128", 8, "bfloat16", "fused_rope"),
    ("16x64", 16, "bfloat16", "fused_rope"),
    ("32x32", 32, "bfloat16", "flash"),
]
P11_PCM_TOLERANCE = 64  # of 32767 per sample: data parallel against one rank
# (b) at the serving dtype only, (c) in float32 only: every collective of a
# solve goes through host memory, so each solve costs tens of seconds here.
P11_B_DTYPE = "bfloat16"
P11_C_DTYPE = "float32"
# (f) compares the served PCM with one rank's: in float32 (TF32 off) tensor
# parallelism is exact to ~1e-5 and the comparison is one of the loop. In
# bfloat16, TP changes the summation order of every matmul and the solve
# drifts (a)'s 3.7e-2–4.1e-2 max-abs, which took a served chunk to a mean of
# 2.569 of 32767 from one rank's on an H100 (700 W), past STREAM_TOLERANCE's
# 2.0 (set for streaming against blocking, one change of batch size).
P11_F_DTYPE = "float32"


def _p11_batch(ref: np.ndarray, vocab: int, n: int, b: int, seed: int) -> dict:
    """A padded batch at bucket ``n``: the catalogue voice's reference
    (up to 40% of the bucket), random text, a shorter valid length per row,
    and an injected noise."""
    hop = 256
    rng = np.random.default_rng(seed)
    ref_len = np.full((b,), min((2 * n) // 5, len(ref) // hop), np.int32)
    total_len = np.array([n - 8 - 12 * i for i in range(b)], np.int32)
    wave = np.zeros((b, n * hop), np.float32)
    wave[:, : ref_len[0] * hop] = ref[: ref_len[0] * hop]
    ids = np.full((b, n), -1, np.int32)
    ids[:, : n // 3] = rng.integers(0, vocab, (b, n // 3))
    x0 = rng.standard_normal((b, n, 100)).astype(np.float32)
    return dict(args=(wave, ref_len, ids, total_len), seed=np.arange(b, dtype=np.uint32), x0=x0)


def _p11_params(cfg):
    """The seeded pack with opened gates, and its vocabulary size."""
    from vietvoice_tts_tpu_torch.runtime.session import ModelSessionManager

    mgr = ModelSessionManager(cfg)
    mgr.load_models()
    return _perturbed_gates(mgr.params), mgr.vocab_size, mgr


def _p11_watch(state: dict):
    """Record any activation of a rank that is not on the card: a
    collective (``parallel/comm.py``) that returns on another device than
    its input's, and any output of the DiT's forward or the vocoder that is
    off the card. Returns a function that hooks an ``EngineCore``."""
    import torch

    from vietvoice_tts_tpu_torch.parallel import comm

    def check(name, value):
        for t in value if isinstance(value, (tuple, list)) else (value,):
            if isinstance(t, torch.Tensor) and t.device.type != "cuda":
                state.setdefault("off_device", []).append(name)

    if not state.get("patched"):
        for name in ("all_reduce", "all_gather", "all_to_all", "ring_shift"):
            real = getattr(comm, name)

            def wrapped(x, *args, _real=real, _name=name, **kw):
                out = _real(x, *args, **kw)
                first = lambda v: v[0] if isinstance(v, (tuple, list)) else v  # noqa: E731
                if first(out).device != first(x).device:
                    state.setdefault("off_device", []).append(_name)
                return out

            setattr(comm, name, wrapped)
        state["patched"] = True

    def hook_core(core):
        real = core.dit.forward_embedded

        def forward_embedded(*args, **kw):
            out = real(*args, **kw)
            check("dit", out)
            return out

        core.dit.forward_embedded = forward_embedded
        core.vocoder.register_forward_hook(lambda mod, inp, out: check("vocoder", out))
        return core

    return hook_core


def _p11_measure(fn):
    """(result, launches, wall s, peak device GB) of one ``fn()``."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, _launches(), time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 1e9


def _p11_step_a(rank, d, meshes, hook):
    from vietvoice_tts_tpu_torch.runtime.engine_core import EngineCore

    out = {}
    b = d["b384"]
    for label, heads, dtype, _ in P11_A_RUNS:
        cfg = dataclasses.replace(d["cfg"], dit_heads=heads, compute_dtype=dtype)
        core = hook(EngineCore(cfg, d["params"], d["vocab"], mesh=meshes["tp"]))
        out[(label, dtype)] = _p11_measure(
            lambda: core.mel_latent_batch(*b["args"], seed=b["seed"], x0=b["x0"]))
        del core
    return out


def _p11_step_sp(rank, d, meshes, hook, mesh_name, batch, dtype):
    from vietvoice_tts_tpu_torch.runtime.engine_core import EngineCore

    b = d[batch]
    cfg = dataclasses.replace(d["cfg"], dit_heads=8, compute_dtype=dtype, sequence_parallel=True)
    core = hook(EngineCore(cfg, d["params"], d["vocab"], mesh=meshes[mesh_name]))
    return _p11_measure(lambda: core.mel_latent_batch(*b["args"], seed=b["seed"], x0=b["x0"]))


def _p11_step_d(rank, d, meshes, hook):
    from vietvoice_tts_tpu_torch.runtime.engine_core import EngineCore

    core = hook(EngineCore(d["cfg"], d["params"], d["vocab"], mesh=meshes["dp"]))
    b = d["b256x4"]
    return _p11_measure(lambda: core.synthesize_batch(*b["args"], seed=b["seed"]))


def _p11_random_biases(tree: dict, seed: int = 13) -> dict:
    """The DiT tree with every bias drawn N(0, 0.05²): from zero, Adam's
    first real update of a bias is ±lr wherever its gradient is, and near
    Adam's eps that sign rides on the gradient's last bits, which would
    make the comparison one of eps, not of the mesh."""
    rng = np.random.default_rng(seed)

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return rng.normal(0.0, 0.05, node.shape).astype(np.float32) if key == "b" else node

    return walk(tree)


def _p11_step_e(rank, d, meshes, hook):
    """Two f32 train steps (TF32 off) of DP 2 and of TP 2 against one rank
    (computed on rank 0), batch 8 × 256, from one tree, batch and draws."""
    import torch

    from vietvoice_tts_tpu_torch.models.dit import DiTConfig
    from vietvoice_tts_tpu_torch.models.params import to_jax_tree
    from vietvoice_tts_tpu_torch.parallel.sharding import gather_tree, param_pspecs, shard_tree
    from vietvoice_tts_tpu_torch.training import train as ttrain

    cfg = d["cfg"]
    tcfg = ttrain.TrainConfig(**P11_TRAIN)
    tree = _p11_random_biases(d["params"]["dit"])
    dcfg = DiTConfig(dim=cfg.dit_dim, depth=cfg.dit_depth, heads=cfg.dit_heads,
                     ff_mult=cfg.dit_ff_mult, n_mels=cfg.n_mels, text_dim=cfg.text_dim,
                     text_conv_layers=cfg.text_conv_layers, vocab_size=d["vocab"])
    rng = np.random.default_rng(14)
    b, n = 8, 256
    batch = ttrain.as_tensors(
        rng.standard_normal((b, n, cfg.n_mels)).astype(np.float32) - 5.0,
        rng.integers(-1, d["vocab"], (b, n)).astype(np.int32),
        np.array([256, 200, 180, 256, 128, 240, 96, 256], np.int32), "cuda")
    draws = ttrain.draw(torch.Generator().manual_seed(15), b, n, cfg.n_mels, tcfg).to("cuda")

    def two_steps(dit_cfg, dit_tree, mesh):
        dit, opt = ttrain.init_train_state(dit_tree, dit_cfg, tcfg, "cuda")
        step = ttrain.make_train_step(dit_cfg, tcfg, mesh)
        losses = [step(dit, opt, draws, *batch).item() for _ in range(2)]
        return dit, opt, losses

    out = {}
    if rank == 0:
        dit, _, ref_losses = two_steps(dcfg, tree, None)
        ref_tree = to_jax_tree(dit)
        del dit
        torch.cuda.empty_cache()
    for name in ("dp", "tp"):
        mesh = meshes[name]
        mcfg = dataclasses.replace(dcfg, model_group=mesh.model_group)
        specs = param_pspecs(mcfg, None)["dit"]
        mtree = tree
        if mesh.model_group is not None:
            mtree = shard_tree(tree, specs, mesh.model_index, mesh.model)

        def run():
            dit, opt, losses = two_steps(mcfg, mtree, mesh)
            return gather_tree(to_jax_tree(dit), specs, mesh.model_group), losses

        (got_tree, losses), launches, wall, peak = _p11_measure(run)
        worst = None
        if rank == 0:
            worst = max(
                float(np.abs(_leaf(got_tree, path) - ref).max()) / max(float(np.abs(ref).max()), 1e-30)
                for path, ref in _leaves(ref_tree)
            )
            rel = abs(losses[-1] - ref_losses[-1]) / abs(ref_losses[-1])
            out[name] = ((losses, ref_losses, rel, worst), launches, wall, peak)
        else:
            out[name] = ((losses, None, None, None), launches, wall, peak)
        del got_tree
        torch.cuda.empty_cache()
    return out


def _p11_step_f(rank, d, meshes, hook):
    """MultiHostServingLoop on TP 2: rank 0 submits the short request's
    chunk and the long text's first chunk; both ranks dispatch in lockstep;
    rank 0's stop() stops both loops. In P11_F_DTYPE."""
    import torch

    from vietvoice_tts_tpu_torch.runtime.engine_core import EngineCore
    from vietvoice_tts_tpu_torch.serving import ChunkJob, MultiHostServingLoop

    cfg = dataclasses.replace(d["cfg"], compute_dtype=P11_F_DTYPE)
    core = hook(EngineCore(cfg, d["params"], d["vocab"], mesh=meshes["tp"]))
    dispatches = []
    real = core.synthesize_batch_async

    def counting(wave, *args, **kw):
        dispatches.append(int((np.asarray(args[0]) > 0).sum()))  # real rows
        return real(wave, *args, **kw)

    core.synthesize_batch_async = counting

    def serve():
        loop = MultiHostServingLoop(core, max_wait_ms=50.0)
        loop.start()
        waves = None
        if rank == 0:
            futures = [loop.submit(ChunkJob(**job)) for job in d["jobs"]]
            waves = [f.result(timeout=P11_TIMEOUT) for f in futures]
            loop.stop(timeout=P11_TIMEOUT)
        loop._thread.join(timeout=P11_TIMEOUT)
        if loop._thread.is_alive() or loop._running:
            raise AssertionError(f"rank {rank}: the serving loop did not stop")
        torch.cuda.synchronize()
        return waves

    waves, launches, wall, peak = _p11_measure(serve)
    return waves, launches, wall, peak, list(dispatches)


def _p11_rank(rank: int, world: int, workdir: str, steps: tuple, d: dict) -> None:
    """One rank of a phase-11 launch: join the gloo group, run ``steps``,
    write the results (or the traceback) under ``workdir``."""
    import datetime
    import pickle
    import traceback

    import torch
    import torch.distributed as dist

    torch.set_num_threads(P11_THREADS)
    out = Path(workdir)
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{out / 'rendezvous'}", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=P11_TIMEOUT))
        from vietvoice_tts_tpu_torch.parallel.mesh import make_mesh

        params, vocab, _ = _p11_params(d["cfg"])
        d = {**d, "params": params, "vocab": vocab}
        meshes = ({"ring": make_mesh(1, 3)} if world == 3
                  else {"tp": make_mesh(1, 2), "dp": make_mesh(2, 1)})
        state: dict = {}
        hook = _p11_watch(state)
        steps_fn = {
            "a": _p11_step_a,
            "b": lambda r, d_, m, h: _p11_step_sp(r, d_, m, h, "tp", "b2048", P11_B_DTYPE),
            "c": lambda r, d_, m, h: _p11_step_sp(r, d_, m, h, "ring", "b384", P11_C_DTYPE),
            "d": _p11_step_d,
            "e": _p11_step_e,
            "f": _p11_step_f,
        }
        results = {}
        for step in steps:
            t0 = time.perf_counter()
            results[step] = steps_fn[step](rank, d, meshes, hook)
            results[step + "_wall"] = time.perf_counter() - t0
            if rank == 0:
                log(f"[11] step ({step}) took {results[step + '_wall']:.1f} s on rank 0")
        results["off_device"] = state.get("off_device", [])
        (out / f"rank{rank}.pkl").write_bytes(pickle.dumps(results))
        dist.destroy_process_group()
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def _p11_launch(world: int, steps: tuple, d: dict, name: str) -> list:
    """Start ``world`` ranks (spawn), join them with a timeout, kill any
    left, and return each rank's results; any failed rank raises."""
    import pickle

    import torch.multiprocessing as mp

    workdir = P11_WORK / name
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_p11_rank, args=(r, world, str(workdir), steps, d), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + P11_TIMEOUT
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    errors = "".join(f.read_text() for f in sorted(workdir.glob("rank*.err")))
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise AssertionError(f"[11] {name}: rank exit codes {codes}\n{errors}")
    return [pickle.loads((workdir / f"rank{r}.pkl").read_bytes()) for r in range(world)]


def _p11_check_latent(label, results, ref, dtype, card, want):
    """Each rank's latent against one rank's; launches per rank as ``want``."""
    max_tol, mean_tol = MEL_TOLERANCE[dtype]
    for rank, (lat, launches, wall, peak) in enumerate(results):
        diff = np.abs(lat - ref)
        err, mean = float(diff.max()), float(diff.mean())
        log(f"[11] {label} {dtype} rank {rank}: latent vs one rank max-abs {err:.3e} "
            f"(tol {max_tol:.0e}), mean-abs {mean:.3e} (tol {mean_tol:.0e}); launches {launches}; "
            f"{wall:.1f} s wall, peak {peak:.2f} GB [{card}]")
        if not (np.isfinite(lat).all() and err <= max_tol and mean <= mean_tol):
            raise AssertionError(f"[11] {label} {dtype} rank {rank}: outside tolerance")
        if launches != want:
            raise AssertionError(f"[11] {label} {dtype} rank {rank}: launches {launches}, want {want}")


def phase_parallel(cfg, smi: str) -> dict:
    """parallel/ and the lockstep serving loop, as ranks sharing the card;
    returns each kernel's launches summed over the ranks."""
    import torch

    from vietvoice_tts_tpu_torch.pipeline.audio import AudioProcessor
    from vietvoice_tts_tpu_torch.pipeline.engine import TTSEngine
    from vietvoice_tts_tpu_torch.runtime.engine_core import EngineCore

    t_phase = time.perf_counter()
    card = f"{torch.cuda.get_device_name(0)}, {smi.split(',')[-1].strip()}"
    cfg = dataclasses.replace(cfg, dit_depth=P11_DEPTH, model_cache_dir=str(P11_WORK / "models"))
    params, vocab, mgr = _p11_params(cfg)
    ref_audio, _ = mgr.select_sample()
    ref = AudioProcessor.load_audio(ref_audio, cfg.sample_rate).astype(np.float32) / 32768.0
    d = dict(cfg=cfg, b384=_p11_batch(ref, vocab, 384, 1, 21),
             b2048=_p11_batch(ref, vocab, 2048, 1, 22), b256x4=_p11_batch(ref, vocab, 256, 4, 23))

    # One rank: the references.
    refs = {}
    for label, heads, dtype, _ in P11_A_RUNS:
        core = EngineCore(dataclasses.replace(cfg, dit_heads=heads, compute_dtype=dtype),
                          params, vocab)
        b = d["b384"]
        refs[(label, dtype)] = core.mel_latent_batch(*b["args"], seed=b["seed"], x0=b["x0"])
        del core
    core = EngineCore(dataclasses.replace(cfg, dit_heads=8, compute_dtype=P11_B_DTYPE),
                      params, vocab)
    b = d["b2048"]
    refs["2048"] = core.mel_latent_batch(*b["args"], seed=b["seed"], x0=b["x0"])
    del core
    core = EngineCore(cfg, params, vocab)
    b = d["b256x4"]
    refs["d"] = core.synthesize_batch(*b["args"], seed=b["seed"])
    engine = TTSEngine(cfg)
    jobs = []
    for text in (SHORT_TEXT, LONG_TEXT):
        ref_path, ref_text = engine.model_session_manager.select_sample()
        ref_f32 = engine._load_ref(ref_path).astype(np.float32) / 32768.0
        plan = engine._plan_chunks(ref_f32, ref_text, text)[0]
        wave, ids = engine._chunk_row(plan, ref_f32)
        jobs.append(dict(bucket=plan.bucket, wave=wave, ref_len=plan.ref_len,
                         total_len=plan.total_len, text_ids=ids, seed=plan.index))
    engine.cleanup()
    del engine, core
    core = EngineCore(dataclasses.replace(cfg, compute_dtype=P11_F_DTYPE), params, vocab)
    # The loop broadcasts the reference prefix in float16 (serving/multihost.py):
    # the one-rank reference takes the same rounded wave.
    refs["f"] = [
        core.synthesize_batch(j["wave"][None].astype(np.float16).astype(np.float32),
                              np.array([j["ref_len"]]), j["text_ids"][None],
                              np.array([j["total_len"]]), seed=np.array([j["seed"]], np.uint32))[0]
        for j in jobs
    ]
    del core
    torch.cuda.empty_cache()
    d["jobs"] = jobs
    log(f"[11] one-rank references in {time.perf_counter() - t_phase:.1f} s [{smi}]")

    t0 = time.perf_counter()
    two = _p11_launch(2, ("a", "b", "d", "e", "f"), d, "two_ranks")
    log(f"[11] two ranks (a, b, d, e, f) in {time.perf_counter() - t0:.1f} s wall "
        f"(spawn and pack loading included) [{smi}]")
    t0 = time.perf_counter()
    three = _p11_launch(3, ("c",), d, "three_ranks")
    log(f"[11] three ranks (c) in {time.perf_counter() - t0:.1f} s wall [{smi}]")

    total = dict(NO_LAUNCHES)
    for r in two + three:
        if r["off_device"]:
            raise AssertionError(f"[11] tensors off the card: {sorted(set(r['off_device']))}")

    # (a) TP 2 at bucket 384: kernel 1 at 4 × 128 and 8 × 64, kernel 2 at 16 × 32.
    for label, heads, dtype, route in P11_A_RUNS:
        _p11_check_latent(f"(a) TP 2 {label} → {heads // 2}x{1024 // heads} per rank",
                          [r["a"][(label, dtype)] for r in two], refs[(label, dtype)],
                          dtype, card, _solves(cfg, 1, route))
    # (b) Ulysses, sp 2, bucket 2048: kernel 1 at 4 × 128 on all 2048 frames.
    _p11_check_latent("(b) Ulysses sp 2, bucket 2048", [r["b"] for r in two], refs["2048"],
                      P11_B_DTYPE, card, _solves(cfg, 1))
    # (c) The ring, sp 3 (8 heads do not split over 3), bucket 384: no
    # attention kernel; the AdaLN kernel on each rank's frames.
    _p11_check_latent("(c) ring sp 3, bucket 384", [r["c"] for r in three],
                      refs[("8x128", P11_C_DTYPE)], P11_C_DTYPE, card, _solves(cfg, 1, None))
    # (d) DP 2: four rows, two per rank.
    for rank, r in enumerate(two):
        pcm, launches, wall, peak = r["d"]
        err = int(np.abs(pcm.astype(np.int32) - refs["d"].astype(np.int32)).max())
        log(f"[11] (d) DP 2, 4 rows at bucket 256 (2 per rank), bf16, rank {rank}: PCM vs one "
            f"rank max {err} of 32767 (tol {P11_PCM_TOLERANCE}); launches {launches}; "
            f"{wall:.1f} s wall, peak {peak:.2f} GB [{card}]")
        if pcm.shape != refs["d"].shape or err > P11_PCM_TOLERANCE:
            raise AssertionError(f"[11] (d) rank {rank}: PCM outside tolerance")
        if launches != _solves(cfg, 1):
            raise AssertionError(f"[11] (d) rank {rank}: launches {launches}")
    # (e) Training: DP 2 and TP 2 against one rank.
    for name in ("dp", "tp"):
        for rank, r in enumerate(two):
            (losses, ref_losses, rel, worst), launches, wall, peak = r["e"][name]
            if launches != NO_LAUNCHES:
                raise AssertionError(f"[11] (e) {name} rank {rank}: launches {launches}")
            if not np.isfinite(losses).all():
                raise AssertionError(f"[11] (e) {name} rank {rank}: loss {losses}")
            if rank == 0:
                log(f"[11] (e) {name.upper()} 2, two f32 steps (TF32 off), batch 8 × 256: loss "
                    f"{losses[-1]:.6f} vs one rank {ref_losses[-1]:.6f}, rel {rel:.3e} (tol 1e-5); "
                    f"worst parameter leaf {worst:.3e} of its max-abs (tol 1e-4); "
                    f"{wall:.1f} s wall, peak {peak:.2f} GB [{card}]")
                if not (rel <= 1e-5 and worst <= 1e-4):
                    raise AssertionError(f"[11] (e) {name}: outside tolerance")
    # (f) The serving loop on TP 2.
    max_tol, mean_tol = STREAM_TOLERANCE
    for rank, r in enumerate(two):
        waves, launches, wall, peak, dispatches = r["f"]
        want = _solves(cfg, len(dispatches))
        log(f"[11] (f) MultiHostServingLoop, TP 2, {P11_F_DTYPE}, rank {rank}: "
            f"{len(dispatches)} dispatches "
            f"(real rows {dispatches}); launches {launches}; {wall:.1f} s wall, peak "
            f"{peak:.2f} GB [{card}]")
        if launches != want or sum(dispatches) != len(d["jobs"]):
            raise AssertionError(f"[11] (f) rank {rank}: launches {launches}, want {want}")
    for job, got, ref in zip(d["jobs"], two[0]["f"][0], refs["f"]):
        diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
        log(f"[11] (f) bucket {job['bucket']} chunk vs one rank: max {int(diff.max())}, mean "
            f"{float(diff.mean()):.3f} of 32767 (tol {max_tol}, {mean_tol})")
        if got.shape != ref.shape or diff.max() > max_tol or diff.mean() > mean_tol:
            raise AssertionError("[11] (f) served chunk outside STREAM_TOLERANCE")

    for r in two + three:
        runs = [*r["a"].values(), r["b"], r["d"], r["f"]] if "a" in r else [r["c"]]
        total = _sum_launches(total, *(run[1] for run in runs))
    log(f"[11] done in {time.perf_counter() - t_phase:.1f} s; launches over all ranks {total}. "
        f"Ranks share one card over a host-staged gloo transport: no time here is a "
        f"scaling number [{smi}]")
    return total


# ---------------------------------------------------------------------------
# Phase 12: the golden harness's sweeps (golden.py in the package) on phase
# 10 (b)'s converted pack: F5 widths, 16 × 64 (kernel 1), 22 layers, NFE 32.
# ---------------------------------------------------------------------------

P12_SHAPE = (16, 64, 22, 31)  # heads, head_dim, layers, Euler steps of phase 10 (b)'s pack
P12_FRAMES = 448  # the bucket of (b) and (c), and of (a)'s kernel-vs-plain check
# Timed solves per sweep setting, after an untimed one: 2, not the
# harness's default 3, to keep the script inside its time limit; (e) times
# the same settings over P12_ROUNDS interleaved rounds.
P12_REPEATS = 2
P12_ROUNDS = 5  # (e)'s interleaved rounds: one solve of every setting each
P12_DEEP = ((1, 7), (2, 7), (2, 11), (3, 7))  # the JAX harness's default settings
P12_CFG = (1, 2, 4)
P12_DRIFT_FRAMES = (384, 448, 512, 704)  # the JAX harness's default buckets
P12_HELD_MIB = 16  # device memory a harness call may leave allocated behind it


def _counted(label: str, fn, want: dict, solves: int):
    """``fn()`` with the launch counters set to 0 just before and read just
    after → (its result, wall s); the kernels must launch as ``want``
    says, each of the ``solves`` must be one graph replay, and the cores
    ``fn`` built must be released (device memory back to where it was)."""
    import torch

    held = torch.cuda.memory_allocated()
    _reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = _launches()
    if got != want:
        raise AssertionError(f"[12] {label}: launches {got}, want {want}")
    _check_replays(f"[12] {label}", solves)
    gc.collect()  # an EngineCore holds reference cycles: only the collector frees it
    left = (torch.cuda.memory_allocated() - held) / 2**20
    if left > P12_HELD_MIB:
        raise AssertionError(f"[12] {label}: {left:.0f} MiB of device memory left behind")
    return out, wall


def _deep_cache_evals(depth: int, steps: int, r: int, j: int) -> int:
    """Block evaluations of one solve, each one launch of kernel 1:
    ⌈steps/r⌉ full passes and j shallow blocks on the other steps."""
    full = -(-steps // r)
    return depth * full + j * (steps - full)


def _sweep_ref(pack: Path, per_solve: dict, card: str) -> dict:
    """The sweeps' reference: the pack's reference clip (``reference_side``
    takes ``audio_metadata.json[0]``), the golden text and seeded noise at
    P12_FRAMES; its ``ref_mel`` is the port's own float32 exact latent
    (TF32 off, launches as ``per_solve`` says, counted apart)."""
    from vietvoice_tts_tpu_torch.golden import torch_latent
    from vietvoice_tts_tpu_torch.pipeline.audio import AudioProcessor
    from vietvoice_tts_tpu_torch.pipeline.text import TextProcessor

    sample = json.loads((pack / "audio_metadata.json").read_text())[0]
    audio = AudioProcessor.load_audio(str(pack / "audios" / sample["file_name"]), 24000)
    tp = TextProcessor(str(pack / "vocab.txt"))
    n_mels = json.loads((pack / "model_meta.json").read_text())["n_mels"]
    noise = np.random.default_rng(12).standard_normal((1, P12_FRAMES, n_mels)).astype(np.float32)
    ref = {
        "audio": audio.astype(np.float32) / 32768.0,
        "combined_text": tp.clean_text(sample["text"]) + tp.clean_text(GOLDEN_TEXT),
        "noise": noise,
        "ref_mel": np.zeros_like(noise),
        "ref_signal_len": len(audio) // 256 + 1,
        "nfe_step": 32,
    }
    (latent, _), wall = _counted(
        "f32 exact reference",
        lambda: torch_latent(pack, ref, device="cuda", compute_dtype="float32"), per_solve, 1)
    if not np.isfinite(latent).all():
        raise AssertionError("[12] the f32 reference latent is not finite")
    log(f"[12] reference: {len(audio) / 24000:.2f} s clip, {ref['ref_signal_len']} reference "
        f"frames of {P12_FRAMES}; f32 exact latent {wall:.1f} s with the core's build, "
        f"launches {per_solve} [{card}]")
    return {**ref, "ref_mel": latent}


def _kernel_vs_plain_at_depth(pack: Path, ref: dict, per_solve: dict, depth: int,
                              card: str) -> None:
    """(a) The bucket-448 solve of the sweeps' reference with kernel 1 and
    without, in float32 (its tf32x3 variant; the kernel's latent is ``ref``'s
    own ``ref_mel``) and bf16 (its wgmma variant), each held to
    MEL_TOLERANCE; each bf16 latent's distance from the float32 one says
    whether bf16's drift comes from the kernel or from bf16 arithmetic."""
    from vietvoice_tts_tpu_torch.golden import torch_latent

    valid = slice(int(ref["ref_signal_len"]), P12_FRAMES)
    latents = {("float32", True): ref["ref_mel"]}
    for dtype, use_kernels in (("float32", False), ("bfloat16", True), ("bfloat16", False)):
        (latent, _), _ = _counted(
            f"(a) {dtype} use_kernels={use_kernels}",
            lambda: torch_latent(pack, ref, device="cuda", compute_dtype=dtype,
                                 use_kernels=use_kernels),
            per_solve if use_kernels else NO_LAUNCHES, 1)
        if not np.isfinite(latent).all():
            raise AssertionError(f"[12] (a) {dtype} use_kernels={use_kernels}: not finite")
        latents[dtype, use_kernels] = latent
    for dtype, (max_tol, mean_tol) in MEL_TOLERANCE.items():
        diff = np.abs(latents[dtype, True][0, valid] - latents[dtype, False][0, valid])
        err, mean = float(diff.max()), float(diff.mean())
        log(f"[12] (a) bucket {P12_FRAMES}, {dtype} latent, kernel vs plain at {depth} layers: "
            f"max-abs {err:.3e} (tol {max_tol:.0e}), mean-abs {mean:.3e} (tol {mean_tol:.0e}) "
            f"[{card}]")
        if not (err <= max_tol and mean <= mean_tol):
            raise AssertionError(f"[12] (a) {dtype} kernel vs plain: max-abs {err:.3e}, "
                                 f"mean-abs {mean:.3e}")
    f32 = latents["float32", False][0, valid]
    for use_kernels in (True, False):
        d = np.abs(latents["bfloat16", use_kernels][0, valid] - f32)
        log(f"[12] (a) bucket {P12_FRAMES}, bf16 {'kernel' if use_kernels else 'plain'} vs "
            f"plain float32: mel MAE {d.mean():.3e}, max-abs {d.max():.3e} [{card}]")


def _interleaved_prices(pack: Path, ref: dict, settings: list) -> list:
    """(e) One bf16 core whose sampler takes each sweep setting in turn (the
    sampler reads its config at every solve; the weights are the same for
    all): one untimed solve each, then P12_ROUNDS rounds with the settings'
    order rotated every round (the median of each setting's solves), and
    one solve each under ``torch.profiler`` (its device kernel time and
    kernel count). ``settings``: (label, SamplerConfig fields, the kernels'
    launches a solve) → rows."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vietvoice_tts_tpu_torch.golden import _latent_inputs
    from vietvoice_tts_tpu_torch.runtime.engine_core import EngineCore
    from vietvoice_tts_tpu_torch.runtime.serialization import load_params
    from vietvoice_tts_tpu_torch.runtime.session import config_from_pack

    cfg = config_from_pack(pack, nfe_step=int(ref["nfe_step"]), device="cuda")
    args, noise, _, _ = _latent_inputs(cfg, pack, ref)
    core = EngineCore(cfg, load_params(pack / "params.msgpack"), cfg.vocab_size)
    samplers = [dataclasses.replace(core.sampler_cfg, **knobs) for _, knobs, _ in settings]

    def solve(i):
        core.sampler_cfg = samplers[i]
        return core.mel_latent_batch(*args, x0=noise)  # host numpy: after the device's work

    for i in range(len(settings)):
        solve(i)
    walls = [[] for _ in settings]
    for rnd in range(P12_ROUNDS):
        for i in (np.arange(len(settings)) + rnd) % len(settings):
            t0 = time.perf_counter()
            solve(i)
            walls[i].append((time.perf_counter() - t0) * 1e3)
    rows = []
    for i, ((label, _, launches), ms) in enumerate(zip(settings, walls)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # The device's activity alone: tracing every host op as well costs
        # seconds a solve.
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            solve(i)
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0
                   and not getattr(e, "is_user_annotation", False) and "#" not in e.key]
        rows.append({"label": label, "evals": launches["fused_rope"], "ms": ms,
                     "median_ms": statistics.median(ms),
                     "device_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
                     "kernels": sum(e.count for e in kernels),
                     "trace_s": time.perf_counter() - t0})
    return rows


def phase_sweeps(card: str) -> dict:
    """Phase 12: ``precision_drift``, ``deep_cache_sweep`` and
    ``cfg_cache_sweep`` at 16 × 64, 22 layers, through kernel 1, the
    harness's command line, and the sweeps' settings timed interleaved and
    traced; returns the kernels' launches."""
    import torch

    from vietvoice_tts_tpu_torch.golden import (
        cfg_cache_sweep, deep_cache_sweep, precision_drift)
    from vietvoice_tts_tpu_torch.runtime.session import config_from_pack

    t_phase = time.perf_counter()
    pack = F5_PACK
    pack_cfg = config_from_pack(pack)
    depth, steps = pack_cfg.dit_depth, pack_cfg.nfe_step - 1
    if (pack_cfg.dit_heads, pack_cfg.head_dim, depth, steps) != P12_SHAPE:
        raise AssertionError(f"[12] pack {pack_cfg.dit_heads} × {pack_cfg.head_dim}, "
                             f"{depth} layers, {steps} steps: want {P12_SHAPE}")
    per_solve = _forwards(depth, steps)
    total = dict(NO_LAUNCHES)

    # (a) precision_drift: per bucket a float32 solve (TF32 off, kernel 1's
    # tf32x3 variant) and a bf16 one (its wgmma variant).
    want = _forwards(depth, 2 * len(P12_DRIFT_FRAMES) * steps)
    drift, wall = _counted("(a) precision_drift",
                           lambda: precision_drift(pack, frames=P12_DRIFT_FRAMES,
                                                   device="cuda"), want,
                           2 * len(P12_DRIFT_FRAMES))
    total = _sum_launches(total, want)
    log(f"[12] (a) precision_drift, compute {drift['compute_dtype']} vs float32, "
        f"{drift['ref_frames']} reference frames: {wall:.1f} s, launches {want} [{card}]")
    for row in drift["rows"]:
        over = " — over the 5e-2 bound (reported, not gated)" if (
            row["mel_max_abs"] > GOLDEN_BF16_MAX) else ""
        log(f"[12] (a) bucket {row['frames']}: mel MAE {row['mel_mae']:.3e}, max-abs "
            f"{row['mel_max_abs']:.3e}, rel MAE {row['rel_mae']:.3e}{over} [{card}]")
        if not all(np.isfinite([row["mel_mae"], row["mel_max_abs"], row["rel_mae"]])):
            raise AssertionError(f"[12] (a) drift not finite: {row}")

    ref = _sweep_ref(pack, per_solve, card)
    total = _sum_launches(total, per_solve)
    # The bf16 kernel solve here only compares: its launches are not counted.
    _kernel_vs_plain_at_depth(pack, ref, per_solve, depth, card)

    # (b) deep_cache_sweep and (c) cfg_cache_sweep in bf16 (--serving-precision).
    torch.cuda.reset_peak_memory_stats()
    want = _sum_launches(*(_deep_cache_launches(depth, steps, r, j)
                           for r, j in P12_DEEP for _ in range(1 + P12_REPEATS)))
    deep, wall = _counted("(b) deep_cache_sweep",
                          lambda: deep_cache_sweep(pack, ref, settings=P12_DEEP,
                                                   repeats=P12_REPEATS, device="cuda"), want,
                          (1 + P12_REPEATS) * len(P12_DEEP))
    total = _sum_launches(total, want)
    log(f"[12] (b) deep_cache_sweep, bf16, bucket {deep['frames']}, best of {P12_REPEATS}: "
        f"{wall:.1f} s, launches {want}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    for row in deep["rows"]:
        r, j = row["deep_cache_interval"], row["deep_cache_blocks"]
        log(f"[12] (b) r={r} j={j}: {row['latent_ms']} ms a solve, speedup "
            f"{row['speedup_vs_exact']}, {_deep_cache_evals(depth, steps, r, j)} block "
            f"evaluations; drift vs exact MAE {row['mel_mae_vs_exact']:.3e}, max-abs "
            f"{row['mel_max_abs_vs_exact']:.3e}; MAE vs the f32 exact latent (the "
            f"mel_mae_vs_onnx column) {row['mel_mae_vs_onnx']:.3e} [{card}]")
    torch.cuda.reset_peak_memory_stats()
    want = _forwards(depth, (1 + P12_REPEATS) * len(P12_CFG) * steps)
    cfgc, wall = _counted("(c) cfg_cache_sweep",
                          lambda: cfg_cache_sweep(pack, ref, intervals=P12_CFG,
                                                  repeats=P12_REPEATS, device="cuda"), want,
                          (1 + P12_REPEATS) * len(P12_CFG))
    total = _sum_launches(total, want)
    log(f"[12] (c) cfg_cache_sweep, bf16, bucket {cfgc['frames']}, best of {P12_REPEATS}: "
        f"{wall:.1f} s, launches {want} (a cond-only evaluation is still one "
        f"forward), peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    for row in cfgc["rows"]:
        log(f"[12] (c) k={row['uncond_interval']}: {row['latent_ms']} ms a solve, speedup "
            f"{row['speedup_vs_exact']}; drift vs exact MAE {row['mel_mae_vs_exact']:.3e}, "
            f"max-abs {row['mel_max_abs_vs_exact']:.3e}; MAE vs the f32 exact latent "
            f"{row['mel_mae_vs_onnx']:.3e} [{card}]")
    for rec in (deep, cfgc):
        exact = rec["rows"][0]
        if exact["mel_mae_vs_exact"] != 0.0 or not all(
                np.isfinite(r["mel_mae_vs_onnx"]) and r["latent_ms"] > 0 for r in rec["rows"]):
            raise AssertionError(f"[12] {rec['metric']}: {rec['rows']}")

    # (d) The command line on 10 (a)'s depth-2, NFE-8 pack against its ONNX
    # reference side: there mel_mae_vs_onnx is the real thing.
    env = {**os.environ, "VIETVOICE_LOG_LEVEL": "WARNING"}
    cmd = [sys.executable, "-m", "vietvoice_tts_tpu_torch.golden", "--ref-npz",
           str(REHEARSAL_REF), "--pack", str(REHEARSAL_PACK)]
    t0 = time.perf_counter()
    proc = subprocess.run([*cmd, "--cfg-cache-sweep", "1,2"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"[12] (d) exit {proc.returncode}, {len(lines)} lines\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    rec = json.loads(lines[0])
    rows = rec["rows"]
    if (rec["metric"], rec["precision"], [r["uncond_interval"] for r in rows]) != (
            "cfg_cache_price", "float32", [1, 2]) or not rows[0]["mel_mae_vs_onnx"] < GOLDEN_F32[0]:
        raise AssertionError(f"[12] (d) {rec}")
    log(f"[12] (d) golden --cfg-cache-sweep 1,2 on the depth-{REHEARSAL_DEPTH} pack, f32: "
        f"exit 0 in {wall:.1f} s; mel MAE vs ONNX {rows[0]['mel_mae_vs_onnx']:.3e} (k=1), "
        f"{rows[1]['mel_mae_vs_onnx']:.3e} (k=2); drift k=2 {rows[1]['mel_mae_vs_exact']:.3e} "
        f"[{card}]")
    proc = subprocess.run([*cmd, "--deep-cache-sweep", "2:1"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 2 or proc.stdout.strip():
        raise AssertionError(f"[12] (d) --deep-cache-sweep 2:1: exit {proc.returncode}, "
                             f"{proc.stdout[-500:]}")
    log(f"[12] (d) --deep-cache-sweep 2:1 (no exact baseline): exit 2, "
        f"{proc.stderr.strip().splitlines()[-1]}")

    # (e) The sweeps time each setting best-of-repeats in a fixed order, as the JAX
    # harness does; here all of (b)'s and (c)'s settings are timed
    # interleaved on one core, and each one's device time is read from a trace.
    settings = [("exact", {}, per_solve)]
    settings += [(f"deep r={r} j={j}", {"deep_cache_interval": r, "deep_cache_blocks": j},
                  _deep_cache_launches(depth, steps, r, j)) for r, j in P12_DEEP[1:]]
    settings += [(f"cfg k={k}", {"uncond_interval": k}, per_solve) for k in P12_CFG[1:]]
    want = _sum_launches(*(launches for _, _, launches in settings for _ in range(2 + P12_ROUNDS)))
    rows, wall = _counted("(e) interleaved", lambda: _interleaved_prices(pack, ref, settings),
                          want, (2 + P12_ROUNDS) * len(settings))
    total = _sum_launches(total, want)
    log(f"[12] (e) {len(settings)} settings on one bf16 core, bucket {P12_FRAMES}, {P12_ROUNDS} "
        f"interleaved rounds and one traced solve each: {wall:.1f} s, launches {want} "
        f"[{card}]")
    base = rows[0]
    for row in rows:
        traced = (f"device kernels {row['device_ms']:.1f} ms in {row['kernels']} launches, "
                  f"idle {100 * (1 - row['device_ms'] / row['median_ms']):.0f}% of the median"
                  if row["device_ms"] else "the profiler recorded no device time")
        log(f"[12] (e) {row['label']}: {row['evals']} block evaluations; median "
            f"{row['median_ms']:.2f} ms (rounds {' '.join(f'{t:.1f}' for t in row['ms'])}), "
            f"speedup {base['median_ms'] / row['median_ms']:.3f}; {traced} (the traced solve "
            f"and its reading {row['trace_s']:.1f} s) [{card}]")
    log(f"[12] done in {time.perf_counter() - t_phase:.1f} s, launches {total} [{card}]")
    return total


# ---------------------------------------------------------------------------
# Phase 14: the captured chunk programs (runtime/graphs.py) against their
# eager runs, on the card, at the serving path's shapes.
# ---------------------------------------------------------------------------

P14_BIG = (8, 1024, 250)  # (batch, frames, reference frames): the bench's batch 8
P14_ROUNDS = 5  # (d)'s interleaved rounds of eager and graph
# (d)'s interleaved rounds of the two streaming orders: a batch-1 chunk's
# device time varies by a few ms from run to run, and medians of five
# rounds put the two orders' first pieces a millisecond apart either way.
P14_STREAM_ROUNDS = 7
P14_REPLAYS = 3  # (c)'s timed replays of each graph; the host's launch ms is their median
# (c): the most a graph's launch may hold the host, median ms. Launches of
# all-kernel graphs returned in 0.3–1.0 ms on an H100; graphs that held
# cuBLAS's memset nodes took up to 1,765.6 ms (PERF.md).
HOST_LAUNCH_MS = 2.0
# (c): (batch, frames) at which each GEMM of a DiT block is captured alone
# (2 · batch rows: CFG doubles the batch): the long text's 2048-frame chunk
# alone, the bench's batch 8 × 1024, and the short request's bucket.
P14_GEMM_SHAPES = ((1, 2048), (8, 1024), (1, 384))
P14_GEMM_REPLAYS = 20  # back-to-back replays of each GEMM's graph, timed together
# torch.profiler leaves CUPTI attached to the process: after a session a
# serving graph's launch holds the host tens of times longer (PERF.md, PR
# 12). So phase 14 runs before phase 9 (e) profiles train steps, its
# traced chunks (e) run after phase 13, and (c) times the train step's graphs
# itself. (e) logs one launch after its traces (PROFILED_LAUNCH) to show it.
PROFILED_LAUNCH = "launch after a torch.profiler session"


def _graph_row(tag: str, label: str, entry, card: str) -> dict:
    """One captured graph: its nodes by type, memset nodes rewritten, the
    median over P14_REPLAYS replays (each on an idle card) of its device ms
    (CUDA events) and of the host's ms to launch it. Raises if a memset
    node is left or the launch held the host past HOST_LAUNCH_MS."""
    import torch

    device_ms, host_ms = [], []
    for _ in range(P14_REPLAYS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        t0 = time.perf_counter()
        entry.graph.replay()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        device_ms.append(start.elapsed_time(end))
    graph = entry.graph
    row = dict(label=label, types=graph.node_types, rewritten=graph.rewritten,
               device_ms=statistics.median(device_ms), host_ms=statistics.median(host_ms),
               capture_s=entry.capture_s)
    log(f"{tag} graph {label}: capture {entry.capture_s:.2f} s (eager run and capture), "
        f"nodes {graph.node_types} (rewritten as kernels: {graph.rewritten}), "
        f"kernel launches {entry.launches}; replay device {row['device_ms']:.2f} ms, host "
        f"{row['host_ms']:.3f} ms to launch it (medians of {P14_REPLAYS}; host "
        f"{' '.join(f'{t:.3f}' for t in host_ms)}) [{card}]")
    if graph.node_types["memset"] or row["host_ms"] > HOST_LAUNCH_MS:
        raise AssertionError(f"{tag} {label}: {graph.node_types['memset']} memset nodes, "
                             f"launch held the host {row['host_ms']:.3f} ms "
                             f"(at most {HOST_LAUNCH_MS})")
    return row


@contextlib.contextmanager
def _waveform_route(core):
    """The voice-conditioning cache off inside: every batch takes the
    waveform route."""
    core.config.voice_cond_cache = False
    try:
        yield
    finally:
        core.config.voice_cond_cache = True


def _chunk_inputs(engine, text: str, **voice) -> tuple:
    """The one padded row a single-chunk request dispatches: (wave, ref_len,
    text_ids, total_len), planned as ``TTSEngine`` plans it."""
    ref_audio, ref_text = engine.model_session_manager.select_sample(**voice)
    ref = engine._load_ref(ref_audio).astype(np.float32) / 32768.0
    (plan,) = engine._plan_chunks(ref, ref_text, text)
    wave, ids = engine._chunk_row(plan, ref)
    return wave[None], np.array([plan.ref_len]), ids[None], np.array([plan.total_len])


def _replay_vs_eager(label: str, core, args, seed, card: str, route=contextlib.nullcontext):
    """The batch through its graph twice (captured at the first call unless
    it was already) and through the eager program bodies once; returns the
    eager PCM."""
    from vietvoice_tts_tpu_torch.runtime import graphs

    replays = graphs.replays
    with route(core):
        first = core.synthesize_batch(*args, seed=seed)
        again = core.synthesize_batch(*args, seed=seed)
        with _eager(core):
            eager = core.synthesize_batch(*args, seed=seed)
    if graphs.replays - replays != 2:
        raise AssertionError(f"[14] {label}: {graphs.replays - replays} replays for 2 batches")
    _check_wave(f"[14] {label}", eager[0])
    _pcm_gap("[14] (a)", f"{label}, first replay", first, eager, card)
    _pcm_gap("[14] (a)", f"{label}, second replay", again, eager, card)
    return eager


def _train_graph_rows(tree: dict, vocab_size: int, card: str) -> list:
    """(c) The train step's graphs of 9 (e) (full width, batch 8 × 256, bf16
    and f32 with TF32 off), captured here, before any profiler session:
    two steps (the capture, its eager run the first step, then a replay),
    then ``_graph_row``."""
    import torch

    from vietvoice_tts_tpu_torch.models.dit import DiTConfig
    from vietvoice_tts_tpu_torch.training import train as ttrain

    dcfg = DiTConfig(vocab_size=vocab_size)
    b, n = 8, 256
    rng = np.random.default_rng(12)
    ids = np.full((b, n), -1, np.int32)
    ids[:, :50] = rng.integers(0, vocab_size, (b, 50))
    batch = ttrain.as_tensors(rng.normal(-4.0, 2.0, (b, n, dcfg.n_mels)).astype(np.float32),
                              ids, np.full((b,), 187, np.int32), "cuda")
    rows = []
    for dtype in ("bfloat16", "float32"):
        tcfg = ttrain.TrainConfig(compute_dtype=dtype, warmup_steps=2)
        dit, opt = ttrain.init_train_state(tree, dcfg, tcfg, "cuda")
        step = ttrain.make_train_step(dcfg, tcfg)
        for i in range(2):
            draws = ttrain.draw(torch.Generator().manual_seed(i), b, n, dcfg.n_mels, tcfg)
            step(dit, opt, draws.to("cuda"), *batch).item()
        (entry,) = step.graphs.entries.values()
        rows.append(_graph_row("[14] (c)", f"train step {dtype} B={b} N={n}", entry, card))
        del dit, opt, step, entry
        torch.cuda.empty_cache()
    return rows


def _graph_table(core, tree: dict, vocab_size: int, card: str) -> None:
    """(c) Every graph the phase captured, then the train step's: nodes by
    type, memsets rewritten, replay device ms and the host's ms to launch
    it (``_graph_row``: no memset node, launch within HOST_LAUNCH_MS)."""
    rows = [_graph_row("[14] (c)", f"{key[0]} B={key[1]} N={key[2]} {key[3].compute_dtype}",
                       entry, card)
            for key, entry in core.graphs.entries.items()]
    train = _train_graph_rows(tree, vocab_size, card)
    rows += train
    worst = max(rows, key=lambda r: r["host_ms"])
    log(f"[14] (c) {len(rows)} graphs ({len(train)} train steps): 0 memset nodes "
        f"({sum(r['rewritten']['memset'] for r in rows)} rewritten as fill kernels, "
        f"{sum(r['rewritten']['memcpy'] for r in rows)} memcpys as copy kernels; "
        f"{sum(r['types']['memcpy'] for r in rows)} memcpys left), the longest launch "
        f"{worst['host_ms']:.3f} ms ({worst['label']}, device {worst['device_ms']:.2f} ms) "
        f"[{card}]")


def _memset_sources(core, card: str) -> None:
    """(c) Which GEMMs of a DiT block put memset nodes into a capture: each
    of the four (qkv, attn_out, ff1, ff2) at P14_GEMM_SHAPES in the serving
    dtype, captured alone as the chunk program captures it, once as
    captured (its nodes by type) and once rewritten (no memset, the same
    number of nodes): both replays and the eager call equal bit for bit, and
    the device µs of a replay of each."""
    import torch

    from vietvoice_tts_tpu_torch.models.dit import linear
    from vietvoice_tts_tpu_torch.runtime import graphs

    blk = core.dit.blocks[0]
    dtype = getattr(torch, core.config.compute_dtype)
    gen = torch.Generator(device="cuda").manual_seed(14)
    stream = torch.cuda.Stream()
    for b, n in P14_GEMM_SHAPES:
        for name in ("qkv", "attn_out", "ff1", "ff2"):
            layer = getattr(blk, name)
            x = torch.randn((2 * b, n, layer.in_features), generator=gen,
                            device="cuda").to(dtype)
            with torch.inference_mode():
                eager = linear(x, layer)
                outs, types, times, rewritten = [], [], [], {"memset": 0, "memcpy": 0}
                for rewrite in (False, True):
                    graph = torch.cuda.CUDAGraph(keep_graph=True)
                    stream.wait_stream(torch.cuda.current_stream())
                    with torch.cuda.graph(graph, stream=stream):
                        out = linear(x, layer)
                    raw = graph.raw_cuda_graph()
                    if rewrite:
                        rewritten = graphs.rewrite_graph(raw, x.device)
                    types.append(graphs.graph_node_types(raw))
                    graph.instantiate()
                    graph.replay()
                    torch.cuda.synchronize()
                    outs.append(out.clone())
                    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    start.record()
                    for _ in range(P14_GEMM_REPLAYS):
                        graph.replay()
                    end.record()
                    end.synchronize()
                    times.append(start.elapsed_time(end) / P14_GEMM_REPLAYS * 1e3)
                    del graph
            captured, after = types
            if (after["memset"] or rewritten["memset"] != captured["memset"]
                    or sum(after.values()) != sum(captured.values())
                    or not torch.equal(outs[0], outs[1]) or not torch.equal(outs[1], eager)):
                raise AssertionError(f"[14] (c) {name} at {2 * b} × {n}: captured {captured}, "
                                     f"rewritten {after} ({rewritten}), replays equal "
                                     f"{torch.equal(outs[0], outs[1])}, equal to eager "
                                     f"{torch.equal(outs[1], eager)}")
            log(f"[14] (c) GEMM {name} [{2 * b} × {n}, {layer.in_features}] → "
                f"{layer.out_features} {core.config.compute_dtype}, captured alone: "
                f"nodes {captured}; rewritten: {after}; replays and eager bit-identical; replay "
                f"{times[0]:.1f} µs as captured, {times[1]:.1f} µs rewritten (mean of "
                f"{P14_GEMM_REPLAYS}) [{card}]")


def _latency_b1(api, core, short, card: str) -> None:
    """(d) Batch 1, eager and graph interleaved in this call: the short
    request, its one chunk, the host's dispatch of that chunk, and
    ``compute_ms_b1`` (the bench's compute leg: bucket 384, inputs already on
    the card). Returns the chunk's median ms in each mode, for
    ``_traced_chunks``."""
    import torch

    from vietvoice_tts_tpu_torch.bench import _batched_inputs

    hop = core.config.hop_length
    on_card = [core._to_device(a, dt) for a, dt in zip(
        _batched_inputs(1, 384, 188, hop), (np.float32, np.int64, np.int64, np.int64))]

    def compute_b1():
        with torch.inference_mode(), core._numerics():
            core._run("pcm", core._waveform_program, *on_card, core._noise([0], 384))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def dispatch():
        t0 = time.perf_counter()
        fetch = core.synthesize_batch_async(*short, seed=0)
        ms = (time.perf_counter() - t0) * 1e3
        fetch()
        return ms

    chunk = f"its chunk (batch 1, bucket {short[2].shape[1]})"
    legs = {
        "short request": lambda: timed(lambda: api.synthesize(SHORT_TEXT)),
        chunk: lambda: timed(lambda: core.synthesize_batch(*short, seed=0)),
        "host dispatch of the chunk": dispatch,
        "compute_ms_b1 (bucket 384)": lambda: timed(compute_b1),
    }
    modes = {"graph": contextlib.nullcontext, "eager": lambda: _eager(core)}
    times = {(m, leg): [] for m in modes for leg in legs}
    for mode, ctx in modes.items():
        with ctx():
            for fn in legs.values():
                fn()  # warm: the graph of bucket 384 is captured here
    for rnd in range(P14_ROUNDS):
        for mode in (("graph", "eager") if rnd % 2 == 0 else ("eager", "graph")):
            with modes[mode]():
                for leg, fn in legs.items():
                    times[mode, leg].append(fn())
    for leg in legs:
        g, e = (statistics.median(times[m, leg]) for m in ("graph", "eager"))
        log(f"[14] (d) {leg}: graph {g:.1f} ms, eager {e:.1f} ms (medians of {P14_ROUNDS} "
            f"interleaved; graph {' '.join(f'{t:.1f}' for t in times['graph', leg])}; eager "
            f"{' '.join(f'{t:.1f}' for t in times['eager', leg])}), eager/graph {e / g:.2f} "
            f"[{card}]")
    return {mode: statistics.median(times[mode, chunk]) for mode in modes}


def _traced_chunks(core, short, chunk_ms: dict, card: str) -> None:
    """(e), last of the script: one batch-1 chunk traced by ``torch.profiler``
    in each mode, its device kernel time and the device's idle share of the
    chunk's median; then the host's ms to launch that chunk's graph again,
    with the profiler's CUPTI still attached (PROFILED_LAUNCH)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    modes = {"graph": contextlib.nullcontext, "eager": lambda: _eager(core)}
    for mode, ctx in modes.items():
        with ctx():
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                core.synthesize_batch(*short, seed=0)
                torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0
                   and not getattr(e, "is_user_annotation", False) and "#" not in e.key]
        device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        idle = (f"idle {100 * (1 - device_ms / chunk_ms[mode]):.1f}% of the chunk's median "
                f"{chunk_ms[mode]:.1f} ms" if device_ms
                else "the profiler recorded no device time")
        log(f"[14] (e) traced batch-1 chunk, {mode}: device kernels {device_ms:.1f} ms in "
            f"{sum(e.count for e in kernels)} launches; {idle} [{card}]")
    b, n = short[2].shape
    key = next(k for k in core.graphs.entries if k[1:3] == (b, n))
    host = []
    for _ in range(P14_REPLAYS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        core.graphs.entries[key].graph.replay()
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    log(f"[14] (e) {PROFILED_LAUNCH}: graph {key[0]} B={b} N={n}, host "
        f"{statistics.median(host):.3f} ms to launch it (median of {P14_REPLAYS}; (c) timed "
        f"it before any session) [{card}]")


def _first_piece(engine, card: str) -> None:
    """(d) Streaming's first piece with the port's order, which is the JAX
    engine's (``TTSEngine._iter_chunk_waves``: up to three single-row
    dispatches queued, the oldest fetched when a third is), against one
    chunk at a time (chunk k reaches the caller before chunk k+1 is
    dispatched, the port's order before), interleaved over
    P14_STREAM_ROUNDS, for the long text with the bench's 4 s head chunk and
    without; with the medians, each order's spread (largest minus smallest)
    and the whole stream's wall."""
    import torch

    ref_audio, ref_text = engine.model_session_manager.select_sample()
    ref = engine._load_ref(ref_audio).astype(np.float32) / 32768.0
    core = engine.engine_core

    def one_at_a_time(plans):
        for p in plans:
            wave, ids = engine._chunk_row(p, ref)
            yield core.synthesize_batch_async(
                wave[None], np.asarray([p.ref_len], np.int32), ids[None],
                np.asarray([p.total_len], np.int32), seed=np.asarray([p.index], np.uint32))()

    modes = {"JAX's order (the port's)": lambda plans: engine._iter_chunk_waves(plans, ref),
             "one at a time": one_at_a_time}
    for cap in (None, 4.0):
        plans = engine._plan_chunks(ref, ref_text, LONG_TEXT, first_chunk_cap=cap)
        firsts, alls = ({m: [] for m in modes} for _ in range(2))
        for rnd in range(P14_STREAM_ROUNDS + 1):  # round 0 warms the shapes
            for mode in (list(modes) if rnd % 2 else list(modes)[::-1]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pieces = modes[mode](plans)
                next(pieces)
                first = (time.perf_counter() - t0) * 1e3
                for _ in pieces:
                    pass
                if rnd:
                    firsts[mode].append(first)
                    alls[mode].append((time.perf_counter() - t0) * 1e3)
        head = f"{plans[0].bucket}-frame head chunk" + (" (4 s cap)" if cap else "")
        log(f"[14] (d) first streamed piece, {len(plans)} chunks, {head}: "
            + "; ".join(f"{m} {statistics.median(t):.1f} ms, spread {max(t) - min(t):.1f} "
                        f"({' '.join(f'{x:.1f}' for x in t)}), whole stream "
                        f"{statistics.median(alls[m]):.1f} ms"
                        for m, t in firsts.items())
            + f" (medians of {P14_STREAM_ROUNDS} interleaved) [{card}]")
        ours, theirs = (firsts[m] for m in modes)
        if statistics.median(ours) > statistics.median(theirs) + max(theirs) - min(theirs):
            raise AssertionError(f"[14] (d) {head}: JAX's order gave the first piece later "
                                 "than one at a time, beyond its spread")


def phase_graphs(cfg, card: str) -> dict:
    """Phase 14: (a) replay against eager on the same core and inputs at the
    serving shapes, both routes (phases 4, 10 (b) and 13 (c) hold the mel
    latent, the 32 × 32 and 16 × 64 routes and batch 32 × 512 alike); (b)
    replays out of capture order with three fetches of one shape
    outstanding; (c) which GEMMs made memset nodes, each graph's capture,
    nodes by type, replay and launch times, and the device memory a warm-up
    of the serving grid takes; (d) batch-1 latency eager against
    graph, interleaved, and the first streamed piece with JAX's order against
    one chunk at a time. Returns the batch-1 chunk's median ms in each mode
    for (e), which traces it at the end of the script (PROFILED_LAUNCH)."""
    import torch

    from vietvoice_tts_tpu_torch import TTSApi
    from vietvoice_tts_tpu_torch.bench import _batched_inputs
    from vietvoice_tts_tpu_torch.runtime.engine_core import EngineCore

    api = TTSApi(cfg)
    engine = api.engine
    params = _perturbed_gates(engine.model_session_manager.params)
    vocab = engine.model_session_manager.vocab_size
    # Opened AdaLN gates, so that attention reaches the output.
    engine.engine_core = core = EngineCore(cfg, params, vocab)
    hop = cfg.hop_length
    clone_voice = {"reference_audio": str(WORK / "clone_voice.wav"),
                   "reference_text": CLONE_REFERENCE_TEXT}
    short = _chunk_inputs(engine, SHORT_TEXT)
    clone = _chunk_inputs(engine, CLONE_TEXT, **clone_voice)
    bucket = short[2].shape[1]

    # (c) The serving grid of the short request's bucket: every batch size
    # the micro-batcher dispatches, and the waveform route at batch 1; and
    # the largest bucket (the long text's chunks) at batch 1 and 8, whose
    # graphs held the most memset nodes (examples/torch_graph_grid.py
    # times the whole grid).
    big = cfg.frame_buckets[-1]
    gc.collect()
    torch.cuda.empty_cache()  # as every capture does on entering
    torch.cuda.synchronize()
    reserved0 = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    engine.warmup(buckets=(bucket,))
    engine.warmup(batches=(1, cfg.max_batch_size), buckets=(big,))
    torch.cuda.synchronize()
    log(f"[14] (c) warmup of bucket {bucket} × batches {cfg.batch_grid()} (+ the waveform "
        f"route at batch 1) and bucket {big} × (1, {cfg.max_batch_size}) (+ the waveform "
        f"route at batch 1): {core.graph_captures} graphs captured in "
        f"{time.perf_counter() - t0:.1f} s; device memory reserved "
        f"{reserved0 / 2**30:.2f} → {torch.cuda.memory_reserved() / 2**30:.2f} GiB [{card}]")

    # (a) Replay against eager at the serving shapes.
    eager = {}
    for label, args in (("short", short), ("clone", clone)):
        for route, ctx in (("cached conditioning", contextlib.nullcontext),
                           ("waveform", _waveform_route)):
            eager[label, route] = _replay_vs_eager(
                f"8x128 {label} ({args[2].shape[1]} frames), {route}", core, args, 0, card, ctx)
    b, n, ref = P14_BIG
    _replay_vs_eager(f"8x128 batch {b} × {n}", core, _batched_inputs(b, n, ref, hop), 1, card)

    # (b) Out of capture order, three fetches of one shape outstanding.
    with _eager(core):
        for seed in (5, 6):
            eager["short", f"seed {seed}"] = core.synthesize_batch(*short, seed=seed)
    order = [("clone", "cached conditioning", clone, 0, contextlib.nullcontext),
             ("short", "seed 5", short, 5, contextlib.nullcontext),
             ("short", "seed 6", short, 6, contextlib.nullcontext),
             ("short", "cached conditioning", short, 0, contextlib.nullcontext),
             ("short", "waveform", short, 0, _waveform_route)]
    fetches = []
    for label, route, args, seed, ctx in order:
        with ctx(core):
            fetches.append((label, route, core.synthesize_batch_async(*args, seed=seed)))
    for label, route, fetch in reversed(fetches):
        got, want = fetch(), eager[label, route]
        if not np.array_equal(got, want):
            _pcm_gap("[14] (b)", f"{label} {route}, interleaved", got, want, card)
    log(f"[14] (b) five batches of three graphs dispatched out of capture order, three of "
        f"one shape outstanding, fetched in reverse: each equal to its own eager run [{card}]")

    _memset_sources(core, card)
    _graph_table(core, params["dit"], vocab, card)
    chunk_ms = _latency_b1(api, core, short, card)
    _first_piece(engine, card)
    api.cleanup()
    return chunk_ms


def phase_traced(cfg, chunk_ms: dict, card: str) -> None:
    """Phase 14 (e), last of the script: the short request's batch-1 chunk
    traced in each mode (``_traced_chunks``) on a core of its own with
    opened gates, against 14 (d)'s medians."""
    from vietvoice_tts_tpu_torch import TTSApi
    from vietvoice_tts_tpu_torch.runtime.engine_core import EngineCore

    api = TTSApi(cfg)
    engine = api.engine
    mgr = engine.model_session_manager
    engine.engine_core = core = EngineCore(cfg, _perturbed_gates(mgr.params), mgr.vocab_size)
    short = _chunk_inputs(engine, SHORT_TEXT)
    core.synthesize_batch(*short, seed=0)  # the capture
    _traced_chunks(core, short, chunk_ms, card)
    api.cleanup()


# ---------------------------------------------------------------------------
# Phase 13: the port's bench harness (vietvoice_tts_tpu_torch/bench.py, the
# root bench.py's configs) on phase 5's seeded pack, default model (8 × 128).
# ---------------------------------------------------------------------------

BENCH_WORK = WORK / "bench"
P13_REQUESTS = 16  # requests per REST point: the bench's 64, cut for time
P13_SWEEP = ((6, 10.0, None), (12, 10.0, 12))  # (concurrency, max_wait_ms, cap)
P13_OPEN_LOOP_RPS = 12.0
P13_BATCH = (32, 512, 125)  # batch32's rows, frames and reference frames
P13_TIMEOUT = 600.0  # seconds the bench's process may take


def start_bench_process():
    """13 (a), started: ``python -m vietvoice_tts_tpu_torch.bench
    --skip-rest`` as a user starts it, in its own process. It runs beside
    phase 11 (whose ranks' times are no measurement either) and is awaited
    after it, by ``finish_bench_process``; its own times are not measured
    here (``PERF.md`` quotes the bench's runs on an idle card)."""
    import torch

    BENCH_WORK.mkdir(parents=True, exist_ok=True)
    full_out = BENCH_WORK / "BENCH_full.json"
    full_out.unlink(missing_ok=True)
    gc.collect()
    torch.cuda.empty_cache()  # the bench's process needs the card's memory
    cmd = [sys.executable, "-m", "vietvoice_tts_tpu_torch.bench", "--skip-rest",
           "--full-out", str(full_out)]
    env = {**os.environ, "VIETVOICE_TPU_CACHE": str(WORK / "models"),
           "VIETVOICE_LOG_LEVEL": "WARNING"}
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    return proc, full_out, time.perf_counter()


def finish_bench_process(started, cfg, smi: str) -> dict:
    """13 (a), awaited: exit 0, the root harness's compact keys, ``cuda``, a
    value above 0, the full record, and 682 kernel-1 and 1,395 AdaLN
    launches per batch in it; returns those launches."""
    from vietvoice_tts_tpu_torch.bench import COMPACT_KEYS, COMPACT_MAX_CHARS

    proc, full_out, t0 = started
    try:
        stdout, stderr = proc.communicate(timeout=P13_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"bench did not finish in {P13_TIMEOUT:.0f} s") from None
    wall = time.perf_counter() - t0
    for line in stderr.splitlines():
        if line.startswith("["):
            log(f"[13] (a) bench: {line}")
    if proc.returncode != 0:
        raise AssertionError(f"bench exited {proc.returncode}:\n{stderr[-3000:]}")
    last = stdout.strip().splitlines()[-1]
    compact = json.loads(last)
    if (list(compact) != list(COMPACT_KEYS) or len(last) > COMPACT_MAX_CHARS
            or compact["backend"] != "cuda" or not compact["value"] > 0):
        raise AssertionError(f"bench's compact line: {last}")
    record = json.loads(full_out.read_text())
    launches = record["launches"]
    got = {"fused_rope": launches["fused_qkv_rope_attention"],
           "flash": launches["flash_attention"], "adaln": launches["adaln_norm"]}
    replays = record["graphs"]["replays"]
    if replays <= 0 or got != _solves(cfg, replays):
        raise AssertionError(f"bench's launches {launches}, want {_solves(cfg, 1)} per graph "
                             f"replay ({record['graphs']})")
    log(f"[13] (a) bench --skip-rest: exit 0, {wall:.1f} s from its start (beside phase 11: "
        f"no time of this run is a measurement); {len(last)} characters: {last} [{smi}]")
    log(f"[13] (a) full record {full_out.relative_to(ROOT)}: launches {got} ({replays} "
        f"batches, each one graph replay; graphs {record['graphs']}) [{smi}]")
    return got


def _bench_rest(api, smi: str) -> dict:
    """13 (b): the bench's REST points in this process, at P13_REQUESTS each;
    returns the kernels' launches."""
    from vietvoice_tts_tpu_torch import bench
    from vietvoice_tts_tpu_torch.api import tts_engine as te

    engine = api.engine
    batchers = []
    real = engine.enable_micro_batching

    def keep(**kw):
        batchers.append(real(**kw))
        return batchers[-1]

    engine.enable_micro_batching = keep
    total = dict(NO_LAUNCHES)
    try:
        t0 = time.perf_counter()
        client = bench.serve_through_app(api)
        log(f"[13] (b) app routed to the engine, batch grid warmed in "
            f"{time.perf_counter() - t0:.1f} s")
        points = [(f"c={c} wait={w} cap={cap}", lambda c=c, w=w, cap=cap: bench._rest_sweep_point(
            api, client, P13_REQUESTS, c, w, max_batch=cap)) for c, w, cap in P13_SWEEP]
        points.append((f"open loop {P13_OPEN_LOOP_RPS} req/s",
                       lambda: bench._rest_open_loop_point(api, client, P13_REQUESTS,
                                                           P13_OPEN_LOOP_RPS, max_batch=12)))
        for label, run in points:
            _reset_launches()
            point = run()
            got = _launches()
            stats = batchers[-1].stats
            if stats.failures or stats.retries:
                raise AssertionError(f"(b) {label}: {stats}")
            if got != _solves(api.config, stats.batches):
                raise AssertionError(f"(b) {label}: launches {got} for {stats.batches} batches")
            _check_replays(f"(b) {label}", stats.batches)
            if "mode" not in point and not point["mean_batch_size"] > 1:
                raise AssertionError(f"(b) {label}: mean batch size {point['mean_batch_size']}")
            total = _sum_launches(total, got)
            log(f"[13] (b) REST {label}: {point}; {stats.batches} batches (the warm-up "
                f"request's included), {stats.jobs} jobs, launches {got} [{smi}]")
    finally:
        te._engine = None
        engine.enable_micro_batching = real
    return total


def _bench_batch_row(api, smi: str) -> dict:
    """13 (c): row 0 of a batch of 32 at 512 frames against the same row
    alone at batch 1, one seed; returns the kernels' launches."""
    from vietvoice_tts_tpu_torch.bench import _batched_inputs

    core = api.engine.engine_core
    batch, frames, ref_frames = P13_BATCH
    wave, ref_len, ids, total = _batched_inputs(batch, frames, ref_frames, core.config.hop_length)
    _reset_launches()
    t0 = time.perf_counter()
    rows = core.synthesize_batch_async(wave, ref_len, ids, total, seed=1)()
    wall = time.perf_counter() - t0
    alone = core.synthesize_batch(wave[:1], ref_len[:1], ids[:1], total[:1], seed=1)
    got = _launches()
    if got != _solves(core.config, 2):
        raise AssertionError(f"(c) launches {got}")
    _check_replays("(c) batch row", 2)
    # Phase 14 (a) at batch 32 × 512: the batch's replay against the eager
    # program bodies of the same core.
    with _eager(core):
        eager = core.synthesize_batch(wave, ref_len, ids, total, seed=1)
    _pcm_gap("[13] (c)", f"8x128 batch {batch} × {frames}", rows, eager, smi)
    _check_wave("(c) batch row 0", rows[0])
    diff = np.abs(rows[0].astype(np.int32) - alone[0].astype(np.int32))
    max_diff, mean_diff = int(diff.max()), float(diff.mean())
    log(f"[13] (c) row 0 of batch {batch} × {frames} ({wall * 1e3:.1f} ms) against batch 1: "
        f"largest sample difference {max_diff} (tol {STREAM_TOLERANCE[0]}), mean "
        f"{mean_diff:.4f} (tol {STREAM_TOLERANCE[1]}) of 32767 [{smi}]")
    if rows.shape != (batch, frames * core.config.hop_length) or alone.shape[1] != rows.shape[1]:
        raise AssertionError(f"(c) shapes {rows.shape}, {alone.shape}")
    if max_diff > STREAM_TOLERANCE[0] or mean_diff > STREAM_TOLERANCE[1]:
        raise AssertionError("(c) batch row outside STREAM_TOLERANCE of its batch-1 self")
    return got


def phase_bench(cfg, smi: str) -> dict:
    """13 (b) and (c), the bench's REST points and a batch row in this
    process; returns the kernels' launches (kernel 2 has none: the bench
    serves 8 × 128). (a) runs beside phase 11."""
    from vietvoice_tts_tpu_torch import TTSApi

    api = TTSApi(cfg)
    try:
        return _sum_launches(_bench_rest(api, smi), _bench_batch_row(api, smi))
    finally:
        api.cleanup()


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
    walls = {}

    def phase(number, fn, *args):
        """Run one phase, wait for the card, log its wall time."""
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        walls[number] = time.perf_counter() - t0
        log(f"[{number}] phase wall {walls[number]:.1f} s")
        return out

    t_script = time.perf_counter()
    phase(2, phase_build)
    fused_record = phase(3, phase_kernels, card)
    flash_record = phase("3 flash", phase_flash_kernel, card)
    adaln_record = phase("3 adaln", phase_adaln, card)
    cfg = ModelConfig(device="cuda", model_cache_dir=str(WORK / "models"))
    # The default model's widths with a head split the fused kernel does not
    # take (head_dim 32); the weights do not depend on the split.
    cfg32 = dataclasses.replace(cfg, dit_heads=32)
    phase(4, phase_whole_path, cfg, cfg32, card)
    head_launches = phase(15, phase_head_shapes, cfg, card, smi)
    launches, solo = phase(5, phase_serving, cfg, cfg32, smi)
    batched = phase(6, phase_batcher, cfg, cfg32, smi, solo)
    phase(7, phase_cli, cfg, smi)
    rest_launches = phase(8, phase_rest, cfg, smi)
    # Replay against eager on an idle card, and the graphs' launch times
    # before 9 (e) and 12 (e) attach the profiler (PROFILED_LAUNCH); its
    # traced chunks (e) come last.
    chunk_ms = phase(14, phase_graphs, cfg, card)
    trained_launches = phase(9, phase_training, cfg, smi)
    converted_launches = phase(10, phase_conversion, smi)
    # 13 (a), the bench's own process, runs beside phase 11 and is awaited
    # before phase 12, whose times must be the card's alone.
    bench = start_bench_process()
    try:
        parallel_launches = phase(11, phase_parallel, cfg, smi)
        bench_launches = phase("13 (a)", finish_bench_process, bench, cfg, smi)
    finally:
        if bench[0].poll() is None:
            bench[0].kill()
            bench[0].communicate()
    sweep_launches = phase(12, phase_sweeps, card)
    bench_launches = _sum_launches(bench_launches, phase(13, phase_bench, cfg, smi))
    phase("14 (e)", phase_traced, cfg, chunk_ms, card)
    log(f"[walls] {', '.join(f'phase {k} {v:.1f} s' for k, v in walls.items())}; "
        f"all phases {time.perf_counter() - t_script:.1f} s [{smi}]")
    launches = _sum_launches(launches, batched, rest_launches, trained_launches,
                             converted_launches, parallel_launches, sweep_launches,
                             bench_launches, head_launches)
    fused_record["launches"] = launches["fused_rope"]
    flash_record["launches"] = launches["flash"]
    adaln_record["launches"] = launches["adaln"]
    if not all(launches.values()):
        raise AssertionError(f"a kernel was never launched on the main path: {launches}")

    print(json.dumps({"kernels": [fused_record, flash_record, adaln_record]}))
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
