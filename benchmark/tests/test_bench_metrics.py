"""The metric arithmetic: percentiles over all requests, the rate over the
span, the idle share, batch matching, the steps' time from a synthetic timeline, the
flops and bytes counts against hand counts, and the per-layer readers."""

from __future__ import annotations

import math

import numpy as np
import pytest

from benchmark import flops, spec
from benchmark.run import LATENCY_OF_FAILED_MS, Window, end_to_end
from benchmark.trace import summarize_events
from benchmark.traffic.common import percentile


def test_percentile_nearest_rank():
    v = list(range(1, 101))
    assert percentile(v, 95) == 95
    assert percentile(v, 50) == 50
    assert percentile([3.0], 95) == 3.0
    assert percentile([1, 2, math.inf], 95) == math.inf
    assert math.isnan(percentile([], 95))


def _rec(i, due, end, ok=True, samples=24000):
    r = {"i": i, "due": due, "end": end, "ok": ok}
    if ok:
        r["pcm"] = np.zeros(samples, np.int16)
    return r


def test_end_to_end_rate_and_tail():
    # 20 requests of 1 s of audio each, the last completing 10 s after start.
    recs = [_rec(i, 100.0 + 0.5 * i, 100.0 + 0.5 * i + 0.2 + 0.01 * i) for i in range(19)]
    recs.append(_rec(19, 109.0, 110.0))
    out = end_to_end(recs, 100.0, 24000)
    assert out["audio_s_per_s"] == pytest.approx(20 / 10.0)
    # Over all 20: nearest rank 19 of the sorted times.
    lat = sorted((r["end"] - r["due"]) * 1e3 for r in recs)
    assert out["latency_p95_ms"] == pytest.approx(lat[18])


def test_a_failed_request_is_above_every_limit():
    recs = [_rec(i, float(i), i + 0.1) for i in range(10)]
    recs[3] = _rec(3, 3.0, math.inf, ok=False)
    out = end_to_end(recs, 0.0, 24000)
    assert out["latency_p95_ms"] == LATENCY_OF_FAILED_MS
    # It delivers nothing: 9 s of audio over 9.1 s.
    assert out["audio_s_per_s"] == pytest.approx(9 / 9.1)


def test_idle_share_and_gaps():
    ms = 1_000_000
    device = [(10 * ms, 20 * ms, "gemm", 7), (15 * ms, 30 * ms, "fused_rope_attention_mma_kernel", 7),
              (50 * ms, 60 * ms, "gemm", 8)]
    runtime = [(0, 1 * ms, "cudaGraphLaunch", 7), (40 * ms, 41 * ms, "cudaGraphLaunch", 8),
               (35 * ms, 45 * ms, "cudaEventSynchronize", 9)]
    host = [(0, 100 * ms, "python", 0)]
    s = summarize_events(sorted(device), sorted(runtime), host)
    assert s.window_s == pytest.approx(0.1)
    assert s.busy_s == pytest.approx(0.030)  # [10, 30] and [50, 60] ms
    assert s.kernel_ns == 35 * ms and s.attention_ns == 15 * ms
    assert s.device_ops[0] == ("gemm", pytest.approx(0.020))
    longest = s.idle_gaps[0]
    assert longest[1] == pytest.approx(0.040)  # 60 .. 100 ms
    gap_20 = [g for g in s.idle_gaps if g[1] == pytest.approx(0.020)][0]
    assert "cudaEventSynchronize" in gap_20[0]


def test_batches_matched_by_launch_time():
    ms = 1_000_000
    device = [(10 * ms, 11 * ms, "fused_rope_attention_mma_kernel", 7),
              (11 * ms, 12 * ms, "fused_rope_attention_mma_kernel", 7),
              (30 * ms, 31 * ms, "fused_rope_attention_mma_kernel", 9)]
    runtime = [(5 * ms, 6 * ms, "cudaGraphLaunch", 7), (25 * ms, 26 * ms, "cudaGraphLaunch", 9)]
    dispatches = [{"t_begin_ns": 4 * ms, "t_end_ns": 7 * ms, "bucket": 512},
                  {"t_begin_ns": 24 * ms, "t_end_ns": 27 * ms, "bucket": 640},
                  {"t_begin_ns": 80 * ms, "t_end_ns": 81 * ms, "bucket": 384}]
    s = summarize_events(device, runtime, [], dispatches)
    assert [b["dispatch"]["bucket"] for b in s.batches] == [512, 640]
    assert s.batches[0]["attention_calls"] == 2
    assert s.batches[0]["attention_ns"] == 2 * ms
    assert (s.batches[0]["first_ns"], s.batches[0]["last_ns"]) == (10 * ms, 12 * ms)
    assert s.step_ns == 3 * ms and s.step_busy_ns == 3 * ms  # [10, 12] and [30, 31] ms
    # Over a span that ends before the second batch's kernels: only the first
    # is whole in it, and busy time and the window are clipped to the span.
    s = summarize_events(device, runtime, [], dispatches, span=(0, 30 * ms))
    assert [b["dispatch"]["bucket"] for b in s.batches] == [512]
    assert s.window_s == pytest.approx(0.030) and s.busy_s == pytest.approx(0.002)
    assert s.step_ns == 2 * ms


def test_step_time_is_the_union_of_the_batches():
    """Two batches whose spans overlap (the second queued behind the
    first) and a gap between one batch's kernels: the step time counts the
    overlap once, its busy part leaves the gap out."""
    ms = 1_000_000
    device = [(10 * ms, 12 * ms, "gemm", 7), (14 * ms, 16 * ms, "gemm", 7),
              (16 * ms, 20 * ms, "gemm", 9), (50 * ms, 51 * ms, "gemm", 11)]
    runtime = [(5 * ms, 6 * ms, "cudaGraphLaunch", 7), (12 * ms, 13 * ms, "cudaGraphLaunch", 9),
               (45 * ms, 46 * ms, "cudaGraphLaunch", 11)]
    dispatches = [{"t_begin_ns": 4 * ms, "t_end_ns": 6 * ms, "bucket": 512},
                  {"t_begin_ns": 11 * ms, "t_end_ns": 13 * ms, "bucket": 512}]
    s = summarize_events(device, runtime, [], dispatches)
    assert [b["correlation"] for b in s.batches] == [7, 9]
    assert s.step_ns == 10 * ms  # [10, 16] and [16, 20]; batch 11 is no dispatch's
    assert s.step_busy_ns == 8 * ms  # less the gap [12, 14]


@pytest.fixture(scope="module")
def base():
    return spec.model(spec.config("f5tts_v1_base"))


def test_dit_flops_by_hand(base):
    # F5 v1 Base, one row of 500 frames, one evaluation.
    d, n = 1024, 500
    dense = 22 * (2 * d * 3 * d + 2 * d * d + 2 * d * 2 * d + 2 * 2 * d * d)
    edges = 2 * (200 + 512) * d + 2 * 31 * d + 2 * d * d + 2 * d * 100
    attn = 22 * (2 * n * n * d + 2 * n * n * d)
    assert flops.dit_eval_flops(base, n) == (dense + edges) * n + attn
    assert dense == pytest.approx(369e6, rel=0.01)  # 369 MFLOP a frame


def test_row_flops_counts_62_evaluations(base):
    n = 400
    expected = (62 * flops.dit_eval_flops(base, n) + 2 * flops.text_embed_flops(base, n)
                + flops.vocoder_flops(base, n))
    assert flops.row_flops(base, n) == expected


def test_attention_bound_by_hand(base):
    # Two rows of 448 valid frames at bucket 512: bytes bound it.
    rows, bucket = [448, 448], 512
    fl = sum(4 * n * n * 1024 for n in rows)
    by = sum(rows) * 4 * 1024 * 2 + 2 * bucket * 64 * 2 + 2 * bucket
    assert flops.attention_bound_s(base, rows, bucket) == pytest.approx(
        max(fl / 989e12, by / 3.35e12))
    # At 2048 valid frames the operations bound it.
    long = [2048] * 16
    assert flops.attention_bound_s(base, long, 2048) == pytest.approx(
        sum(4 * n * n * 1024 for n in long) / 989e12)
    assert flops.attention_calls_per_batch(base) == 22 * 31


def _window(model, batches, trace=None):
    return Window(model=model, start=0.0, records=[], batches=batches,
                  batcher={"batches": 4, "jobs": 10, "padded_rows": 2, "retries": 0,
                           "failures": 0},
                  stages={"chunk_dispatch": (0.012, 4)}, trace=trace)


def test_layer_readers(base):
    batches = [{"bucket": 512, "total_len": [448, 500, 200], "real": [True, True, False]}]
    win = _window(base, batches)
    assert spec.metric_reader("bucket_pad_pct")(win) == pytest.approx(
        100 * (64 + 12) / 1024)
    assert spec.metric_reader("batch_rows_mean")(win) == pytest.approx(2.5)
    assert spec.metric_reader("padded_row_pct")(win) == pytest.approx(100 * 2 / 12)
    assert spec.metric_reader("dispatch_host_ms.rest")(win) == pytest.approx(3.0)
    for name in ("attn_device_pct", "attn_roofline", "step_idle_pct", "step_mfu_pct"):
        assert spec.metric_reader(name)(win) is None  # no trace: nothing to read


def test_trace_readers(base):
    calls = flops.attention_calls_per_batch(base)
    d = {"bucket": 512, "total_len": [448, 200], "real": [True, False]}
    whole = {"dispatch": d, "attention_calls": calls, "attention_ns": 10**9,
             "first_ns": 0, "last_ns": 2 * 10**9}
    partial = {**whole, "attention_calls": calls - 1}
    from benchmark.trace import Summary

    t = Summary((0, 4 * 10**9), 3 * 10**9, [], [], 4 * 10**9, 10**9, [whole, partial],
                step_ns=2 * 10**9, step_busy_ns=15 * 10**8)
    win = _window(base, [d], t)
    assert spec.metric_reader("attn_device_pct")(win) == pytest.approx(25.0)
    assert spec.metric_reader("step_idle_pct")(win) == pytest.approx(25.0)
    bound = calls * flops.attention_bound_s(base, [448, 200, 448, 200], 512)
    assert spec.metric_reader("attn_roofline")(win) == pytest.approx(100 * bound / 1.0)
    mfu = flops.row_flops(base, 448) / (2.0 * 989e12)
    assert spec.metric_reader("step_mfu_pct")(win) == pytest.approx(100 * mfu)


def test_every_metric_has_a_reader_and_every_cell_its_files():
    from benchmark.weights import parameter_count

    b = spec.benchmark()
    for c in b["configs"]:
        cfg = spec.config(c["name"])
        assert cfg["parameters"] == parameter_count(spec.model(cfg))
    for m in b["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))
    for w in b["workloads"]:
        spec.config(w["config"])
        mix = spec.mix(w["traffic"])
        spec.generator(mix["kind"])
        assert spec.limits(w["name"])["pcm_rel_err_max"]["limit"] > 0
