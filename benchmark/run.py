"""Run one cell of the benchmark once.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``) names a configuration and a traffic mix. The
run makes the weights and the voice clips from the seed, writes them as a
weight pack under ``$TMPDIR``, loads the program (``vietvoice_tts_tpu_torch``)
from it with micro-batching on, warms every (batch, bucket) shape the
traffic reaches, then offers the traffic for ``--seconds``. ``setup_s`` is
the wall time from the process's start to the window's opening.

After the window it frees the program and compares a sample of the served
waveforms, drawn from the seed, with the plain float32 reference
(``benchmark/reference``) run on the same weights. The last line of
standard output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones, read from a profiled span of the window), ``device``,
``breakdown`` with ``--trace 1``, and ``checks`` last: each number compared
with its limit. The checks are also the last lines of standard error.

It needs a CUDA card (``torch.cuda.is_available()``) and as many as the
cell asks for; without them, and without the program beside it, it exits
with a code other than 0 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "vietvoice_tts_tpu")
LATENCY_OF_FAILED_MS = 1e9  # a failed request lies above every limit


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


class Recorder:
    """Wraps ``EngineCore.synthesize_batch_async`` to record every dispatched
    batch: its wall time, bucket, each row's valid frames and whether the
    row is a request's (a padding row has no text)."""

    def __init__(self, core):
        self.inner = core.synthesize_batch_async
        self.items: list = []
        self.on = False
        core.synthesize_batch_async = self

    def __call__(self, wave, ref_len, text_ids, total_len, seed=0):
        t_begin = time.time_ns()
        fetch = self.inner(wave, ref_len, text_ids, total_len, seed=seed)
        if self.on:
            self.items.append({
                "t_begin_ns": t_begin, "t_end_ns": time.time_ns(),
                "bucket": int(text_ids.shape[1]),
                "total_len": [int(x) for x in total_len],
                "real": [bool(r) for r in (text_ids >= 0).any(axis=1)],
            })
        return fetch


class Profiler:
    """``torch.profiler`` over a span of the window: started on the
    traffic's own thread when the span opens, its end marked when the span
    closes, and stopped once the window's work is done, so that the stop
    never meets work in flight. The events are reduced in memory, clipped
    to the span (``benchmark/trace.py``)."""

    def __init__(self, device: str):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device != "cpu" else [])
        self.prof = profile(activities=acts)
        self.span_ns = [None, None]

    def start(self) -> None:
        self.prof.start()
        self.span_ns[0] = time.time_ns()

    def mark_end(self) -> None:
        if self.span_ns[0] is not None:
            self.span_ns[1] = time.time_ns()

    def summary(self, dispatches):
        """Stop the profiler (after the window) and reduce its span."""
        from .trace import summarize

        if self.span_ns[0] is None:
            return None
        t = time.perf_counter()
        self.prof.stop()
        span = (self.span_ns[0], self.span_ns[1] or time.time_ns())
        out = summarize(self.prof, dispatches, span=span)
        log(f"trace: stopped and reduced in {time.perf_counter() - t:.2f} s; busy "
            f"{out.busy_s:.3f} s of {out.window_s:.3f} s, {len(out.batches)} whole batches")
        return out


@dataclass
class Window:
    """What the per-layer metrics' readers read (``metrics/<name>.py``)."""

    model: dict
    start: float
    records: list
    batches: list  # the recorder's items over the window (up to a trace)
    batcher: dict  # BatcherStats' counts over the window (up to a trace)
    stages: dict  # EngineCore.timer over the window (up to a trace): {stage: (s, count)}
    trace: object = None  # trace.Summary of the traced span, or None


def _stats(batcher) -> dict:
    s = batcher.stats
    return {"batches": s.batches, "jobs": s.jobs, "padded_rows": s.padded_rows,
            "retries": s.retries, "failures": s.failures}


def _tree_to(tree, device):
    import torch

    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return torch.as_tensor(tree).to(device)


def load_program(cfg: dict, mix: dict, model: dict, seed: int, weights_np: dict, voices: list,
                 buckets, tmp: Path, device: str):
    """Write the pack under ``tmp``, load the program from it with the mix's
    micro-batcher, and warm every (batch, bucket) shape the traffic
    reaches → the loaded ``TTSApi``."""
    from vietvoice_tts_tpu_torch import ModelConfig, TTSApi
    from vietvoice_tts_tpu_torch.config import batch_grid

    from . import pack

    t0 = time.perf_counter()
    pack.write_pack(tmp / "pack", weights_np, model, seed, voices)
    t1 = time.perf_counter()
    settings = {**cfg["model_config"], "frame_buckets": tuple(cfg["model_config"]["frame_buckets"])}
    api = TTSApi(ModelConfig(**settings, model_cache_dir=str(tmp), model_name="pack",
                             device=device, allow_synthetic_pack=True))
    engine = api.engine
    engine.enable_micro_batching(max_batch=mix["max_batch"], max_wait_ms=mix["max_wait_ms"])
    t2 = time.perf_counter()
    batches = batch_grid(mix["max_batch"])
    engine.engine_core.warmup(batches=batches, buckets=buckets, fallback_batches=())
    log(f"set-up: pack written in {t1 - t0:.1f} s, program loaded in {t2 - t1:.1f} s, "
        f"{len(batches) * len(buckets)} shapes (batches {list(batches)}, buckets "
        f"{list(buckets)}) warmed in {time.perf_counter() - t2:.1f} s")
    return api


def run(cell: dict, cfg: dict, mix: dict, limits: dict, seed: int, seconds: float,
        trace: bool, device: str = "cuda", fault=None) -> tuple[dict, list]:
    """One run of a cell → (result, check lines). ``device="cpu"`` serves
    the CPU tests; ``fault`` (a callable taking the loaded ``TTSApi``)
    breaks the program under test for them."""
    import torch

    from . import pack, spec
    from .reference import check
    from .traffic import common
    from .weights import make_weights

    model = spec.model(cfg)
    gen = spec.generator(mix["kind"])
    voices = pack.voices(seed, model["audio"]["sample_rate"])
    reqs = gen.requests(mix, model, voices, seed, seconds)
    lengths = {r["i"]: len(r["text"]) for r in reqs}

    t0 = time.perf_counter()
    weights = make_weights(model, seed, device)
    weights_np = pack.to_numpy(weights)
    del weights
    log(f"set-up: process start to weights {t0 - T_START:.1f} s, weights made in "
        f"{time.perf_counter() - t0:.1f} s")
    tmp = Path(tempfile.mkdtemp(prefix="vv-bench-"))
    api = None
    try:
        api = load_program(cfg, mix, model, seed, weights_np, voices,
                           common.buckets(reqs, voices, model), tmp, device)
        engine = api.engine
        batcher, core = engine.batcher, engine.engine_core
        if fault is not None:
            fault(api)
        recorder = Recorder(core)
        if device != "cpu":
            torch.cuda.synchronize()

        def counters() -> dict:
            return {"batcher": _stats(batcher), "batches": len(recorder.items),
                    "stages": {k: (core.timer.totals[k], core.timer.counts[k])
                               for k in core.timer.totals}}

        # With a trace, the host's counters cover the window up to the traced
        # span: profiling slows every launch from its start on (CUPTI stays
        # attached even after a stop).
        profiler = Profiler(device) if trace else None
        events, taken = [], {}
        if profiler is not None:
            span = mix["trace"]

            def begin_trace():
                taken.update(counters())
                profiler.start()

            events = [(span["start_s"], begin_trace),
                      (span["start_s"] + span["seconds"], profiler.mark_end)]
        base = _stats(batcher)
        core.timer.reset()
        recorder.on = True
        setup_s = time.perf_counter() - T_START
        out = gen.drive(reqs, mix, model, voices, api, events=events, seconds=seconds)
        log(f"window: closed after {time.perf_counter() - out['start']:.1f} s")
        recorder.on = False
        if device != "cpu":
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
        summary = profiler.summary(recorder.items) if profiler is not None else None
        end = taken or counters()
        win = Window(model=model, start=out["start"], records=out["records"],
                     batches=recorder.items[: end["batches"]],
                     batcher={k: end["batcher"][k] - base[k] for k in base},
                     stages=end["stages"], trace=summary)
    finally:
        if api is not None:
            api.cleanup()
        api = engine = batcher = core = recorder = None
        gc.collect()
        if device != "cpu":
            torch.cuda.empty_cache()
        shutil.rmtree(tmp, ignore_errors=True)

    records = win.records
    sr = model["audio"]["sample_rate"]
    ok = [r for r in records if r.get("ok")]
    failed = len(records) - len(ok)
    lat = [(r["end"] - r["due"]) * 1e3 if r.get("ok") else math.inf for r in records]
    late = [(r["sent"] - r["due"]) * 1e3 for r in records if "sent" in r]
    ok_lat = [x for x in lat if math.isfinite(x)]
    log(f"window: {len(records)} requests, {failed} failed; latency p50 "
        f"{common.percentile(ok_lat, 50):.1f} ms, p95 {common.percentile(lat, 95):.1f} ms "
        f"(over all {len(lat)}); generator lateness p95 {common.percentile(late, 95):.2f} ms, "
        f"max {max(late, default=0.0):.2f} ms; batches {win.batcher['batches']}, "
        f"jobs {win.batcher['jobs']}, padded rows {win.batcher['padded_rows']}")

    # The output check, on the reference, after the program is gone.
    picked = check.sample(records, lengths, mix["check"]["sample"], seed)
    by_i = {r["i"]: r for r in records}
    req_by_i = {r["i"]: r for r in reqs}
    t_check = time.perf_counter()
    dev_weights = _tree_to(weights_np, device)
    errors, mismatches = [], 0
    for i in picked:
        expected = check.expected_pcm(req_by_i[i]["text"], voices[req_by_i[i]["voice"]],
                                      model, dev_weights, device)
        served = by_i[i]["pcm"]
        mismatches += int(served.shape != expected.shape)
        errors.append(check.relative_error(served, expected))
    del dev_weights
    log(f"check: {len(picked)} requests compared ({sum(lengths[i] for i in picked)} "
        f"characters, {sum(len(by_i[i]['pcm']) for i in picked) / sr:.1f} s of audio) "
        f"in {time.perf_counter() - t_check:.1f} s; relative errors "
        + ", ".join(f"{e:.4g}" for e in errors))
    lim = limits["pcm_rel_err_max"]["limit"]
    checks = {
        "failed_requests": {"value": failed, "limit": 0},
        "compared_requests": {"value": len(picked), "limit": 1},
        "pcm_length_mismatches": {"value": mismatches, "limit": 0},
        "pcm_rel_err_max": {"value": max(errors) if errors else None, "limit": lim},
    }
    correct = (failed == 0 and len(picked) >= 1 and mismatches == 0
               and max(errors, default=math.inf) <= lim)

    specs = spec.metrics_for(cell["name"], trace)
    metrics = {}
    if not trace:
        values = {"setup_s": setup_s, **end_to_end(records, win.start, sr)}
        for m in specs:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for m in specs:
            value = spec.metric_reader(m["name"])(win)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
           "count": cell.get("chips", 1), "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(records), "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and win.trace is not None:
        dev["busy_s"] = win.trace.busy_s
        dev["window_s"] = win.trace.window_s
        result["breakdown"] = {"device_ops": [list(x) for x in win.trace.device_ops],
                               "idle_gaps": [list(x) for x in win.trace.idle_gaps]}
    result["checks"] = checks
    lines = [f"check {k}: {v['value']} (limit {v['limit']})" for k, v in checks.items()]
    return result, lines


def end_to_end(records: list, start: float, sample_rate: int) -> dict:
    """The window's end-to-end numbers from its requests' records (``due``,
    ``end``, ``ok``, ``pcm``): seconds of audio delivered over the span from
    the window's start to its last completion, and the 95th percentile of
    every request's time from due to its whole response, a failed one
    counting above every limit."""
    from .traffic import common

    ok = [r for r in records if r.get("ok")]
    span = max((r["end"] for r in ok), default=start) - start
    lat = [(r["end"] - r["due"]) * 1e3 if r.get("ok") else math.inf for r in records]
    return {
        "audio_s_per_s": sum(len(r["pcm"]) for r in ok) / sample_rate / span if span > 0 else 0.0,
        "latency_p95_ms": min(common.percentile(lat, 95), LATENCY_OF_FAILED_MS),
    }


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # Every build and kernel cache of the program inside this checkout.
    build = ROOT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("VIETVOICE_LOG_LEVEL", "WARNING")

    from . import spec

    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        log("no CUDA card: torch.cuda.is_available() is False")
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        log(f"the cell asks for {cell['chips']} cards, {torch.cuda.device_count()} present")
        return 2
    import vietvoice_tts_tpu_torch  # noqa: F401 — the program must be beside the benchmark

    log(f"card: {card_line()}")
    result, lines = run(cell, spec.config(cell["config"]), spec.mix(cell["traffic"]),
                        spec.limits(cell["name"]), args.seed & ((1 << 64) - 1),
                        args.seconds, bool(args.trace))
    bad = forbidden_loaded()
    if bad:
        log(f"modules that must not load were loaded: {', '.join(bad)}")
        return 3
    log(f"card: {card_line()}")
    for line in lines:
        log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
