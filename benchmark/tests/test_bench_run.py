"""The harness end to end on the CPU at tiny widths (the look for a card
skipped): the result line's shape, a run without a card, the modules it
may not load, the control, and faults planted in the timed path, which
the output check has to catch."""

from __future__ import annotations

import ast
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import run as runmod
from benchmark import spec

BENCH = Path(runmod.__file__).resolve().parent
REST = {"name": "f5base.rest_short", "chips": 1}
DOCS = {"name": "docs", "chips": 1}  # a long-form cell; none runs in BENCHMARK.json yet
SEED = 2**31 + 77


def _run(cell, cfg, mix, seconds, trace=False, fault=None, seed=SEED):
    # The REST cell's limits serve the long-form one too.
    result, lines = runmod.run(cell, cfg, mix, spec.limits(REST["name"]), seed, seconds, trace,
                               device="cpu", fault=fault)
    json.dumps(result, allow_nan=False)  # one valid JSON object
    return result, lines


def _shape(result, metric_names):
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) <= set(metric_names)
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}


def test_rest_cell_on_the_cpu(tiny_cfg, tiny_rest_mix):
    result, lines = _run(REST, tiny_cfg, tiny_rest_mix, 2.0)
    _shape(result, ["audio_s_per_s", "latency_p95_ms", "setup_s"])
    assert set(result["metrics"]) == {"audio_s_per_s", "latency_p95_ms", "setup_s"}
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] == 4
    assert result["checks"]["pcm_rel_err_max"]["value"] < 1e-4  # float32 both sides
    assert lines[-1].startswith("check pcm_rel_err_max")


def test_traced_rest_cell_on_the_cpu(tiny_cfg, tiny_rest_mix):
    result, _ = _run(REST, tiny_cfg, tiny_rest_mix, 3.0, trace=True)
    names = [m["name"] for m in spec.metrics_for(REST["name"], True)]
    _shape(result, names)
    # The host counters read; the device ones find no card and stay out.
    assert {"bucket_pad_pct", "batch_rows_mean", "padded_row_pct",
            "dispatch_host_ms.rest"} <= set(result["metrics"])
    assert "breakdown" in result and result["correct"] is True


def test_docs_cell_on_the_cpu(tiny_cfg, tiny_docs_mix):
    result, _ = _run(DOCS, tiny_cfg, tiny_docs_mix, 1.0)
    _shape(result, ["audio_s_per_s", "setup_s"])
    assert set(result["metrics"]) == {"audio_s_per_s", "setup_s"}
    assert result["correct"] is True and result["attempted"] == 2


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert runmod.main(["--workload", "f5base.rest_short", "--seed", "1", "--seconds", "1",
                        "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


FORBIDDEN = ("jax", "jaxlib", "flax", "vietvoice_tts_tpu")


def forbidden(module: str) -> bool:
    """Whether an imported module's top-level name is one that may not load."""
    return module.split(".")[0] in FORBIDDEN


def test_forbidden_names_compare_whole():
    assert forbidden("jax.numpy") and forbidden("vietvoice_tts_tpu.models.dit")
    assert not forbidden("vietvoice_tts_tpu_torch.client")
    assert not forbidden("jaxtyping") and not forbidden("flaxen")


def test_no_module_imports_jax_or_the_jax_package():
    found = []
    for path in sorted(BENCH.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                names = [node.module]
            found += [(path.name, n) for n in names if forbidden(n)]
    assert found == []


def test_the_harness_sees_a_forbidden_module(monkeypatch):
    import sys
    import types

    assert runmod.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "flax", types.ModuleType("flax"))
    assert runmod.forbidden_loaded() == ["flax"]


@pytest.mark.parametrize("cell", ["f5base.rest_short"])
def test_the_control_fails_the_check(tiny_cfg, cell):
    """The reference in fp8 (the precision below the configuration's
    bfloat16) against itself in float32, on a cell's requests at tiny
    widths: above the cell's limit; bfloat16 rounding stays under it."""
    from benchmark import pack
    from benchmark.reference import check
    from benchmark.traffic import open_loop_rest
    from benchmark.weights import make_weights

    limit = spec.limits(cell)["pcm_rel_err_max"]["limit"]
    model = spec.model(tiny_cfg)
    for seed in (1, 2, 3):
        voices = pack.voices(seed, 24000)
        reqs = open_loop_rest.requests(spec.mix("rest_short_open"), model, voices, seed, 1.0)
        w = make_weights(model, seed, "cpu")
        r = reqs[0]
        args = (r["text"], voices[r["voice"]], model, w, "cpu")
        ref = check.expected_pcm(*args)
        assert check.relative_error(check.expected_pcm(*args, precision="fp8"), ref) > limit
        assert check.relative_error(check.expected_pcm(*args, precision="bfloat16"), ref) < limit


def test_the_control_tool_fails_the_check(tiny_cfg, tiny_rest_mix):
    """``tools.control``'s readings, on the CPU at tiny widths: the fp8
    reference above the cell's limit on every sampled request's seed, the
    bfloat16 one under it."""
    from benchmark.tools import control

    limit = spec.limits("f5base.rest_short")["pcm_rel_err_max"]["limit"]
    out = control.readings(spec.model(tiny_cfg), tiny_rest_mix, SEED, 1.0,
                           ["fp8", "bfloat16"], "cpu")
    assert out["requests"] == 2
    assert out["fp8"]["max"] > limit and out["bfloat16"]["max"] < limit


def _state_unchanged(api):
    """The solve returns its initial noise: no step moves the state."""
    import vietvoice_tts_tpu_torch.runtime.engine_core as ec

    ec.flow_matching_sample = lambda dit, cfg, cond, ids, mask, seeds, x0=None: x0


def _answer_altered(api):
    """Every row's PCM scaled by 0.95 where the core produces it."""
    core = api.engine.engine_core
    finish = core._finish_waveform

    def altered(*a):
        return (finish(*a).float() * 0.95).to(torch.int16)

    core._finish_waveform = altered


def _half_the_batch(api):
    """Only the first half of a batch's rows computed; the rest answered
    with the first row's audio."""
    core = api.engine.engine_core
    inner = core.synthesize_batch_async

    def half(wave, ref_len, text_ids, total_len, seed=0):
        b = wave.shape[0]
        keep = max(1, b // 2)
        fetch = inner(wave[:keep], ref_len[:keep], text_ids[:keep], total_len[:keep],
                      seed=np.asarray(seed)[:keep] if np.ndim(seed) else seed)

        def get():
            out = fetch()
            return np.concatenate([out, np.repeat(out[:1], b - keep, axis=0)])
        return get

    core.synthesize_batch_async = half


@pytest.mark.parametrize("fault", [_state_unchanged, _answer_altered, _half_the_batch])
def test_a_planted_fault_is_not_correct(tiny_cfg, tiny_docs_mix, monkeypatch, fault):
    import vietvoice_tts_tpu_torch.runtime.engine_core as ec

    monkeypatch.setattr(ec, "flow_matching_sample", ec.flow_matching_sample)
    result, _ = _run(DOCS, tiny_cfg, tiny_docs_mix, 1.0, fault=fault)
    assert result["correct"] is False
    assert result["failed"] == 0  # every answer came: they are wrong


def _served_by_the_control(model, seed):
    """A fault: the REST app's engine answers every request with the plain
    reference computed in fp8 (the control), from the weights and voices
    that the run makes from ``seed``, in place of the program's PCM."""
    import io
    import wave

    from benchmark import pack
    from benchmark.reference import check
    from benchmark.weights import make_weights

    sr = model["audio"]["sample_rate"]
    voices = {(v["gender"], v["group"], v["area"], v["emotion"]): v
              for v in pack.voices(seed, sr)}
    weights = make_weights(model, seed, "cpu")

    def fault(api):
        def control(text, gender=None, group=None, area=None, emotion=None, **_):
            pcm = check.expected_pcm(text, voices[(gender, group, area, emotion)], model,
                                     weights, "cpu", precision="fp8")
            buf = io.BytesIO()
            with wave.open(buf, "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(sr)
                w.writeframes(pcm.astype("<i2").tobytes())
            return buf.getvalue(), 0.0

        api.synthesize_to_bytes = control

    return fault


@pytest.mark.parametrize("seed", [SEED, SEED + 1])
def test_the_control_served_is_not_correct(tiny_cfg, tiny_rest_mix, seed):
    """The control in the program's place, through the whole run and its
    REST path: every answer comes, in the right length, and the check
    reads ``correct`` false."""
    model = spec.model(tiny_cfg)
    result, _ = _run(REST, tiny_cfg, tiny_rest_mix, 2.0, seed=seed,
                     fault=_served_by_the_control(model, seed))
    checks = result["checks"]
    assert result["failed"] == 0 and checks["pcm_length_mismatches"]["value"] == 0
    assert checks["pcm_rel_err_max"]["value"] > checks["pcm_rel_err_max"]["limit"]
    assert result["correct"] is False
