"""The PyTorch port's bench harness (``vietvoice_tts_tpu_torch/bench.py``)
against the repo-root ``bench.py`` (CPU, float32, tiny widths, no kernels).

Both harnesses run on one pack (``tiny_pack_dir``), each through its own
package. Held equal:

- the text constants and the helpers' arithmetic;
- each config's record: the same keys, and the fields that do not depend on
  a clock (``audio_s``, ``chunks``, ``pieces``, ``batch``, ``frames``,
  ``audio_s_per_batch``; a sweep point's ``requests``, ``concurrency`` and
  ``max_batch``), at the smallest sizes the functions take where the root
  harness's fixed sizes would be slow here;
- the REST sweep's settings (points, open-loop rates, warm-up grid);
- ``main``'s compact line: the root harness's keys (its source and
  ``BENCH_r05.json``), under 1400 characters, its full record where
  ``--full-out`` says and never at the root's ``BENCH_full.json``.

And the port's one arithmetic change: a sweep point's ``rtf`` counts the n
timed requests' audio, where the root harness counts n + 1.
"""

import ast
import inspect
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import importlib

import numpy as np
import pytest
import torch

import bench as jax_bench
from conftest import tiny_config
from test_torch_slice import port_config

import vietvoice_tts_tpu_torch as vt
from vietvoice_tts_tpu.client import TTSApi as JaxApi
from vietvoice_tts_tpu_torch import bench as tbench

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "msgpack", "vietvoice_tts_tpu", "bench"}


@pytest.fixture(scope="module")
def apis(tiny_pack_dir):
    """(JAX TTSApi, port TTSApi) on the shared tiny pack, engines loaded."""
    jax_api = JaxApi(tiny_config(model_cache_dir=tiny_pack_dir))
    port_api = vt.TTSApi(port_config(model_cache_dir=tiny_pack_dir))
    jax_api.engine, port_api.engine  # noqa: B018 — load both packs
    yield jax_api, port_api
    jax_api.cleanup()
    port_api.cleanup()


def _same_keys(jax_rec: dict, port_rec: dict) -> None:
    assert list(port_rec) == list(jax_rec)


# -- Constants and helpers ----------------------------------------------------------


@pytest.mark.parametrize("name", ["SHORT_TEXT", "LONG_TEXT", "RTT_SLOW_MS", "AGREEMENT_PCT"])
def test_constants_equal_the_root_harness(name):
    assert getattr(tbench, name) == getattr(jax_bench, name)


def test_sweep_text_is_the_root_harness_request():
    """The root harness writes its sweep text inline, twice, and once more
    for the warm-up bucket."""
    source = inspect.getsource(jax_bench)
    assert source.count(tbench.SWEEP_TEXT.replace("{}", "{i}")) == 2
    assert tbench.SWEEP_TEXT.format(1) in inspect.getsource(jax_bench.bench_rest_serving)


@pytest.mark.parametrize("n", [1, 2, 5, 13])
def test_p50_p90_equal_the_root_harness(n):
    lat = list(np.random.default_rng(n).uniform(0.01, 0.5, n))
    assert tbench._p50_p90_ms(lat) == jax_bench._p50_p90_ms(lat)


def test_timed_calls_and_result_equal_the_root_harness():
    for mod in (jax_bench, tbench):
        calls = []
        p50, last = mod._timed(lambda: calls.append(1) or len(calls), reps=5, warm=2)
        assert (len(calls), last) == (7, 7) and p50 >= 0.0


def test_timed_records_each_sample_and_spread():
    times = []
    tbench._timed(lambda: None, reps=4, warm=1, times=times)
    assert len(times) == 4
    spread = tbench._spread_ms([0.3, 0.1, 0.2])
    assert spread == {"reps": 3, "min_ms": 100.0, "p50_ms": 200.0, "max_ms": 300.0}


def test_link_probe_returns_the_root_harness_keys():
    link = tbench.measure_link_rtt("cpu", reps=3)
    assert list(link) == ["rtt_p50_ms", "rtt_p90_ms"]
    assert 0.0 <= link["rtt_p50_ms"] <= link["rtt_p90_ms"]


# -- Config records, against the root harness --------------------------------------


def test_short_sentence_record(apis):
    jax_api, port_api = apis
    sr = port_api.config.sample_rate
    spread = {}
    jax_rec = jax_bench.bench_short_sentence(jax_api.engine, sr)
    port_rec = tbench.bench_short_sentence(port_api.engine, sr, spread)
    _same_keys(jax_rec, port_rec)
    assert port_rec["audio_s"] == jax_rec["audio_s"] > 0
    assert spread["short_sentence"]["reps"] == 13


def test_voice_clone_record(apis, tmp_path):
    jax_api, port_api = apis
    sr = port_api.config.sample_rate
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jax_rec = jax_bench.bench_voice_clone(jax_api.engine, sr, str(tmp_path / "jax"))
    port_rec = tbench.bench_voice_clone(port_api.engine, sr, str(tmp_path / "port"))
    _same_keys(jax_rec, port_rec)
    assert port_rec["audio_s"] == jax_rec["audio_s"] > 0
    assert (tmp_path / "port" / "clone_ref.wav").read_bytes() == (
        tmp_path / "jax" / "clone_ref.wav").read_bytes()


def test_long_text_record(apis):
    jax_api, port_api = apis
    sr = port_api.config.sample_rate
    jax_rec = jax_bench.bench_long_text(jax_api.engine, sr)
    port_rec = tbench.bench_long_text(port_api.engine, sr)
    _same_keys(jax_rec, port_rec)
    assert (port_rec["chunks"], port_rec["audio_s"]) == (jax_rec["chunks"], jax_rec["audio_s"])
    assert port_rec["chunks"] >= 2


def test_streaming_record(apis):
    jax_api, port_api = apis
    sr = port_api.config.sample_rate
    jax_rec = jax_bench.bench_streaming(jax_api.engine, sr)
    port_rec = tbench.bench_streaming(port_api.engine, sr)
    _same_keys(jax_rec, port_rec)
    assert (port_rec["pieces"], port_rec["audio_s"]) == (jax_rec["pieces"], jax_rec["audio_s"])
    assert port_rec["pieces"] >= 2


@pytest.mark.parametrize("batch, n_frames, ref_frames", [(2, 128, 32), (3, 256, 60)])
def test_batched_record(apis, batch, n_frames, ref_frames):
    jax_api, port_api = apis
    hop, sr = port_api.config.hop_length, port_api.config.sample_rate
    args = dict(batch=batch, n_frames=n_frames, ref_frames=ref_frames, label="test")
    jax_rec = jax_bench.bench_batched(jax_api.engine.engine_core, hop, sr, **args)
    port_rec = tbench.bench_batched(port_api.engine.engine_core, hop, sr, **args)
    _same_keys(jax_rec, port_rec)
    for key in ("batch", "frames", "audio_s_per_batch"):
        assert port_rec[key] == jax_rec[key]


# (request, first-chunk cap, buckets the default bucket list plans it to): the
# bench's requests; the 3 s clone lands in 704, not the 544 the root
# harness's comment names (its warm-up keeps 544).
PLANS = [
    ("short", None, [440]),
    ("clone", None, [704]),
    ("long", None, [2048, 2048]),
    ("long", 4.0, [640, 2048, 2048]),
    ("sweep", None, [384]),
]


@pytest.mark.parametrize("request_name, cap, buckets", PLANS)
def test_requests_plan_to_the_root_harness_buckets(apis, monkeypatch, tmp_path, request_name,
                                                   cap, buckets):
    """At ``ModelConfig``'s frame buckets, both packages plan each of the
    bench's requests to the same buckets: the kernel-1 shapes
    ``chip_smoke.py`` holds for the bench."""
    from vietvoice_tts_tpu.utils.wavio import write_wav

    default = vt.ModelConfig.__dataclass_fields__["frame_buckets"].default
    sr = 24000
    clip = tmp_path / "clone_ref.wav"
    t = np.arange(3 * sr) / sr
    write_wav((0.4 * np.sin(2 * np.pi * 180 * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t)))
              .astype(np.float32), str(clip), sr)
    got = []
    for api in apis:
        engine = api.engine
        monkeypatch.setattr(engine.config, "frame_buckets", default)
        if request_name == "clone":
            ref_audio, ref_text = str(clip), "Đây là giọng nói tham khảo do người dùng cung cấp."
        else:
            ref_audio, ref_text = engine.model_session_manager.select_sample()
        ref = engine.audio_processor.load_audio(ref_audio, sr).astype(np.float32) / 32768.0
        text = {"short": tbench.SHORT_TEXT, "clone": tbench.SHORT_TEXT, "long": tbench.LONG_TEXT,
                "sweep": tbench.SWEEP_TEXT.format(1)}[request_name]
        speed = 0.9 if request_name == "sweep" else None
        plans = engine._plan_chunks(ref, ref_text, text, speed=speed, first_chunk_cap=cap)
        got.append([p.bucket for p in plans])
    assert got[0] == got[1] == buckets


def test_batched_inputs_are_the_root_harness_batch(apis, monkeypatch):
    """The batch the port dispatches is the root harness's, bit for bit."""
    jax_api, port_api = apis
    hop, sr = port_api.config.hop_length, port_api.config.sample_rate
    seen = {}

    def spy(name, real):
        def call(wave, ref_len, text_ids, total_len, **kw):
            seen.setdefault(name, (wave, ref_len, text_ids, total_len))
            return real(wave, ref_len, text_ids, total_len, **kw)
        return call

    for name, core in (("jax", jax_api.engine.engine_core), ("port", port_api.engine.engine_core)):
        monkeypatch.setattr(core, "synthesize_batch", spy(name, core.synthesize_batch))
    jax_bench.bench_batched(jax_api.engine.engine_core, hop, sr, 2, 128, 32, "test")
    tbench.bench_batched(port_api.engine.engine_core, hop, sr, 2, 128, 32, "test")
    for a, b in zip(seen["jax"], seen["port"]):
        np.testing.assert_array_equal(a, b)


def test_latency_breakdown_record(apis):
    jax_api, port_api = apis
    hop = port_api.config.hop_length
    spread = {}
    jax_rec = jax_bench.bench_latency_breakdown(jax_api.engine.engine_core, hop, n_frames=256)
    port_rec = tbench.bench_latency_breakdown(port_api.engine.engine_core, hop,
                                              n_frames=256, spread=spread)
    _same_keys(jax_rec, port_rec)
    assert port_rec["frames"] == jax_rec["frames"] == 256
    assert port_rec["compute_ms"] > 0 and port_rec["h2d_ms"] >= 0
    assert sorted(spread) == [f"latency_breakdown_{leg}" for leg in
                              ("compute", "cond_cached_full", "d2h", "full")]


def test_latency_breakdown_legs_are_the_engine_route(apis):
    """The breakdown's route is ``EngineCore``'s: every PCM it makes equals
    ``synthesize_batch`` with the conditioning cache off."""
    _, port_api = apis
    core = port_api.engine.engine_core
    hop, n = core.config.hop_length, 256
    rng = np.random.default_rng(0)
    wave = rng.uniform(-0.5, 0.5, (1, n * hop)).astype(np.float32)
    ids = np.full((1, n), -1, np.int32)
    ids[:, :100] = 7
    core.config.voice_cond_cache = False
    try:
        want = core.synthesize_batch(wave, np.array([188]), ids, np.array([n]))
    finally:
        core.config.voice_cond_cache = True
    got = []
    real = core._finish_waveform

    def keep(*a):
        got.append(real(*a))
        return got[-1]

    core._finish_waveform = keep
    try:
        tbench.bench_latency_breakdown(core, hop, n_frames=n)
    finally:
        del core._finish_waveform
    # 1 warm + 6 full + 6 compute + 6 d2h runs, then 7 cached calls, whose
    # route is array-equal to the waveform route here (f32 on the CPU).
    assert len(got) == 26
    for pcm in got:
        np.testing.assert_array_equal(pcm.numpy(), want)


# -- The REST sweep -------------------------------------------------------------------


@pytest.fixture
def rest(apis):
    """Each package's app routed to its tiny engine, with an in-process client."""
    from vietvoice_tts_tpu.api import tts_engine as jte
    from vietvoice_tts_tpu.api.testing import AsyncTestClient as JaxClient
    from vietvoice_tts_tpu_torch.api import tts_engine as tte
    from vietvoice_tts_tpu_torch.api.testing import AsyncTestClient

    jax_api, port_api = apis
    jte._engine, tte._engine = jax_api, port_api
    try:
        yield ((jax_api, JaxClient(importlib.import_module("vietvoice_tts_tpu.api.app").app)),
               (port_api, AsyncTestClient(
                   importlib.import_module("vietvoice_tts_tpu_torch.api.app").app)))
    finally:
        jte._engine = tte._engine = None


@pytest.mark.parametrize("concurrency, cap", [(2, None), (3, 2)])
def test_rest_sweep_point_record(rest, concurrency, cap):
    (jax_api, jax_client), (port_api, port_client) = rest
    jax_rec = jax_bench._rest_sweep_point(jax_api, jax_client, 3, concurrency, 10.0, max_batch=cap)
    port_rec = tbench._rest_sweep_point(port_api, port_client, 3, concurrency, 10.0,
                                        max_batch=cap)
    _same_keys(jax_rec, port_rec)
    for key in ("requests", "concurrency", "max_wait_ms", "max_batch"):
        assert port_rec[key] == jax_rec[key]
    assert port_rec["mean_batch_size"] >= 1 and port_rec["rtf"] > 0
    assert port_api.engine.batcher is None


def test_rest_open_loop_point_record(rest):
    (jax_api, jax_client), (port_api, port_client) = rest
    jax_rec = jax_bench._rest_open_loop_point(jax_api, jax_client, 3, 20.0, max_batch=2)
    port_rec = tbench._rest_open_loop_point(port_api, port_client, 3, 20.0, max_batch=2)
    _same_keys(jax_rec, port_rec)
    for key in ("mode", "offered_rps", "requests"):
        assert port_rec[key] == jax_rec[key]
    assert port_api.engine.batcher is None


def test_rest_serving_runs_the_root_harness_sweep(apis, monkeypatch):
    """``bench_rest_serving``: the same points, open-loop rates and warm-up
    grid and bucket as the root harness, and a record of its keys (the
    points themselves are stubbed: their records are held above)."""
    jax_api, port_api = apis
    calls = {"jax": [], "port": []}

    def recorders(name, engine):
        def sweep(api, client, n, c, wait, max_batch=None):
            calls[name].append(("sweep", n, c, wait, max_batch))
            return {"rtf": float(c), "requests": n}

        def open_loop(api, client, n, rate, max_wait_ms=10.0, max_batch=None):
            calls[name].append(("open", n, rate, max_wait_ms, max_batch))
            return {"mode": "open_loop"}

        def warmup(batches=None, buckets=None, **kw):
            calls[name].append(("warmup", tuple(batches), tuple(buckets)))

        monkeypatch.setattr(engine, "warmup", warmup)
        return sweep, open_loop

    for name, mod, api in (("jax", jax_bench, jax_api), ("port", tbench, port_api)):
        sweep, open_loop = recorders(name, api.engine)
        monkeypatch.setattr(mod, "_rest_sweep_point", sweep)
        monkeypatch.setattr(mod, "_rest_open_loop_point", open_loop)
    jax_rec = jax_bench.bench_rest_serving(jax_api, n_requests=5)
    port_rec = tbench.bench_rest_serving(port_api, n_requests=5)
    assert calls["port"] == calls["jax"]
    assert len([c for c in calls["port"] if c[0] == "sweep"]) == 5
    assert port_rec == jax_rec
    from vietvoice_tts_tpu_torch.api import tts_engine as tte

    assert tte._engine is None


class _Clock:
    """A host clock that moves one second per request and stands still
    otherwise: a point's wall is exactly its number of timed requests."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now


def _one_second_client(clock, sr):
    class Client:
        async def post(self, path, json=None):
            clock.now += 1.0
            return SimpleNamespace(status_code=200, content=bytes(44 + 2 * sr))

    return Client()


def _stub_api(sr):
    engine = SimpleNamespace(batcher=None)

    def enable(max_batch=None, max_wait_ms=5.0):
        engine.batcher = SimpleNamespace(stats=SimpleNamespace(mean_batch_size=1.0),
                                         shutdown=lambda: None)

    engine.enable_micro_batching = enable
    return SimpleNamespace(engine=engine, config=SimpleNamespace(sample_rate=sr, max_batch_size=4))


@pytest.mark.parametrize("n", [2, 4, 10])
def test_rest_sweep_rtf_counts_only_the_timed_requests(monkeypatch, n):
    """Every response holds one second of audio and takes one second: the
    port's ``rtf`` is 1; the root harness's counts the warm-up request's
    audio too, (n + 1) / n."""
    sr = 100
    rtf = {}
    for name, mod in (("jax", jax_bench), ("port", tbench)):
        clock = _Clock()
        monkeypatch.setattr(mod, "time", SimpleNamespace(perf_counter=clock.perf_counter))
        point = mod._rest_sweep_point(_stub_api(sr), _one_second_client(clock, sr), n, 2, 10.0)
        assert point["requests_per_s"] == 1.0
        rtf[name] = point["rtf"]
    assert rtf["port"] == 1.0
    assert rtf["jax"] == round((n + 1) / n, 2)


def test_rest_sweep_point_raises_on_a_failed_request(monkeypatch):
    class Failing:
        async def post(self, path, json=None):
            return SimpleNamespace(status_code=500, content=b"")

    with pytest.raises(RuntimeError, match="500"):
        tbench._rest_sweep_point(_stub_api(100), Failing(), 2, 2, 10.0)


# -- main ----------------------------------------------------------------------------


def _root_compact_keys() -> list:
    """The keys of the ``compact`` dict literal in the root harness's main."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "compact" for t in node.targets)):
            return [k.value for k in node.value.keys]
    raise AssertionError("no compact dict in bench.py")


def test_compact_keys_are_the_root_harness_keys():
    recorded = json.loads((ROOT / "BENCH_r05.json").read_text())["parsed"]
    assert list(tbench.COMPACT_KEYS) == _root_compact_keys() == list(recorded)


def test_main_prints_the_compact_line_and_writes_the_full_record(tmp_path, capsys):
    """At the root harness's sizes (batch 64 × 512 and the rest), on a pack
    one layer deep and one Euler step long: the sizes cost the time here."""
    tpu_record = (ROOT / "BENCH_full.json").read_bytes()
    full_out = tmp_path / "out" / "BENCH_full.json"
    config = port_config(model_cache_dir=str(tmp_path / "pack"), dit_depth=1, nfe_step=2,
                         vocoder_num_layers=1)
    rc = tbench.main(["--skip-rest", "--full-out", str(full_out)], config=config)
    assert rc == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and len(lines[0]) <= 1400
    compact = json.loads(lines[0])
    assert list(compact) == list(tbench.COMPACT_KEYS)
    assert compact["backend"] == "cpu" and compact["value"] > 0
    assert compact["detail"] == "BENCH_full.json"
    assert set(compact["rtf"]) == {"batch32", "short_sentence", "voice_clone", "long_text",
                                   "streaming", "batch32_rerun"}
    full = json.loads(full_out.read_text())
    assert full["value"] == compact["value"]
    assert {"batch8", "batch64", "configs", "link", "spread_ms", "launches"} <= set(full)
    assert full["configs"]["batch32"]["batch"] == 32
    assert full["batch64"]["batch"] == 64
    assert full["spread_ms"]["short_sentence"]["reps"] == 13
    assert full["launches"] == {"fused_qkv_rope_attention": 0, "flash_attention": 0,
                                "adaln_norm": 0}
    assert (ROOT / "BENCH_full.json").read_bytes() == tpu_record


def test_main_refuses_the_root_tpu_record(tiny_pack_dir):
    tpu_record = (ROOT / "BENCH_full.json").read_bytes()
    with pytest.raises(SystemExit) as exc:
        tbench.main(["--full-out", str(ROOT / "BENCH_full.json")],
                    config=port_config(model_cache_dir=tiny_pack_dir))
    assert exc.value.code == 2
    assert (ROOT / "BENCH_full.json").read_bytes() == tpu_record


def test_default_full_record_lies_under_build():
    assert tbench.DEFAULT_FULL_OUT == ROOT / "build" / "bench_torch" / "BENCH_full.json"


def test_main_without_a_card_exits_1_and_prints_nothing(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tbench.main(["--full-out", str(tmp_path / "r.json")]) == 1
    assert capsys.readouterr().out == ""
    assert not (tmp_path / "r.json").exists()


def test_entry_point_without_a_card_and_without_jax(tmp_path):
    """``python -m vietvoice_tts_tpu_torch.bench`` with jax, the JAX package
    and the root harness unimportable: exit 1, nothing on stdout."""
    code = (
        "import sys, runpy\n"
        "for m in ('jax', 'vietvoice_tts_tpu', 'bench'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "torch.cuda.is_available = lambda: False\n"
        f"sys.argv = ['bench', '--full-out', {str(tmp_path / 'r.json')!r}]\n"
        "runpy.run_module('vietvoice_tts_tpu_torch.bench', run_name='__main__')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 1, proc.stderr
    assert proc.stdout == ""
    assert "no CUDA device" in proc.stderr


def test_module_imports_neither_jax_nor_the_jax_package():
    tree = ast.parse((ROOT / "vietvoice_tts_tpu_torch" / "bench.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    assert "torch" in roots
    assert not roots & FORBIDDEN, roots & FORBIDDEN
