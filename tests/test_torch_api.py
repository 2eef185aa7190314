"""The REST app of the PyTorch port (``vietvoice_tts_tpu_torch/api``),
counterpart of ``tests/test_api.py``, ``tests/test_api_schemas.py`` and
``tests/test_openapi.py``. The engine runs with ``device="cpu"`` at
``tiny_config`` sizes; requests go through the in-process ``AsyncTestClient``.

Held against the JAX package, all exact:

- the same requests to both apps, ``synthesize_async`` patched in both, give
  the same status codes, the same headers and the same JSON keys;
- the two OpenAPI documents are equal apart from texts (every path at which
  they differ ends in ``description``, ``summary`` or ``title``);
- the pydantic models have equal JSON schemas apart from descriptions.
"""

import asyncio
import importlib
import json
import time
from unittest.mock import patch

import numpy as np
import pytest
from pydantic import ValidationError

from test_torch_slice import port_config

from vietvoice_tts_tpu.api import schemas as jschemas
from vietvoice_tts_tpu_torch import config as tconfig
from vietvoice_tts_tpu_torch.api import schemas
from vietvoice_tts_tpu_torch.api import settings as settings_mod
from vietvoice_tts_tpu_torch.api import tts_engine as te
from vietvoice_tts_tpu_torch.api.asgi import App, JSONResponse
from vietvoice_tts_tpu_torch.api.testing import AsyncTestClient
from vietvoice_tts_tpu_torch.utils.wavio import read_wav, wav_bytes

# ``from <package>.api import app`` resolves to the App instance that the
# package __init__ re-exports; importlib gets the module itself.
app_module = importlib.import_module("vietvoice_tts_tpu_torch.api.app")
jax_app_module = importlib.import_module("vietvoice_tts_tpu.api.app")

FAKE_WAV = wav_bytes(np.zeros(2400, np.int16), 24000)
TEXT_DIFFERENCES = ("description", "summary", "title")


def run(coro):
    return asyncio.get_event_loop_policy().new_event_loop().run_until_complete(coro)


async def fake_synthesize_async(**kwargs):
    return FAKE_WAV, 24000, 0.1


async def failing_synthesize_async(**kwargs):
    raise RuntimeError("engine exploded")


@pytest.fixture
def client():
    return AsyncTestClient(app_module.app)


@pytest.fixture
def patched(client):
    with patch.object(app_module, "synthesize_async", fake_synthesize_async):
        yield client


@pytest.fixture
def tiny_server(tiny_pack_dir):
    """The app over a real small engine on the CPU, micro-batcher attached
    (``settings.MICRO_BATCHING`` is on by default)."""
    old = te._engine_config
    te.reset_engine()
    te._engine_config = port_config(model_cache_dir=tiny_pack_dir)
    try:
        yield AsyncTestClient(app_module.app)
    finally:
        te.reset_engine()
        te._engine_config = old


def _differences(x, y, path=""):
    if type(x) is not type(y):
        yield path
    elif isinstance(x, dict):
        for k in set(x) | set(y):
            if k not in x or k not in y:
                yield f"{path}/{k}"
            else:
                yield from _differences(x[k], y[k], f"{path}/{k}")
    elif isinstance(x, list):
        if len(x) != len(y):
            yield path
        else:
            for i, (p, q) in enumerate(zip(x, y)):
                yield from _differences(p, q, f"{path}/{i}")
    elif x != y:
        yield path


# -- Against the JAX package ------------------------------------------------------


PARITY_REQUESTS = [
    ("GET", "/api/v1/health", None),
    ("POST", "/api/v1/health", {}),  # 405
    ("POST", "/api/v1/synthesize", {"text": "xin chào"}),
    ("POST", "/api/v1/synthesize", {"text": "xin chào", "speed": 1.2, "gender": "female",
                                    "group": "news", "area": "southern", "emotion": "happy",
                                    "sample_iteration": 2}),
    ("POST", "/api/v1/synthesize", {}),  # 422
    ("POST", "/api/v1/synthesize", {"text": "x" * 1001}),
    ("POST", "/api/v1/synthesize", {"text": "ok", "speed": 3.0}),
    ("POST", "/api/v1/synthesize", {"text": "ok", "gender": "robot"}),
    ("POST", "/api/v1/synthesize", {"text": "ok", "output_format": "mp3"}),
    ("POST", "/api/v1/synthesize/stream", {"text": ""}),
    ("POST", "/api/v1/synthesize/stream", {"text": "ok", "first_chunk_duration": -1}),
    ("POST", "/api/v1/synthesize/download", {"text": "đính kèm"}),
    ("GET", "/api/v1/download/nope123456", None),  # 404
    ("GET", "/api/v1/nothing", None),
    ("GET", "/api/v1/stats", None),
    ("GET", "/api/v1/voices?gender=female&limit=5&offset=5", None),
    ("GET", "/api/v1/voices?limit=x", None),
    ("GET", "/schema", None),
]


def _shape(resp):
    """What a client can rely on: status, headers, and the JSON keys (or the
    bytes of a body that is no JSON object)."""
    try:
        body = resp.json()
        body = sorted(body) if isinstance(body, dict) else body
    except ValueError:
        body = resp.content
    return resp.status_code, resp.headers, body


class TestSameAnswersAsTheJaxApp:
    @pytest.mark.parametrize("method, path, body", PARITY_REQUESTS)
    def test_status_headers_and_keys(self, method, path, body):
        shapes = []
        for module in (app_module, jax_app_module):
            with patch.object(module, "synthesize_async", fake_synthesize_async):
                shapes.append(_shape(run(AsyncTestClient(module.app).request(method, path, body))))
        assert shapes[0] == shapes[1]

    def test_engine_error_is_500_in_both(self):
        shapes = []
        for module in (app_module, jax_app_module):
            with patch.object(module, "synthesize_async", failing_synthesize_async):
                resp = run(AsyncTestClient(module.app).post("/api/v1/synthesize", json={"text": "x"}))
                shapes.append(_shape(resp))
        assert shapes[0] == shapes[1] and shapes[0][0] == 500

    def test_download_round_trip_in_both(self):
        shapes = []
        for module in (app_module, jax_app_module):
            c = AsyncTestClient(module.app)
            with patch.object(module, "synthesize_async", fake_synthesize_async):
                made = run(c.post("/api/v1/synthesize/file", json={"text": "tải về"}))
                fetched = run(c.get(made.json()["download_url"]))
            assert fetched.content == FAKE_WAV
            headers = dict(fetched.headers)
            # The attachment is named after the file's random id.
            assert headers.pop("Content-Disposition").startswith("attachment")
            shapes.append((made.status_code, sorted(made.json()), made.headers,
                           fetched.status_code, headers))
        assert shapes[0] == shapes[1]

    def test_openapi_documents_differ_in_texts_only(self):
        ours, ref = (
            run(AsyncTestClient(m.app).get("/schema/openapi.json")).json()
            for m in (app_module, jax_app_module)
        )
        differing = list(_differences(ours, ref))
        assert all(p.rsplit("/", 1)[-1] in TEXT_DIFFERENCES for p in differing), differing
        assert set(ours["paths"]) == set(ref["paths"]) and len(ours["paths"]) >= 10

    @pytest.mark.parametrize(
        "model",
        ["HealthResponse", "SynthesizeRequest", "StreamSynthesizeRequest",
         "SynthesizeFileResponse", "StatsResponse", "VoiceEntry", "VoicesResponse"],
    )
    def test_model_schemas_differ_in_descriptions_only(self, model):
        ours = getattr(schemas, model).model_json_schema()
        ref = getattr(jschemas, model).model_json_schema()
        differing = list(_differences(ours, ref))
        assert all(p.endswith("/description") for p in differing), differing

    @pytest.mark.parametrize("enum", ["Gender", "Group", "Area", "Emotion"])
    def test_enums_equal(self, enum):
        ours, ref = getattr(schemas, enum), getattr(jschemas, enum)
        assert [(m.name, m.value) for m in ours] == [(m.name, m.value) for m in ref]
        assert issubclass(ours, str)


# -- Schemas (tests/test_api_schemas.py) -------------------------------------------


class TestSchemas:
    def test_enums_match_model_constants(self):
        assert [g.value for g in schemas.Gender] == tconfig.MODEL_GENDER
        assert [g.value for g in schemas.Group] == tconfig.MODEL_GROUP
        assert [a.value for a in schemas.Area] == tconfig.MODEL_AREA
        assert [e.value for e in schemas.Emotion] == tconfig.MODEL_EMOTION

    def test_health_response(self):
        h = schemas.HealthResponse(status="healthy", uptime=5, backend="cuda", device_count=1)
        assert (h.status, h.uptime, h.backend, h.device_count) == ("healthy", 5, "cuda", 1)
        with pytest.raises(ValidationError):
            schemas.HealthResponse(status="on fire", uptime=1)
        with pytest.raises(ValidationError):
            schemas.HealthResponse(status="healthy")

    def test_synthesize_request_defaults_and_round_trip(self):
        r = schemas.SynthesizeRequest(text="Xin chào Việt Nam — ổn không?")
        assert r.speed == 0.9 and r.output_format == "wav" and r.gender is None
        again = schemas.SynthesizeRequest.model_validate_json(r.model_dump_json())
        assert again == r

    @pytest.mark.parametrize(
        "body",
        [
            {},
            {"text": ""},
            {"text": "x" * 1001},
            {"text": "ok", "speed": 0.1},
            {"text": "ok", "speed": 3.0},
            {"text": "ok", "gender": "robot"},
            {"text": "ok", "emotion": "bored"},
            {"text": "ok", "output_format": "mp3"},
            {"text": "ok", "sample_iteration": -1},
        ],
    )
    def test_synthesize_request_refuses(self, body):
        with pytest.raises(ValidationError):
            schemas.SynthesizeRequest(**body)

    def test_text_and_speed_bounds_are_inclusive(self):
        schemas.SynthesizeRequest(text="x")
        schemas.SynthesizeRequest(text="x" * 1000, speed=0.25)
        schemas.SynthesizeRequest(text="x", speed=2.0)
        schemas.StreamSynthesizeRequest(text="x", first_chunk_duration=20)

    def test_file_response_requires_every_field(self):
        fields = dict(download_url="/api/v1/download/a", duration_seconds=1.0, sample_rate=24000,
                      format="wav", file_size_bytes=10)
        assert schemas.SynthesizeFileResponse(**fields).sample_rate == 24000
        for missing in fields:
            with pytest.raises(ValidationError):
                schemas.SynthesizeFileResponse(**{k: v for k, v in fields.items() if k != missing})


# -- Routes with the engine patched (tests/test_api.py) -----------------------------


class TestRoutes:
    def test_health(self, client):
        resp = run(client.get("/api/v1/health"))
        assert resp.status_code == 200
        data = resp.json()
        assert data["status"] == "healthy"
        assert isinstance(data["uptime"], int)
        # Before the engine loads, the device the settings ask for.
        assert data["backend"] == settings_mod.settings.DEVICE.split(":")[0]
        assert data["engine_loaded"] is False and data["synthetic_weights"] is None

    def test_health_wrong_method(self, client):
        assert run(client.post("/api/v1/health", json={})).status_code == 405

    def test_synthesize_returns_wav(self, patched):
        resp = run(patched.post("/api/v1/synthesize", json={"text": "xin chào"}))
        assert resp.status_code == 200
        assert resp.content == FAKE_WAV
        assert resp.headers["content-type"] == "audio/wav"
        assert "inline" in resp.headers["Content-Disposition"]

    def test_malformed_json(self, patched):
        async def raw():
            sent = {}
            received = [{"type": "http.request", "body": b"{not json", "more_body": False}]

            async def receive():
                return received.pop(0)

            async def send(m):
                if m["type"] == "http.response.start":
                    sent["status"] = m["status"]

            await app_module.app(
                {"type": "http", "method": "POST", "path": "/api/v1/synthesize"}, receive, send
            )
            return sent["status"]

        assert run(raw()) in (400, 422)

    def test_file_then_download(self, patched):
        resp = run(patched.post("/api/v1/synthesize/file", json={"text": "tải về"}))
        assert resp.status_code == 200
        data = resp.json()
        assert data["file_size_bytes"] == len(FAKE_WAV)
        assert data["sample_rate"] == 24000
        assert data["format"] == "wav"
        dl = run(patched.get(data["download_url"]))
        assert dl.status_code == 200
        assert dl.content == FAKE_WAV
        assert "attachment" in dl.headers["Content-Disposition"]

    def test_download_expired_file_404(self, patched):
        resp = run(patched.post("/api/v1/synthesize/file", json={"text": "x"}))
        url = resp.json()["download_url"]
        app_module._file_cache[url.rsplit("/", 1)[-1]]["path"].unlink()
        assert run(patched.get(url)).status_code == 404

    def test_synthesize_download_attachment(self, patched):
        resp = run(patched.post("/api/v1/synthesize/download", json={"text": "đính kèm"}))
        assert resp.status_code == 200
        assert resp.content == FAKE_WAV
        assert "attachment" in resp.headers["Content-Disposition"]

    def test_stats_without_engine(self, client):
        data = run(client.get("/api/v1/stats")).json()
        assert data["stage_seconds"] == {} and data["batcher"] is None
        assert data["hbm"] is None  # no card here

    def test_metrics_without_engine(self, client):
        resp = run(client.get("/metrics"))
        assert resp.status_code == 200
        text = resp.content.decode()
        assert "vietvoice_uptime_seconds" in text
        assert "vietvoice_engine_loaded 0" in text
        typed = {line.split()[2] for line in text.splitlines() if line.startswith("# TYPE")}
        for s in (line for line in text.splitlines() if line and not line.startswith("#")):
            assert s.split("{")[0].split()[0] in typed, s


class TestVoicesRoute:
    def test_unfiltered_returns_catalog(self, client):
        d = run(client.get("/api/v1/voices")).json()
        assert d["total"] >= 238  # the real catalogue is bundled
        assert len(d["voices"]) == 50  # default page size
        assert set(d["voices"][0]) == {
            "filename", "gender", "group", "area", "emotion", "text", "clip_available",
        }

    def test_filters_and_paging(self, client):
        all_f = run(client.get("/api/v1/voices?gender=female")).json()
        assert 0 < all_f["total"] < 239
        assert all(v["gender"] == "female" for v in all_f["voices"])
        assert all_f["filters"] == {"gender": "female"}
        page2 = run(client.get("/api/v1/voices?gender=female&limit=5&offset=5")).json()
        first = run(client.get("/api/v1/voices?gender=female&limit=5")).json()
        assert len(page2["voices"]) == 5 and page2["voices"][0] != first["voices"][0]

    def test_no_match_is_empty_not_error(self, client):
        d = run(client.get("/api/v1/voices?gender=robot")).json()
        assert d["total"] == 0 and d["voices"] == []


# -- The real engine behind the app, on the CPU --------------------------------------


class TestRealEngine:
    def test_every_route_with_the_batcher_enabled(self, tiny_server):
        """health, synthesize, synthesize/stream, stats and metrics over one
        small engine whose requests go through the micro-batcher."""
        c = tiny_server
        resp = run(c.post("/api/v1/synthesize", json={"text": "xin chào thế giới", "speed": 0.9}))
        assert resp.status_code == 200 and resp.content[:4] == b"RIFF"
        samples, sr = read_wav(resp.content)
        assert sr == 24000 and np.abs(samples).max() > 0
        engine = te._engine.engine
        assert engine.batcher is not None and engine.batcher.stats.jobs >= 1

        health = run(c.get("/api/v1/health")).json()
        assert health["status"] == "healthy" and health["backend"] == "cpu"
        assert health["device_count"] == 1
        assert health["engine_loaded"] is True and health["synthetic_weights"] is True
        assert health["batcher_healthy"] is True and health["last_error"] is None

        streamed = run(c.post("/api/v1/synthesize/stream",
                              json={"text": "xin chào thế giới", "speed": 0.9}))
        assert streamed.status_code == 200
        body = streamed.content
        assert body[:4] == b"RIFF"
        assert body[4:8] == b"\xff\xff\xff\xff" and body[40:44] == b"\xff\xff\xff\xff"
        wave, _ = te._engine.synthesize("xin chào thế giới", speed=0.9)
        np.testing.assert_array_equal(np.frombuffer(body[44:], "<i2"), wave)
        np.testing.assert_array_equal(np.frombuffer(body[44:], "<i2"),
                                      np.frombuffer(resp.content[44:], "<i2"))

        stats = run(c.get("/api/v1/stats")).json()
        assert stats["stage_seconds"]
        assert stats["batcher"]["jobs"] >= 3 and stats["batcher"]["failures"] == 0
        assert stats["cond_cache"]["hits"] + stats["cond_cache"]["misses"] >= 3
        assert stats["hbm"] is None

        text = run(c.get("/metrics")).content.decode()
        assert "vietvoice_engine_loaded 1" in text
        assert "vietvoice_stage_seconds_total{stage=" in text
        assert "vietvoice_batcher_healthy 1" in text
        assert "vietvoice_batches_total" in text
        assert "vietvoice_cond_cache_misses_total" in text
        for line in text.splitlines():
            if line and not line.startswith("#"):
                float(line.rsplit(" ", 1)[1])

    def test_gathered_requests_share_batches(self, tiny_server):
        texts = ["xin chào", "tạm biệt", "cảm ơn", "xin lỗi"]

        async def go():
            return await asyncio.gather(
                *(tiny_server.post("/api/v1/synthesize", json={"text": t}) for t in texts)
            )

        for resp in run(go()):
            assert resp.status_code == 200 and resp.content[:4] == b"RIFF"
        stats = te._engine.engine.batcher.stats
        assert stats.jobs == 4 and stats.failures == 0

    def test_first_chunk_duration_reaches_the_engine(self, tiny_server):
        long_text = " ".join(f"Câu số {i} trong đoạn văn dài." for i in range(60))
        resp = run(tiny_server.post(
            "/api/v1/synthesize/stream",
            json={"text": long_text[:990], "first_chunk_duration": 1.0},
        ))
        assert resp.status_code == 200
        assert resp.content[:4] == b"RIFF" and len(resp.content) > 44

    def test_speed_passed_as_argument_not_mutation(self, tiny_server):
        before = te.get_engine_config().speed
        audio, sr, dur = run(te.synthesize_async(
            text="Một câu.", speed=1.5, gender=None, group=None, area=None, emotion=None,
            sample_iteration=None,
        ))
        assert te._engine.config.speed == before
        assert audio[:4] == b"RIFF" and sr == 24000 and dur > 0

    def test_micro_batching_can_be_switched_off(self, tiny_server, monkeypatch):
        monkeypatch.setattr(te._settings, "MICRO_BATCHING", False)
        run(tiny_server.post("/api/v1/synthesize", json={"text": "một"}))
        assert te._engine.engine.batcher is None
        assert run(tiny_server.get("/api/v1/health")).json()["batcher_healthy"] is None

    @pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
    def test_health_degrades_then_self_heals(self, tiny_server):
        run(tiny_server.post("/api/v1/synthesize", json={"text": "một", "speed": 0.9}))
        batcher = te._engine.engine.batcher
        # Kill the dispatcher with a non-Exception (the loops catch Exception).
        batcher._collect = lambda: (_ for _ in ()).throw(SystemExit("boom"))
        batcher._queue.put(None)  # wake it; the bomb fires in the next round
        deadline = time.monotonic() + 5
        while batcher._thread.is_alive() and time.monotonic() < deadline:
            time.sleep(0.01)
        del batcher._collect
        data = run(tiny_server.get("/api/v1/health")).json()
        assert (data["status"], data["batcher_healthy"]) == ("degraded", False)
        data = run(tiny_server.get("/api/v1/health")).json()
        assert (data["status"], data["batcher_healthy"]) == ("healthy", True)


class TestServerPolicy:
    def test_server_default_refuses_synthetic_pack(self, temp_dir):
        assert settings_mod.settings.ALLOW_SYNTHETIC is False
        cfg = port_config(model_cache_dir=temp_dir, allow_synthetic_pack=False)
        with patch.object(te, "_engine_config", cfg), patch.object(te, "_engine", None):
            with pytest.raises(RuntimeError, match="[Ss]ynthetic|weight pack"):
                te.get_tts_engine().engine

    def test_settings_read_the_environment(self, monkeypatch):
        monkeypatch.setenv("VIETVOICE_ALLOW_SYNTHETIC", "1")
        monkeypatch.setenv("VIETVOICE_DEVICE", "cpu")
        monkeypatch.setenv("VIETVOICE_MICRO_BATCHING", "0")
        s = settings_mod.Settings()
        assert (s.ALLOW_SYNTHETIC, s.DEVICE, s.MICRO_BATCHING) == (True, "cpu", False)
        monkeypatch.delenv("VIETVOICE_DEVICE")
        monkeypatch.delenv("VIETVOICE_MICRO_BATCHING")
        s = settings_mod.Settings()
        assert (s.DEVICE, s.MICRO_BATCHING) == ("cuda", True)

    def test_default_server_config_needs_a_card(self, monkeypatch):
        import torch

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with patch.object(te, "_engine_config", None), patch.object(te, "_engine", None):
            with pytest.raises(RuntimeError, match="CUDA"):
                te.get_engine_config()
            with pytest.raises(RuntimeError, match="CUDA"):
                te.get_tts_engine()

    def test_launcher_exits_before_listening_without_a_card(self, monkeypatch, capsys):
        import sys

        import torch

        from vietvoice_tts_tpu_torch.api import server

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        monkeypatch.setattr(sys, "argv", ["server"])
        monkeypatch.setattr(server, "_run_stdlib", lambda *a, **k: pytest.fail("listened"))
        with patch.object(te, "_engine_config", None), patch.object(te, "_engine", None):
            with pytest.raises(SystemExit) as exc_info:
                server.main()
        assert exc_info.value.code == 1
        assert "CUDA" in capsys.readouterr().err

    def test_stdlib_server_bridges_the_app(self, monkeypatch):
        """The launcher's ``http.server`` route answers over a socket on
        localhost: health, a patched synthesis, a 404."""
        import http.client
        import threading

        from vietvoice_tts_tpu_torch.api import server

        started = []

        class Recording(server.ThreadingHTTPServer):
            def __init__(self, *args):
                super().__init__(*args)
                started.append(self)

        monkeypatch.setattr(server, "ThreadingHTTPServer", Recording)
        thread = threading.Thread(target=server._run_stdlib, args=("127.0.0.1", 0), daemon=True)
        thread.start()
        deadline = time.monotonic() + 10
        while not started and time.monotonic() < deadline:
            time.sleep(0.01)
        httpd = started[0]
        try:
            conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=30)
            conn.request("GET", "/api/v1/health")
            resp = conn.getresponse()
            assert resp.status == 200 and json.loads(resp.read())["status"] == "healthy"
            with patch.object(app_module, "synthesize_async", fake_synthesize_async):
                conn.request("POST", "/api/v1/synthesize", body=json.dumps({"text": "xin chào"}))
                resp = conn.getresponse()
                assert resp.status == 200 and resp.getheader("content-type") == "audio/wav"
                assert resp.read() == FAKE_WAV
            conn.request("GET", "/api/v1/nothing")
            resp = conn.getresponse()
            assert resp.status == 404 and resp.read()
            conn.close()
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=10)
        assert not thread.is_alive()

    def test_library_default_stays_permissive(self):
        assert tconfig.ModelConfig(device="cpu").allow_synthetic_pack is True


# -- The framework (tests/test_openapi.py) --------------------------------------------


class TestFramework:
    def test_reference_routes_are_documented(self, client):
        doc = run(client.get("/schema/openapi.json")).json()
        assert doc["openapi"].startswith("3.1.")
        for path in ("/api/v1/health", "/api/v1/synthesize", "/api/v1/synthesize/file",
                     "/api/v1/synthesize/download", "/api/v1/download/{file_id}",
                     "/api/v1/synthesize/stream", "/api/v1/stats", "/api/v1/voices", "/metrics"):
            assert path in doc["paths"], path
        assert "PyTorch" in doc["info"]["description"]

    def test_schema_landing_page(self, client):
        resp = run(client.get("/schema"))
        assert resp.status_code == 200 and b"/schema/openapi.json" in resp.content

    def _echo_app(self, cap):
        app = App(max_body_bytes=cap)

        @app.post("/echo")
        async def echo():
            return JSONResponse({"ok": True})

        @app.get("/items/{item_id:int}")
        async def item(item_id):
            return JSONResponse({"item": item_id, "kind": type(item_id).__name__})

        return app

    def _post(self, app, chunks, headers=()):
        sent = {}
        received = [
            {"type": "http.request", "body": c, "more_body": i < len(chunks) - 1}
            for i, c in enumerate(chunks)
        ]
        pulled = []

        async def receive():
            pulled.append(1)
            return received.pop(0)

        async def send(m):
            if m["type"] == "http.response.start":
                sent["status"] = m["status"]

        run(app({"type": "http", "method": "POST", "path": "/echo", "headers": list(headers)},
                receive, send))
        return sent["status"], len(pulled)

    def test_body_size_guard(self):
        app = self._echo_app(cap=100)
        assert self._post(app, [b"x" * 50]) == (200, 1)
        # A declared length over the cap is refused without reading.
        assert self._post(app, [b"x" * 500], [(b"content-length", b"500")]) == (413, 0)
        # A chunked body is refused as soon as it passes the cap.
        assert self._post(app, [b"x" * 60, b"x" * 60, b"x" * 60]) == (413, 2)

    def test_oversized_synthesize_request_is_413(self, client):
        resp = run(client.post("/api/v1/synthesize", json={"text": "x" * (2 << 20)}))
        assert resp.status_code == 413

    def test_typed_path_params(self):
        c = AsyncTestClient(self._echo_app(cap=100))
        assert run(c.get("/items/42")).json() == {"item": 42, "kind": "int"}
        assert run(c.get("/items/abc")).status_code == 404
        with pytest.raises(ValueError, match="Unknown path-parameter type"):

            @App().get("/x/{y:zzz}")
            async def handler(y):  # pragma: no cover
                return None
