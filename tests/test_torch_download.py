"""Tarball downloader of the PyTorch port
(``vietvoice_tts_tpu_torch/models/download.py``), the JAX package's
``tests/test_download.py`` case for case (configs on the CPU) — reference
parity for
``ModelConfig.ensure_model_downloaded``
(``vietvoicetts/core/model_config.py:71-104``): fresh
download, cache reuse, partial-download handling, and resume — all against a
patched opener, no network.
"""

import urllib.error
from pathlib import Path

import pytest

from vietvoice_tts_tpu_torch.models.download import (
    DEFAULT_MODEL_URL,
    ensure_model_downloaded,
    resolve_tarball,
)

PAYLOAD = bytes(range(256)) * 40  # 10240 bytes


class FakeResponse:
    """Minimal urlopen response: status, headers, chunked reads, fail-at."""

    def __init__(self, data: bytes, status=200, content_length=True, fail_after=None):
        self.data = data
        self.status = status
        self.headers = (
            {"Content-Length": str(len(data))} if content_length else {}
        )
        self.pos = 0
        self.fail_after = fail_after

    def read(self, n):
        if self.fail_after is not None and self.pos >= self.fail_after:
            raise urllib.error.URLError("connection reset")
        chunk = self.data[self.pos : self.pos + min(n, 1024)]
        self.pos += len(chunk)
        return chunk

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def make_opener(responses: list, seen: list):
    """Sequential opener: pops the next FakeResponse per call."""

    def opener(req):
        seen.append(req)
        return responses.pop(0)

    return opener


class TestFreshDownload:
    def test_downloads_and_renames_atomically(self, tmp_path):
        dest = tmp_path / "model-bin.pt"
        seen: list = []
        out = ensure_model_downloaded(
            url="https://x/model-bin.pt",
            dest=dest,
            opener=make_opener([FakeResponse(PAYLOAD)], seen),
        )
        assert out == dest
        assert dest.read_bytes() == PAYLOAD
        assert not dest.with_suffix(".pt.partial").exists()
        assert len(seen) == 1

    def test_progress_callback_sees_totals(self, tmp_path):
        calls = []
        ensure_model_downloaded(
            url="https://x/m.pt",
            dest=tmp_path / "m.pt",
            progress=lambda done, total: calls.append((done, total)),
            opener=make_opener([FakeResponse(PAYLOAD)], []),
        )
        assert calls[-1] == (len(PAYLOAD), len(PAYLOAD))
        assert all(t == len(PAYLOAD) for _, t in calls)

    def test_unknown_length_still_downloads(self, tmp_path):
        dest = tmp_path / "m.pt"
        ensure_model_downloaded(
            url="https://x/m.pt",
            dest=dest,
            opener=make_opener([FakeResponse(PAYLOAD, content_length=False)], []),
        )
        assert dest.read_bytes() == PAYLOAD


class TestCachedReuse:
    def test_existing_file_is_not_refetched(self, tmp_path):
        dest = tmp_path / "m.pt"
        dest.write_bytes(b"cached")
        seen: list = []
        out = ensure_model_downloaded(
            url="https://x/m.pt", dest=dest, opener=make_opener([], seen)
        )
        assert out == dest
        assert dest.read_bytes() == b"cached"
        assert seen == []


class TestInterruptedDownload:
    def test_failure_keeps_partial_for_resume(self, tmp_path):
        dest = tmp_path / "m.pt"
        with pytest.raises(RuntimeError, match="Failed to download"):
            ensure_model_downloaded(
                url="https://x/m.pt",
                dest=dest,
                opener=make_opener([FakeResponse(PAYLOAD, fail_after=4096)], []),
            )
        partial = dest.with_suffix(".pt.partial")
        assert not dest.exists()
        assert partial.exists()
        assert partial.read_bytes() == PAYLOAD[:4096]

    def test_failure_without_resume_removes_partial(self, tmp_path):
        dest = tmp_path / "m.pt"
        with pytest.raises(RuntimeError):
            ensure_model_downloaded(
                url="https://x/m.pt",
                dest=dest,
                resume=False,
                opener=make_opener([FakeResponse(PAYLOAD, fail_after=2048)], []),
            )
        assert not dest.with_suffix(".pt.partial").exists()

    def test_short_read_without_exception_is_a_failure(self, tmp_path):
        """Server closes early with Content-Length promised: must not rename
        the truncated partial into place."""
        dest = tmp_path / "m.pt"
        truncated = FakeResponse(PAYLOAD[:1000])
        truncated.headers = {"Content-Length": str(len(PAYLOAD))}
        with pytest.raises(RuntimeError, match="resume"):
            ensure_model_downloaded(
                url="https://x/m.pt", dest=dest, opener=make_opener([truncated], [])
            )
        assert not dest.exists()


class TestResume:
    def test_resume_appends_with_range_header(self, tmp_path):
        dest = tmp_path / "m.pt"
        partial = dest.with_suffix(".pt.partial")
        partial.write_bytes(PAYLOAD[:4096])
        rest = FakeResponse(PAYLOAD[4096:], status=206)
        seen: list = []
        ensure_model_downloaded(
            url="https://x/m.pt", dest=dest, opener=make_opener([rest], seen)
        )
        assert dest.read_bytes() == PAYLOAD
        assert seen[0].headers.get("Range") == "bytes=4096-"

    def test_server_ignoring_range_restarts(self, tmp_path):
        dest = tmp_path / "m.pt"
        partial = dest.with_suffix(".pt.partial")
        partial.write_bytes(b"junkjunk")
        full = FakeResponse(PAYLOAD, status=200)  # not 206: range ignored
        ensure_model_downloaded(
            url="https://x/m.pt", dest=dest, opener=make_opener([full], [])
        )
        assert dest.read_bytes() == PAYLOAD

    def test_interrupt_then_resume_round_trip(self, tmp_path):
        dest = tmp_path / "m.pt"
        with pytest.raises(RuntimeError):
            ensure_model_downloaded(
                url="https://x/m.pt",
                dest=dest,
                opener=make_opener([FakeResponse(PAYLOAD, fail_after=4096)], []),
            )
        rest = FakeResponse(PAYLOAD[4096:], status=206)
        ensure_model_downloaded(
            url="https://x/m.pt", dest=dest, opener=make_opener([rest], [])
        )
        assert dest.read_bytes() == PAYLOAD

    def test_resume_sends_if_range_validator(self, tmp_path):
        """ADVICE r4: the validator captured when the .partial started is
        sent back as If-Range so a changed remote can't be silently spliced."""
        dest = tmp_path / "m.pt"
        first = FakeResponse(PAYLOAD, fail_after=4096)
        first.headers["ETag"] = '"v1"'
        with pytest.raises(RuntimeError):
            ensure_model_downloaded(
                url="https://x/m.pt", dest=dest, opener=make_opener([first], [])
            )
        meta = dest.with_suffix(".pt.partial.meta")
        assert meta.exists()
        seen: list = []
        rest = FakeResponse(PAYLOAD[4096:], status=206)
        ensure_model_downloaded(
            url="https://x/m.pt", dest=dest, opener=make_opener([rest], seen)
        )
        assert seen[0].headers.get("If-range") == '"v1"'
        assert dest.read_bytes() == PAYLOAD
        assert not meta.exists()  # cleaned up on completion

    def test_changed_remote_restarts_instead_of_splicing(self, tmp_path):
        """If-Range on a changed file makes the server reply 200 with the
        full new body; the stale partial must be discarded, not appended."""
        dest = tmp_path / "m.pt"
        partial = dest.with_suffix(".pt.partial")
        partial.write_bytes(b"OLDVERSION" * 100)
        meta = dest.with_suffix(".pt.partial.meta")
        meta.write_text('{"etag": "\\"v1\\""}')
        full = FakeResponse(PAYLOAD, status=200)  # validator mismatch → 200
        ensure_model_downloaded(
            url="https://x/m.pt", dest=dest, opener=make_opener([full], [])
        )
        assert dest.read_bytes() == PAYLOAD
        assert not meta.exists()

    def test_content_range_start_mismatch_restarts_fresh(self, tmp_path):
        """A 206 whose Content-Range start disagrees with the partial size
        must trigger a FRESH request — consuming the mismatched ranged body
        from byte 0 would silently corrupt the file (it starts at the
        server's offset, not 0)."""
        dest = tmp_path / "m.pt"
        partial = dest.with_suffix(".pt.partial")
        partial.write_bytes(PAYLOAD[:4096])
        # Server resumes from the WRONG offset (500) — this body must be
        # discarded, not written as the whole file.
        bad = FakeResponse(PAYLOAD[500:], status=206)
        bad.headers["Content-Range"] = f"bytes 500-{len(PAYLOAD) - 1}/{len(PAYLOAD)}"
        fresh = FakeResponse(PAYLOAD, status=200)
        seen: list = []
        ensure_model_downloaded(
            url="https://x/m.pt", dest=dest, opener=make_opener([bad, fresh], seen)
        )
        assert dest.read_bytes() == PAYLOAD
        assert len(seen) == 2  # the mismatched response forced a new request
        assert seen[1].headers.get("Range") is None  # fresh, not ranged


class TestResolveTarball:
    def test_local_path_passthrough(self, tmp_path):
        p = tmp_path / "local.pt"
        p.write_bytes(b"x")
        assert resolve_tarball(p) == p

    def test_url_downloads_into_cache(self, tmp_path):
        out = resolve_tarball(
            "https://host/path/model-bin.pt",
            cache_dir=tmp_path,
            opener=make_opener([FakeResponse(PAYLOAD)], []),
        )
        assert out == tmp_path / "model-bin.pt"
        assert out.read_bytes() == PAYLOAD

    def test_default_url_matches_reference(self):
        assert DEFAULT_MODEL_URL.endswith("/model-bin.pt")
        assert "VietVoice-TTS" in DEFAULT_MODEL_URL


class TestModelConfigParity:
    """ModelConfig.ensure_model_downloaded — the reference's entry point
    (model_config.py:71-104), explicit here (never implicit on init)."""

    def test_fetches_into_cache_and_sets_onnx_path(self, tmp_path, monkeypatch):
        from vietvoice_tts_tpu_torch.config import ModelConfig
        from vietvoice_tts_tpu_torch.models import download as dl

        calls = {}

        def fake_fetch(url, dest, **kw):
            calls["url"] = url
            p = tmp_path / "model-bin.pt"
            p.write_bytes(b"tar")
            return p

        monkeypatch.setattr(dl, "ensure_model_downloaded", fake_fetch)
        cfg = ModelConfig(device="cpu", model_cache_dir=str(tmp_path))
        out = cfg.ensure_model_downloaded()
        assert out == str(tmp_path / "model-bin.pt")
        assert cfg.onnx_model_path == out
        assert calls["url"] == dl.DEFAULT_MODEL_URL

    def test_existing_onnx_path_short_circuits(self, tmp_path):
        from vietvoice_tts_tpu_torch.config import ModelConfig

        tar = tmp_path / "local.pt"
        tar.write_bytes(b"tar")
        cfg = ModelConfig(
            device="cpu", model_cache_dir=str(tmp_path), onnx_model_path=str(tar)
        )
        assert cfg.ensure_model_downloaded() == str(tar)

    def test_construction_never_touches_network(self, monkeypatch):
        import urllib.request

        from vietvoice_tts_tpu_torch.config import ModelConfig

        def boom(*a, **k):  # pragma: no cover — must not be called
            raise AssertionError("network touched at config construction")

        monkeypatch.setattr(urllib.request, "urlopen", boom)
        ModelConfig(device="cpu")  # no exception: construction is offline by design


class TestNetworkErrorClasses:
    def test_connection_reset_mid_stream_keeps_partial(self, tmp_path):
        """ConnectionResetError (an OSError, NOT a URLError) raised by
        resp.read() must still preserve the partial for resume."""

        class ResetResponse(FakeResponse):
            def read(self, n):
                if self.pos >= 4096:
                    raise ConnectionResetError("peer reset")
                return super().read(n)

        dest = tmp_path / "m.pt"
        with pytest.raises(RuntimeError, match="partial kept for resume"):
            ensure_model_downloaded(
                url="https://x/m.pt",
                dest=dest,
                opener=make_opener([ResetResponse(PAYLOAD)], []),
            )
        assert dest.with_suffix(".pt.partial").read_bytes() == PAYLOAD[:4096]

    def test_416_with_complete_partial_finalizes(self, tmp_path):
        """Crash between last write and rename: the .partial holds the whole
        file; the resume request gets 416 whose Content-Range confirms the
        size — finalize instead of wedging forever."""
        import urllib.error

        dest = tmp_path / "m.pt"
        partial = dest.with_suffix(".pt.partial")
        partial.write_bytes(PAYLOAD)

        def opener_416(req):
            raise urllib.error.HTTPError(
                req.full_url, 416, "Range Not Satisfiable",
                {"Content-Range": f"bytes */{len(PAYLOAD)}"}, None,
            )

        out = ensure_model_downloaded(
            url="https://x/m.pt", dest=dest, opener=opener_416
        )
        assert out == dest
        assert dest.read_bytes() == PAYLOAD
        assert not partial.exists()

    def test_416_with_stale_partial_restarts(self, tmp_path):
        """416 whose Content-Range disagrees with the partial size: restart
        from scratch (stale or corrupt partial)."""
        import urllib.error

        dest = tmp_path / "m.pt"
        partial = dest.with_suffix(".pt.partial")
        partial.write_bytes(b"x" * 20000)  # larger than the real file

        calls = {"n": 0}

        def opener(req):
            calls["n"] += 1
            if calls["n"] == 1:
                raise urllib.error.HTTPError(
                    req.full_url, 416, "Range Not Satisfiable",
                    {"Content-Range": f"bytes */{len(PAYLOAD)}"}, None,
                )
            assert "Range" not in req.headers  # fresh start
            return FakeResponse(PAYLOAD)

        out = ensure_model_downloaded(url="https://x/m.pt", dest=dest, opener=opener)
        assert out.read_bytes() == PAYLOAD
