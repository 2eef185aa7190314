"""REST server launcher (port of ``vietvoice_tts_tpu/api/server.py``).

    python -m vietvoice_tts_tpu_torch.api.server [host] [port]

Counterpart of the reference's ``run_api_server.py:14-61`` (uvicorn). Uses
uvicorn when installed; otherwise falls back to a stdlib threaded HTTP server
bridging into the ASGI app, so serving works with zero extra dependencies.
The engine runs on ``VIETVOICE_DEVICE`` (default ``cuda``); without a card
the launcher exits before it listens.
"""

from __future__ import annotations

import asyncio
import sys
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..utils.logging import get_logger

log = get_logger("api.server")


def _run_stdlib(host: str, port: int) -> None:
    """Bridge the ASGI app onto http.server (one event loop per worker)."""
    from .app import app

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _serve(self, method: str) -> None:
            length = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(length) if length else b""
            result = {"status": 500, "headers": [], "body": b""}

            async def receive():
                return {"type": "http.request", "body": body, "more_body": False}

            async def send(message):
                if message["type"] == "http.response.start":
                    result["status"] = message["status"]
                    result["headers"] = message.get("headers", [])
                elif message["type"] == "http.response.body":
                    result["body"] += message.get("body", b"")

            scope = {"type": "http", "method": method, "path": self.path.split("?")[0]}
            asyncio.run(app(scope, receive, send))
            self.send_response(result["status"])
            for k, v in result["headers"]:
                self.send_header(k.decode(), v.decode())
            self.send_header("Content-Length", str(len(result["body"])))
            self.end_headers()
            self.wfile.write(result["body"])

        def do_GET(self):  # noqa: N802 — http.server API
            self._serve("GET")

        def do_POST(self):  # noqa: N802
            self._serve("POST")

        def log_message(self, fmt, *args):  # route through our logger
            log.info("%s - %s", self.address_string(), fmt % args)

    server = ThreadingHTTPServer((host, port), Handler)
    log.info("Serving on http://%s:%d (stdlib fallback server)", host, port)
    server.serve_forever()


def main() -> None:
    host = sys.argv[1] if len(sys.argv) > 1 else "0.0.0.0"
    port = int(sys.argv[2]) if len(sys.argv) > 2 else 8000
    from .tts_engine import get_engine_config

    try:
        get_engine_config()  # device="cuda" without a card raises here
    except (RuntimeError, ValueError) as e:
        print(f"Error: {e}", file=sys.stderr)
        sys.exit(1)
    try:
        import uvicorn

        log.info("Starting uvicorn on %s:%d", host, port)
        uvicorn.run("vietvoice_tts_tpu_torch.api.app:app", host=host, port=port, workers=1)
    except ImportError:
        _run_stdlib(host, port)


if __name__ == "__main__":
    main()
