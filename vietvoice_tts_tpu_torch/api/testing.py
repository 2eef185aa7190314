"""In-process ASGI test client (like ``litestar.testing.AsyncTestClient``).

Drives the :class:`~vietvoice_tts_tpu_torch.api.asgi.App` without a socket or a
server process: requests are dispatched straight through the ASGI callable.
Used by the test suite and the REST benchmark; kept OUT of the production
``asgi`` module: test machinery does not belong in the serving path.
"""

from __future__ import annotations

import json
from typing import Any, Dict

from .asgi import App


class TestResponse:
    def __init__(self, status_code: int, body: bytes, headers: Dict[str, str]):
        self.status_code = status_code
        self.content = body
        self.headers = headers

    def json(self):
        return json.loads(self.content)

    @property
    def text(self) -> str:
        return self.content.decode()


class AsyncTestClient:
    """In-process ASGI client (like litestar.testing.AsyncTestClient)."""

    def __init__(self, app: App):
        self.app = app

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        return False

    async def request(self, method: str, path: str, json_body: Any = None) -> TestResponse:
        body = json.dumps(json_body).encode() if json_body is not None else b""
        sent: Dict[str, Any] = {"status": 500, "headers": {}, "body": b""}
        received = [
            {"type": "http.request", "body": body, "more_body": False}
        ]

        async def receive():
            return received.pop(0) if received else {"type": "http.disconnect"}

        async def send(message):
            if message["type"] == "http.response.start":
                sent["status"] = message["status"]
                sent["headers"] = {
                    k.decode(): v.decode() for k, v in message.get("headers", [])
                }
            elif message["type"] == "http.response.body":
                sent["body"] += message.get("body", b"")

        path, _, query = path.partition("?")
        scope = {
            "type": "http",
            "method": method,
            "path": path,
            "query_string": query.encode("latin-1"),
        }
        await self.app(scope, receive, send)
        return TestResponse(sent["status"], sent["body"], sent["headers"])

    async def get(self, path: str) -> TestResponse:
        return await self.request("GET", path)

    async def post(self, path: str, json: Any = None) -> TestResponse:
        return await self.request("POST", path, json_body=json)
