"""Minimal ASGI micro-framework.

The reference leans on Litestar for routing/validation/streaming
(``vietvoicetts/api/app.py``). Litestar is not a dependency
here, so this module provides the small subset the TTS API needs as
first-party code — route decorators with path parameters, pydantic request
validation (422 on failure), JSON / streaming / file responses, background
tasks after the response, and an in-process async test client. It speaks
plain ASGI, so production serving works under uvicorn unchanged.
"""

from __future__ import annotations

import inspect
import json
import re
from pathlib import Path
from typing import Any, Awaitable, Callable, Dict, Iterable, Optional
from urllib.parse import parse_qsl

import pydantic

from ..utils.logging import get_logger

log = get_logger("asgi")


class HTTPException(Exception):
    def __init__(self, status_code: int, detail: str = ""):
        super().__init__(detail)
        self.status_code = status_code
        self.detail = detail


class NotFoundException(HTTPException):
    def __init__(self, detail: str = "Not Found"):
        super().__init__(404, detail)


class Response:
    def __init__(
        self,
        content: bytes | str = b"",
        status_code: int = 200,
        media_type: str = "application/json",
        headers: Optional[Dict[str, str]] = None,
        background: Optional[Callable[[], Awaitable[None]]] = None,
    ):
        self.body = content.encode() if isinstance(content, str) else content
        self.status_code = status_code
        self.media_type = media_type
        self.headers = headers or {}
        self.background = background


class JSONResponse(Response):
    def __init__(self, data: Any, status_code: int = 200, **kw):
        if isinstance(data, pydantic.BaseModel):
            body = data.model_dump_json()
        else:
            body = json.dumps(data)
        super().__init__(body, status_code, "application/json", **kw)


class Stream(Response):
    """Byte-iterable response (reference uses litestar.response.Stream)."""

    def __init__(
        self,
        content: Iterable[bytes],
        media_type: str = "application/octet-stream",
        headers: Optional[Dict[str, str]] = None,
        background: Optional[Callable[[], Awaitable[None]]] = None,
        status_code: int = 200,
    ):
        super().__init__(b"", status_code, media_type, headers, background)
        self.chunks = content


class File(Response):
    """File download response (reference uses litestar.response.File)."""

    def __init__(
        self,
        path: str | Path,
        media_type: str = "application/octet-stream",
        filename: Optional[str] = None,
        content_disposition_type: str = "attachment",
        status_code: int = 200,
    ):
        p = Path(path)
        if not p.exists():
            raise NotFoundException(f"File not found: {path}")
        headers = {
            "Content-Disposition": (
                f'{content_disposition_type}; filename="{filename or p.name}"'
            )
        }
        super().__init__(p.read_bytes(), status_code, media_type, headers)


_PARAM_RE = re.compile(r"\{(\w+)(?::(\w+))?\}")

# Path-parameter converters, Litestar-style: ``{file_id:str}``,
# ``{n:int}``, ``{id:uuid}``, ``{rest:path}`` (the last crosses slashes).
_CONVERTERS: Dict[str, tuple] = {
    "str": (r"[^/]+", str),
    "int": (r"[0-9]+", int),
    "float": (r"[+-]?(?:\d+(?:\.\d*)?|\.\d+)(?:[eE][+-]?\d+)?", float),
    "uuid": (r"[0-9a-fA-F-]{8,36}", str),
    "path": (r".+", str),
}


class Route:
    def __init__(self, method: str, path: str, handler: Callable):
        self.method = method
        self.path = path  # original template, kept for the OpenAPI document
        self.handler = handler
        self.converters: Dict[str, Callable] = {}

        def sub(m: re.Match) -> str:
            name, kind = m.group(1), m.group(2) or "str"
            if kind not in _CONVERTERS:
                raise ValueError(
                    f"Unknown path-parameter type '{kind}' in {path!r} "
                    f"(known: {sorted(_CONVERTERS)})"
                )
            sub_pattern, conv = _CONVERTERS[kind]
            self.converters[name] = conv
            return f"(?P<{name}>{sub_pattern})"

        pattern = _PARAM_RE.sub(sub, path)
        self.regex = re.compile(f"^{pattern}$")
        # The pydantic model annotated on a parameter named 'data', if any.
        # typing.get_type_hints resolves string annotations (PEP 563 modules).
        import typing

        self.body_model = None
        self.response_model = None
        try:
            hints = typing.get_type_hints(handler)
        except Exception:
            hints = {
                n: p.annotation
                for n, p in inspect.signature(handler).parameters.items()
            }
        ann = hints.get("data")
        if isinstance(ann, type) and issubclass(ann, pydantic.BaseModel):
            self.body_model = ann
        ret = hints.get("return")
        if isinstance(ret, type) and issubclass(ret, pydantic.BaseModel):
            self.response_model = ret
        # A handler that declares a ``query`` parameter receives the parsed
        # query string as a {name: value} dict (last value wins; values are
        # strings — handlers validate/cast, like Litestar's raw query API).
        self.wants_query = "query" in inspect.signature(handler).parameters


# Largest request body the server will buffer. The biggest legitimate
# payload is a JSON synthesize request (≤1000 chars of text); 1 MiB leaves
# two orders of magnitude of headroom while keeping an accidental (or
# hostile) multi-GB POST from being buffered whole.
DEFAULT_MAX_BODY_BYTES = 1 << 20


class App:
    """ASGI application with decorator-based routing."""

    def __init__(self, max_body_bytes: int = DEFAULT_MAX_BODY_BYTES):
        self.routes: list[Route] = []
        self.max_body_bytes = max_body_bytes

    def get(self, path: str, **_ignored):
        def deco(fn):
            self.routes.append(Route("GET", path, fn))
            return fn

        return deco

    def post(self, path: str, **_ignored):
        def deco(fn):
            self.routes.append(Route("POST", path, fn))
            return fn

        return deco

    # -- request handling ----------------------------------------------------

    async def _dispatch(self, method: str, path: str, body: bytes,
                        query_string: bytes = b"") -> Response:
        path_matched = False
        for route in self.routes:
            m = route.regex.match(path)
            if not m:
                continue
            if route.method != method:
                path_matched = True
                continue
            try:
                kwargs: Dict[str, Any] = {
                    k: route.converters.get(k, str)(v) for k, v in m.groupdict().items()
                }
            except (ValueError, TypeError):
                # A captured segment the converter rejects (e.g. the float
                # pattern is permissive enough to admit an unparseable string)
                # means the URL doesn't name a resource — 404, never a 500.
                continue
            path_matched = True
            if route.wants_query:
                kwargs["query"] = dict(
                    parse_qsl(query_string.decode("latin-1"),
                              keep_blank_values=True)
                )
            if route.body_model is not None:
                try:
                    payload = json.loads(body or b"{}")
                except json.JSONDecodeError:
                    return JSONResponse({"detail": "Invalid JSON body"}, 400)
                try:
                    kwargs["data"] = route.body_model.model_validate(payload)
                except pydantic.ValidationError as e:
                    return JSONResponse(
                        {"detail": "Validation failed", "extra": e.errors(include_url=False)},
                        422,
                    )
            try:
                result = await route.handler(**kwargs)
            except HTTPException as e:
                return JSONResponse({"detail": e.detail}, e.status_code)
            except Exception as e:  # noqa: BLE001 — server boundary
                log.error("Handler error on %s %s: %s", method, path, e)
                return JSONResponse({"detail": f"Internal Server Error: {e}"}, 500)
            if isinstance(result, Response):
                return result
            return JSONResponse(result)
        if path_matched:
            return JSONResponse({"detail": "Method Not Allowed"}, 405)
        return JSONResponse({"detail": "Not Found"}, 404)

    # -- ASGI ----------------------------------------------------------------

    async def __call__(self, scope, receive, send):
        if scope["type"] == "lifespan":
            while True:
                message = await receive()
                if message["type"] == "lifespan.startup":
                    await send({"type": "lifespan.startup.complete"})
                elif message["type"] == "lifespan.shutdown":
                    await send({"type": "lifespan.shutdown.complete"})
                    return
        if scope["type"] != "http":
            return
        # Reject oversized bodies BEFORE buffering: first via the declared
        # Content-Length, then while draining (a chunked request carries no
        # length up front). 413 per RFC 9110 §15.5.14.
        too_large = False
        for k, v in scope.get("headers") or []:
            if k == b"content-length":
                try:
                    too_large = int(v) > self.max_body_bytes
                except ValueError:
                    pass
        body = b""
        while not too_large:
            message = await receive()
            body += message.get("body", b"")
            if len(body) > self.max_body_bytes:
                too_large = True
                break
            if not message.get("more_body"):
                break
        if too_large:
            resp = JSONResponse(
                {"detail": f"Request body exceeds {self.max_body_bytes} bytes"},
                413,
            )
        else:
            resp = await self._dispatch(
                scope["method"], scope["path"], body,
                query_string=scope.get("query_string", b""),
            )
        headers = [(b"content-type", resp.media_type.encode())]
        headers += [(k.encode(), v.encode()) for k, v in resp.headers.items()]
        await send(
            {"type": "http.response.start", "status": resp.status_code, "headers": headers}
        )
        if isinstance(resp, Stream):
            if hasattr(resp.chunks, "__aiter__"):
                # Async generator: chunks arrive as upstream work completes
                # (true streaming — the event loop stays free in between).
                async for chunk in resp.chunks:
                    await send(
                        {"type": "http.response.body", "body": chunk, "more_body": True}
                    )
            else:
                # Blocking iterator: pull each piece on a worker thread so a
                # slow producer can't stall the event loop.
                from anyio import to_thread

                it = iter(resp.chunks)
                sentinel = object()
                while True:
                    chunk = await to_thread.run_sync(next, it, sentinel)
                    if chunk is sentinel:
                        break
                    await send(
                        {"type": "http.response.body", "body": chunk, "more_body": True}
                    )
            await send({"type": "http.response.body", "body": b"", "more_body": False})
        else:
            await send({"type": "http.response.body", "body": resp.body})
        if resp.background is not None:
            try:
                await resp.background()
            except Exception as e:  # noqa: BLE001 — background best-effort
                log.warning("Background task failed: %s", e)


def openapi_schema(
    app: App,
    title: str = "API",
    version: str = "1.0.0",
    description: str = "",
) -> dict:
    """OpenAPI 3.1 document assembled from the route table.

    Litestar auto-generates this surface for the reference
    (``vietvoicetts/api/app.py:166-168`` → ``/schema``);
    here the same machine-readable contract comes from the registered
    routes: request bodies and typed responses from the pydantic models'
    ``model_json_schema()`` (shared ``$defs`` hoisted into
    ``components.schemas``), path parameters from the route templates.
    """
    components: Dict[str, Any] = {}

    def _ref_schema(model) -> dict:
        schema = model.model_json_schema(
            ref_template="#/components/schemas/{model}"
        )
        for name, sub in schema.pop("$defs", {}).items():
            if name in components and components[name] != sub:
                log.warning(
                    "OpenAPI component name collision on %r; keeping the "
                    "first registration — rename one of the models",
                    name,
                )
            components.setdefault(name, sub)
        if model.__name__ in components and components[model.__name__] != schema:
            log.warning(
                "OpenAPI component name collision on %r; keeping the first "
                "registration — rename one of the models",
                model.__name__,
            )
        components.setdefault(model.__name__, schema)
        return {"$ref": f"#/components/schemas/{model.__name__}"}

    paths: Dict[str, dict] = {}
    for route in app.routes:
        op: Dict[str, Any] = {
            "operationId": f"{route.method.lower()}_{route.handler.__name__}",
            "summary": (inspect.getdoc(route.handler) or "").split("\n")[0],
        }
        params = _PARAM_RE.findall(route.path)  # [(name, kind), ...]
        if params:
            _json_types = {"int": "integer", "float": "number"}
            op["parameters"] = [
                {
                    "name": name,
                    "in": "path",
                    "required": True,
                    "schema": {"type": _json_types.get(kind, "string")},
                }
                for name, kind in params
            ]
        if route.body_model is not None:
            op["requestBody"] = {
                "required": True,
                "content": {
                    "application/json": {"schema": _ref_schema(route.body_model)}
                },
            }
            op["responses"] = {
                "422": {"description": "Validation failed"},
            }
        responses = op.setdefault("responses", {})
        if route.response_model is not None:
            responses["200"] = {
                "description": "Successful response",
                "content": {
                    "application/json": {"schema": _ref_schema(route.response_model)}
                },
            }
        else:
            responses.setdefault("200", {"description": "Successful response"})
        # Strip converter suffixes from the template — OpenAPI path keys use
        # plain ``{name}``, never ``{name:int}``.
        oas_path = _PARAM_RE.sub(lambda m: "{%s}" % m.group(1), route.path)
        paths.setdefault(oas_path, {})[route.method.lower()] = op

    return {
        "openapi": "3.1.0",
        "info": {"title": title, "version": version, "description": description},
        "paths": paths,
        "components": {"schemas": components},
    }


# Backwards-compatible re-exports: the in-process client grew up in this
# module; it now lives in api/testing.py so the production surface carries
# no test machinery.
from .testing import AsyncTestClient, TestResponse  # noqa: E402,F401
