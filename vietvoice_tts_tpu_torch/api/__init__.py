"""Async REST API (port of ``vietvoice_tts_tpu/api``).

The reference Litestar app's routes and schemas
(``vietvoicetts/api/app.py:37-168``) plus streaming, stats, voices and
metrics, served by a dependency-free ASGI micro-framework (``asgi.py``). Any
ASGI server (uvicorn/hypercorn) can host ``app``; ``server.py`` also ships a
stdlib server. The engine runs on ``VIETVOICE_DEVICE`` (default ``cuda``).
"""

from .app import app

__all__ = ["app"]
