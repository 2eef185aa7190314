"""Server settings from environment / .env file.

A copy of ``vietvoice_tts_tpu/api/settings.py`` with two more variables
(``VIETVOICE_DEVICE``, ``VIETVOICE_MICRO_BATCHING``). Counterpart of the
reference's pydantic-settings module
(``vietvoicetts/api/settings.py:4-11``); pydantic-settings is
not a dependency here, so a small explicit loader reads the same two variables
(``TMP_DIR_PATH``, ``FILE_LIFESPAN_SECONDS``) from a ``.env`` file and the
process environment (environment wins).
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path


def _load_dotenv(path: str = ".env") -> dict[str, str]:
    values: dict[str, str] = {}
    p = Path(path)
    if p.exists():
        for line in p.read_text(encoding="utf-8").splitlines():
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            key, _, val = line.partition("=")
            values[key.strip()] = val.strip().strip("\"'")
    return values


class Settings:
    """Application configuration."""

    def __init__(self) -> None:
        env = {**_load_dotenv(), **os.environ}
        self.TMP_DIR_PATH = Path(
            env.get("TMP_DIR_PATH", Path(tempfile.gettempdir()) / "vietvoice_tts_cache")
        )
        self.FILE_LIFESPAN_SECONDS = int(env.get("FILE_LIFESPAN_SECONDS", "4800"))
        # Load the model and run every serving shape once at server startup
        # (background thread) instead of on the first request.
        self.WARMUP_ON_START = env.get("WARMUP_ON_START", "0").lower() in (
            "1", "true", "yes",
        )
        # The SERVER defaults to refusing synthetic (seeded-random) weight
        # packs: a misconfigured deployment would otherwise serve noise with
        # HTTP 200. Offline demos opt in with VIETVOICE_ALLOW_SYNTHETIC=1;
        # the CLI keeps the permissive library default (config.py).
        self.ALLOW_SYNTHETIC = env.get("VIETVOICE_ALLOW_SYNTHETIC", "0").lower() in (
            "1", "true", "yes",
        )
        # Where the server's engine runs. The default asks for the card and
        # the server fails without one; VIETVOICE_DEVICE=cpu is for tests.
        self.DEVICE = env.get("VIETVOICE_DEVICE", "cuda")
        # Concurrent requests share device batches through the micro-batcher
        # (serving/batcher.py); VIETVOICE_MICRO_BATCHING=0 runs every request
        # as its own batches.
        self.MICRO_BATCHING = env.get("VIETVOICE_MICRO_BATCHING", "1").lower() in (
            "1", "true", "yes",
        )


settings = Settings()
