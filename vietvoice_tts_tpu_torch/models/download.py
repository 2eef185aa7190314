"""Reference-tarball downloader (parity with the reference's model fetch).

The reference's first action on a fresh machine is downloading
``model-bin.pt`` from HuggingFace with a progress hook, cache-reuse, and
partial-download cleanup
(``vietvoicetts/core/model_config.py:71-104``). This module
is that capability for the PyTorch port (a copy of
``vietvoice_tts_tpu/models/download.py``), hardened for the multi-GB file it
actually fetches:

- staged download to ``<target>.partial`` with an **atomic rename** on
  completion — a crashed download can never masquerade as a complete
  tarball (the reference's ``urlretrieve`` straight to the final path can);
- **resume** via HTTP ``Range`` when a ``.partial`` exists and the server
  honors it (HF does); a server that ignores the range restarts cleanly;
- progress logged at whole-percent steps (the reference's hook granularity)
  plus byte counts when the length is unknown;
- the ``.partial`` is kept on network errors (so a retry resumes) and
  removed on corrupt/unexpected states.

CLI (also the conversion-day entry — chains straight into preflight)::

    python -m vietvoice_tts_tpu_torch.models.download [--url U] [--dest models/model-bin.pt] [--preflight]
"""

from __future__ import annotations

import http.client
import json
import re
import urllib.error
import urllib.parse
import urllib.request
from pathlib import Path
from typing import Callable, Optional

from ..utils.logging import get_logger

log = get_logger("download")

# The reference's model home (core/model_config.py:25): the real tarball the
# conversion runbook consumes.
DEFAULT_MODEL_URL = (
    "https://huggingface.co/nguyenvulebinh/VietVoice-TTS/resolve/main/model-bin.pt"
)
DEFAULT_MODEL_FILENAME = "model-bin.pt"

_CHUNK = 1 << 20  # 1 MiB read granularity


def _log_progress(done: int, total: Optional[int], state: dict) -> None:
    if total:
        pct = min(100, done * 100 // total)
        if pct != state.get("pct"):
            state["pct"] = pct
            log.info("Downloading: %d%% (%d/%d bytes)", pct, done, total)
    else:
        mb = done >> 20
        if mb != state.get("mb") and mb % 64 == 0:
            state["mb"] = mb
            log.info("Downloading: %d MiB (total size unknown)", mb)


def ensure_model_downloaded(
    url: str = DEFAULT_MODEL_URL,
    dest: str | Path = Path("models") / DEFAULT_MODEL_FILENAME,
    resume: bool = True,
    progress: Optional[Callable[[int, Optional[int]], None]] = None,
    opener: Callable = urllib.request.urlopen,
) -> Path:
    """Return the local tarball path, downloading it first when absent.

    ``progress(bytes_done, total_or_None)`` overrides the default log-line
    progress; ``opener`` is injectable for tests. Raises ``RuntimeError`` on
    network failure (the ``.partial`` survives for a resumed retry when
    ``resume``; otherwise it is removed, matching the reference's
    partial-download cleanup).
    """
    dest = Path(dest).expanduser()
    if dest.exists():
        log.info("Using cached model: %s", dest)
        return dest
    dest.parent.mkdir(parents=True, exist_ok=True)
    partial = dest.with_suffix(dest.suffix + ".partial")
    # Sidecar with the server's validator (ETag / Last-Modified) captured when
    # the .partial was started. A resume sends it back as ``If-Range``: if the
    # remote file changed between attempts the server replies 200 (full body)
    # instead of 206 and the restart branch below discards the stale bytes —
    # without this, a ranged continuation of a changed file silently splices
    # two versions into one corrupt tarball.
    meta_path = partial.with_suffix(partial.suffix + ".meta")

    offset = partial.stat().st_size if (resume and partial.exists()) else 0
    if not resume and partial.exists():
        partial.unlink()
        meta_path.unlink(missing_ok=True)

    headers = {"User-Agent": "vietvoice-tts-tpu/1.0"}
    if offset:
        headers["Range"] = f"bytes={offset}-"
        validator = None
        if meta_path.exists():
            try:
                meta = json.loads(meta_path.read_text())
                validator = meta.get("etag") or meta.get("last_modified")
            except (OSError, ValueError):
                pass
        if validator:
            headers["If-Range"] = validator
        log.info("Resuming download at byte %d: %s", offset, url)
    else:
        log.info("Downloading model from %s", url)
    log.info("Saving to %s", dest)

    state: dict = {}
    report = progress or (lambda done, total: _log_progress(done, total, state))

    try:
        req = urllib.request.Request(url, headers=headers)
        with opener(req) as resp:
            status = getattr(resp, "status", 200)
            resp_headers = getattr(resp, "headers", {}) or {}
            length = resp_headers.get("Content-Length")
            if offset and status != 206:
                # Server ignored the range (or If-Range said the file
                # changed) — restart from scratch.
                log.info("Server does not support resume; restarting download")
                offset = 0
                partial.unlink(missing_ok=True)
                meta_path.unlink(missing_ok=True)
            elif offset:
                # Cross-check the 206 Content-Range start against our offset:
                # a mismatched continuation would corrupt the file silently.
                # The mismatched RANGED body must not be consumed either —
                # it starts at the server's offset, not byte 0 — so restart
                # with a FRESH request (like the 416 branch), never by
                # falling through to write this response from scratch.
                rng = resp_headers.get("Content-Range", "")
                m = re.match(r"bytes (\d+)-", rng)
                if m and int(m.group(1)) != offset:
                    log.info(
                        "Content-Range start %s != partial size %d; restarting",
                        m.group(1),
                        offset,
                    )
                    partial.unlink(missing_ok=True)
                    meta_path.unlink(missing_ok=True)
                    return ensure_model_downloaded(
                        url=url, dest=dest, resume=resume,
                        progress=progress, opener=opener,
                    )
            if not offset:
                # Record the validator for a future resume of this .partial.
                validators = {
                    "etag": resp_headers.get("ETag"),
                    "last_modified": resp_headers.get("Last-Modified"),
                }
                if any(validators.values()):
                    meta_path.write_text(json.dumps(validators))
            total = (int(length) + offset) if length else None
            mode = "ab" if offset else "wb"
            done = offset
            with open(partial, mode) as out:
                while True:
                    chunk = resp.read(_CHUNK)
                    if not chunk:
                        break
                    out.write(chunk)
                    done += len(chunk)
                    report(done, total)
            if total is not None and done != total:
                # Short read without an exception: treat as failure but keep
                # the partial — a retry resumes from here.
                raise urllib.error.URLError(
                    f"connection closed early ({done}/{total} bytes)"
                )
    except urllib.error.HTTPError as e:
        if e.code == 416 and offset:
            # Range past EOF: the partial may already BE the whole file
            # (crash between the last write and the rename). 416 carries
            # the real size in Content-Range ("bytes */<total>") — finish
            # the rename when it matches, restart clean otherwise.
            rng = (getattr(e, "headers", {}) or {}).get("Content-Range", "")
            total_s = rng.rpartition("/")[2]
            if total_s.isdigit() and offset == int(total_s):
                log.info("Partial download was already complete; finalizing")
                partial.rename(dest)
                meta_path.unlink(missing_ok=True)
                return dest
            log.info("Stale .partial (server size %s ≠ %d); restarting", total_s or "?", offset)
            partial.unlink(missing_ok=True)
            meta_path.unlink(missing_ok=True)
            return ensure_model_downloaded(
                url=url, dest=dest, resume=resume, progress=progress, opener=opener
            )
        if not resume:
            partial.unlink(missing_ok=True)
        raise RuntimeError(
            f"Failed to download model from {url}: {e} "
            + ("(partial kept for resume)" if resume and partial.exists() else "")
        ) from e
    except (urllib.error.URLError, OSError, http.client.HTTPException, TimeoutError) as e:
        # Network-class failures (URLError, connection resets — OSError
        # subclasses — short bodies, timeouts): keep the partial so a retry
        # RESUMES, per the module contract.
        if not resume:
            partial.unlink(missing_ok=True)
        raise RuntimeError(
            f"Failed to download model from {url}: {e} "
            + ("(partial kept for resume)" if resume and partial.exists() else "")
        ) from e
    except Exception as e:  # noqa: BLE001 — reference parity: clean up partials
        partial.unlink(missing_ok=True)
        meta_path.unlink(missing_ok=True)
        raise RuntimeError(f"Failed to download model: {e}") from e

    partial.rename(dest)
    meta_path.unlink(missing_ok=True)
    log.info("Model downloaded successfully to %s", dest)
    return dest


def resolve_tarball(
    source: str | Path,
    cache_dir: str | Path = "models",
    opener: Callable = urllib.request.urlopen,
) -> Path:
    """A local path stays a path; an http(s) URL is downloaded to the cache.

    The convert CLI accepts either, so conversion day is one command
    whether the tarball was hand-copied or must be fetched."""
    s = str(source)
    if s.startswith(("http://", "https://")):
        name = Path(urllib.parse.urlparse(s).path).name or DEFAULT_MODEL_FILENAME
        return ensure_model_downloaded(
            url=s, dest=Path(cache_dir) / name, opener=opener
        )
    return Path(source)


def main(argv=None) -> int:  # pragma: no cover — thin CLI
    import argparse
    import sys

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--url", default=DEFAULT_MODEL_URL)
    ap.add_argument(
        "--dest", default=str(Path("models") / DEFAULT_MODEL_FILENAME)
    )
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument(
        "--preflight",
        action="store_true",
        help="run the conversion preflight on the downloaded tarball",
    )
    args = ap.parse_args(argv)
    path = ensure_model_downloaded(
        url=args.url, dest=args.dest, resume=not args.no_resume
    )
    print(path)
    if args.preflight:
        from .preflight import main as preflight_main

        return preflight_main([str(path)])
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
