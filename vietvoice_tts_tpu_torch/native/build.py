"""Build the native audio DSP shared library at first use.

``audio_kernels.cpp`` is compiled by ``g++`` into
``build/vietvoice_tts_tpu_torch/`` at the root of the checkout (beside the
package directory), as the CUDA kernels are (``ops/kernels/build.py``). The
library's file name carries a hash of its source and the flags, so an edited
source is rebuilt and a built one is reused. Nothing is built when a module
is imported.

Usage: ``python -m vietvoice_tts_tpu_torch.native.build`` builds it ahead of
use and prints its path.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from ..utils.logging import get_logger

log = get_logger("native.build")

HERE = Path(__file__).resolve().parent
SRC = HERE / "audio_kernels.cpp"
BUILD_DIR = HERE.parents[1] / "build" / HERE.parent.name
# No -march=native: the library must load on any x86-64 host the checkout
# is copied to, and the float arithmetic must not depend on the host's FMA.
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def find_gxx() -> str | None:
    """Path of ``g++``, or None where the host has no C++ compiler."""
    return shutil.which("g++")


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libvvaudio-{h.hexdigest()[:16]}.so"


def build() -> Path | None:
    """Build the library if needed and return its path; None without
    ``g++``. A failing build raises: with a compiler present, the numpy path
    must not silently stand in for a broken library. Callers in one process
    are serialized by ``audio_native``."""
    out = library_path()
    if out.exists():
        return out
    gxx = find_gxx()
    if gxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Compile to a temporary name, then rename: a concurrent process never
    # loads a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [gxx, *GXX_FLAGS, str(SRC), "-o", tmp], capture_output=True, text=True
        )
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed building {SRC.name}:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    log.info("Built %s in %.1fs", out, time.perf_counter() - t0)
    return out


if __name__ == "__main__":
    path = build()
    if path is None:
        print("g++ not found; the numpy path serves", file=sys.stderr)
        sys.exit(1)
    print(path)
