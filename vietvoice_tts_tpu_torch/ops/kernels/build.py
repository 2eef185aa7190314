"""Build the package's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` has a plain C entry point and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``build/vietvoice_tts_tpu_torch/`` at
the root of the checkout (beside the package directory), then loaded with
``ctypes``. The library's file name carries a hash of its source, the
headers beside it (``csrc/*.cuh``) and the flags, so an edited source is
rebuilt and a built one is reused. Different libraries may build at the same
time (one lock per name). Nothing is built
when a module is imported: the CPU tests import every module on machines
without ``nvcc``.

``ptxas`` reports each kernel's registers, shared memory and spills
(``-Xptxas -v``); the report is kept beside the library (``.log``) and any
warning in it is logged. :func:`count_sass` counts instructions of the built
code, which is how a run shows that the bfloat16 paths are on the tensor
cores (``HGMMA`` is the machine instruction behind ``wgmma``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

from ...utils.logging import get_logger

log = get_logger("kernels.build")

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / PACKAGE_DIR.name
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()  # guards the two dicts below
_build_locks: dict[str, threading.Lock] = {}
_libraries: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, under $CUDA_HOME, or /usr/local/cuda."""
    candidates = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        candidates.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and Path(c).is_file():
            return c
    raise RuntimeError(
        "nvcc not found (searched PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
        "the CUDA kernels cannot be built"
    )


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and return the loaded library."""
    with _lock:
        build_lock = _build_locks.setdefault(name, threading.Lock())
    with build_lock:
        lib = _libraries.get(name)
        if lib is not None:
            return lib
        out = library_path(name)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            cmd = [find_nvcc(), *NVCC_FLAGS, str(CSRC_DIR / f"{name}.cu")]
            # Compile to a temporary name, then rename: a concurrent process
            # never loads a half-written library.
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            t0 = time.perf_counter()
            try:
                proc = subprocess.run(
                    [*cmd, "-o", tmp], capture_output=True, text=True
                )
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed building {name}.cu:\n{proc.stderr}"
                    )
                out.with_suffix(".log").write_text(proc.stderr)
                for line in proc.stderr.splitlines():
                    if "warning" in line.lower():
                        log.warning("nvcc, %s.cu: %s", name, line)
                os.replace(tmp, out)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            log.info("Built %s in %.1fs", out, time.perf_counter() - t0)
        lib = ctypes.CDLL(str(out))
        _libraries[name] = lib
        return lib


def is_loaded(name: str) -> bool:
    """Whether ``csrc/<name>.cu`` is built and loaded in this process."""
    with _lock:
        return name in _libraries


def build_report(name: str) -> str:
    """What ``ptxas -v`` said when ``csrc/<name>.cu`` was built (registers,
    shared memory and spills of each kernel); builds it if needed."""
    load_library(name)
    return library_path(name).with_suffix(".log").read_text()


def count_sass(name: str, mnemonic: str) -> int:
    """How many machine instructions of the built ``csrc/<name>.cu`` carry
    ``mnemonic`` (``cuobjdump -sass``, from the toolkit that holds ``nvcc``)."""
    load_library(name)
    cuobjdump = Path(find_nvcc()).with_name("cuobjdump")
    proc = subprocess.run(
        [str(cuobjdump), "-sass", str(library_path(name))],
        capture_output=True, text=True, check=True,
    )
    return sum(mnemonic in line for line in proc.stdout.splitlines())
