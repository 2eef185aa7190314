"""ctypes binding for the C++ audio DSP library (``audio_kernels.cpp``).

:func:`available` builds the library at first use (``build.py``) and is
False only where the host has no ``g++``; then callers in
``pipeline/audio.py`` keep their numpy paths. A build that fails raises.
``joins`` counts the pairwise joins the library made, so a run can show
that the native path served.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from .build import build

_lib = None
_loaded = False
_lock = threading.Lock()

joins = 0  # wave pairs joined by the library in this process; callers may reset it


def _load():
    global _lib, _loaded
    with _lock:
        if not _loaded:
            path = build()
            if path is not None:
                lib = ctypes.CDLL(str(path))
                lib.vv_crossfade_concat.restype = ctypes.c_longlong
                lib.vv_crossfade_concat.argtypes = [
                    ctypes.POINTER(ctypes.POINTER(ctypes.c_int16)),  # waves
                    ctypes.POINTER(ctypes.c_longlong),  # lengths
                    ctypes.c_int,  # n_waves
                    ctypes.c_int,  # crossfade samples
                    ctypes.POINTER(ctypes.c_int16),  # out buffer
                ]
                _lib = lib
            _loaded = True
    return _lib


def available() -> bool:
    return _load() is not None


def crossfade_concat(
    waves: list[np.ndarray], cross_fade_duration: float, sample_rate: int
) -> np.ndarray:
    """Equal-power RMS-matched cross-fade concat (C++ hot path)."""
    global joins
    lib = _load()
    if lib is None:
        raise RuntimeError("the native audio library is not available (no g++)")
    waves = [np.ascontiguousarray(w, dtype=np.int16) for w in waves]
    n = len(waves)
    arr_type = ctypes.POINTER(ctypes.c_int16) * n
    ptrs = arr_type(*[w.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)) for w in waves])
    lens = (ctypes.c_longlong * n)(*[len(w) for w in waves])
    total = sum(len(w) for w in waves)
    out = np.zeros(total, np.int16)
    cf = int(cross_fade_duration * sample_rate)
    written = lib.vv_crossfade_concat(
        ptrs, lens, n, cf, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))
    )
    joins += max(n - 1, 0)
    return out[:written]
