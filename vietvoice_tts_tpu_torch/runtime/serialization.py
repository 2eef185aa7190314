"""Parameter (de)serialization for the weight pack, without flax or msgpack.

The pack's ``params.msgpack`` is written by ``flax.serialization`` in the
JAX package (``vietvoice_tts_tpu/runtime/serialization.py``). That format is
plain msgpack in which every numpy array is msgpack ext type 1 holding
``packb((shape, dtype_name, raw_bytes))`` and every numpy scalar is ext type
3 with the same payload. This module reads and writes that subset of
msgpack itself — maps, arrays, str, bin, int, float, bool, nil and ext 1/3 —
so the port loads the same packs on a machine that has neither package.

Flax splits arrays above 1 GiB into a chunked-array map; no pack of this
model has such a leaf, and reading one raises.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
_CHUNKED_MARKER = "__msgpack_chunked_array__"


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


def _pack_len(out: list, n: int, fix_base: int | None, fix_max: int, codes) -> None:
    """Header for a length-prefixed type: fix form, then 8/16/32-bit forms."""
    if fix_base is not None and n <= fix_max:
        out.append(bytes([fix_base | n]))
        return
    for code, fmt, limit in codes:
        if n < limit:
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise ValueError(f"msgpack length {n} too large")


_STR_CODES = ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16), (0xDB, ">I", 1 << 32))
_BIN_CODES = ((0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16), (0xC6, ">I", 1 << 32))
_ARRAY_CODES = ((0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32))
_MAP_CODES = ((0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _pack_int(out: list, v: int) -> None:
    if 0 <= v < 128:
        out.append(bytes([v]))
    elif -32 <= v < 0:
        out.append(struct.pack(">b", v))
    elif v >= 0:
        for code, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                 (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < limit:
                out.append(bytes([code]) + struct.pack(fmt, v))
                return
        raise ValueError(f"integer {v} too large for msgpack")
    else:
        for code, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                 (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if v >= -limit:
                out.append(bytes([code]) + struct.pack(fmt, v))
                return
        raise ValueError(f"integer {v} too small for msgpack")


def _pack_ext(out: list, code: int, data: bytes) -> None:
    n = len(data)
    if n in _FIXEXT:
        out.append(bytes([_FIXEXT[n], code]))
    else:
        for hdr, fmt, limit in ((0xC7, ">B", 1 << 8), (0xC8, ">H", 1 << 16),
                                (0xC9, ">I", 1 << 32)):
            if n < limit:
                out.append(bytes([hdr]) + struct.pack(fmt, n) + bytes([code]))
                break
        else:
            raise ValueError(f"ext payload of {n} bytes too large")
    out.append(data)


def _array_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError(f"cannot serialize arrays of dtype {arr.dtype}")
    return packb((list(arr.shape), arr.dtype.name, np.ascontiguousarray(arr).tobytes()))


def _pack(out: list, obj: Any) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, EXT_NDARRAY, _array_payload(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _array_payload(np.asarray(obj)))
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(out, len(data), 0xA0, 31, _STR_CODES)
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(out, len(data), None, 0, _BIN_CODES)
        out.append(data)
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 15, _ARRAY_CODES)
        for item in obj:
            _pack(out, item)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 15, _MAP_CODES)
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """msgpack-encode ``obj`` (dict/list/tuple/str/bytes/int/float/bool/None
    and numpy arrays or scalars, the latter as flax's ext types 1/3)."""
    out: list = []
    _pack(out, obj)
    return b"".join(out)


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, data, raw: bool = False):
        self.buf = memoryview(data)
        self.pos = 0
        # flax's inner array header: str as bytes, bin as a memoryview.
        self.raw = raw

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        view = self.buf[self.pos : self.pos + n]
        self.pos += n
        return view

    def _uint(self, fmt: str, n: int) -> int:
        return struct.unpack(fmt, self._take(n))[0]

    def _str(self, n: int):
        data = bytes(self._take(n))
        return data if self.raw else data.decode("utf-8")

    def _ext(self, n: int):
        code = struct.unpack(">b", self._take(1))[0]
        payload = self._take(n)
        if code == EXT_NDARRAY:
            return _array_from_payload(payload)
        if code == EXT_NPSCALAR:
            return _array_from_payload(payload)[()]
        raise ValueError(f"unsupported msgpack ext type {code}")

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        if _CHUNKED_MARKER in out:
            raise ValueError(
                "weight pack holds a flax chunked array (a leaf above 1 GiB); "
                "this reader does not support chunked arrays"
            )
        return out

    def read(self):
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in (0xC4, 0xC5, 0xC6):
            n = self._uint(*{0xC4: (">B", 1), 0xC5: (">H", 2), 0xC6: (">I", 4)}[b])
            view = self._take(n)
            # Array payloads stay views of the file's bytes (no copy).
            return view if self.raw else bytes(view)
        if b in (0xC7, 0xC8, 0xC9):
            n = self._uint(*{0xC7: (">B", 1), 0xC8: (">H", 2), 0xC9: (">I", 4)}[b])
            return self._ext(n)
        if b == 0xCA:
            return struct.unpack(">f", self._take(4))[0]
        if b == 0xCB:
            return struct.unpack(">d", self._take(8))[0]
        if 0xCC <= b <= 0xCF:
            fmt, n = {0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8)}[b]
            return self._uint(fmt, n)
        if 0xD0 <= b <= 0xD3:
            fmt, n = {0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8)}[b]
            return self._uint(fmt, n)
        if 0xD4 <= b <= 0xD8:
            return self._ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            n = self._uint(*{0xD9: (">B", 1), 0xDA: (">H", 2), 0xDB: (">I", 4)}[b])
            return self._str(n)
        if b in (0xDC, 0xDD):
            return self._array(self._uint(*{0xDC: (">H", 2), 0xDD: (">I", 4)}[b]))
        if b in (0xDE, 0xDF):
            return self._map(self._uint(*{0xDE: (">H", 2), 0xDF: (">I", 4)}[b]))
        raise ValueError(f"unsupported msgpack type byte {b:#x}")


def _array_from_payload(payload) -> np.ndarray:
    shape, dtype_name, buffer = _Reader(payload, raw=True).read()
    name = dtype_name.decode() if isinstance(dtype_name, bytes) else dtype_name
    if name == "bfloat16":
        raise ValueError("bfloat16 arrays in a weight pack are not supported")
    return np.frombuffer(buffer, dtype=np.dtype(name)).reshape(shape)


def unpackb(data) -> Any:
    """Decode one msgpack object (the subset :func:`packb` writes)."""
    reader = _Reader(data)
    obj = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after msgpack object")
    return obj


# ---------------------------------------------------------------------------
# Pack files
# ---------------------------------------------------------------------------


def _sorted_keys(tree):
    """Dicts re-keyed in sorted order, as flax's pytree copy leaves them."""
    if isinstance(tree, dict):
        return {k: _sorted_keys(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_sorted_keys(v) for v in tree]
    return tree


def save_params(path: str | Path, params) -> None:
    """Write a pytree of numpy arrays as flax's msgpack (the same bytes
    ``flax.serialization.msgpack_serialize`` writes)."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_bytes(packb(_sorted_keys(params)))


def load_params(path: str | Path):
    """Read a flax-msgpack pytree; arrays come back as read-only numpy views."""
    return unpackb(Path(path).read_bytes())
