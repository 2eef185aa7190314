"""Dependency-free WAV read/write.

A copy of ``vietvoice_tts_tpu/utils/wavio.py``: RIFF/WAVE(+WAVEX) parsing and
writing on top of ``struct``+numpy, shelling out to ``ffmpeg`` only when a
non-WAV container is encountered *and* the binary exists.
"""

from __future__ import annotations

import io
import shutil
import struct
import subprocess
import tempfile
from pathlib import Path

import numpy as np

WAVE_FORMAT_PCM = 0x0001
WAVE_FORMAT_IEEE_FLOAT = 0x0003
WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def _parse_wav(data: bytes) -> tuple[np.ndarray, int]:
    """Parse a RIFF/WAVE byte buffer → (samples [n, channels], sample_rate).

    Supports PCM 16/24/32-bit, IEEE float 32/64, and WAVEX extensible headers.
    """
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("Not a RIFF/WAVE file")
    pos = 12
    fmt = None
    raw = None
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        (chunk_size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8 : pos + 8 + chunk_size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
            if fmt[0] == WAVE_FORMAT_EXTENSIBLE and chunk_size >= 40:
                # SubFormat GUID's first two bytes carry the real format tag
                (sub_format,) = struct.unpack_from("<H", body, 24)
                fmt = (sub_format,) + fmt[1:]
        elif chunk_id == b"data":
            raw = body
        pos += 8 + chunk_size + (chunk_size & 1)
    if fmt is None or raw is None:
        raise ValueError("WAV missing fmt or data chunk")
    format_tag, channels, sample_rate, _, _, bits = fmt
    if format_tag == WAVE_FORMAT_PCM:
        if bits == 16:
            samples = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            samples = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            ints = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
            samples = ints.astype(np.float32) / float(1 << 23)
        elif bits == 8:
            samples = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"Unsupported PCM bit depth: {bits}")
    elif format_tag == WAVE_FORMAT_IEEE_FLOAT:
        dtype = "<f4" if bits == 32 else "<f8"
        samples = np.frombuffer(raw, dtype=dtype).astype(np.float32)
    else:
        raise ValueError(f"Unsupported WAV format tag: {format_tag:#x}")
    if channels > 1:
        samples = samples[: len(samples) - len(samples) % channels]
        samples = samples.reshape(-1, channels)
    else:
        samples = samples.reshape(-1, 1)
    return samples, sample_rate


def _ffmpeg_decode(data: bytes, suffix: str = "") -> tuple[np.ndarray, int]:
    """Decode a non-WAV container via the ffmpeg binary, if present."""
    if shutil.which("ffmpeg") is None:
        raise RuntimeError(
            "Cannot decode non-WAV audio: ffmpeg binary not found. "
            "Provide a .wav file instead."
        )
    with tempfile.NamedTemporaryFile(suffix=suffix or ".bin") as src:
        src.write(data)
        src.flush()
        out = subprocess.run(
            ["ffmpeg", "-v", "error", "-i", src.name, "-f", "wav", "-"],
            capture_output=True,
            check=True,
        ).stdout
    return _parse_wav(out)


def read_wav(path_or_bytes: str | bytes | Path) -> tuple[np.ndarray, int]:
    """Read audio → (float32 samples [n, channels] in [-1, 1], sample_rate).

    WAV is parsed natively; other containers fall back to ffmpeg.
    """
    if isinstance(path_or_bytes, (str, Path)):
        p = Path(path_or_bytes)
        if not p.exists():
            raise FileNotFoundError(f"Audio file not found: {path_or_bytes}")
        data = p.read_bytes()
        suffix = p.suffix
    else:
        data = path_or_bytes
        suffix = ""
    try:
        return _parse_wav(data)
    except ValueError:
        return _ffmpeg_decode(data, suffix)


def wav_bytes(samples: np.ndarray, sample_rate: int) -> bytes:
    """Encode int16 (or float32 in [-1,1]) samples as 16-bit PCM WAV bytes."""
    samples = np.asarray(samples)
    if samples.dtype != np.int16:
        samples = np.clip(samples, -1.0, 1.0)
        samples = (samples * 32767.0).astype(np.int16)
    samples = samples.reshape(-1)
    data = samples.tobytes()
    channels = 1
    byte_rate = sample_rate * channels * 2
    buf = io.BytesIO()
    buf.write(b"RIFF")
    buf.write(struct.pack("<I", 36 + len(data)))
    buf.write(b"WAVE")
    buf.write(b"fmt ")
    buf.write(
        struct.pack(
            "<IHHIIHH", 16, WAVE_FORMAT_PCM, channels, sample_rate, byte_rate, 2, 16
        )
    )
    buf.write(b"data")
    buf.write(struct.pack("<I", len(data)))
    buf.write(data)
    return buf.getvalue()


def wav_stream_header(sample_rate: int) -> bytes:
    """44-byte PCM WAV header for a stream of unknown length.

    RIFF/data sizes are 0xFFFFFFFF — the conventional open-ended marker that
    players and browsers treat as "read until the connection closes". Append
    raw little-endian int16 PCM after it (chunked HTTP transfer)."""
    channels = 1
    byte_rate = sample_rate * channels * 2
    buf = io.BytesIO()
    buf.write(b"RIFF")
    buf.write(struct.pack("<I", 0xFFFFFFFF))
    buf.write(b"WAVE")
    buf.write(b"fmt ")
    buf.write(
        struct.pack(
            "<IHHIIHH", 16, WAVE_FORMAT_PCM, channels, sample_rate, byte_rate, 2, 16
        )
    )
    buf.write(b"data")
    buf.write(struct.pack("<I", 0xFFFFFFFF))
    return buf.getvalue()


def write_wav(samples: np.ndarray, path: str | Path, sample_rate: int) -> None:
    """Write samples to a 16-bit PCM WAV file, creating parent dirs."""
    if np.asarray(samples).size == 0:
        raise ValueError("Cannot save empty audio.")
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_bytes(wav_bytes(samples, sample_rate))
