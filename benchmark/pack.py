"""The weight pack and voice catalogue that the program loads, written from
the benchmark's own weights and clips.

Layout of a pack directory, as the program's loader reads it::

    params.msgpack       flax-format msgpack {'dit': ..., 'vocoder': ...}
    model_meta.json      the sizes, the backbone's from its architecture module
                         (``benchmark/archs/``); "synthetic": true
    vocab.txt            one character a line
    audio_metadata.json  the voice catalogue
    audios/*.wav         the catalogue's clips, 16-bit PCM

The msgpack writer is a frozen copy of the subset flax writes (maps, lists,
strings, ints, floats and numpy arrays as ext type 1), so that the bytes
the program reads do not depend on the program.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np

from . import spec
from .reference.pipeline import VOCAB_CHARS

GENDERS = ("male", "female")
GROUPS = ("story", "news", "audiobook", "interview", "review")
AREAS = ("northern", "southern", "central")
EMOTIONS = ("neutral", "serious", "monotone", "sad", "surprised", "happy", "angry")
CLIP_SECONDS = 2.0
DATA = Path(__file__).resolve().parent / "data"


# ---------------------------------------------------------------------------
# msgpack (the flax subset)
# ---------------------------------------------------------------------------


def _len_header(n: int, fix_base, fix_max: int, codes) -> bytes:
    if fix_base is not None and n <= fix_max:
        return bytes([fix_base | n])
    for code, fmt, limit in codes:
        if n < limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack length {n} too large")


_STR = ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16), (0xDB, ">I", 1 << 32))
_BIN = ((0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16), (0xC6, ">I", 1 << 32))
_ARR = ((0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32))
_MAP = ((0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32))
_EXT = ((0xC7, ">B", 1 << 8), (0xC8, ">H", 1 << 16), (0xC9, ">I", 1 << 32))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _pack(out: list, obj) -> None:
    if isinstance(obj, np.ndarray):
        payload = b"".join(_packb_list([list(obj.shape), obj.dtype.name,
                                         np.ascontiguousarray(obj).tobytes()]))
        n = len(payload)
        if n in _FIXEXT:
            out.append(bytes([_FIXEXT[n], 1]))
        else:
            for code, fmt, limit in _EXT:
                if n < limit:
                    out.append(bytes([code]) + struct.pack(fmt, n) + b"\x01")
                    break
        out.append(payload)
    elif isinstance(obj, bool):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        if 0 <= obj < 128:
            out.append(bytes([obj]))
        elif 0 <= obj < 1 << 32:
            out.append(b"\xce" + struct.pack(">I", obj))
        else:
            raise ValueError(f"integer {obj} out of the range this writer takes")
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        out.append(_len_header(len(data), 0xA0, 31, _STR))
        out.append(data)
    elif isinstance(obj, bytes):
        out.append(_len_header(len(obj), None, 0, _BIN))
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        out.append(_len_header(len(obj), 0x90, 15, _ARR))
        for item in obj:
            _pack(out, item)
    elif isinstance(obj, dict):
        out.append(_len_header(len(obj), 0x80, 15, _MAP))
        for k in sorted(obj):
            _pack(out, k)
            _pack(out, obj[k])
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def _packb_list(obj) -> list:
    out: list = []
    _pack(out, obj)
    return out


def write_params(path: Path, tree) -> None:
    """A tree of float32 numpy arrays → flax-format msgpack at ``path``."""
    with open(path, "wb") as f:
        for piece in _packb_list(tree):
            f.write(piece)


def to_numpy(tree):
    """Torch leaves → float32 numpy leaves (one copy each from the device)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_numpy(v) for v in tree]
    return tree.detach().float().cpu().numpy()


# ---------------------------------------------------------------------------
# Voice catalogue
# ---------------------------------------------------------------------------


def voice_transcripts() -> list[str]:
    return [line.strip() for line in (DATA / "voice_transcripts.txt").read_text(
        encoding="utf-8").splitlines() if line.strip()]


def catalogue() -> list[dict]:
    """One voice per (gender, area, emotion), groups in turn: 42 entries."""
    texts = voice_transcripts()
    out = []
    for gender in GENDERS:
        for area in AREAS:
            for emotion in EMOTIONS:
                i = len(out)
                out.append({
                    "file_name": f"{gender}_{area}_{emotion}_{i:03d}.wav",
                    "gender": gender,
                    "group": GROUPS[i % len(GROUPS)],
                    "area": area,
                    "emotion": emotion,
                    "text": texts[i % len(texts)],
                })
    return out


def voice_clip(index: int, seed: int, sample_rate: int) -> np.ndarray:
    """A 2 s harmonic 'voice' with syllable-like amplitude, from the seed:
    float samples in [-0.8, 0.8]."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, index])
    t = np.arange(int(CLIP_SECONDS * sample_rate)) / sample_rate
    f0 = (120.0 if index < 21 else 210.0) + 8.0 * (index % 5) + rng.uniform(-5.0, 5.0)
    sig = np.zeros_like(t)
    for h, amp in enumerate((1.0, 0.6, 0.35, 0.2, 0.1), start=1):
        vib = 1.0 + 0.01 * np.sin(2 * np.pi * 5.0 * t + h)
        sig += amp * np.sin(2 * np.pi * f0 * h * vib * t)
    env = 0.5 * (1 + np.sin(2 * np.pi * 3.0 * t - np.pi / 2)) * 0.8 + 0.2
    sig = sig * env + 0.01 * rng.standard_normal(t.shape)
    return (sig / np.abs(sig).max() * 0.8).astype(np.float32)


def wav_bytes(samples_int16: np.ndarray, sample_rate: int) -> bytes:
    data = np.asarray(samples_int16, "<i2").tobytes()
    return (b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
            + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sample_rate, 2 * sample_rate, 2, 16)
            + b"data" + struct.pack("<I", len(data)) + data)


def parse_wav_pcm(data: bytes) -> np.ndarray:
    """16-bit mono PCM WAV bytes → int16 samples."""
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE payload")
    pos = 12
    while pos + 8 <= len(data):
        cid, size = data[pos : pos + 4], struct.unpack_from("<I", data, pos + 4)[0]
        if cid == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", data, pos + 8)
            if fmt[0] != 1 or fmt[1] != 1 or fmt[5] != 16:
                raise ValueError(f"not 16-bit mono PCM: {fmt}")
        elif cid == b"data":
            return np.frombuffer(data[pos + 8 : pos + 8 + size], "<i2").astype(np.int16)
        pos += 8 + size + (size & 1)
    raise ValueError("WAV payload without a data chunk")


def clip_int16(clip: np.ndarray) -> np.ndarray:
    """The clip as written to its WAV file."""
    return (np.clip(clip, -1.0, 1.0) * 32767.0).astype(np.int16)


def voices(seed: int, sample_rate: int) -> list[dict]:
    """The catalogue with each voice's clip (int16, as written) under ``"pcm"``."""
    out = catalogue()
    for i, v in enumerate(out):
        v["pcm"] = clip_int16(voice_clip(i, seed, sample_rate))
    return out


def write_pack(pack_dir: Path, weights_np: dict, model: dict, seed: int, voices: list) -> None:
    """Write the pack: weights, sizes, vocabulary and the voice catalogue."""
    pack_dir.mkdir(parents=True, exist_ok=True)
    write_params(pack_dir / "params.msgpack", weights_np)
    (pack_dir / "vocab.txt").write_text("\n".join(VOCAB_CHARS) + "\n", encoding="utf-8")
    voc, audio = model["vocoder"], model["audio"]
    meta = {
        "vocab_size": len(VOCAB_CHARS),
        "dit": spec.architecture(model["architecture"]).pack_meta(model),
        "vocoder": {"dim": voc["dim"], "intermediate_dim": voc["intermediate_dim"],
                    "num_layers": voc["num_layers"]},
        "n_mels": audio["n_mels"], "n_fft": audio["n_fft"],
        "hop_length": audio["hop_length"], "sample_rate": audio["sample_rate"],
        "seed": int(seed), "synthetic": True,
    }
    (pack_dir / "model_meta.json").write_text(json.dumps(meta, indent=1))
    audios = pack_dir / "audios"
    audios.mkdir(exist_ok=True)
    for v in voices:
        (audios / v["file_name"]).write_bytes(wav_bytes(v["pcm"], audio["sample_rate"]))
    (pack_dir / "audio_metadata.json").write_text(json.dumps(
        [{k: v[k] for k in v if k != "pcm"} for v in voices], ensure_ascii=False, indent=1))
