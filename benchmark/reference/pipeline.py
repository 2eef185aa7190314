"""The serving path's host steps, worked out again for the reference: text
cleaning, the duration estimate and chunk plan, character ids, the
reference clip's int16 normalisation, the per-chunk rows and the
equal-power cross-fade of the chunks.

A frozen copy of the rules of the VietVoice-TTS reference that the program
follows (text_processor.py, audio_processor.py and the engine's chunk
policy), kept here so that the yardstick does not move with the program.
It imports nothing of the program.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

_ASCII = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
_VIETNAMESE = (
    "àáảãạăằắẳẵặâầấẩẫậèéẻẽẹêềếểễệđìíỉĩịòóỏõọôồốổỗộ"
    "ơờớởỡợùúủũụưừứửữựỳỵỷỹýỳỵỷỹ"
)
_PUNCT = " .,!?'@$%&/:;()"
# The character vocabulary: one character a line of vocab.txt, the id is
# the line number.
VOCAB_CHARS = "".join(sorted(set(_ASCII + _VIETNAMESE + _VIETNAMESE.upper() + _PUNCT)))

_INVALID_RE = re.compile(f"[^{re.escape(VOCAB_CHARS)}]")
_SOFT_STOP_RE = re.compile(r"[;:()]")
_MULTI_DOT_RE = re.compile(r"\.+")
_MULTI_COMMA_RE = re.compile(r",+")
_MULTI_SPACE_RE = re.compile(r"\s+")
_SENTENCE_SPLIT_RE = re.compile(r"(?<=[.!?]) +")

PAUSE_PUNCTUATION = r".,?!:"
SAFETY_MARGIN_S = 1.0


def clean_text(text: str) -> str:
    if "\n" in text:
        paragraphs = [p.strip() for p in text.split("\n") if p.strip()]
        text = " ".join(p if p.endswith(".") else p + "." for p in paragraphs)
    text = _INVALID_RE.sub(" ", text).strip()
    text = _SOFT_STOP_RE.sub(",", text)
    text = _MULTI_DOT_RE.sub(".", text)
    text = _MULTI_COMMA_RE.sub(",", text)
    text = _MULTI_SPACE_RE.sub(" ", text)
    if not text.endswith((".", "?", "!", ",")):
        text += "."
    return text


def text_length(text: str, pause_punc: str = PAUSE_PUNCTUATION) -> int:
    """UTF-8 bytes plus 3 for each pause mark: the duration proxy."""
    return len(text.encode("utf-8")) + 3 * len(re.findall(pause_punc, text))


def _split_long_part(part: str, max_chars: int) -> List[str]:
    pieces: List[str] = []
    current = ""
    for word in part.split():
        if current and len(current) + 1 + len(word) > max_chars:
            pieces.append(current)
            current = word
        else:
            current = f"{current} {word}" if current else word
    if current:
        pieces.append(current)
    return pieces


def _split_into_units(text: str, max_chars: int) -> List[str]:
    units: List[str] = []
    for sentence in _SENTENCE_SPLIT_RE.split(text.strip()):
        sentence = sentence.strip()
        if not sentence:
            continue
        if len(sentence) <= max_chars:
            units.append(sentence)
            continue
        for part in sentence.split(", "):
            part = part.strip()
            if not part:
                continue
            if len(part) <= max_chars:
                units.append(part)
            else:
                units.extend(_split_long_part(part, max_chars))
    return units


def _merge_units(units: Sequence[str], max_chars: int) -> List[str]:
    chunks: List[str] = []
    current = ""
    for unit in units:
        if current and len(current) + 1 + len(unit) > max_chars:
            chunks.append(current.strip())
            current = unit
        else:
            current = f"{current} {unit}" if current else unit
    if current:
        chunks.append(current.strip())
    return chunks


def _absorb_short_chunks(chunks: List[str], max_chars: int) -> List[str]:
    out: List[str] = []
    i = 0
    while i < len(chunks):
        current = chunks[i]
        if len(current.split()) < 4 and len(chunks) > 1:
            if i < len(chunks) - 1:
                merged = f"{current} {chunks[i + 1]}"
                if len(merged) <= max_chars:
                    out.append(merged)
                    i += 2
                    continue
            elif out:
                merged = f"{out[-1]} {current}"
                if len(merged) <= max_chars:
                    out[-1] = merged
                    i += 1
                    continue
        out.append(current)
        i += 1
    return out


def chunk_text(text: str, max_chars: int) -> List[str]:
    if not text.strip():
        return []
    units = _split_into_units(text, max_chars)
    if not units:
        return []
    return _absorb_short_chunks(_merge_units(units, max_chars), max_chars)


@dataclass(frozen=True)
class Chunk:
    index: int
    text: str  # reference transcript + chunk text
    ref_len: int  # reference frames
    total_len: int  # reference + target frames
    bucket: int  # padded frame count


def frame_bucket(n_frames: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n_frames <= b:
            return b
    return buckets[-1]


def plan_chunks(ref_samples: int, ref_text: str, target_text: str, model: dict) -> List[Chunk]:
    """The chunk plan of one request: a reference clip of ``ref_samples``
    samples with transcript ``ref_text``, and the text to speak."""
    audio, plan = model["audio"], model["planning"]
    sr, hop, speed = audio["sample_rate"], audio["hop_length"], model["speed"]
    max_chunk, min_target = plan["max_chunk_duration"], plan["min_target_duration"]
    buckets = plan["frame_buckets"]
    ref_text = clean_text(ref_text)
    target_text = clean_text(target_text)
    ref_text_len = text_length(ref_text)
    ref_audio_len = ref_samples // hop + 1
    ref_duration = ref_samples / sr
    rate = ref_text_len / ref_duration if ref_duration > 0 else 100.0

    def duration(text: str) -> float:
        return max(text_length(text) / rate / speed, min_target)

    if ref_duration + duration(target_text) <= max_chunk:
        chunks = [target_text]
    else:
        available = max_chunk - ref_duration - SAFETY_MARGIN_S
        if available <= 0:
            raise ValueError("reference clip longer than a chunk")
        chunks = []
        for chunk in chunk_text(target_text, int(rate * available * speed)):
            c_dur = duration(chunk)
            if ref_duration + c_dur <= max_chunk:
                chunks.append(chunk)
            else:
                chunks.extend(chunk_text(chunk, int(len(chunk) * available / c_dur * 0.9)))
    out = []
    for i, chunk in enumerate(chunks):
        target = int(duration(chunk) * sr) // hop + 1
        total = ref_audio_len + target
        bucket = frame_bucket(total, buckets)
        ref_len = ref_audio_len
        if total > bucket:
            target = min(target, bucket - 1)
            ref_len = min(ref_audio_len, bucket - target)
            total = ref_len + target
        out.append(Chunk(i, ref_text + chunk, ref_len, total, bucket))
    return out


def encode_ids(text: str, bucket: int) -> np.ndarray:
    """Character ids padded with -1 to ``bucket``; an unknown character is 0."""
    index = {c: i for i, c in enumerate(VOCAB_CHARS)}
    ids = np.array([index.get(c, 0) for c in text[:bucket]], np.int64)
    row = np.full((bucket,), -1, np.int64)
    row[: len(ids)] = ids
    return row


def normalize_clip(samples: np.ndarray) -> np.ndarray:
    """A reference clip (float samples) → int16: DC removed, peak at 90%."""
    audio = np.asarray(samples, np.float32)
    audio = audio - audio.mean()
    peak = np.abs(audio).max() if audio.size else 0.0
    if peak > 0:
        audio = audio * (29491.0 / peak)
    return audio.astype(np.int16)


def chunk_row(chunk: Chunk, ref_f32: np.ndarray, hop: int):
    """(wave [bucket·hop] float32, ids [bucket]) of one chunk."""
    wave = np.zeros((chunk.bucket * hop,), np.float32)
    n = min(len(ref_f32), chunk.bucket * hop)
    wave[:n] = ref_f32[:n]
    return wave, encode_ids(chunk.text, chunk.bucket)


def _fix_clipped(audio: np.ndarray) -> np.ndarray:
    audio = np.nan_to_num(audio, nan=0.0, posinf=0.0, neginf=0.0)
    peak = np.abs(audio).max() if audio.size else 0.0
    if peak >= 32767.0:
        return (audio * (26214.0 / peak)).astype(np.int16)
    return audio


def _crossfade_pair(prev: np.ndarray, nxt: np.ndarray, n_fade: int) -> np.ndarray:
    n = min(n_fade, len(prev), len(nxt))
    if n <= 0:
        return np.concatenate([prev, nxt])
    prev_overlap = prev[-n:].astype(np.float32)
    next_overlap = nxt[:n].astype(np.float32)
    prev_rms = np.sqrt(np.mean(prev_overlap**2))
    next_rms = np.sqrt(np.mean(next_overlap**2))
    if prev_rms > 100 and next_rms > 100:
        ratio = float(np.clip(prev_rms / next_rms, 0.7, 1.5))
        nxt = (nxt.astype(np.float32) * ratio).astype(np.int16)
        next_overlap = nxt[:n].astype(np.float32)
    theta = np.linspace(0.0, np.pi / 2, n)
    overlap = (prev_overlap * np.cos(theta) ** 2 + next_overlap * np.sin(theta) ** 2)
    return np.concatenate([prev[:-n], overlap.astype(np.int16), nxt[n:]])


def join_chunks(waves: List[np.ndarray], cross_fade_s: float, sample_rate: int) -> np.ndarray:
    """Chunks' int16 waves → one wave: clip repair, then an equal-power
    cross-fade with the next chunk's RMS matched to the previous one's."""
    waves = [_fix_clipped(np.asarray(w).reshape(-1)) for w in waves]
    if len(waves) == 1 or cross_fade_s <= 0:
        return np.concatenate(waves)
    out = waves[0]
    for nxt in waves[1:]:
        out = _crossfade_pair(out, nxt, int(cross_fade_s * sample_rate))
    return out
