"""Vietnamese text processing for TTS.

A copy of ``vietvoice_tts_tpu/pipeline/text.py``, which keeps behavioral
parity with the reference's ``TextProcessor``
(``vietvoicetts/core/text_processor.py:12-175``): the same character
whitelist and cleaning rules, the same UTF-8-byte+pause-weight length
heuristic, and the same sentence→comma→word-boundary chunking with
short-chunk merging, plus a batch encoder that pads character-ID rows into
the frame buckets.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

from ..utils.logging import get_logger

log = get_logger("text")

_ASCII = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
_VIETNAMESE = (
    "àáảãạăằắẳẵặâầấẩẫậèéẻẽẹêềếểễệđìíỉĩịòóỏõọôồốổỗộ"
    "ơờớởỡợùúủũụưừứửữựỳỵỷỹýỳỵỷỹ"
)
_PUNCT = " .,!?'@$%&/:;()"
VALID_CHARS = "".join(
    sorted(set(_ASCII + _VIETNAMESE + _VIETNAMESE.upper() + _PUNCT))
)

_INVALID_RE = re.compile(f"[^{re.escape(VALID_CHARS)}]")
_SOFT_STOP_RE = re.compile(r"[;:()]")
_MULTI_DOT_RE = re.compile(r"\.+")
_MULTI_COMMA_RE = re.compile(r",+")
_MULTI_SPACE_RE = re.compile(r"\s+")
_SENTENCE_SPLIT_RE = re.compile(r"(?<=[.!?]) +")


def clean_text(text: str) -> str:
    """Normalize raw input to the model's readable-character set.

    Rule-for-rule equivalent of reference ``clean_text``
    (text_processor.py:43-74): newline → sentence with '.' appended,
    whitelist filter, ``;:()`` → ``,``, punctuation dedupe, whitespace
    collapse, guaranteed trailing punctuation.
    """
    if "\n" in text:
        paragraphs = [p.strip() for p in text.split("\n") if p.strip()]
        paragraphs = [p if p.endswith(".") else p + "." for p in paragraphs]
        text = " ".join(paragraphs)
    text = _INVALID_RE.sub(" ", text).strip()
    text = _SOFT_STOP_RE.sub(",", text)
    text = _MULTI_DOT_RE.sub(".", text)
    text = _MULTI_COMMA_RE.sub(",", text)
    text = _MULTI_SPACE_RE.sub(" ", text)
    if not text.endswith((".", "?", "!", ",")):
        text += "."
    return text


def text_length(text: str, pause_punc: str = r".,?!:") -> int:
    """Duration-estimation proxy: UTF-8 byte count + 3 per pause mark
    (reference ``calculate_text_length``, text_processor.py:39-41)."""
    return len(text.encode("utf-8")) + 3 * len(re.findall(pause_punc, text))


def _split_long_part(part: str, max_chars: int) -> List[str]:
    """Greedy word-boundary split of an over-long comma-free fragment."""
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
    """Sentences that fit; long sentences split at ', '; still-long parts
    split at word boundaries (reference text_processor.py:81-121)."""
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
                log.warning(
                    "Part too long (%d chars), splitting at word boundaries: %.50s...",
                    len(part),
                    part,
                )
                units.extend(_split_long_part(part, max_chars))
    return units


def _merge_units(units: Sequence[str], max_chars: int) -> List[str]:
    """Greedy re-merge of units into chunks ≤ max_chars
    (reference text_processor.py:126-144)."""
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
    """Merge chunks of <4 words into a neighbor when the result still fits
    (reference text_processor.py:147-171)."""
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


def chunk_text(text: str, max_chars: int = 135) -> List[str]:
    """Split ``text`` into ≤``max_chars`` chunks respecting word boundaries."""
    if not text.strip():
        return []
    units = _split_into_units(text, max_chars)
    if not units:
        return []
    chunks = _absorb_short_chunks(_merge_units(units, max_chars), max_chars)
    log.debug(
        "chunk_text: %d chunks, lengths %s, max_chars %d",
        len(chunks),
        [len(c) for c in chunks],
        max_chars,
    )
    return chunks


class TextProcessor:
    """Char-level vocabulary mapping + cleaning + chunking.

    Same public surface as the reference class (text_processor.py:12-175)
    plus ``encode_batch`` for padding rows into the frame buckets.
    """

    def __init__(self, vocab_path: str | Path):
        self.vocab_char_map = self._load_vocab(vocab_path)
        self.vocab_size = len(self.vocab_char_map)
        # Fast path: codepoint → id LUT for the BMP; dict fallback beyond.
        self._lut = np.zeros(0x10000, dtype=np.int32)
        for ch, idx in self.vocab_char_map.items():
            if len(ch) == 1 and ord(ch) < 0x10000:
                self._lut[ord(ch)] = idx

    @staticmethod
    def _load_vocab(vocab_path: str | Path) -> Dict[str, int]:
        """One character per line → its line index (text_processor.py:19-28)."""
        p = Path(vocab_path)
        if not p.exists():
            raise FileNotFoundError(f"Vocabulary file not found: {vocab_path}")
        vocab: Dict[str, int] = {}
        with p.open("r", encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return vocab

    # -- Reference-compatible single-utterance API ---------------------------

    def text_to_indices(self, texts: List[List[str]]) -> np.ndarray:
        """[[chars...]] → int32 ids, unknown → 0 (text_processor.py:30-37)."""
        rows = []
        for chars in texts:
            cps = np.array([ord(c) if ord(c) < 0x10000 else 0 for c in chars], dtype=np.int64)
            rows.append(self._lut[cps].astype(np.int32))
        return np.stack(rows, axis=0)

    def calculate_text_length(self, text: str, pause_punc: str) -> int:
        return text_length(text, pause_punc)

    def clean_text(self, text: str) -> str:
        return clean_text(text)

    def chunk_text(self, text: str, max_chars: int = 135) -> List[str]:
        return chunk_text(text, max_chars)

    # -- Bucketed batch encoding ---------------------------------------------

    def encode_padded(self, text: str, bucket_len: int) -> tuple[np.ndarray, int]:
        """Encode one string to a 0-padded int32 row of ``bucket_len``.

        Padding uses -1 so the model can mask padding apart from real id 0
        (the reference maps unknown → 0 and never pads; our embedding maps
        -1 → a dedicated filler row).
        """
        ids = self.text_to_indices([list(text)])[0]
        n = min(len(ids), bucket_len)
        row = np.full((bucket_len,), -1, dtype=np.int32)
        row[:n] = ids[:n]
        return row, n

    def encode_batch(self, texts: Sequence[str], bucket_len: int) -> tuple[np.ndarray, np.ndarray]:
        """Encode a batch → (ids [B, bucket_len] padded with -1, lengths [B])."""
        rows, lens = [], []
        for t in texts:
            row, n = self.encode_padded(t, bucket_len)
            rows.append(row)
            lens.append(n)
        return np.stack(rows, axis=0), np.array(lens, dtype=np.int32)
