"""Built-in reference-voice sample catalog (a copy of
``vietvoice_tts_tpu/reference_samples.py``).

Equivalent of the reference's ``vietvoicetts/reference_samples.py:36-167``:
a dataclass per sample with gender/group/area/emotion tags + transcript, CSV
loading, filtering, path resolution and best-effort playback. The catalog file
location differs: we look for (in order)

1. ``$VIETVOICE_SAMPLES_CSV`` (explicit override),
2. ``<model_cache>/reference_samples.csv`` next to the weight pack,
3. the bundled ``models_data/reference_samples.csv`` in this repo.

The reference audio clips themselves live in the weight pack's ``audios/``
directory (the reference stores them inside its model tarball,
``core/model.py:206-210``).
"""

from __future__ import annotations

import csv
import os
import shutil
import subprocess
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

from .config import MODEL_AREA, MODEL_EMOTION, MODEL_GENDER, MODEL_GROUP

__all__ = [
    "ReferenceSample",
    "load_reference_samples",
    "filter_samples",
    "catalog_audio_bases",
    "get_sample_path",
    "play_sample",
    "MODEL_GENDER",
    "MODEL_GROUP",
    "MODEL_AREA",
    "MODEL_EMOTION",
]


# Categorical tag columns, in CSV column order after the filename. Driving
# parsing/filtering off this tuple keeps the loader and the filter in lockstep
# with the 4-way voice taxonomy without repeating it per function.
TAG_FIELDS = ("gender", "group", "area", "emotion")
CSV_COLUMNS = ("filename", *TAG_FIELDS, "text")


@dataclass(slots=True)
class ReferenceSample:
    """One catalog row: clip file + voice tags + transcript."""

    filename: str
    gender: str
    group: str
    area: str
    emotion: str
    text: str

    @classmethod
    def from_row(cls, row: dict) -> "ReferenceSample":
        """Build from a column-name→raw-string dict; tag columns are folded
        to lowercase so filtering is case-insensitive."""
        clean = {k: (row.get(k) or "").strip() for k in CSV_COLUMNS}
        for tag in TAG_FIELDS:
            clean[tag] = clean[tag].lower()
        return cls(**clean)

    def tags(self) -> dict:
        return {name: getattr(self, name) for name in TAG_FIELDS}

    def matches(
        self,
        gender: Optional[str] = None,
        group: Optional[str] = None,
        area: Optional[str] = None,
        emotion: Optional[str] = None,
    ) -> bool:
        wanted = dict(gender=gender, group=group, area=area, emotion=emotion)
        return all(
            value is None or getattr(self, name) == value
            for name, value in wanted.items()
        )


def _candidate_csv_paths() -> List[Path]:
    paths = []
    env = os.environ.get("VIETVOICE_SAMPLES_CSV")
    if env:
        paths.append(Path(env))
    cache = Path(os.environ.get("VIETVOICE_TPU_CACHE", "models")).expanduser()
    paths.append(cache / "reference_samples.csv")
    paths.append(Path(__file__).resolve().parent.parent / "models_data" / "reference_samples.csv")
    return paths


def catalog_csv_path() -> Optional[Path]:
    for p in _candidate_csv_paths():
        if p.exists():
            return p
    return None


def load_reference_samples() -> List[ReferenceSample]:
    """Load the catalog; empty list when no CSV is found (graceful degrade,
    behavior parity with reference reference_samples.py:81-110).

    The CSV is headerless with columns ``CSV_COLUMNS``; rows missing the
    transcript column are dropped as malformed."""
    csv_path = catalog_csv_path()
    if csv_path is None:
        return []
    with csv_path.open(newline="", encoding="utf-8") as fh:
        reader = csv.DictReader(fh, fieldnames=list(CSV_COLUMNS), restkey="_extra")
        return [
            ReferenceSample.from_row(row)
            for row in reader
            if row.get("text") is not None  # DictReader leaves short rows None
        ]


def filter_samples(
    samples: List[ReferenceSample],
    *,
    gender: Optional[str] = None,
    group: Optional[str] = None,
    area: Optional[str] = None,
    emotion: Optional[str] = None,
) -> List[ReferenceSample]:
    """Samples matching every provided tag (case-insensitive)."""
    wanted = {
        name: value.lower()
        for name, value in zip(TAG_FIELDS, (gender, group, area, emotion))
        if value is not None
    }
    return [s for s in samples if s.matches(**wanted)]


def catalog_audio_bases() -> List[Path]:
    """Directories a catalog clip may live in: the weight packs' ``audios/``
    dirs under the cache, then the cache root. Resolve ONCE per batch of
    lookups — this globs the cache directory."""
    cache = Path(os.environ.get("VIETVOICE_TPU_CACHE", "models")).expanduser()
    bases = [cache / "audios", cache]
    if cache.is_dir():
        bases[1:1] = sorted(p for p in cache.glob("*/audios") if p.is_dir())
    return bases


def get_sample_path(
    sample: ReferenceSample, bases: Optional[List[Path]] = None
) -> Path:
    """Resolve a sample's audio file on disk: organized (relative) path
    first, flat filename fallback, across ``bases`` (or a fresh
    :func:`catalog_audio_bases` when not supplied — pass it explicitly when
    resolving many samples to avoid re-globbing the cache per call)."""
    if bases is None:
        bases = catalog_audio_bases()
    for base in bases:
        for candidate in (base / sample.filename, base / Path(sample.filename).name):
            if candidate.exists():
                return candidate
    cache = Path(os.environ.get("VIETVOICE_TPU_CACHE", "models")).expanduser()
    return cache / "audios" / sample.filename


def play_sample(sample: ReferenceSample) -> None:
    """Best-effort local playback via ffplay/aplay; prints the path otherwise
    (reference reference_samples.py:148-167 uses pydub.playback)."""
    path = get_sample_path(sample)
    for player, args in (("ffplay", ["-nodisp", "-autoexit"]), ("aplay", [])):
        exe = shutil.which(player)
        if exe:
            print(f"\n  Playing {path.name} ... (Ctrl-C to stop)\n")
            try:
                subprocess.run([exe, *args, str(path)], check=False)
                return
            except Exception:  # pragma: no cover — best effort
                break
    print(f"  Unable to auto-play audio. You can open the file manually: {path}")
