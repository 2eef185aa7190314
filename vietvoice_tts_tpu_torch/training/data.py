"""Training data pipeline: (audio, transcript) manifests → bucketed batches.

Port of ``vietvoice_tts_tpu/training/data.py``. Manifest format: JSON-lines,
one ``{"audio": <wav path>, "text": <str>}`` per line (the weight pack's
voice catalog doubles as a toy manifest via ``manifest_from_pack``). The
pipeline:

1. load + resample each clip (stdlib WAV reader), clean the transcript;
2. length-bucket utterances into the config's frame buckets (the serving
   buckets);
3. yield padded numpy (mel, text_ids, lengths) batches — the mel from the
   same ``MelFrontend`` the serving path uses, on ``config.device``, so
   there is no train/serve feature mismatch.

Same bucketing, per-``__iter__`` shuffle from ``shuffle_seed`` and
``drop_last`` as the JAX loader, so both give the same batches in the same
order.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..ops.stft import MelFrontend
from ..pipeline.audio import AudioProcessor
from ..pipeline.text import TextProcessor
from ..utils.logging import get_logger
from ..utils.wavio import read_wav

log = get_logger("data")


@dataclass
class Utterance:
    audio_path: str
    text: str
    n_frames: int  # estimated from file length


def load_manifest(path: str | Path) -> List[dict]:
    """JSON-lines manifest → list of {'audio', 'text'} records."""
    records = []
    with Path(path).open(encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if "audio" not in rec or "text" not in rec:
                raise ValueError(f"Manifest record missing audio/text: {rec}")
            records.append(rec)
    return records


def manifest_from_pack(pack_dir: str | Path) -> List[dict]:
    """Use the weight pack's voice catalog as a (toy) training manifest."""
    pack = Path(pack_dir)
    meta = json.loads((pack / "audio_metadata.json").read_text())
    return [
        {"audio": str(pack / "audios" / s["file_name"]), "text": s["text"]}
        for s in meta
    ]


class TextMelDataset:
    """Bucketed, padded (mel, text_ids, lengths) batches."""

    def __init__(
        self,
        records: Sequence[dict],
        config: ModelConfig,
        vocab_path: str | Path,
        batch_size: int = 8,
        shuffle_seed: int | None = 0,
        drop_last: bool = False,
    ):
        self.config = config
        self.batch_size = batch_size
        self.shuffle_seed = shuffle_seed
        self.drop_last = drop_last
        self.text_processor = TextProcessor(vocab_path)
        self.frontend = MelFrontend(
            sample_rate=config.sample_rate,
            n_fft=config.n_fft,
            win_length=config.win_length,
            hop_length=config.hop_length,
            n_mels=config.n_mels,
        ).to(config.device)
        self.utterances = [
            Utterance(
                audio_path=r["audio"],
                text=self.text_processor.clean_text(r["text"]),
                n_frames=self._estimate_frames(r["audio"]),
            )
            for r in records
        ]
        log.info("Dataset: %d utterances", len(self.utterances))

    def _estimate_frames(self, path: str) -> int:
        samples, sr = read_wav(path)
        n = int(samples.shape[0] * self.config.sample_rate / sr)
        return n // self.config.hop_length

    # -- batching -------------------------------------------------------------

    def _buckets(self) -> dict[int, List[Utterance]]:
        out: dict[int, List[Utterance]] = {}
        for u in self.utterances:
            b = self.config.frame_bucket_for(u.n_frames)
            out.setdefault(b, []).append(u)
        return out

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        rng = (
            np.random.default_rng(self.shuffle_seed)
            if self.shuffle_seed is not None
            else None
        )
        for bucket, utts in sorted(self._buckets().items()):
            order = list(range(len(utts)))
            if rng is not None:
                rng.shuffle(order)
            for start in range(0, len(order), self.batch_size):
                idx = order[start : start + self.batch_size]
                if self.drop_last and len(idx) < self.batch_size:
                    continue
                yield self._make_batch([utts[i] for i in idx], bucket)

    def _make_batch(self, utts: List[Utterance], bucket: int):
        hop = self.config.hop_length
        b = len(utts)
        wave = np.zeros((b, bucket * hop), np.float32)
        lengths = np.zeros((b,), np.int32)
        text_ids = np.full((b, bucket), -1, np.int32)
        for row, u in enumerate(utts):
            audio = AudioProcessor.load_audio(u.audio_path, self.config.sample_rate)
            f32 = audio.astype(np.float32) / 32768.0
            n = min(len(f32), bucket * hop)
            wave[row, :n] = f32[:n]
            lengths[row] = min(n // hop, bucket)
            ids, _ = self.text_processor.encode_padded(u.text, bucket)
            text_ids[row] = ids
        with torch.no_grad():
            mel = self.frontend(torch.from_numpy(wave).to(self.config.device))
        return mel.cpu().numpy(), text_ids, lengths
