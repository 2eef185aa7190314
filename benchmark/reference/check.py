"""The output check: what the reference makes of a request, and how far the
served waveform lies from it.

For each request the reference works out again the chunk plan, each
chunk's row (reference clip, character ids, the row's seeded noise), the
31-step CFG solve, the vocoder, the int16 cut and the cross-fade of the
chunks, on the weights the benchmark made, in float32 with TF32 off
(``precision="float32"``), or in a lower precision for the control.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from . import model as ref_model
from . import pipeline

ROWS_PER_CALL = 4  # chunks of one bucket solved together


@contextlib.contextmanager
def true_float32():
    """float32 products without TF32, restoring the settings on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def expected_pcm(text: str, voice: dict, model: dict, weights: dict, device,
                 precision: str = "float32") -> np.ndarray:
    """The int16 waveform the serving path should return for ``text`` in
    ``voice`` (a catalogue entry with its clip under ``"pcm"``)."""
    ops = ref_model.Ops(precision)
    hop = model["audio"]["hop_length"]
    ref_i16 = pipeline.normalize_clip(voice["pcm"] / 32768.0)
    ref_f32 = ref_i16.astype(np.float32) / 32768.0
    chunks = pipeline.plan_chunks(len(ref_f32), voice["text"], text, model)
    waves: dict = {}
    by_bucket: dict = {}
    for c in chunks:
        by_bucket.setdefault(c.bucket, []).append(c)
    with true_float32():
        for group in by_bucket.values():
            for k in range(0, len(group), ROWS_PER_CALL):
                part = group[k : k + ROWS_PER_CALL]
                rows = [pipeline.chunk_row(c, ref_f32, hop) for c in part]
                pcm = ref_model.chunk_pcm(
                    ops, weights, model,
                    torch.from_numpy(np.stack([w for w, _ in rows])).to(device),
                    torch.tensor([c.ref_len for c in part], device=device),
                    torch.from_numpy(np.stack([i for _, i in rows])).to(device),
                    torch.tensor([c.total_len for c in part], device=device),
                    [c.index for c in part]).cpu().numpy()
                for c, row in zip(part, pcm):
                    waves[c.index] = row[c.ref_len * hop : c.total_len * hop]
    return pipeline.join_chunks([waves[i] for i in sorted(waves)],
                                model["planning"]["cross_fade_duration"],
                                model["audio"]["sample_rate"])


def relative_error(served: np.ndarray, expected: np.ndarray) -> float:
    """||served - expected|| / ||expected|| over the int16 samples; 1.0
    where the lengths differ."""
    if served.shape != expected.shape:
        return 1.0
    e = expected.astype(np.float64)
    diff = served.astype(np.float64) - e
    return float(np.sqrt((diff**2).sum() / max((e**2).sum(), 1.0)))


def sample(records: list, lengths: dict, k: int, seed: int) -> list:
    """Indices of the finished requests the check compares: the longest
    one (by characters) and ``k - 1`` others drawn from the seed."""
    done = [r["i"] for r in records if r.get("ok")]
    if not done:
        return []
    longest = max(done, key=lambda i: (lengths[i], -i))
    rest = [i for i in done if i != longest]
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, 99])
    picked = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False) if rest else []
    return [longest] + [rest[j] for j in sorted(picked)]
