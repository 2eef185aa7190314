"""What the traffic generators share: Poisson arrivals; lengths as the
quantiles of their law in an order drawn from the seed; texts of a given
length from the sentence bank; catalogue voices by a Zipf law; the frame
buckets that a set of requests reaches.

Every seed of a mix gets the same number of requests and the same multiset
of lengths, in another order, so that two seeds ask for the same work in
all; the texts, the voices and the weights are the seed's.
"""

from __future__ import annotations

import math
from pathlib import Path
from statistics import NormalDist

import numpy as np

from ..reference import pipeline

DATA = Path(__file__).resolve().parents[1] / "data"


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """A generator for one use (``stream``) of a run's seed; seeds of any
    size up to 64 bits."""
    seed = int(seed)
    return np.random.default_rng([seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, stream])


def lognormal_quantiles(n: int, median: float, sigma: float, lo: float, hi: float) -> np.ndarray:
    """The midpoint quantiles (i + 1/2) / n of a lognormal law, clipped to
    [lo, hi], as whole numbers."""
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    return np.clip(np.round(median * np.exp(sigma * z)), lo, hi).astype(int)


def lognormal_lengths(rng: np.random.Generator, n: int, chars: dict) -> np.ndarray:
    """``n`` lengths: the midpoint quantiles of the mix's lognormal law
    (``median``, ``sigma``, ``min``, ``max``) in an order drawn from ``rng``."""
    return rng.permutation(lognormal_quantiles(n, chars["median"], chars["sigma"],
                                               chars["min"], chars["max"]))


def poisson_arrivals(rng: np.random.Generator, n: int, seconds: float) -> np.ndarray:
    """The arrival times of a Poisson process over [0, ``seconds``) given
    that ``n`` requests arrive in it: ``n`` uniform times, sorted."""
    return np.sort(rng.uniform(0.0, seconds, n))


def bank_words() -> list[str]:
    text = (DATA / "sentences.txt").read_text(encoding="utf-8")
    return [w for line in text.splitlines() for w in line.split()]


def text_of_length(rng: np.random.Generator, words: list[str], n_chars: int,
                   paragraph_chars: int = 0) -> str:
    """Words of the bank from a random place on, up to about ``n_chars``
    characters, ending with a full stop; with ``paragraph_chars``, a line
    break after a sentence once a paragraph is that long."""
    i = int(rng.integers(len(words)))
    out, para = [], 0
    length = 0
    while length < n_chars - 1:
        w = words[i % len(words)]
        i += 1
        out.append(w)
        length += len(w) + 1
        para += len(w) + 1
        if paragraph_chars and para >= paragraph_chars and w.endswith("."):
            out.append("\n")
            para = 0
    text = " ".join(out).replace(" \n ", "\n").strip()
    text = text.rstrip(",;:")
    if not text.endswith((".", "?", "!")):
        text += "."
    return text


def zipf_voices(rng: np.random.Generator, n: int, n_voices: int, s: float) -> np.ndarray:
    """``n`` voice indices drawn by a Zipf law of exponent ``s`` over the
    catalogue, its ranks given to the voices in an order from the seed."""
    p = 1.0 / np.arange(1, n_voices + 1) ** s
    ranks = rng.choice(n_voices, size=n, p=p / p.sum())
    return rng.permutation(n_voices)[ranks]


def planned_chunks(text: str, voice: dict, model: dict) -> list:
    """The chunk plan the serving path makes for ``text`` in ``voice``."""
    ref = pipeline.normalize_clip(voice["pcm"] / 32768.0)
    return pipeline.plan_chunks(len(ref), voice["text"], text, model)


def buckets(requests: list, voices: list, model: dict) -> tuple[int, ...]:
    """The frame buckets that serving these requests dispatches."""
    return tuple(sorted({c.bucket for r in requests
                         for c in planned_chunks(r["text"], voices[r["voice"]], model)}))


def percentile(values, q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least q% of the
    values at or below it."""
    v = sorted(values)
    if not v:
        return math.nan
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]
