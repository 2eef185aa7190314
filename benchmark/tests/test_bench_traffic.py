"""The traffic generators: the same seed gives the same requests; every
seed gets the same arrival times and the same lengths in another order;
arrivals are a Poisson process, lengths follow the mix."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import pack, spec
from benchmark.traffic import closed_loop_docs, common, open_loop_rest

SEED = 2**31 + 12345


@pytest.fixture(scope="module")
def model():
    return spec.model(spec.config("f5tts_v1_base"))


@pytest.fixture(scope="module")
def voices(model):
    return pack.voices(SEED, model["audio"]["sample_rate"])


def test_same_seed_same_requests(model, voices):
    mix = spec.mix("rest_short_open")
    a = open_loop_rest.requests(mix, model, voices, SEED, 30.0)
    b = open_loop_rest.requests(mix, model, voices, SEED, 30.0)
    assert a == b
    c = open_loop_rest.requests(mix, model, voices, SEED + 1, 30.0)
    assert [r["text"] for r in a] != [r["text"] for r in c]


def test_open_loop_schedule(model, voices):
    """Poisson arrivals over the window: gaps of mean 1 / rate and as wide
    as their mean, counts in 5 s stretches as wide as a Poisson law's (no
    stretch offers a fixed load), over the paths of 20 arrival seeds."""
    mix = spec.mix("rest_short_open")
    rate, seconds = mix["rate_rps"], 51.0
    gaps, dispersion = [], []
    for path in range(20):
        reqs = open_loop_rest.requests({**mix, "arrival_seed": path}, model, voices, SEED,
                                       seconds)
        assert len(reqs) == round(rate * seconds)
        due = np.array([r["due"] for r in reqs])
        assert due[0] >= 0.0 and np.all(np.diff(due) >= 0) and due[-1] < seconds
        gaps.append(np.diff(due))
        counts = np.histogram(due, bins=np.arange(0.0, 50.0 + 1e-9, 5.0))[0]
        dispersion.append(counts.var(ddof=1) / counts.mean())
    gaps = np.concatenate(gaps)
    assert gaps.mean() * rate == pytest.approx(1.0, rel=0.03)
    assert gaps.std() / gaps.mean() == pytest.approx(1.0, rel=0.05)  # exponential
    assert 0.7 < np.mean(dispersion) < 1.3  # Poisson counts: variance = mean


def test_lengths_follow_the_mix(model, voices):
    mix = spec.mix("rest_short_open")
    c = mix["chars"]
    reqs = open_loop_rest.requests(mix, model, voices, SEED, 30.0)
    lengths = np.array([len(r["text"]) for r in reqs])
    assert lengths.min() >= c["min"] - 1 and lengths.max() <= c["max"] + 20
    assert abs(np.median(lengths) - c["median"]) < 10


def test_seeds_share_the_work(model, voices):
    """Two seeds: the same arrival times and the same target lengths, in
    another order; another arrival seed, other times."""
    mix = spec.mix("rest_short_open")
    a = open_loop_rest.requests(mix, model, voices, 1, 30.0)
    b = open_loop_rest.requests(mix, model, voices, 2, 30.0)
    assert [r["due"] for r in a] == [r["due"] for r in b]
    assert [r["text"] for r in a] != [r["text"] for r in b]
    c = open_loop_rest.requests({**mix, "arrival_seed": mix["arrival_seed"] + 1}, model, voices,
                                1, 30.0)
    assert [r["due"] for r in a] != [r["due"] for r in c]
    q = common.lognormal_quantiles(len(a), 70, 0.45, 30, 150)
    x = common.lognormal_lengths(common.rng_for(1, 1), len(a), mix["chars"])
    y = common.lognormal_lengths(common.rng_for(2, 1), len(a), mix["chars"])
    assert sorted(x) == sorted(y) == sorted(q) and list(x) != list(y)


def test_arrival_path_score():
    """The single server of ``tools/arrivals.py``: at 10 req/s, two requests
    at once wait one service for the second; one alone, its own."""
    from benchmark.tools.arrivals import score

    reqs = [{"due": 0.0}, {"due": 0.0}, {"due": 1.0}]
    frames = np.array([512.0, 512.0, 512.0])
    # Waits 0.1, 0.2, 0.1 s: the 95th percentile interpolates to 0.19 s.
    assert score(reqs, frames, 10.0) == pytest.approx(190.0)


def test_voices_are_zipf(model):
    rng = common.rng_for(7, 3)
    v = common.zipf_voices(rng, 20000, 42, 1.1)
    counts = np.bincount(v, minlength=42)
    ranked = np.sort(counts)[::-1]
    assert v.min() >= 0 and v.max() < 42
    # Rank 1 against rank 2 of a Zipf(1.1) law: 2**1.1.
    assert abs(ranked[0] / ranked[1] - 2**1.1) < 0.25


def test_documents(model, voices, docs_mix):
    mix = docs_mix
    docs = closed_loop_docs.requests(mix, model, voices, SEED, 30.0)
    assert len(docs) == mix["docs"]
    lengths = np.array([len(d["text"]) for d in docs])
    assert lengths.min() >= mix["chars"]["min"] - 1
    assert lengths.max() <= mix["chars"]["max"] + 40
    chunks = [common.planned_chunks(d["text"], voices[d["voice"]], model) for d in docs[:8]]
    assert all(len(c) >= 2 for c in chunks)
    # The planner's 20 s chunks: about half the rows at bucket 2048.
    rows = [ch.bucket for c in chunks for ch in c]
    assert sum(b == 2048 for b in rows) >= len(rows) / 3


def test_voice_catalogue(voices):
    assert len(voices) == 42
    keys = {(v["gender"], v["area"], v["emotion"]) for v in voices}
    assert len(keys) == 42
    from benchmark.reference.pipeline import clean_text, text_length

    # Equal transcripts' lengths and clip durations: one speaking rate.
    assert len({text_length(clean_text(v["text"])) for v in voices}) == 1
    assert len({len(v["pcm"]) for v in voices}) == 1
