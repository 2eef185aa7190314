"""Shared pieces of the benchmark's CPU tests: the repository root on the
path, and a configuration and mixes at tiny widths."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = dict(dit_dim=64, dit_depth=2, dit_heads=1, text_dim=32, text_conv_layers=1,
            vocoder_dim=48, vocoder_intermediate_dim=96, vocoder_num_layers=2, nfe_step=4,
            compute_dtype="float32")


@pytest.fixture
def tiny_cfg():
    from benchmark import spec

    cfg = copy.deepcopy(spec.config("f5tts_v1_base"))
    cfg["model_config"].update(TINY)
    return cfg


@pytest.fixture
def tiny_rest_mix():
    from benchmark import spec

    mix = spec.mix("rest_short_open")
    mix.update(rate_rps=2.0)
    mix["check"]["sample"] = 2
    mix["trace"] = {"start_s": 1.5, "seconds": 0.5}
    return mix


# A long-form mix of the closed-loop kind (no cell runs one yet): documents
# of 1,500-4,000 characters in 20 s chunks, through the micro-batcher.
DOCS_MIX = {"kind": "closed_loop_docs", "clients": 4, "docs": 96,
            "chars": {"median": 2450, "sigma": 0.3, "min": 1500, "max": 4000, "paragraph": 600},
            "voices": {"zipf_s": 1.1}, "max_batch": 8, "max_wait_ms": 10,
            "trace": {"start_s": 35.0, "seconds": 5.0}, "check": {"sample": 2}}


@pytest.fixture
def docs_mix():
    return copy.deepcopy(DOCS_MIX)


@pytest.fixture
def tiny_docs_mix(docs_mix):
    mix = docs_mix
    mix.update(clients=2, docs=3)
    mix["chars"].update(median=1550, min=1500, max=1600)
    mix["check"]["sample"] = 2
    return mix
