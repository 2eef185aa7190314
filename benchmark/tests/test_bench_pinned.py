"""Readings of the yardstick pinned to the values it gave before each
architecture moved into a module of its own (``benchmark/archs/``): the
seeded weights leaf by leaf, the weight pack's bytes, the reference's PCM
at tiny widths on the CPU, the flop and byte counts of F5 v1 Base and the
parameter counts of both F5 configurations. A change that moves any of
them moves what every earlier run of the benchmark measured."""

from __future__ import annotations

import copy
import hashlib
import json
from pathlib import Path

import pytest
import torch

from benchmark import flops, pack, spec
from benchmark.reference import check
from benchmark.traffic import open_loop_rest
from benchmark.weights import make_weights, parameter_count

PINNED_WEIGHTS = Path(__file__).resolve().parent / "pinned_weights.json"
SEED = 424242


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _leaves(tree, path=()):
    """(path, tensor) of every leaf, in the tree's insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


@pytest.fixture(scope="module")
def tiny_model():
    from conftest import TINY

    cfg = copy.deepcopy(spec.config("f5tts_v1_base"))
    cfg["model_config"].update(TINY)
    return spec.model(cfg)


@pytest.mark.parametrize("seed", [SEED, 2**31 + 77])
def test_weights_leaf_by_leaf(tiny_model, seed):
    expected = json.loads(PINNED_WEIGHTS.read_text())[str(seed)]
    leaves = list(_leaves(make_weights(tiny_model, seed, "cpu")))
    assert {t.dtype for _, t in leaves} == {torch.float32}
    assert [["/".join(map(str, p)), list(t.shape), _sha(t.contiguous().numpy().tobytes())]
            for p, t in leaves] == expected


def test_pack_bytes(tiny_model, tmp_path):
    voices = pack.voices(SEED, 24000)
    pack.write_pack(tmp_path / "pack", pack.to_numpy(make_weights(tiny_model, SEED, "cpu")),
                    tiny_model, SEED, voices)
    assert {n: _sha((tmp_path / "pack" / n).read_bytes())
            for n in ("params.msgpack", "model_meta.json")} == {
        "params.msgpack": "b688b7f3cc44c85b0a40cd1fbc067af2279917da0b2546e55b5f80f4fe1eb90e",
        "model_meta.json": "2c2920eb0e70d6af2964cb875efc7c9c4c672d44d8a1fb5027f451760d73b845",
    }


def test_reference_pcm(tiny_model):
    voices = pack.voices(SEED, 24000)
    reqs = open_loop_rest.requests(spec.mix("rest_short_open"), tiny_model, voices, SEED, 1.0)
    weights = make_weights(tiny_model, SEED, "cpu")
    got = []
    for r in reqs[:2]:
        pcm = check.expected_pcm(r["text"], voices[r["voice"]], tiny_model, weights, "cpu")
        got.append((r["i"], len(pcm), str(pcm.dtype), _sha(pcm.tobytes())))
    assert got == [
        (0, 43264, "int16", "764ecf22ee090f38467d0ac79e8b0ff13fd5b15893080574542a44413f64956c"),
        (1, 26624, "int16", "f7761695ae4f78c168d1165fee15404df7924f0c1939aca4af49e447a331194b"),
    ]


@pytest.mark.parametrize("valid, bucket, row, bound", [
    (200, 256, 4856900403200, 7.533277611940298e-07),
    (448, 512, 11500188729344, 1.6827223880597015e-06),
    (2000, 2048, 68682002432000, 2.070778564206269e-05),
])
def test_flop_counts(valid, bucket, row, bound):
    base = spec.model(spec.config("f5tts_v1_base"))
    assert flops.row_flops(base, valid) == row
    assert flops.attention_bound_s(base, [valid, valid // 2], bucket) == bound
    assert flops.attention_calls_per_batch(base) == 682


@pytest.mark.parametrize("config, count", [("f5tts_v1_base", 346438246),
                                           ("f5tts_small", 169881190)])
def test_parameter_counts(config, count):
    assert parameter_count(spec.model(spec.config(config))) == count
