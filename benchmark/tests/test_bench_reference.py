"""The plain reference against the program's plain path (``use_kernels``
off, float32, on the CPU) at tiny widths on shared seeded weights: the
mel front end, the noise, one padded chunk batch end to end, the chunk
plan and the cross-fade."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import pack, spec
from benchmark.reference import check, pipeline
from benchmark.reference import model as ref
from benchmark.traffic import closed_loop_docs, common, open_loop_rest
from benchmark.weights import make_weights

SEED = 424242


@pytest.fixture(scope="module")
def tiny():
    from conftest import TINY

    cfg = spec.config("f5tts_v1_base")
    cfg["model_config"].update(TINY)
    return cfg, spec.model(cfg)


def test_mel_matches_the_program(tiny):
    from vietvoice_tts_tpu_torch.ops.stft import MelFrontend

    _, model = tiny
    wave = torch.randn(2, 384 * 256) * 0.3
    ours = ref.log_mel(wave, model["audio"])
    theirs = MelFrontend()(wave)
    assert torch.allclose(ours, theirs, atol=2e-4, rtol=1e-4)


def test_noise_matches_the_program():
    from vietvoice_tts_tpu_torch.models.sampler import row_noise

    a = ref.row_noise(9527, [0, 3, 11], 64, 100, "cpu")
    b = row_noise(9527, [0, 3, 11], 64, 100, torch.device("cpu"))
    assert torch.equal(a, b)


def test_chunk_batch_matches_the_program(tiny):
    from vietvoice_tts_tpu_torch.config import ModelConfig
    from vietvoice_tts_tpu_torch.runtime.engine_core import EngineCore

    cfg, model = tiny
    weights = make_weights(model, SEED, "cpu")
    settings = {**cfg["model_config"], "use_kernels": False,
                "frame_buckets": tuple(cfg["model_config"]["frame_buckets"])}
    mc = ModelConfig(**settings, device="cpu")
    core = EngineCore(mc, pack.to_numpy(weights), model["vocab_size"])
    voices = pack.voices(SEED, 24000)
    ref_f32 = pipeline.normalize_clip(voices[0]["pcm"] / 32768.0).astype(np.float32) / 32768.0
    texts = ["Xin chào, đây là một câu thử.", "Hôm nay trời đẹp, chúng ta cùng đi dạo."]
    chunks = [pipeline.plan_chunks(len(ref_f32), voices[0]["text"], t, model)[0] for t in texts]
    bucket = max(c.bucket for c in chunks)
    rows = [pipeline.chunk_row(pipeline.Chunk(c.index, c.text, c.ref_len, c.total_len, bucket),
                               ref_f32, 256) for c in chunks]
    wave = np.stack([w for w, _ in rows])
    ids = np.stack([i for _, i in rows])
    ref_len = np.array([c.ref_len for c in chunks])
    total = np.array([c.total_len for c in chunks])
    seeds = np.array([5, 6])
    theirs = core.synthesize_batch(wave, ref_len, ids.astype(np.int32), total, seed=seeds)
    with check.true_float32():
        ours = ref.chunk_pcm(ref.Ops("float32"), weights, model, torch.from_numpy(wave),
                             torch.from_numpy(ref_len), torch.from_numpy(ids),
                             torch.from_numpy(total), [5, 6]).numpy()
    assert ours.shape == theirs.shape
    for r in range(2):
        n = total[r] * 256
        assert check.relative_error(theirs[r, :n], ours[r, :n]) < 1e-4
    assert np.abs(theirs.astype(int) - ours.astype(int)).max() <= 4


def test_text_rules_match_the_program(tiny, docs_mix):
    from vietvoice_tts_tpu_torch.pipeline import text as theirs

    _, model = tiny
    voices = pack.voices(SEED, 24000)
    rest = open_loop_rest.requests(spec.mix("rest_short_open"), model, voices, SEED, 10.0)
    docs = closed_loop_docs.requests(docs_mix, model, voices, SEED, 10.0)[:6]
    for t in [r["text"] for r in rest + docs] + ["Một;  hai (ba)...\nbốn", "x"]:
        assert pipeline.clean_text(t) == theirs.clean_text(t)
        assert pipeline.text_length(t) == theirs.text_length(t)
        for n in (40, 135, 453):
            assert pipeline.chunk_text(t, n) == theirs.chunk_text(t, n)
    assert pipeline.VOCAB_CHARS == theirs.VALID_CHARS


def test_plan_matches_the_program(tiny, docs_mix, tmp_path):
    from vietvoice_tts_tpu_torch.client import TTSApi
    from vietvoice_tts_tpu_torch.config import ModelConfig

    cfg, model = tiny
    voices = pack.voices(SEED, 24000)
    pack.write_pack(tmp_path / "pack", pack.to_numpy(make_weights(model, SEED, "cpu")), model,
                    SEED, voices)
    settings = {**cfg["model_config"], "frame_buckets": tuple(cfg["model_config"]["frame_buckets"])}
    api = TTSApi(ModelConfig(**settings, model_cache_dir=str(tmp_path), model_name="pack",
                             device="cpu"))
    try:
        engine = api.engine
        docs = closed_loop_docs.requests(docs_mix, model, voices, SEED, 10.0)
        rest = open_loop_rest.requests(spec.mix("rest_short_open"), model, voices, SEED, 5.0)
        for r in docs[:5] + rest[:10]:
            v = voices[r["voice"]]
            audio, text = engine.model_session_manager.select_sample(
                v["gender"], v["group"], v["area"], v["emotion"])
            assert text == v["text"]
            loaded = engine._load_ref(audio).astype(np.float32) / 32768.0
            expected = pipeline.normalize_clip(v["pcm"] / 32768.0).astype(np.float32) / 32768.0
            assert np.array_equal(loaded, expected)
            theirs = engine._plan_chunks(loaded, text, r["text"])
            ours = common.planned_chunks(r["text"], v, model)
            assert [(p.index, p.text, p.ref_len, p.total_len, p.bucket) for p in theirs] == \
                [(c.index, c.text, c.ref_len, c.total_len, c.bucket) for c in ours]
            ids, _ = engine.text_processor.encode_padded(ours[0].text, ours[0].bucket)
            assert np.array_equal(ids, pipeline.encode_ids(ours[0].text, ours[0].bucket))
    finally:
        api.cleanup()


def test_crossfade_matches_the_program():
    from vietvoice_tts_tpu_torch.pipeline.audio import AudioProcessor

    rng = np.random.default_rng(3)
    waves = [(rng.standard_normal(n) * 4000).astype(np.int16) for n in (30000, 41000, 12000)]
    theirs = AudioProcessor.concatenate_with_crossfade_improved(waves, 0.1, 24000)
    ours = pipeline.join_chunks(waves, 0.1, 24000)
    assert ours.shape == theirs.shape
    assert np.abs(ours.astype(int) - theirs.astype(int)).max() <= 1
