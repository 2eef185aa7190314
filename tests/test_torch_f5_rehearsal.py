"""Full conversion rehearsal of the PyTorch port on an F5-export-shaped
fixture tarball: the JAX package's ``tests/test_f5_rehearsal.py`` case for
case, through the port's converter, its golden harness
(``vietvoice_tts_tpu_torch/golden.py``: ``reference_side`` and
``torch_side``) and its vocoder, on the CPU in float32.

Round-2 verdict #1/#2: before the real ``model-bin.pt`` exists in this
environment, everything around it must already be proven — architecture
facts derived from graph evidence (16 heads, head_dim, mel params), a
committed starter name map resolving 100% of leaves, and the golden harness
running BOTH sides end-to-end (reference side via the numpy ONNX evaluator,
torch side via the converted pack) at ~0 MAE. The fixture mirrors a torch
export: [out, in] Gemm transB=1 Linears, [out, in/g, k] Convs, per-layer
``blocks.{i}.attn.qkv.weight`` naming, Vocos-style decode
(``models/f5_fixture.py``; reference layout
``vietvoicetts/core/model.py:65-129``).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from vietvoice_tts_tpu_torch.models.convert import _flatten, convert_reference_tarball
from vietvoice_tts_tpu_torch.models.f5_fixture import (
    FixtureSpec,
    build_name_map,
    write_fixture_tarball,
)
from vietvoice_tts_tpu_torch.models.probe import probe_tarball
from vietvoice_tts_tpu_torch.runtime.serialization import load_params

SPEC = FixtureSpec(
    dim=64, depth=2, heads=16, ff_mult=2, n_mels=20, text_dim=32,
    text_conv_layers=2, vocab_size=211, voc_dim=48, voc_inter=96,
    voc_layers=2, nfe_step=8,
)


@pytest.fixture(scope="module")
def fixture_pack(tmp_path_factory):
    root = tmp_path_factory.mktemp("f5fix")
    tar, name_map, params = write_fixture_tarball(
        root / "model-bin.pt", SPEC, seed=3, ref_seconds=0.5
    )
    pack = root / "pack"
    report = convert_reference_tarball(tar, pack, name_map=name_map)
    return {"tar": tar, "pack": pack, "report": report, "params": params,
            "name_map": name_map}


class TestArchitectureProbe:
    def test_probe_extracts_16_head_architecture(self, fixture_pack):
        """Every architecture fact comes from graph evidence — the heads
        landmine (8 vs 16 changes RoPE frequencies) is now impossible to
        ship silently."""
        arch = probe_tarball(fixture_pack["tar"])["architecture"]
        assert arch["conflicts"] == {}
        facts = arch["facts"]
        assert facts["heads"] == 16
        assert facts["head_dim"] == SPEC.head_dim
        assert facts["dim"] == SPEC.dim
        assert facts["depth"] == SPEC.depth
        assert facts["n_mels"] == SPEC.n_mels
        assert facts["text_dim"] == SPEC.text_dim
        assert facts["text_conv_layers"] == SPEC.text_conv_layers
        assert facts["n_fft"] == SPEC.n_fft
        assert facts["hop_length"] == SPEC.hop_length
        assert facts["vocoder_dim"] == SPEC.voc_dim
        assert facts["vocoder_layers"] == SPEC.voc_layers
        assert facts["vocoder_intermediate"] == SPEC.voc_inter

    def test_conflicting_explicit_config_is_hard_error(self, fixture_pack, temp_dir):
        """An explicit config contradicting graph evidence must refuse to
        convert (a perfect name map with wrong heads still yields wrong
        audio)."""
        from vietvoice_tts_tpu_torch.config import ModelConfig

        wrong = ModelConfig(device="cpu", dit_heads=8, dit_dim=SPEC.dim, n_mels=SPEC.n_mels)
        with pytest.raises(ValueError, match="heads"):
            convert_reference_tarball(
                fixture_pack["tar"], Path(temp_dir) / "p", config=wrong
            )


class TestConversion:
    def test_resolves_all_leaves_bit_exact(self, fixture_pack):
        report = fixture_pack["report"]
        assert report["weights"]["unresolved"] == []
        converted = load_params(fixture_pack["pack"] / "params.msgpack")
        orig = _flatten(fixture_pack["params"])
        conv = _flatten(converted)
        assert set(orig) == set(conv)
        for k in orig:
            np.testing.assert_array_equal(orig[k], conv[k], err_msg=k)

    def test_pack_meta_records_probed_facts(self, fixture_pack):
        meta = json.loads((fixture_pack["pack"] / "model_meta.json").read_text())
        assert meta["synthetic"] is False
        assert meta["dit"]["heads"] == 16
        assert meta["probed"]["heads"] == 16  # audit trail

    def test_zero_flag_conversion_discovers_sibling_name_map(
        self, fixture_pack, temp_dir
    ):
        """`convert_reference_tarball(tar, pack)` with NO name_map must find
        the sibling `<tarball>.name_map.json` (what `f5_fixture` writes) and
        resolve 100% of leaves — the zero-flag invocation is what actually
        gets typed on conversion day."""
        tar = fixture_pack["tar"]
        sib = Path(str(tar)).with_suffix(".name_map.json")
        sib.write_text(json.dumps(fixture_pack["name_map"]))
        try:
            report = convert_reference_tarball(tar, Path(temp_dir) / "p0")
            assert report["weights"]["unresolved"] == []
        finally:
            sib.unlink()

    def test_committed_name_map_matches_generator(self):
        """``models/f5_name_map.json`` (the conversion-day starter artifact)
        is exactly ``build_name_map`` at the expected real-model shape."""
        committed = json.loads(
            (Path(__file__).parent.parent / "vietvoice_tts_tpu_torch" / "models"
             / "f5_name_map.json").read_text()
        )
        assert committed == build_name_map(FixtureSpec())


class TestGoldenRehearsal:
    def test_mel_mae_near_zero_through_golden_harness(self, fixture_pack):
        """The decisive rehearsal: reference side runs the fixture graphs
        through the numpy evaluator with the reference's loop semantics
        (tts_engine.py:148-174), the torch side integrates the port's sampler
        from the graph's noise via the converted 16-head pack — mel MAE ≈ 0."""
        from vietvoice_tts_tpu_torch.golden import reference_side, torch_side

        ref = reference_side(str(fixture_pack["tar"]), "xin chào", nfe_step=SPEC.nfe_step)
        assert ref["ref_signal_len"] == 46  # 0.5 s / 256-sample hop
        rep = torch_side(
            fixture_pack["pack"], ref, device="cpu", compute_dtype="float32",
        )
        assert rep["allclose"], rep
        assert rep["mel_mae"] < 1e-4, rep

    def test_decode_graph_matches_vocoder(self, fixture_pack):
        """The fixture decode graph (trim → ConvNeXt → iSTFT-by-ConvTranspose
        → int16) equals the port's Vocoder on the trimmed latent."""
        import tarfile

        from vietvoice_tts_tpu_torch.models.onnx_eval import EvalSession
        from vietvoice_tts_tpu_torch.models.params import from_jax_tree
        from vietvoice_tts_tpu_torch.models.vocoder import Vocoder, VocoderConfig

        with tarfile.open(fixture_pack["tar"]) as tar:
            dec = EvalSession(tar.extractfile("decode.onnx").read())
        rng = np.random.default_rng(11)
        n, ref_len = 24, 8
        latent = rng.standard_normal((1, n, SPEC.n_mels)).astype(np.float32) * 0.1
        out = dec.run(None, {
            "noise": latent, "ref_signal_len": np.array([ref_len], np.int64),
        })[0]
        voc_cfg = VocoderConfig(
            dim=SPEC.voc_dim, intermediate_dim=SPEC.voc_inter,
            num_layers=SPEC.voc_layers, n_mels=SPEC.n_mels, n_fft=SPEC.n_fft,
            hop_length=SPEC.hop_length, compute_dtype=torch.float32,
        )
        _, voc_state = from_jax_tree(fixture_pack["params"], torch.float32)
        vocoder = Vocoder(voc_cfg)
        vocoder.load_state_dict(voc_state)
        with torch.no_grad():
            wav = vocoder(torch.from_numpy(latent[:, ref_len:])).numpy()
        pcm = (np.clip(wav, -1, 1) * 32767.0).astype(np.int16)
        assert out.shape == pcm.shape
        np.testing.assert_allclose(
            out.astype(np.int32), pcm.astype(np.int32), atol=1
        )
