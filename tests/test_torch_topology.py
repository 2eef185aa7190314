"""Topology-level graph verification of the PyTorch port
(``vietvoice_tts_tpu_torch/models/topology.py``), the JAX package's
``tests/test_topology.py`` case for case. The fixture has 2 heads × 64
(the JAX file's has 16 × 4): the port's preflight refuses a head shape no
CUDA kernel takes, and these cases want a clean preflight.

Round-4 verdict #2: the per-block op sequence of transformer.onnx must be
verified against the model's block (pre-norm AdaLN → QKV → RoPE → attention → gated residual →
FFN), the CFG/Euler update form, the sway time grid, and the preprocess
graph's embedded DSP constants — and HOSTILE export variants must be
DETECTED, never converted silently.
"""

import dataclasses
import io
import tarfile

import pytest

from vietvoice_tts_tpu_torch.models import topology
from vietvoice_tts_tpu_torch.models.f5_fixture import (
    FixtureSpec,
    build_preprocess,
    build_transformer,
    make_params,
    write_fixture_tarball,
)
from vietvoice_tts_tpu_torch.models.onnx_pb import parse_model

SPEC = FixtureSpec(
    dim=128, depth=2, heads=2, ff_mult=2, n_mels=20, text_dim=32,
    text_conv_layers=2, vocab_size=211, voc_dim=48, voc_inter=96,
    voc_layers=2, nfe_step=8,
)
FACTS = {
    "depth": SPEC.depth, "head_dim": SPEC.head_dim, "n_mels": SPEC.n_mels,
    "n_fft": SPEC.n_fft, "hop_length": SPEC.hop_length,
}


@pytest.fixture(scope="module")
def params():
    return make_params(SPEC, seed=5)


@pytest.fixture(scope="module")
def clean_transformer(params):
    return parse_model(build_transformer(SPEC, params))


class TestCleanTransformer:
    def test_every_block_verifies(self, clean_transformer):
        rep = topology.verify_transformer(clean_transformer, FACTS)
        assert rep["ok"], rep["errors"]
        s = rep["summary"]
        n = 2 * SPEC.depth  # CFG cond + uncond branches
        assert s["attention_blocks"] == n
        for key in ("pre_norm_ok", "adaln_ok", "rope_ok", "attn_core_ok",
                    "gated_residual_ok", "ffn_ok"):
            assert s[key] == n, (key, s)

    def test_euler_and_cfg_verified(self, clean_transformer):
        rep = topology.verify_transformer(clean_transformer, FACTS)
        assert rep["euler"]["ok"]
        assert rep["cfg"]["ok"]
        assert rep["cfg"]["sub_cond_uncond"]

    def test_sway_grid_extracted_and_matched(self, clean_transformer):
        rep = topology.verify_transformer(clean_transformer, FACTS)
        tg = rep["time_grid"]
        assert tg["match"] == "sway(coef=-1.0)"
        assert tg["nfe"] == SPEC.nfe_step
        assert tg["grid_head"][0] == 0.0
        assert tg["grid_tail"][-1] == pytest.approx(1.0, abs=1e-4)

    def test_branches_classified(self, clean_transformer):
        rep = topology.verify_transformer(clean_transformer, FACTS)
        branches = [b["branch"] for b in rep["blocks"]]
        assert branches.count("cond") == SPEC.depth
        assert branches.count("uncond") == SPEC.depth

    def test_packed_qkv_noted(self, clean_transformer):
        rep = topology.verify_transformer(clean_transformer, FACTS)
        assert all(b["qkv_proj"] == "packed" for b in rep["blocks"])


class TestHostileVariantsDetected:
    """Each structurally-wrong export must FAIL verification with a
    specific error — silence here is the failure mode the verifier exists
    to prevent."""

    def _verify(self, params, variant):
        m = parse_model(build_transformer(SPEC, params, variant=variant))
        return topology.verify_transformer(m, FACTS)

    def test_post_norm_block(self, params):
        rep = self._verify(params, "post_norm")
        assert not rep["ok"]
        assert any("pre-norm" in e for e in rep["errors"])

    def test_modulation_before_norm(self, params):
        rep = self._verify(params, "mod_before_norm")
        assert not rep["ok"]
        assert any("AdaLN" in e for e in rep["errors"])

    def test_ungated_residual(self, params):
        rep = self._verify(params, "no_gate")
        assert not rep["ok"]
        assert any("gated" in e for e in rep["errors"])

    def test_missing_cfg(self, params):
        rep = self._verify(params, "no_cfg")
        assert not rep["ok"]
        assert any("CFG" in e or "uncond" in e for e in rep["errors"])

    def test_swapped_rope_tables(self, params):
        """cos/sin exchanged in the RoPE application is the same symbolic
        shape but the wrong rotation direction — caught via the
        name-identified table assignment (plain→cos, rotated→sin)."""
        rep = self._verify(params, "rope_swapped")
        assert not rep["ok"]
        assert any("SWAPPED" in e for e in rep["errors"])

    def test_different_sway_coefficient(self):
        spec = dataclasses.replace(SPEC, sway_sampling_coef=0.8)
        m = parse_model(build_transformer(spec, make_params(spec, seed=5)))
        rep = topology.verify_transformer(m, FACTS)
        assert not rep["ok"]
        assert rep["time_grid"]["match"] == "unknown"
        assert rep["time_grid"]["fitted_sway_coef"] == pytest.approx(0.8, abs=1e-3)
        assert any("sway" in e for e in rep["errors"])

    def test_linear_grid_detected(self):
        spec = dataclasses.replace(SPEC, sway_sampling_coef=0.0)
        m = parse_model(build_transformer(spec, make_params(spec, seed=5)))
        rep = topology.verify_transformer(m, FACTS)
        assert not rep["ok"]
        assert rep["time_grid"]["match"] == "linear"
        assert any("sway" in e for e in rep["errors"])


class TestBenignSpellingsVerify:
    """Spelling variants a real torch export emits (decomposed LayerNorm,
    separate q/k/v Gemms, erf-GELU) are structurally THE SAME block and
    must verify clean — the verifier flags different topology, not
    different spellings of the same topology."""

    def test_torch_decomposed_spelling_passes(self, params):
        m = parse_model(
            build_transformer(SPEC, params, variant="torch_decomposed")
        )
        rep = topology.verify_transformer(m, FACTS)
        assert rep["ok"], rep["errors"]
        s = rep["summary"]
        n = 2 * SPEC.depth
        assert s["pre_norm_ok"] == n  # decomposed LN recognized as a norm
        assert s["ffn_ok"] == n  # erf-GELU recognized as the nonlinearity
        assert all(b["qkv_proj"] == "separate" for b in rep["blocks"])

    def test_matmul_add_projection_spelling_passes(self, params):
        """MatMul + bias Add instead of Gemm (dynamo/older-opset form): the
        bias Add must be crossed on the way to the residual, never mistaken
        FOR the residual (which made the gated-residual check false-positive
        before _walk_to_residual_add)."""
        m = parse_model(build_transformer(SPEC, params, variant="matmul_add"))
        rep = topology.verify_transformer(m, FACTS)
        assert rep["ok"], rep["errors"]
        s = rep["summary"]
        n = 2 * SPEC.depth
        assert s["gated_residual_ok"] == n
        assert s["ffn_ok"] == n

    def test_scale_on_q_spelling_passes(self, params):
        """The 1/√d_k scale multiplied into Q before the QK MatMul (one
        SDPA decomposition) must not break the RoPE detection."""
        m = parse_model(build_transformer(SPEC, params, variant="scale_on_q"))
        rep = topology.verify_transformer(m, FACTS)
        assert rep["ok"], rep["errors"]
        assert rep["summary"]["rope_ok"] == 2 * SPEC.depth

    def test_clamped_schedule_gather_passes(self, params):
        """An export that CLIPS the schedule-gather index (final-step guard
        spelling) repeats the last dt forever instead of erroring past the
        table — the grid extraction must truncate the trailing stall and
        still match the sway formula, not produce a false blocker."""
        m = parse_model(
            build_transformer(SPEC, params, variant="clamped_schedule")
        )
        rep = topology.verify_transformer(m, FACTS)
        assert rep["ok"], rep["errors"]
        tg = rep["time_grid"]
        assert tg["match"] == "sway(coef=-1.0)"
        assert tg["nfe"] == SPEC.nfe_step  # stall truncated to the real grid


class TestPreprocessConstants:
    def test_clean_constants_all_verified(self, params):
        m = parse_model(build_preprocess(SPEC, params))
        rep = topology.verify_preprocess(m, FACTS)
        assert rep["ok"], rep["errors"]
        c = rep["checks"]
        assert c["hop_from_framing_conv"] == SPEC.hop_length
        assert c["mel_filterbank"]["max_abs_diff_vs_htk"] < 1e-6
        assert c["mel_filterbank"]["n_fft"] == SPEC.n_fft
        assert c["stft_dft_kernel"]["max_abs_diff"] < 1e-6
        assert c["rope_inv_freq"]["max_abs_diff_vs_base_10000"] < 1e-6
        assert c["concat_order"] == "mel,text"
        assert c["noise_source"].startswith("RandomNormal")

    def test_swapped_concat_detected(self, params):
        m = parse_model(build_preprocess(SPEC, params, variant="swapped_concat"))
        rep = topology.verify_preprocess(m, FACTS)
        assert not rep["ok"]
        assert any("Concat order" in e for e in rep["errors"])

    def test_wrong_mel_scale_detected(self, params):
        """A filterbank built for a different sample rate has different
        breakpoints — must be flagged, not assumed."""
        m = parse_model(build_preprocess(SPEC, params))
        rep = topology.verify_preprocess(m, FACTS, sample_rate=22050)
        assert not rep["ok"]
        assert any("mel filterbank" in e for e in rep["errors"])


class TestTimeGridExtraction:
    def test_unextractable_without_dt(self, clean_transformer):
        out = topology.extract_time_grid(clean_transformer, None)
        assert out["match"] == "unextractable"


class TestPreflightIntegration:
    """preflight_report must turn topology failures into blockers
    (non-zero exit on conversion day)."""

    def _tarball_with(self, tmp_path, transformer_bytes):
        tar, _, params = write_fixture_tarball(
            tmp_path / "model-bin.pt", SPEC, seed=5, ref_seconds=0.5
        )
        out = tmp_path / "hostile.pt"
        with tarfile.open(tar) as tin, tarfile.open(out, "w") as tout:
            for m in tin.getmembers():
                if not m.isfile():
                    continue
                data = tin.extractfile(m).read()
                if m.name.endswith("transformer.onnx"):
                    data = transformer_bytes
                info = tarfile.TarInfo(m.name)
                info.size = len(data)
                tout.addfile(info, io.BytesIO(data))
        return out, params

    def test_clean_tarball_reports_topology_ok(self, tmp_path):
        from vietvoice_tts_tpu_torch.models.preflight import preflight_report

        tar, _, _ = write_fixture_tarball(
            tmp_path / "model-bin.pt", SPEC, seed=5, ref_seconds=0.5
        )
        report = preflight_report(tar)
        assert report["ok"], report["blockers"]
        assert report["topology"]["transformer"]["ok"]
        assert report["topology"]["preprocess"]["ok"]
        tg = report["topology"]["transformer"]["time_grid"]
        assert tg["match"] == "sway(coef=-1.0)"

    def test_hostile_transformer_blocks_preflight(self, tmp_path, params):
        from vietvoice_tts_tpu_torch.models.preflight import preflight_report

        hostile = build_transformer(SPEC, params, variant="post_norm")
        tar, _ = self._tarball_with(tmp_path, hostile)
        report = preflight_report(tar)
        assert not report["ok"]
        assert any("topology" in b for b in report["blockers"])

    def test_hostile_transformer_blocks_conversion_itself(self, tmp_path, params):
        """Defense in depth: convert run DIRECTLY (preflight skipped) must
        refuse a structurally different export — name-map resolution says
        nothing about op order. skip_topology_check is the escape hatch."""
        from vietvoice_tts_tpu_torch.models.convert import convert_reference_tarball

        hostile = build_transformer(SPEC, params, variant="post_norm")
        tar, _ = self._tarball_with(tmp_path, hostile)
        with pytest.raises(ValueError, match="topology"):
            convert_reference_tarball(tar, tmp_path / "pack")
        report = convert_reference_tarball(
            tar, tmp_path / "pack2", skip_topology_check=True
        )
        assert (tmp_path / "pack2" / "model_meta.json").exists()
        assert "topology" not in report

    def test_clean_conversion_records_topology_ok(self, tmp_path):
        from vietvoice_tts_tpu_torch.models.convert import convert_reference_tarball

        tar, _, _ = write_fixture_tarball(
            tmp_path / "model-bin.pt", SPEC, seed=5, ref_seconds=0.5
        )
        report = convert_reference_tarball(tar, tmp_path / "pack")
        assert report["topology"]["transformer"]["ok"]
        assert report["topology"]["preprocess"]["ok"]


def test_noise_output_preferred_over_an_earlier_aux_output(clean_transformer):
    """An export that lists an auxiliary output before the noise output is
    verified against the noise output (the JAX verifier takes the first
    output not named for the time step, and would check the wrong tensor)."""
    import copy

    from vietvoice_tts_tpu.models import topology as jax_topology
    from vietvoice_tts_tpu_torch.models.onnx_pb import OnnxValueInfo

    model = copy.deepcopy(clean_transformer)
    aux = next(n.outputs[0] for n in model.graph.nodes if n.op_type == "Softmax")
    model.graph.outputs.insert(0, OnnxValueInfo(name=aux, elem_type=1, shape=None))
    rep = topology.verify_transformer(model, FACTS)
    assert rep["ok"], rep["errors"]
    assert rep["euler"]["ok"] and rep["cfg"]["ok"]
    jax_rep = jax_topology.verify_transformer(model, FACTS)
    assert not jax_rep["ok"]
