"""Conversion-day preflight checks of the PyTorch port
(``vietvoice_tts_tpu_torch/models/preflight.py``), the JAX package's
``tests/test_preflight.py`` case for case. The fixture has 2 heads × 64 (the
JAX file's has 16 × 4, which no CUDA kernel takes: the port's preflight
refuses it); the attention-route advice names the port's kernels.

Round-3 verdict #1: first contact with the real ``model-bin.pt`` must fail
in seconds with a checklist, not 40 minutes into conversion. These tests run
the preflight against the F5-export-shaped fixture (clean pass) and against
deliberately-hostile variants: an op outside the numpy evaluator's registry,
a stale/renamed name-map entry, an architecture outside the fused kernel's
envelope, and a missing graph.
"""

import io
import json
import tarfile
from pathlib import Path

import numpy as np
import pytest

from vietvoice_tts_tpu_torch.models import onnx_pb as ox
from vietvoice_tts_tpu_torch.models.f5_fixture import (
    FixtureSpec,
    build_name_map,
    write_fixture_tarball,
)
from vietvoice_tts_tpu_torch.models.preflight import preflight_report

SPEC = FixtureSpec(
    dim=128, depth=2, heads=2, ff_mult=2, n_mels=20, text_dim=32,
    text_conv_layers=2, vocab_size=211, voc_dim=48, voc_inter=96,
    voc_layers=2, nfe_step=8,
)


@pytest.fixture(scope="module")
def fixture_tar(tmp_path_factory):
    root = tmp_path_factory.mktemp("preflight")
    tar, name_map, _params = write_fixture_tarball(
        root / "model-bin.pt", SPEC, seed=5, ref_seconds=0.5
    )
    return tar, name_map


def _retar(src, dst, replace=None, drop=()):
    """Copy a tarball, replacing/dropping members by name."""
    replace = replace or {}
    with tarfile.open(src) as tin, tarfile.open(dst, "w") as tout:
        for m in tin.getmembers():
            if not m.isfile() or m.name in drop:
                continue
            data = tin.extractfile(m).read()
            if m.name in replace:
                data = replace[m.name]
            info = tarfile.TarInfo(m.name)
            info.size = len(data)
            tout.addfile(info, io.BytesIO(data))
    return dst


class TestCleanFixture:
    def test_clean_fixture_is_ok(self, fixture_tar):
        tar, name_map = fixture_tar
        report = preflight_report(tar, name_map=name_map)
        assert report["ok"], report["blockers"]
        assert report["blockers"] == []
        assert report["graphs_found"] == ["decode", "preprocess", "transformer"]
        assert report["vocab_size"] == SPEC.vocab_size

    def test_every_graph_op_is_in_evaluator_registry(self, fixture_tar):
        tar, name_map = fixture_tar
        report = preflight_report(tar, name_map=name_map)
        for stem, entry in report["op_coverage"].items():
            assert entry["unsupported_ops"] == [], stem
            assert entry["num_nodes"] > 0

    def test_name_map_resolves_every_leaf(self, fixture_tar):
        tar, name_map = fixture_tar
        report = preflight_report(tar, name_map=name_map)
        w = report["weights"]
        assert w["unresolved_leaves"] == []
        assert w["resolved_by_map"] + w["resolved_by_heuristic"] == w["leaves_total"]
        assert w["resolved_by_map"] > 0
        assert w["name_map_stale_entries"] == []

    def test_auto_discovers_sibling_name_map(self, fixture_tar):
        """name_map=None must pick up `<tarball>.name_map.json` — the
        zero-flag invocation that actually gets typed on conversion day."""
        tar, name_map = fixture_tar
        sib = Path(str(tar)).with_suffix(".name_map.json")
        sib.write_text(json.dumps(name_map))
        try:
            report = preflight_report(tar)
            assert report["ok"], report["blockers"]
            assert report["weights"]["name_map_source"] == str(sib)
            assert report["weights"]["resolved_by_map"] > 0
        finally:
            sib.unlink()

    def test_architecture_facts_and_kernel_note(self, fixture_tar):
        tar, name_map = fixture_tar
        report = preflight_report(tar, name_map=name_map)
        arch = report["architecture"]
        assert arch["conflicts"] == {}
        assert arch["facts"]["heads"] == 2
        assert arch["config"]["dit_heads"] == 2
        # head_dim = 128/2 = 64 → kernel 1, the fused RoPE attention.
        assert arch["attention_route"]["kernel"] == 1
        assert any("kernel 1 serves" in n for n in arch["notes"])


class TestHostileVariants:
    def test_unknown_op_is_a_blocker(self, fixture_tar, tmp_path):
        """A graph op missing from onnx_eval._OPS must be reported up front
        (it would otherwise abort the golden gate mid-run)."""
        tar, name_map = fixture_tar
        F32 = 1
        hostile_decode = ox.make_model(
            ox.make_graph(
                "decode",
                nodes=[
                    ox.make_node("Resize", ["noise", "roi", "scales"], ["up"]),
                    ox.make_node("ScatterND", ["up", "idx", "upd"], ["wav"]),
                ],
                initializers=[
                    ox.make_tensor("roi", np.zeros(4, np.float32)),
                    ox.make_tensor("scales", np.ones(2, np.float32)),
                    ox.make_tensor("idx", np.zeros((1, 1), np.int64)),
                    ox.make_tensor("upd", np.zeros((1,), np.float32)),
                ],
                inputs=[
                    ox.make_value_info("noise", F32, [1, "n", SPEC.n_mels]),
                    ox.make_value_info("ref_signal_len", 7, [1]),
                ],
                outputs=[ox.make_value_info("wav", F32, [1, "t"])],
            )
        )
        bad = _retar(
            tar, tmp_path / "bad-op.pt", replace={"decode.onnx": hostile_decode}
        )
        report = preflight_report(bad, name_map=name_map)
        assert not report["ok"]
        assert set(report["op_coverage"]["decode"]["unsupported_ops"]) == {
            "Resize",
            "ScatterND",
        }
        assert any("Resize" in b and "UnsupportedOp" in b for b in report["blockers"])

    def test_stale_explicit_name_map_entry_blocks(self, fixture_tar):
        """An explicit map entry naming a nonexistent initializer must mark
        its leaf unresolved (the escape hatch fails loudly)."""
        tar, name_map = fixture_tar
        broken = dict(name_map)
        leaf = next(iter(broken))
        broken[leaf] = {"name": "transformer.RENAMED.weight", "transpose": True}
        report = preflight_report(tar, name_map=broken)
        stale = report["weights"]["name_map_stale_entries"]
        assert leaf in stale
        # The leaf may still resolve by heuristics; if not, it must block.
        if leaf in report["weights"]["unresolved_leaves"]:
            assert not report["ok"]

    def test_stale_auto_map_entry_falls_back_to_heuristics(self, fixture_tar):
        """A stale entry in the AUTO-discovered sibling map is filtered (the
        heuristics take over) and surfaces as a warning, not a blocker —
        convert.py:518-524 semantics."""
        tar, name_map = fixture_tar
        broken = dict(name_map)
        # Rename an entry that heuristics can definitely recover: a
        # depth-stacked unique-shape family.
        leaf = next(iter(broken))
        broken[leaf] = {"name": "transformer.RENAMED.weight"}
        sib = Path(str(tar)).with_suffix(".name_map.json")
        sib.write_text(json.dumps(broken))
        try:
            report = preflight_report(tar)
            w = report["weights"]
            assert leaf in w["name_map_stale_entries"]
            assert any("stale" in x for x in report["warnings"])
        finally:
            sib.unlink()

    def test_missing_graph_blocks(self, fixture_tar, tmp_path):
        tar, name_map = fixture_tar
        bad = _retar(tar, tmp_path / "no-transformer.pt", drop=("transformer.onnx",))
        report = preflight_report(bad, name_map=name_map)
        assert not report["ok"]
        assert any("transformer.onnx missing" in b for b in report["blockers"])

    def test_missing_vocab_blocks(self, fixture_tar, tmp_path):
        tar, name_map = fixture_tar
        bad = _retar(tar, tmp_path / "no-vocab.pt", drop=("vocab.txt",))
        report = preflight_report(bad, name_map=name_map)
        assert not report["ok"]
        assert any("vocab.txt missing" in b for b in report["blockers"])

    @pytest.mark.parametrize("dim, heads, kernel", [
        (64, 2, 2),  # head_dim 32: kernel 2 on the split-heads route
        (72, 2, None),  # head_dim 36 (was 48 until kernel 2 took it): no kernel
    ])
    def test_head_shape_decides_the_route(self, tmp_path, dim, heads, kernel):
        """The route advice names the kernel that serves the probed head
        shape on the card; a head_dim neither kernel takes is a blocker
        (with use_kernels the card raises on it), not a note."""
        spec = FixtureSpec(
            dim=dim, depth=2, heads=heads, ff_mult=2, n_mels=20, text_dim=32,
            text_conv_layers=2, vocab_size=211, voc_dim=48, voc_inter=96,
            voc_layers=2, nfe_step=8,
        )
        tar, name_map, _ = write_fixture_tarball(
            tmp_path / "k.pt", spec, seed=6, ref_seconds=0.4
        )
        report = preflight_report(tar, name_map=name_map)
        arch = report["architecture"]
        assert arch["attention_route"]["kernel"] == kernel
        if kernel is None:
            assert not report["ok"]
            assert any("no CUDA attention kernel takes head_dim 36" in b
                       for b in report["blockers"])
            assert report["topology"]["transformer"]["ok"]  # the graphs are fine
        else:
            assert report["ok"], report["blockers"]
            assert any(f"kernel {kernel} serves" in n for n in arch["notes"])


@pytest.mark.parametrize("heads, head_dim, kernel", [
    (16, 64, 1),  # the F5 head shape
    (8, 128, 1),  # the default model
    (4, 256, 1),  # kernel 2 until kernel 1 took JAX's D % 128 == 0 widths
    (32, 32, 2),
    (2, 96, 2),
    (16, 48, 2),  # no kernel until kernel 2 took every multiple of 8
    (4, 16, 2),  # the same
    (3, 384, 1),
    (2, 512, 1),
    (16, 72, 2),  # DiT-XL/2's heads
    (4, 320, 2),
    (16, 36, None),
    (1, 1032, None),
    (1, 1152, None),
])
def test_attention_route(heads, head_dim, kernel):
    """The route is the DiT's own choice (``DiT._attend``): kernel 1 where
    the fused wrapper's supports_shape holds, else kernel 2 where
    flash_attention takes the head_dim, else none."""
    from vietvoice_tts_tpu_torch.models.preflight import attention_route

    route = attention_route(heads, head_dim, 2048)
    assert route["kernel"] == kernel
    assert f"heads={heads} head_dim={head_dim}" in route["advice"]
    if kernel is not None:  # both dtypes on the tensor cores, float32 in split TF32
        assert route["variants"] == {"bfloat16": "wgmma", "float32": "tf32x3"}
        assert "float32 on tf32x3" in route["advice"]


@pytest.mark.parametrize("bucket", [127, 130])
def test_frame_buckets_need_no_multiple_of_8(bucket, tmp_path):
    """The JAX preflight's "frame buckets % 8" blocker is a Mosaic tiling
    rule: neither CUDA kernel has it (both take any frame count), so the
    port dropped it. A bucket that is not a multiple of 8 serves."""
    import vietvoice_tts_tpu_torch as vt
    from vietvoice_tts_tpu_torch.ops.kernels import flash_attention, fused_rope_attention

    assert fused_rope_attention.supports_shape(16, 64, bucket)
    assert flash_attention.supports_shape(32, 32, bucket)
    cfg = vt.ModelConfig(
        device="cpu", dit_dim=128, dit_depth=1, dit_heads=2, text_dim=16,
        text_conv_layers=1, vocoder_dim=16, vocoder_intermediate_dim=32,
        vocoder_num_layers=1, nfe_step=3, frame_buckets=(bucket,),
        compute_dtype="float32", model_cache_dir=str(tmp_path),
    )
    wave, _ = vt.TTSApi(cfg).synthesize("Xin chào.")
    assert wave.dtype == np.int16 and wave.size > 0 and np.all(np.isfinite(wave))
