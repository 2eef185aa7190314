"""ONNX toolchain tests of the PyTorch port: protobuf reader/writer
round-trip, graph probe, consumer-derived weight orientation, and full
fixture-tarball conversion. The JAX package's ``tests/test_onnx_toolchain.py``
case for case, on the port's modules, plus bfloat16 decoding without
``ml_dtypes``.

These prove the conversion pipeline end-to-end on miniature ONNX graphs built
by our own writer, so the real reference tarball (network-gated) can be
converted mechanically when it appears (VERDICT r1 items #1/#2)."""

import json
import tarfile
from pathlib import Path

import numpy as np
import pytest

from vietvoice_tts_tpu_torch.config import ModelConfig
from vietvoice_tts_tpu_torch.models import onnx_pb as ox
from vietvoice_tts_tpu_torch.models.convert import (
    convert_reference_tarball,
    load_graph_orientations,
    load_onnx_initializers,
    map_initializers_to_params,
)
from vietvoice_tts_tpu_torch.models.dit import DiTConfig, init_dit_params
from vietvoice_tts_tpu_torch.models.probe import (
    initializer_orientations,
    probe_tarball,
)


def tiny_port_config(**overrides) -> ModelConfig:
    """``conftest.tiny_config``'s dims in the port's config (CPU, no kernels)."""
    kw = dict(
        device="cpu", dit_dim=64, dit_depth=2, dit_heads=4, text_dim=32,
        text_conv_layers=1, vocoder_dim=64, vocoder_intermediate_dim=128,
        vocoder_num_layers=2, nfe_step=4, frame_buckets=(128, 256),
        max_batch_size=4, use_kernels=False, compute_dtype="float32",
    )
    kw.update(overrides)
    return ModelConfig(**kw)


def _simple_model(rng) -> tuple[bytes, dict]:
    """A Gemm(transB=1) + MatMul + grouped-Conv graph with known weights."""
    wq = rng.standard_normal((8, 8)).astype(np.float32)  # square, [out, in]
    wm = rng.standard_normal((8, 16)).astype(np.float32)  # [in, out]
    cw = rng.standard_normal((16, 1, 7)).astype(np.float32)  # depthwise conv
    bias = rng.standard_normal(8).astype(np.float32)
    nodes = [
        ox.make_node("Gemm", ["x", "wq", "bias"], ["h"], name="attn_q", transB=1),
        ox.make_node("MatMul", ["h", "wm"], ["m"], name="ff"),
        ox.make_node("Conv", ["m", "cw"], ["y"], name="dw", group=16, kernel_shape=[7]),
    ]
    inits = [
        ox.make_tensor("wq", wq),
        ox.make_tensor("wm", wm),
        ox.make_tensor("cw", cw),
        ox.make_tensor("bias", bias),
    ]
    graph = ox.make_graph(
        "mini",
        nodes,
        inits,
        inputs=[ox.make_value_info("x", 1, [1, "N", 8])],
        outputs=[ox.make_value_info("y", 1, [1, "N", 16])],
    )
    weights = {"wq": wq, "wm": wm, "cw": cw, "bias": bias}
    return ox.make_model(graph), weights


class TestWireFormat:
    def test_round_trip_dtypes(self):
        rng = np.random.default_rng(0)
        arrays = {
            "f32": rng.standard_normal((3, 4)).astype(np.float32),
            "f16": rng.standard_normal(5).astype(np.float16),
            "i64": np.arange(-3, 3, dtype=np.int64),
            "i32": np.arange(6, dtype=np.int32).reshape(2, 3),
            "u8": np.arange(4, dtype=np.uint8),
        }
        inits = [ox.make_tensor(k, v) for k, v in arrays.items()]
        model = ox.parse_model(ox.make_model(ox.make_graph("g", [], inits)))
        for k, v in arrays.items():
            t = model.graph.initializers[k]
            assert t.dims == v.shape
            np.testing.assert_array_equal(t.array, v)

    def test_nodes_attributes_and_io(self):
        data, _ = _simple_model(np.random.default_rng(1))
        m = ox.parse_model(data)
        assert m.ir_version == 8 and m.opset == 17
        ops = [n.op_type for n in m.graph.nodes]
        assert ops == ["Gemm", "MatMul", "Conv"]
        gemm, _, conv = m.graph.nodes
        assert gemm.attrs["transB"] == 1
        assert conv.attrs["group"] == 16 and conv.attrs["kernel_shape"] == [7]
        assert m.graph.inputs[0].shape == [1, "N", 8]
        assert m.graph.outputs[0].name == "y"

    def test_typed_float_data_fallback(self):
        """TensorProto with float_data (no raw_data) parses too."""
        from vietvoice_tts_tpu_torch.models.onnx_pb import _emit, _emit_str

        out = bytearray()
        for d in (2, 2):
            _emit(out, 1, 0, d)
        _emit(out, 2, 0, 1)  # FLOAT
        _emit_str(out, 8, "t")
        # packed float_data
        _emit(out, 4, 2, np.asarray([1.0, 2.0, 3.0, 4.0], "<f4").tobytes())
        g = ox.make_graph("g", [], [bytes(out)])
        t = ox.parse_model(ox.make_model(g)).graph.initializers["t"]
        np.testing.assert_array_equal(t.array, [[1.0, 2.0], [3.0, 4.0]])

    @pytest.mark.parametrize("encoding", ["raw_data", "int32_data"])
    def test_bfloat16_widens_to_float32(self, encoding):
        """TensorProto type 16 decodes without ml_dtypes: each bfloat16 is
        the top half of a float32, so the widening is exact."""
        from vietvoice_tts_tpu_torch.models.onnx_pb import _emit, _emit_str

        f32 = np.asarray([[1.0, -2.5, 3.140625], [0.0, 65280.0, -1e-3]], np.float32)
        bits = (f32.view(np.uint32) >> 16).astype(np.uint16)  # truncate to bf16
        out = bytearray()
        for d in f32.shape:
            _emit(out, 1, 0, d)
        _emit(out, 2, 0, 16)  # BFLOAT16
        _emit_str(out, 8, "b")
        if encoding == "raw_data":
            _emit(out, 9, 2, bits.astype("<u2").tobytes())
        else:
            for b in bits.reshape(-1):
                _emit(out, 5, 0, int(b))
        g = ox.make_graph("g", [], [bytes(out)])
        t = ox.parse_model(ox.make_model(g)).graph.initializers["b"]
        assert t.data_type == 16 and t.array.dtype == np.float32
        expect = (bits.astype(np.uint32) << 16).view(np.float32)
        np.testing.assert_array_equal(t.array, expect)
        np.testing.assert_array_equal(t.array[0, :2], [1.0, -2.5])


def _fixture_tarball(tmp: Path, rng) -> tuple[Path, dict]:
    data, weights = _simple_model(rng)
    tar_path = tmp / "model-bin.pt"
    (tmp / "transformer.onnx").write_bytes(data)
    with tarfile.open(tar_path, "w") as tar:
        tar.add(tmp / "transformer.onnx", arcname="transformer.onnx")
    return tar_path, weights


class TestProbe:
    def test_orientations_from_consumers(self):
        data, _ = _simple_model(np.random.default_rng(2))
        g = ox.parse_model(data).graph
        orient = initializer_orientations(g)
        assert orient["wq"] == "transpose"  # Gemm transB=1 → [out, in]
        assert orient["wm"] == "as_is"  # MatMul operand B → [in, out]
        assert "cw" not in orient  # conv weights are not a Gemm question

    def test_probe_tarball_summary(self, temp_dir):
        tar_path, _ = _fixture_tarball(Path(temp_dir), np.random.default_rng(3))
        report = probe_tarball(tar_path)
        assert set(report) == {"transformer", "architecture"}
        t = report["transformer"]
        assert t["op_histogram"] == {"Gemm": 1, "MatMul": 1, "Conv": 1}
        assert t["convs"][0]["group"] == 16
        assert {i["name"] for i in t["initializers"]} == {"wq", "wm", "cw", "bias"}
        assert t["orientations"] == {"wq": "transpose", "wm": "as_is"}
        assert any(c["op"] == "Gemm" and c.get("transB") == 1
                   for c in t["consumers"]["wq"])

    def test_initializer_loading_from_tarball(self, temp_dir):
        tar_path, weights = _fixture_tarball(Path(temp_dir), np.random.default_rng(4))
        inits = load_onnx_initializers(tar_path)
        assert set(inits) == {"transformer"}
        np.testing.assert_array_equal(inits["transformer"]["wq"], weights["wq"])
        orient = load_graph_orientations(tar_path)
        assert orient["transformer.wq"] == "transpose"


class TestOrientationAwareMapping:
    def test_square_weight_transposed_by_consumer_evidence(self):
        """The round-1 advisor finding: a square [out,in] weight would match
        the template shape untransposed. Consumer orientation must flip it."""
        rng = np.random.default_rng(5)
        w = rng.standard_normal((6, 6)).astype(np.float32)
        template = {"attn": {"w": np.zeros((6, 6), np.float32)}}
        params, report = map_initializers_to_params(
            {"wq": w}, template, orientations={"wq": "transpose"}
        )
        assert report["unresolved"] == []
        assert report["transposed"] == ["wq"]
        np.testing.assert_array_equal(params["attn"]["w"], w.T)
        # Without orientation info the exact-shape match stays as-is.
        params2, report2 = map_initializers_to_params({"wq": w}, template)
        assert report2["transposed"] == []
        np.testing.assert_array_equal(params2["attn"]["w"], w)

    def test_name_map_transpose_flag(self):
        rng = np.random.default_rng(6)
        w = rng.standard_normal((4, 4)).astype(np.float32)
        template = {"a": {"w": np.zeros((4, 4), np.float32)}}
        params, report = map_initializers_to_params(
            {"x": w}, template, name_map={"a.w": {"name": "x", "transpose": True}}
        )
        assert report["unresolved"] == []
        np.testing.assert_array_equal(params["a"]["w"], w.T)
        # transpose=False pins the as-is orientation even if consumers said
        # otherwise (explicit flag wins).
        params2, _ = map_initializers_to_params(
            {"x": w},
            template,
            name_map={"a.w": {"name": "x", "transpose": False}},
            orientations={"x": "transpose"},
        )
        np.testing.assert_array_equal(params2["a"]["w"], w)

    def test_name_map_stacked_list(self):
        rng = np.random.default_rng(7)
        l0 = rng.standard_normal((3, 5)).astype(np.float32)  # [in, out]
        l1 = rng.standard_normal((5, 3)).astype(np.float32)  # [out, in] → flip
        template = {"blocks": {"w": np.zeros((2, 3, 5), np.float32)}}
        params, report = map_initializers_to_params(
            {"w0": l0, "w1": l1},
            template,
            name_map={"blocks.w": ["w0", {"name": "w1", "transpose": True}]},
        )
        assert report["unresolved"] == []
        np.testing.assert_array_equal(params["blocks"]["w"][0], l0)
        np.testing.assert_array_equal(params["blocks"]["w"][1], l1.T)

    def test_stacked_square_weights_use_orientation(self):
        """Per-layer square attn_out weights stored [out,in] stack transposed
        when every member's consumer says transB=1."""
        rng = np.random.default_rng(8)
        layers = [rng.standard_normal((4, 4)).astype(np.float32) for _ in range(3)]
        inits = {f"layer.{i}.out.weight": a for i, a in enumerate(layers)}
        template = {"attn_out": {"w": np.zeros((3, 4, 4), np.float32)}}
        orient = {n: "transpose" for n in inits}
        params, report = map_initializers_to_params(
            inits, template, orientations=orient
        )
        assert report["unresolved"] == []
        for i, a in enumerate(layers):
            np.testing.assert_array_equal(params["attn_out"]["w"][i], a.T)


class TestFullFixtureConversion:
    def test_convert_resolves_all_leaves_and_unmarks_synthetic(self, temp_dir):
        """End-to-end: fixture tarball (assets + ONNX graph holding every
        parameter leaf) → conversion resolves 100% → pack is non-synthetic
        and loads through the session manager without the synthetic gate."""
        from vietvoice_tts_tpu_torch.models.vocoder import VocoderConfig, init_vocoder_params
        from vietvoice_tts_tpu_torch.models.convert import _flatten
        from vietvoice_tts_tpu_torch.runtime.serialization import load_params

        root = Path(temp_dir)
        cfg = tiny_port_config(model_cache_dir=str(root / "cache"))

        # Assets (reference tarball layout, core/model.py:73-123).
        (root / "cleaned_audios").mkdir()
        vocab_chars = [chr(ord("a") + i) for i in range(26)]
        (root / "vocab.txt").write_text("\n".join(vocab_chars) + "\n")
        (root / "audio_metadata.json").write_text("[]")
        (root / "cleaned_audios" / "x.wav").write_bytes(b"RIFFfake")

        # One initializer per template leaf, exact shapes, fresh values.
        dit_cfg = DiTConfig(
            dim=cfg.dit_dim, depth=cfg.dit_depth, heads=cfg.dit_heads,
            ff_mult=cfg.dit_ff_mult, n_mels=cfg.n_mels, text_dim=cfg.text_dim,
            text_conv_layers=cfg.text_conv_layers, vocab_size=len(vocab_chars),
        )
        voc_cfg = VocoderConfig(
            dim=cfg.vocoder_dim, intermediate_dim=cfg.vocoder_intermediate_dim,
            num_layers=cfg.vocoder_num_layers, n_mels=cfg.n_mels,
            n_fft=cfg.n_fft, hop_length=cfg.hop_length,
        )
        template = {
            "dit": init_dit_params(cfg.random_seed, dit_cfg),
            "vocoder": init_vocoder_params(cfg.random_seed + 1, voc_cfg),
        }
        rng = np.random.default_rng(99)
        flat = _flatten(template)
        values = {
            path: rng.standard_normal(np.shape(leaf)).astype(np.float32)
            for path, leaf in flat.items()
        }
        inits = [ox.make_tensor(f"g.{p}", v) for p, v in values.items()]
        graph = ox.make_graph("transformer", [], inits)
        (root / "transformer.onnx").write_bytes(ox.make_model(graph))

        tar_path = root / "model-bin.pt"
        with tarfile.open(tar_path, "w") as tar:
            for name in ("vocab.txt", "audio_metadata.json",
                         "cleaned_audios/x.wav", "transformer.onnx"):
                tar.add(root / name, arcname=name)

        name_map = {p: f"transformer.g.{p}" for p in flat}
        pack = root / "pack"
        # This fixture graph is a node-less bag of initializers (it tests
        # LEAF RESOLUTION only) — the round-5 topology gate rightly rejects
        # it as structurally alien, so opt out explicitly here.
        report = convert_reference_tarball(
            tar_path, pack, config=cfg, name_map=name_map,
            skip_topology_check=True,
        )
        assert report["weights"]["unresolved"] == []
        assert report["weights"]["resolved"] == len(flat)

        meta = json.loads((pack / "model_meta.json").read_text())
        assert meta["synthetic"] is False

        params = load_params(pack / "params.msgpack")
        np.testing.assert_array_equal(
            params["dit"]["final_proj"]["w"], values["dit.final_proj.w"]
        )

        # The converted pack loads under the no-synthetic gate.
        from vietvoice_tts_tpu_torch.runtime.session import ModelSessionManager
        import shutil

        cache = root / "cache2"
        gated = tiny_port_config(model_cache_dir=str(cache), allow_synthetic_pack=False)
        shutil.copytree(pack, Path(gated.model_path))
        # A converted pack has no bundled audios here; metadata is empty.
        mgr = ModelSessionManager(gated)
        mgr.load_models()
        assert mgr.is_synthetic is False
        assert mgr.vocab_size == len(vocab_chars)


class TestArchitectureConflicts:
    """infer_architecture must refuse to guess when evidence disagrees."""

    def _model_with_rope_dims(self, d1, d2):
        outs = [
            ox.make_value_info(f"rope_cos_q", 1, [1, "N", d1]),
            ox.make_value_info(f"rope_sin_q", 1, [1, "N", d1]),
            ox.make_value_info(f"rope_cos_k", 1, [1, "N", d2]),
            ox.make_value_info(f"rope_sin_k", 1, [1, "N", d2]),
        ]
        graph = ox.make_graph("preprocess", [], [], [], outs)
        return ox.parse_model(ox.make_model(graph))

    def test_disagreeing_rope_dims_is_conflict(self):
        from vietvoice_tts_tpu_torch.models.probe import infer_architecture

        arch = infer_architecture({"preprocess": self._model_with_rope_dims(64, 128)})
        assert "head_dim" in arch["conflicts"]
        assert "head_dim" not in arch["facts"]

    def test_conflict_blocks_conversion(self):
        from vietvoice_tts_tpu_torch.models.convert import apply_probed_architecture
        from vietvoice_tts_tpu_torch.models.probe import infer_architecture

        arch = infer_architecture({"preprocess": self._model_with_rope_dims(64, 128)})
        with pytest.raises(ValueError, match="conflicting"):
            apply_probed_architecture(None, arch)

    def test_agreeing_rope_dims_is_fact(self):
        from vietvoice_tts_tpu_torch.models.probe import infer_architecture

        arch = infer_architecture({"preprocess": self._model_with_rope_dims(64, 64)})
        assert arch["facts"]["head_dim"] == 64
        assert arch["conflicts"] == {}


def test_name_map_stacked_list_of_one():
    """A one-entry list is a depth-1 stack (a depth-1 model's name map), not
    a single leaf: it resolves to shape [1, ...]. (The JAX converter takes a
    one-entry list for a single leaf and leaves it unresolved.)"""
    from vietvoice_tts_tpu.models.convert import map_initializers_to_params as jax_map

    w = np.arange(15, dtype=np.float32).reshape(5, 3)  # [out, in]
    template = {"blocks": {"w": np.zeros((1, 3, 5), np.float32)}}
    name_map = {"blocks.w": [{"name": "w0", "transpose": True}]}
    params, report = map_initializers_to_params({"w0": w}, template, name_map=name_map)
    assert report["unresolved"] == [] and report["transposed"] == ["w0"]
    np.testing.assert_array_equal(params["blocks"]["w"], w.T[None])
    _, jax_report = jax_map({"w0": w}, template, name_map=name_map)
    assert jax_report["unresolved"] == ["blocks.w"]
