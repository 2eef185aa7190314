"""The command line of the PyTorch port (``vietvoice_tts_tpu_torch/cli.py``),
counterpart of ``tests/test_cli.py``; everything runs with ``device="cpu"``.

Held against the JAX package: the two parsers offer the same options apart
from the ones that are tied to the backend (``--no-pallas`` / ``--no-kernels``,
``--device``), with equal defaults, types and choices; ``create_config`` gives equal values on every field the two
``ModelConfig`` share. Both comparisons are exact.
"""

import dataclasses
import sys
import wave as wave_file
from unittest.mock import MagicMock, patch

import numpy as np
import pytest
import torch

from test_torch_slice import port_config

import vietvoice_tts_tpu_torch as vt
import vietvoice_tts_tpu_torch.client as client_mod
from vietvoice_tts_tpu import cli as jcli
from vietvoice_tts_tpu_torch import cli
from vietvoice_tts_tpu_torch.cli import build_parser, create_config

JAX_ONLY = {"no_pallas"}
PORT_ONLY = {"no_kernels", "device"}


class TestParser:
    def test_minimal_args(self):
        args = build_parser().parse_args(["xin chào", "out.wav"])
        assert args.text == "xin chào"
        assert args.output == "out.wav"

    def test_voice_flags(self):
        args = build_parser().parse_args(
            ["t", "o.wav", "--gender", "female", "--area", "northern"]
        )
        assert args.gender == "female"
        assert args.area == "northern"

    def test_invalid_gender_rejected(self):
        with pytest.raises(SystemExit):
            build_parser().parse_args(["t", "o.wav", "--gender", "robot"])

    def test_device_flags(self):
        args = build_parser().parse_args(
            ["t", "o.wav", "--compute-dtype", "float32", "--device", "cpu", "--no-kernels"]
        )
        assert args.compute_dtype == "float32"
        assert args.device == "cpu"
        assert args.no_kernels is True
        assert build_parser().parse_args(["t", "o.wav"]).device == "cuda"

    @pytest.mark.parametrize("flag", ["--mesh-data", "--mesh-model", "--no-pallas"])
    def test_flags_that_wait_for_their_module_are_not_offered(self, flag):
        """``--no-pallas`` is not offered (``--no-kernels`` is); the mesh
        flags, which waited for ``parallel/``, are offered since it came."""
        if flag == "--no-pallas":
            with pytest.raises(SystemExit):
                build_parser().parse_args(["t", "o.wav", flag, "2"])
        else:
            args = build_parser().parse_args(["t", "o.wav", flag, "2"])
            assert getattr(args, flag[2:].replace("-", "_")) == 2


def _options(parser) -> dict:
    return {
        a.dest: (tuple(a.option_strings), a.default, a.type, a.choices, a.nargs, type(a).__name__)
        for a in parser._actions
    }


class TestAgainstJax:
    def test_parsers_offer_the_same_options(self):
        ours, ref = _options(build_parser()), _options(jcli.build_parser())
        assert set(ref) - set(ours) == JAX_ONLY
        assert set(ours) - set(ref) == PORT_ONLY
        for dest in set(ours) & set(ref):
            assert ours[dest] == ref[dest], dest
        assert ours["no_kernels"][1:] == ref["no_pallas"][1:]

    @pytest.mark.parametrize(
        "argv",
        [
            [],
            ["--speed", "1.1", "--nfe-step", "16"],
            ["--compute-dtype", "float32", "--max-batch-size", "4", "--cfg-strength", "1.5"],
            ["--nfe-uncond-interval", "2", "--random-seed", "7", "--cross-fade-duration", "0.2"],
            ["--nfe-deep-cache-interval", "2", "--nfe-deep-cache-blocks", "3"],
            ["--max-chunk-duration", "12", "--min-target-duration", "2", "--model-cache-dir", "x"],
        ],
    )
    def test_create_config_agrees_on_shared_fields(self, argv):
        ours = create_config(build_parser().parse_args(["t", "o.wav", "--device", "cpu", *argv]))
        ref = jcli.create_config(jcli.build_parser().parse_args(["t", "o.wav", *argv]))
        shared = {f.name for f in dataclasses.fields(ours)} & {
            f.name for f in dataclasses.fields(ref)
        }
        assert len(shared) >= 40
        for name in shared:
            assert getattr(ours, name) == getattr(ref, name), name
        assert ours.use_kernels == ref.use_pallas and ours.device == "cpu"

    def test_create_config_from_dict_agrees(self):
        settings = {"speed": None, "nfe_step": 8, "cfg_strength": 1.5, "max_batch_size": 4}
        ours = create_config({**settings, "device": "cpu"})
        ref = jcli.create_config(settings)
        for name in ("speed", "nfe_step", "cfg_strength", "max_batch_size", "max_chunk_duration"):
            assert getattr(ours, name) == getattr(ref, name), name

    def test_interactive_defaults_agree(self):
        ours, ref = cli._default_settings(), jcli._default_settings()
        assert set(ours) - set(ref) == {"device"} and ours["device"] == "cuda"
        assert all(ours[k] == ref[k] for k in ref)


class TestCreateConfig:
    def test_from_namespace(self):
        args = build_parser().parse_args(
            ["t", "o.wav", "--speed", "1.1", "--nfe-step", "16", "--device", "cpu"]
        )
        cfg = create_config(args)
        assert cfg.speed == 1.1
        assert cfg.nfe_step == 16
        assert cfg.device == "cpu"
        # CLI-facing default, not the config default.
        assert cfg.max_chunk_duration == 15.0

    def test_from_dict_ignores_none(self):
        cfg = create_config({"speed": None, "nfe_step": 8, "device": "cpu"})
        assert cfg.nfe_step == 8
        assert cfg.speed == 0.9  # dataclass default preserved

    def test_no_kernels_flag(self):
        args = build_parser().parse_args(["t", "o.wav", "--device", "cpu", "--no-kernels"])
        assert create_config(args).use_kernels is False

    def test_default_device_needs_a_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            create_config(build_parser().parse_args(["t", "o.wav"]))
        with pytest.raises(RuntimeError, match="CUDA"):
            create_config({"nfe_step": 8})

    def test_existing_pack_decides_the_architecture(self, tiny_pack_dir):
        tiny = port_config(model_cache_dir=tiny_pack_dir)
        args = build_parser().parse_args(
            ["t", "o.wav", "--device", "cpu", "--model-cache-dir", tiny_pack_dir, "--nfe-step", "4"]
        )
        cfg = create_config(args)
        for name in ("dit_dim", "dit_depth", "dit_heads", "text_dim", "vocoder_dim",
                     "vocoder_intermediate_dim", "vocoder_num_layers"):
            assert getattr(cfg, name) == getattr(tiny, name), name
        assert cfg.nfe_step == 4 and cfg.model_path == tiny.model_path


class TestMain:
    def _run(self, argv, api_mock):
        with patch.object(sys, "argv", ["vietvoice-tts", *argv]), patch.object(
            cli, "create_config", return_value=MagicMock(device="cpu")
        ), patch.object(client_mod, "TTSApi", return_value=api_mock):
            cli.main()

    def test_happy_path(self, capsys):
        api = MagicMock()
        api.synthesize_to_file.return_value = 1.23
        self._run(["xin chào", "out.wav"], api)
        api.synthesize_to_file.assert_called_once()
        out = capsys.readouterr().out
        assert "Synthesis complete" in out
        assert "Device: cpu" in out
        assert "fused_qkv_rope_attention=" in out and "flash_attention=" in out

    def test_warmup_flag_runs_the_engines_warmup(self):
        api = MagicMock()
        api.synthesize_to_file.return_value = 0.1
        self._run(["t", "o.wav", "--warmup"], api)
        api.engine.warmup.assert_called_once_with()

    def test_missing_output_errors(self):
        with patch.object(sys, "argv", ["vietvoice-tts", "only-text"]):
            with pytest.raises(SystemExit):
                cli.main()

    def test_ref_audio_without_text_errors(self):
        with patch.object(
            sys, "argv", ["vietvoice-tts", "t", "o.wav", "--reference-audio", "a.wav"]
        ):
            with pytest.raises(SystemExit):
                cli.main()

    def test_engine_error_exits_nonzero(self, capsys):
        api = MagicMock()
        api.synthesize_to_file.side_effect = RuntimeError("boom")
        with pytest.raises(SystemExit) as exc_info:
            self._run(["t", "o.wav"], api)
        assert exc_info.value.code == 1
        assert "boom" in capsys.readouterr().err

    def test_without_a_card_and_without_device_cpu_nothing_is_synthesized(
        self, capsys, monkeypatch, tmp_path
    ):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        out = tmp_path / "o.wav"
        with patch.object(sys, "argv", ["vietvoice-tts", "Xin chào.", str(out)]), patch.object(
            client_mod, "TTSApi"
        ) as api_cls:
            with pytest.raises(SystemExit) as exc_info:
                cli.main()
        assert exc_info.value.code == 1
        assert "CUDA" in capsys.readouterr().err
        api_cls.assert_not_called()
        assert not out.exists()

    def test_cpu_run_writes_a_wav(self, capsys, tiny_pack_dir, tmp_path):
        """The real engine, no patches: ``--device cpu`` on a small pack."""
        out = tmp_path / "o.wav"
        argv = ["Xin chào.", str(out), "--device", "cpu", "--model-cache-dir", tiny_pack_dir,
                "--nfe-step", "4", "--compute-dtype", "float32"]
        with patch.object(sys, "argv", ["vietvoice-tts", *argv]):
            cli.main()
        with wave_file.open(str(out), "rb") as fh:
            assert (fh.getframerate(), fh.getnchannels(), fh.getsampwidth()) == (24000, 1, 2)
            pcm = np.frombuffer(fh.readframes(fh.getnframes()), "<i2")
        assert pcm.size > 0 and np.any(pcm)
        shown = capsys.readouterr().out
        assert "Device: cpu" in shown
        assert "fused_qkv_rope_attention=0, flash_attention=0" in shown


class TestModuleLevelFunctions:
    def test_synthesize_and_synthesize_to_bytes(self, tiny_pack_dir, tmp_path):
        cfg = port_config(model_cache_dir=tiny_pack_dir)
        out = tmp_path / "m.wav"
        assert vt.synthesize("Xin chào.", str(out), config=cfg) > 0
        data, secs = vt.synthesize_to_bytes("Xin chào.", config=cfg)
        assert data[:4] == b"RIFF" and secs > 0
        assert out.read_bytes() == data  # deterministic: same text, same voice

    def test_main_module_runs_the_cli(self):
        import runpy

        with patch.object(sys, "argv", ["vietvoice-tts", "--help"]):
            with pytest.raises(SystemExit) as exc_info:
                runpy.run_module("vietvoice_tts_tpu_torch", run_name="__main__")
        assert exc_info.value.code == 0


class TestInteractive:
    def _session(self, inputs):
        it = iter(inputs)
        api = MagicMock()
        api.synthesize_to_file.return_value = 0.5
        with patch("builtins.input", lambda *a: next(it)), patch.object(
            cli, "create_config", return_value=MagicMock(device="cpu")
        ), patch.object(client_mod, "TTSApi", return_value=api):
            cli.run_interactive_mode()
        return api

    def test_immediate_synthesize(self):
        """Scripted session: text, default output, option 7, confirm."""
        api = self._session(["một câu thử", "", "7", "y"])
        api.synthesize_to_file.assert_called_once()
        kwargs = api.synthesize_to_file.call_args.kwargs
        assert kwargs["text"] == "một câu thử"
        assert kwargs["output_path"].endswith("output.wav")

    def test_voice_edit_then_synthesize(self):
        # text, output name, menu 1, gender=2 (female), group 0 keep,
        # area 0 keep, emotion 0 keep, menu 7, confirm y
        api = self._session(["văn bản", "giọng", "1", "2", "0", "0", "0", "7", "y"])
        assert api.synthesize_to_file.call_args.kwargs["gender"] == "female"

    def test_invalid_menu_choice_reprompts(self, capsys):
        self._session(["text", "out", "99", "7", "y"])
        assert "Invalid choice" in capsys.readouterr().out

    def test_confirm_without_a_card_reports_and_does_not_synthesize(self, capsys, monkeypatch):
        """The failure is shown and the menu comes back, where "Device
        Runtime" can set the CPU."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        settings = {"text": "text", "output": "out", **cli._default_settings()}
        with patch("builtins.input", lambda *a: "y"), patch.object(
            client_mod, "TTSApi"
        ) as api_cls:
            assert cli._confirm_and_synthesize(settings) is False
        api_cls.assert_not_called()
        assert "CUDA" in capsys.readouterr().out


def _fake_catalog(n):
    from vietvoice_tts_tpu_torch.reference_samples import ReferenceSample

    return [
        ReferenceSample(
            filename=f"clip_{i:03d}.wav",
            gender="female",
            group="news",
            area="northern",
            emotion="neutral",
            text=f"câu số {i}",
        )
        for i in range(n)
    ]


class TestBrowserPaging:
    """The sample browser pages past 20 matches, and rows whose clip is
    absent locally are marked and unselectable."""

    def _browse(self, n_samples, inputs, tmp_path, monkeypatch, clips_present=True):
        import vietvoice_tts_tpu_torch.reference_samples as rs

        audios = tmp_path / "audios"
        audios.mkdir(exist_ok=True)
        catalog = _fake_catalog(n_samples)
        if clips_present:
            for s in catalog:
                (audios / s.filename).write_bytes(b"RIFFfake")
        monkeypatch.setenv("VIETVOICE_TPU_CACHE", str(tmp_path))
        it = iter(inputs)
        settings = {
            "gender": None, "group": None, "area": None, "emotion": None,
            "reference_audio": None, "reference_text": None,
        }
        with patch("builtins.input", lambda *a: next(it)), patch.object(
            rs, "load_reference_samples", return_value=catalog
        ):
            return cli._browse_reference_samples(settings)

    def test_select_from_second_page(self, capsys, tmp_path, monkeypatch):
        # no filters (0,0,0) → 45 matches → page to 2 ("n"), pick #3 =
        # global index 22, decline playback.
        out = self._browse(45, ["0", "0", "0", "n", "3", "n"], tmp_path, monkeypatch)
        assert out["reference_audio"].endswith("clip_022.wav")
        assert out["reference_text"] == "câu số 22"
        assert "page 2/3" in capsys.readouterr().out

    def test_wraps_backward_from_first_page(self, tmp_path, monkeypatch):
        # "p" from page 1 of 3 wraps to page 3 (5 rows: 40..44); pick #5.
        out = self._browse(45, ["0", "0", "0", "p", "5", "n"], tmp_path, monkeypatch)
        assert out["reference_audio"].endswith("clip_044.wav")

    def test_cancel_returns_unchanged(self, tmp_path, monkeypatch):
        out = self._browse(45, ["0", "0", "0", "0"], tmp_path, monkeypatch)
        assert out["reference_audio"] is None

    def test_single_page_has_no_nav_hint(self, capsys, tmp_path, monkeypatch):
        out = self._browse(5, ["0", "0", "0", "2", "n"], tmp_path, monkeypatch)
        assert out["reference_audio"].endswith("clip_001.wav")
        assert "next page" not in capsys.readouterr().out

    def test_missing_clip_marked_and_unselectable(self, capsys, tmp_path, monkeypatch):
        out = self._browse(5, ["0", "0", "0", "2", "0"], tmp_path, monkeypatch,
                           clips_present=False)
        assert out["reference_audio"] is None  # selection refused, then cancel
        shown = capsys.readouterr().out
        assert "clip not local" in shown
        assert "not in the local pack" in shown
