"""The serving slice of the PyTorch port against the JAX package, end to end.

Both packages run at ``conftest.tiny_config`` dims in float32 on the CPU,
from the same weight pack and the same injected noise. Covered: the pack
codec, the numpy initialisers, the whole mel-latent solve with opened AdaLN
gates, int16 PCM from a shared latent, text and chunk planning, config
defaults, the copied framework-free modules, the blocking ``TTSApi`` path,
and that the port imports and runs with JAX blocked.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from conftest import tiny_config

import vietvoice_tts_tpu_torch as vt
from vietvoice_tts_tpu import config as jconfig
from vietvoice_tts_tpu.models import dit as jdit
from vietvoice_tts_tpu.models import vocoder as jvoc
from vietvoice_tts_tpu.pipeline import audio as jaudio
from vietvoice_tts_tpu.pipeline import text as jtext
from vietvoice_tts_tpu.runtime.engine_core import EngineCore as JaxEngineCore
from vietvoice_tts_tpu.runtime.session import config_from_pack as jax_config_from_pack
from vietvoice_tts_tpu.utils import wavio as jwavio
from vietvoice_tts_tpu_torch import config as tconfig
from vietvoice_tts_tpu_torch.models import dit as tdit
from vietvoice_tts_tpu_torch.models import vocoder as tvoc
from vietvoice_tts_tpu_torch.models.sampler import SamplerConfig, row_noise, sway_time_grid
from vietvoice_tts_tpu_torch.pipeline import audio as taudio
from vietvoice_tts_tpu_torch.pipeline import text as ttext
from vietvoice_tts_tpu_torch.runtime import serialization as tser
from vietvoice_tts_tpu_torch.runtime.engine_core import EngineCore as TorchEngineCore
from vietvoice_tts_tpu_torch.runtime.session import ModelSessionManager as TorchSession
from vietvoice_tts_tpu_torch.runtime.session import config_from_pack
from vietvoice_tts_tpu_torch.utils import logging as tlogging
from vietvoice_tts_tpu_torch.utils import wavio as twavio

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "vietvoice_tts_tpu_torch"

CORPUS = [
    "Xin chào Việt Nam!",
    "Hôm nay trời đẹp; chúng ta (cùng nhau) đi dạo... ở công viên,,, nhé",
    "Dòng một\nDòng hai không có dấu chấm\n\nDòng ba.",
    "Giá là 100$ & 50% giảm giá: mua ngay @ cửa hàng / online?",
    "emoji 😀 và ký tự lạ ★ bị loại bỏ",
    " ".join(["Người dân thành phố thức dậy sớm để chuẩn bị cho một ngày làm việc mới."] * 9),
    "Một câu rất dài " + "với nhiều từ nối tiếp nhau mà không có dấu phẩy " * 12 + "kết thúc.",
]


def port_config(**overrides) -> vt.ModelConfig:
    """The port's twin of ``tiny_config`` (CPU, no kernels)."""
    jax_fields = tiny_config(**overrides).to_dict()
    names = {f.name for f in dataclasses.fields(vt.ModelConfig)}
    kw = {k: v for k, v in jax_fields.items() if k in names}
    kw.update(device="cpu", use_kernels=jax_fields["use_pallas"])
    return vt.ModelConfig(**kw)


def _open_gates(tree, seed=5):
    """Copy of a pack tree with random blocks.ada and final_ada."""
    rng = np.random.default_rng(seed)
    out = jax.tree.map(np.array, tree)
    for sub in (out["dit"]["blocks"]["ada"], out["dit"]["final_ada"]):
        for k in sub:
            sub[k] = rng.normal(0.0, 0.05, sub[k].shape).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def pack_tree(tiny_pack_dir):
    path = Path(tiny_pack_dir) / "vietvoice-tpu-v1" / "params.msgpack"
    return tser.load_params(path)


@pytest.fixture(scope="module")
def cores(tiny_pack_dir, pack_tree):
    """(JAX EngineCore, port EngineCore) on one pack with opened gates."""
    params = _open_gates(pack_tree)
    vocab = len((Path(tiny_pack_dir) / "vietvoice-tpu-v1" / "vocab.txt").read_text().splitlines())
    jcore = JaxEngineCore(
        tiny_config(model_cache_dir=tiny_pack_dir, transfer_dtype="float32"), params, vocab
    )
    tcore = TorchEngineCore(port_config(model_cache_dir=tiny_pack_dir), params, vocab)
    return jcore, tcore


def _batch(n=128, seed=3):
    rng = np.random.default_rng(seed)
    wave = (0.2 * rng.standard_normal((2, n * 256))).astype(np.float32)
    ref_len = np.array([40, 60], np.int32)
    total_len = np.array([100, n], np.int32)
    ids = rng.integers(0, 150, (2, n)).astype(np.int32)
    ids[0, 90:] = -1
    x0 = rng.standard_normal((2, n, 100)).astype(np.float32)
    return wave, ref_len, ids, total_len, x0


# -- Weight pack ---------------------------------------------------------------


class TestPackCodec:
    def test_reads_jax_pack_identically(self, tiny_pack_dir, pack_tree):
        path = Path(tiny_pack_dir) / "vietvoice-tpu-v1" / "params.msgpack"
        ref = serialization.msgpack_restore(path.read_bytes())
        assert jax.tree.structure(pack_tree) == jax.tree.structure(ref)
        for ours, theirs in zip(jax.tree.leaves(pack_tree), jax.tree.leaves(ref)):
            assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
            assert np.array_equal(ours, theirs)

    def test_flax_reads_port_pack_identically(self, pack_tree, tmp_path):
        tser.save_params(tmp_path / "p.msgpack", pack_tree)
        data = (tmp_path / "p.msgpack").read_bytes()
        back = serialization.msgpack_restore(data)
        assert jax.tree.structure(back) == jax.tree.structure(pack_tree)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(pack_tree)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        # Byte-for-byte the file flax itself writes.
        assert data == serialization.msgpack_serialize(jax.tree.map(np.asarray, pack_tree))

    @pytest.mark.parametrize(
        "value",
        [
            None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2**32, 2**63 + 5,
            -1, -32, -33, -128, -129, -32768, -40000, -(2**31) - 1, -(2**62),
            0.5, -1e300, "", "a" * 31, "ế" * 40, "x" * 70000, b"", b"\x00" * 300,
            b"y" * 70000, [], list(range(20)), [list(range(16))] * 3,
            {str(i): i for i in range(20)}, {"nested": {"k": [1, "two", None]}},
        ],
    )
    def test_matches_msgpack_library(self, value):
        ours = tser.packb(value)
        assert ours == msgpack.packb(value, use_bin_type=True)
        assert tser.unpackb(ours) == msgpack.unpackb(ours, raw=False, strict_map_key=False)

    @pytest.mark.parametrize(
        "arr",
        [
            np.arange(6, dtype=np.float32).reshape(2, 3),
            np.zeros((0, 4), np.float32),
            np.array(3.5, np.float64),
            np.arange(5, dtype=np.int16),
            np.array([True, False]),
            np.ones((2, 2, 2), np.uint8),
        ],
    )
    def test_arrays_and_scalars_match_flax(self, arr):
        tree = {"a": arr, "i": np.int64(-7), "s": np.float32(2.25)}  # flax sorts keys
        data = tser.packb(tree)
        assert data == serialization.msgpack_serialize(tree)
        back = tser.unpackb(data)
        assert back["a"].dtype == arr.dtype and np.array_equal(back["a"], arr)
        assert back["s"] == np.float32(2.25) and isinstance(back["s"], np.float32)
        assert back["i"] == -7 and isinstance(back["i"], np.int64)

    def test_chunked_array_raises(self):
        data = msgpack.packb({"w": {"__msgpack_chunked_array__": True, "shape": {}}})
        with pytest.raises(ValueError, match="chunked"):
            tser.unpackb(data)

    def test_malformed_input_raises(self):
        with pytest.raises(ValueError):
            tser.unpackb(b"\x92\x01")  # array of 2 with one element
        with pytest.raises(ValueError):
            tser.unpackb(b"\x01\x02")  # trailing bytes
        with pytest.raises(TypeError):
            tser.packb({"x": object()})


class TestInitialisers:
    def test_dit_and_vocoder_bit_identical(self):
        """Same RNG draws in the same order: one seed, one pack."""
        dims = dict(dim=32, depth=3, heads=2, ff_mult=2, n_mels=8, text_dim=16,
                    text_conv_layers=2, vocab_size=30)
        vdims = dict(dim=16, intermediate_dim=24, num_layers=2, n_mels=8, n_fft=64,
                     hop_length=16)
        jr, tr = np.random.default_rng(11), np.random.default_rng(11)
        ref = {"dit": jdit.init_dit_params(jr, jdit.DiTConfig(**dims)),
               "vocoder": jvoc.init_vocoder_params(jr, jvoc.VocoderConfig(**vdims))}
        ours = {"dit": tdit.init_dit_params(tr, tdit.DiTConfig(**dims)),
                "vocoder": tvoc.init_vocoder_params(tr, tvoc.VocoderConfig(**vdims))}
        assert jax.tree.structure(ours) == jax.tree.structure(ref)
        for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(ref)):
            assert a.dtype == b.dtype and np.array_equal(a, b)

    def test_materialized_pack_identical(self, tiny_pack_dir, tmp_path):
        cfg = port_config(model_cache_dir=str(tmp_path))
        mgr = TorchSession(cfg)
        mgr.load_models()
        ours, theirs = Path(cfg.model_path), Path(tiny_pack_dir) / "vietvoice-tpu-v1"
        for name in ("params.msgpack", "vocab.txt", "audio_metadata.json", "model_meta.json"):
            assert (ours / name).read_bytes() == (theirs / name).read_bytes(), name
        for wav in (theirs / "audios").iterdir():
            assert (ours / "audios" / wav.name).read_bytes() == wav.read_bytes()
        assert mgr.is_synthetic and mgr.vocab_size == len(ttext.VALID_CHARS)


# -- The model path ------------------------------------------------------------


class TestSolve:
    def test_mel_latent_matches_jax(self, cores):
        """The whole chunk solve (mel front-end, text embed, hoisted
        modulations, CFG-doubled Euler steps) from one shared x0."""
        jcore, tcore = cores
        wave, ref_len, ids, total_len, x0 = _batch()
        ref = jcore.mel_latent_batch(wave, ref_len, ids, total_len, x0=x0)
        out = tcore.mel_latent_batch(wave, ref_len, ids, total_len, x0=x0)
        assert out.shape == ref.shape == (2, 128, 100)
        assert np.abs(ref).max() > 1.0
        np.testing.assert_allclose(out, ref, atol=1e-3, rtol=0)
        assert (out[0, 100:] == 0).all()

    def test_int16_pcm_from_shared_latent(self, cores):
        """Vocoder + ground-truth reference prefix + int16 truncation."""
        jcore, tcore = cores
        wave, ref_len, _, total_len, _ = _batch(seed=8)
        rng = np.random.default_rng(9)
        latent = (rng.standard_normal((2, 128, 100)) * 2.0 - 4.0).astype(np.float32)
        mel = np.asarray(jcore.frontend(jnp.asarray(wave)))
        frames = np.arange(128)
        is_ref = frames[None] < ref_len[:, None]
        mask = frames[None] < total_len[:, None]
        packed = jcore._finish_waveform(
            jcore.params, jnp.asarray(mel), jnp.asarray(is_ref), jnp.asarray(mask),
            jnp.asarray(latent), 0,
        )
        ref = np.asarray(packed).view(np.int16).reshape(2, -1)
        with torch.inference_mode():
            out = tcore._finish_waveform(
                *(torch.tensor(a) for a in (mel, is_ref, mask, latent))
            ).numpy()
        assert out.dtype == np.int16 and out.shape == ref.shape == (2, 128 * 256)
        assert np.abs(ref).max() > 100
        assert np.abs(out.astype(np.int32) - ref.astype(np.int32)).max() <= 1

    def test_sway_grid_matches_jax(self):
        from vietvoice_tts_tpu.models.sampler import SamplerConfig as JaxSamplerConfig
        from vietvoice_tts_tpu.models.sampler import sway_time_grid as jax_grid

        for nfe, sway in ((32, -1.0), (8, 0.0), (5, 0.5)):
            ours = sway_time_grid(SamplerConfig(nfe_step=nfe, sway_sampling_coef=sway))
            ref = jax_grid(JaxSamplerConfig(nfe_step=nfe, sway_sampling_coef=sway))
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6, rtol=0)

    def test_row_noise_independent_of_batch(self):
        both = row_noise(9527, [3, 8], 16, 4, torch.device("cpu"))
        alone = row_noise(9527, [8], 16, 4, torch.device("cpu"))
        assert torch.equal(both[1], alone[0]) and not torch.equal(both[0], both[1])
        assert not torch.equal(alone, row_noise(1, [8], 16, 4, torch.device("cpu")))

    def test_true_float32_scope_restores_tf32_flags(self):
        """The float32 parity mode turns TF32 off only while its batch runs."""
        from vietvoice_tts_tpu_torch.runtime.engine_core import _true_float32

        flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
        saved = [f.allow_tf32 for f in flags]
        try:
            for f in flags:
                f.allow_tf32 = True
            with _true_float32():
                assert not any(f.allow_tf32 for f in flags)
            assert all(f.allow_tf32 for f in flags)
        finally:
            for f, v in zip(flags, saved):
                f.allow_tf32 = v

    def test_cached_samplers_rejected(self, cores):
        """Each sampler cache runs on its own (test_torch_sampler_cache.py);
        only the two together are rejected."""
        from vietvoice_tts_tpu_torch.models.sampler import flow_matching_sample

        tcore = cores[1]
        z = torch.zeros((1, 8, 100))
        args = (z, torch.zeros((1, 8), dtype=torch.long), torch.ones((1, 8), dtype=torch.bool), [0])
        both = SamplerConfig(nfe_step=4, uncond_interval=2, deep_cache_interval=2,
                             deep_cache_blocks=1)
        with pytest.raises(ValueError, match="mutually exclusive"):
            flow_matching_sample(tcore.dit, both, *args)
        for cfg in (SamplerConfig(nfe_step=4, uncond_interval=2),
                    SamplerConfig(nfe_step=4, deep_cache_interval=2, deep_cache_blocks=1)):
            with torch.no_grad():
                assert flow_matching_sample(tcore.dit, cfg, *args, x0=z).shape == z.shape


# -- Host side -----------------------------------------------------------------


class TestHostCopies:
    @pytest.mark.parametrize("text", CORPUS)
    def test_text_functions(self, text):
        assert ttext.clean_text(text) == jtext.clean_text(text)
        cleaned = jtext.clean_text(text)
        assert ttext.text_length(cleaned) == jtext.text_length(cleaned)
        for max_chars in (20, 60, 135):
            assert ttext.chunk_text(cleaned, max_chars) == jtext.chunk_text(cleaned, max_chars)

    def test_encode_padded(self, tiny_pack_dir):
        vocab = Path(tiny_pack_dir) / "vietvoice-tpu-v1" / "vocab.txt"
        ours, ref = ttext.TextProcessor(vocab), jtext.TextProcessor(vocab)
        for text in CORPUS:
            for bucket in (16, 256):
                a, na = ours.encode_padded(text, bucket)
                b, nb = ref.encode_padded(text, bucket)
                assert na == nb and np.array_equal(a, b)

    def test_wavio_and_audio(self, tmp_path, monkeypatch):
        monkeypatch.setattr(jaudio, "_native_dsp", lambda: None)  # numpy path
        rng = np.random.default_rng(2)
        x = (0.5 * rng.standard_normal(4000)).astype(np.float32)
        assert twavio.wav_bytes(x, 24000) == jwavio.wav_bytes(x, 24000)
        twavio.write_wav(x, tmp_path / "a.wav", 16000)
        for ours, ref in zip(twavio.read_wav(tmp_path / "a.wav"), jwavio.read_wav(tmp_path / "a.wav")):
            assert np.array_equal(ours, ref)
        assert np.array_equal(
            taudio.AudioProcessor.load_audio(str(tmp_path / "a.wav"), 24000),
            jaudio.AudioProcessor.load_audio(str(tmp_path / "a.wav"), 24000),
        )
        loud = (rng.standard_normal(3000) * 40000).astype(np.float32)
        assert np.array_equal(taudio.AudioProcessor.fix_clipped_audio(loud),
                              jaudio.AudioProcessor.fix_clipped_audio(loud))
        waves = [(rng.standard_normal(n) * 3000).astype(np.int16) for n in (5000, 300, 7000)]
        for fade in (0.0, 0.01, 0.1):
            assert np.array_equal(
                taudio.AudioProcessor.concatenate_with_crossfade_improved(waves, fade, 24000),
                jaudio.AudioProcessor.concatenate_with_crossfade_improved(waves, fade, 24000),
            )

    def test_stage_timer_and_logger(self):
        timer = tlogging.StageTimer()
        with timer.stage("a"):
            pass
        with timer.stage("a"):
            pass
        assert timer.counts == {"a": 2} and set(timer.report()) == {"a"}
        timer.reset()
        assert timer.report() == {}
        assert tlogging.get_logger("x").name == "vietvoice_tts_tpu_torch.x"


class TestConfig:
    def test_shared_defaults_agree(self):
        ours = {f.name: f for f in dataclasses.fields(tconfig.ModelConfig)}
        ref = {f.name: f for f in dataclasses.fields(jconfig.ModelConfig)}
        shared = set(ours) & set(ref)
        assert len(shared) >= 40
        assert set(ours) - shared == {"device", "use_kernels"}
        for name in shared:
            a, b = ours[name], ref[name]
            if a.default_factory is not dataclasses.MISSING:
                assert a.default_factory() == b.default_factory(), name
            else:
                assert a.default == b.default, name
        assert ours["use_kernels"].default == ref["use_pallas"].default
        for const in ("MODEL_GENDER", "MODEL_GROUP", "MODEL_AREA", "MODEL_EMOTION"):
            assert getattr(tconfig, const) == getattr(jconfig, const)

    def test_config_from_pack_agrees(self, tiny_pack_dir):
        pack = Path(tiny_pack_dir) / "vietvoice-tpu-v1"
        ours = config_from_pack(pack, device="cpu").to_dict()
        ref = jax_config_from_pack(pack).to_dict()
        assert all(ours[k] == ref[k] for k in set(ours) & set(ref))

    def test_cuda_device_raises_without_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="cuda"):
            vt.ModelConfig(device="cuda")
        with pytest.raises(RuntimeError):
            vt.ModelConfig()  # the default device is cuda
        with pytest.raises(ValueError):
            vt.ModelConfig(device="meta")
        with pytest.raises(ValueError):
            vt.ModelConfig(device="cpu", compute_dtype="float16")
        assert vt.ModelConfig(device="cpu").device == "cpu"


# -- The blocking serving path ----------------------------------------------


@pytest.fixture(scope="module")
def port_api(tiny_pack_dir):
    api = vt.TTSApi(port_config(model_cache_dir=tiny_pack_dir))
    yield api
    api.cleanup()


class TestServing:
    def test_plan_chunks_identical(self, tiny_engine, port_api, sample_wav):
        eng = port_api.engine
        for voice in ({}, {"gender": "male", "area": "southern"},
                      {"reference_audio": sample_wav, "reference_text": "Xin chào."}):
            ref_audio, ref_text = tiny_engine.model_session_manager.select_sample(**voice)
            assert (ref_audio, ref_text) == eng.model_session_manager.select_sample(**voice)
            ref = eng._load_ref(ref_audio).astype(np.float32) / 32768.0
            assert np.array_equal(ref, tiny_engine._load_ref(ref_audio).astype(np.float32) / 32768.0)
            for text in CORPUS:
                for speed in (None, 1.7):
                    ours = eng._plan_chunks(ref, ref_text, text, speed=speed)
                    theirs = tiny_engine._plan_chunks(ref, ref_text, text, speed=speed)
                    assert [dataclasses.asdict(p) for p in ours] == [
                        dataclasses.asdict(p) for p in theirs
                    ]

    def test_synthesize_deterministic_with_jax_length(self, tiny_engine, port_api, tmp_path):
        text = "Xin chào, hôm nay trời rất đẹp."
        long_text = " ".join([text] * 40)
        for t in (text, long_text):
            a, secs = port_api.synthesize(t)
            b, _ = port_api.synthesize(t)
            ref, _ = tiny_engine.synthesize(t)
            assert a.dtype == np.int16 and a.size > 0 and np.any(a) and secs > 0
            assert np.array_equal(a, b)
            assert a.shape == ref.shape
        short, _ = port_api.synthesize(text)
        wav_bytes, _ = port_api.synthesize_to_bytes(text)
        assert wav_bytes[:4] == b"RIFF" and len(wav_bytes) == 44 + 2 * short.size
        out = tmp_path / "o.wav"
        assert port_api.synthesize_to_file(text, str(out)) > 0 and out.exists()
        with pytest.raises(ValueError):
            port_api.synthesize(None)
        with pytest.raises(ValueError):
            port_api.synthesize(text, gender="robot")

    def test_voice_clone(self, port_api, tiny_engine, sample_wav):
        kw = dict(reference_audio=sample_wav, reference_text="Xin chào thế giới.")
        a, _ = port_api.synthesize("Giọng được nhân bản.", **kw)
        ref, _ = tiny_engine.synthesize("Giọng được nhân bản.", **kw)
        assert a.shape == ref.shape and np.any(a)
        assert port_api.validate_configuration(sample_wav)


# -- Independence from JAX ----------------------------------------------------


def test_package_never_imports_jax():
    for path in PACKAGE.rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.strip().split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                root = words[1].split(".")[0]
                assert root not in {"jax", "flax", "msgpack", "vietvoice_tts_tpu"}, (
                    f"{path}: {line}"
                )


def test_runs_with_jax_blocked(tmp_path):
    """A fresh interpreter in which importing jax, flax or msgpack fails
    materializes a pack and synthesizes on the CPU."""
    code = textwrap.dedent(
        f"""
        import sys
        for name in ("jax", "flax", "msgpack"):
            sys.modules[name] = None
        import numpy as np
        import vietvoice_tts_tpu_torch as vt
        cfg = vt.ModelConfig(
            device="cpu", dit_dim=32, dit_depth=1, dit_heads=2, text_dim=16,
            text_conv_layers=1, vocoder_dim=16, vocoder_intermediate_dim=32,
            vocoder_num_layers=1, nfe_step=3, frame_buckets=(128, 256),
            compute_dtype="float32", model_cache_dir={str(tmp_path)!r},
        )
        wave, _ = vt.TTSApi(cfg).synthesize("Xin chào.")
        assert wave.dtype == np.int16 and wave.size > 0
        assert not any(m.split(".")[0] in ("jax", "flax", "msgpack", "vietvoice_tts_tpu")
                       for m, mod in sys.modules.items() if mod is not None)
        print("OK", wave.size)
        """
    )
    env = {**os.environ, "VIETVOICE_LOG_LEVEL": "WARNING"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK")
