"""The golden harness's sweeps in the PyTorch port against the JAX harness's
(CPU, float32, tiny widths).

``cfg_cache_sweep``, ``deep_cache_sweep`` and ``precision_drift`` of
``vietvoice_tts_tpu_torch/golden.py`` against those of the repo-root
``golden.py``, each on one pack that both packages read: the same records
(keys, settings in order, the exact row exactly 0), every setting's latent
within 1e-5 of the JAX sweep's, and ``precision_drift`` feeding the engine
the same inputs bit for bit with f32 latents within 1e-4. The latents and
inputs are recorded by a spy on each package's
``EngineCore.mel_latent_batch``. Then the port's one change to the sweeps
(a first setting that is not exact raises) and the three command-line flags.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest

import golden as jax_golden
from conftest import tiny_config
from vietvoice_tts_tpu.runtime.engine_core import EngineCore as JaxCore
from vietvoice_tts_tpu.runtime.serialization import load_params, save_params
from vietvoice_tts_tpu.runtime.session import ModelSessionManager
from vietvoice_tts_tpu.runtime.session import config_from_pack as jax_config_from_pack
from vietvoice_tts_tpu_torch import golden as tgolden
from vietvoice_tts_tpu_torch.runtime.engine_core import EngineCore as TorchCore

LATENT_TOL = 1e-5  # each sweep setting's latent, port vs JAX (f32)
DRIFT_TOL = 2e-5  # mel_mae_vs_exact, port vs JAX: two latents within LATENT_TOL
DRIFT_F32_TOL = 1e-4  # precision_drift's f32 latents, port vs JAX (32 steps)
GATE_STD = 0.01  # opened AdaLN gates, as chip_smoke.py:ADA_STD

# (kind, settings, pack): the cfg cache on the depth-2 pack, the deep cache
# on the depth-4 pack (its shallow blocks must lie in [1, depth)).
SWEEPS = {
    "cfg": ("cfg_cache_sweep", "intervals", (1, 2, 4), "tiny"),
    "deep": ("deep_cache_sweep", "settings", ((1, 1), (2, 1), (2, 3), (3, 2)), "deep"),
}


def _gated_copy(src: Path, dst: Path, seed: int) -> Path:
    """A copy of a pack with its AdaLN gates opened, N(0, GATE_STD²): the
    synthetic pack's gates are exactly zero, so every block would add
    nothing and a skipped block would change no latent."""
    shutil.copytree(src, dst)
    params = load_params(dst / "params.msgpack")
    rng = np.random.default_rng(seed)
    for sub in (params["dit"]["blocks"]["ada"], params["dit"]["final_ada"]):
        for k in sub:
            sub[k] = rng.normal(0.0, GATE_STD, np.shape(sub[k])).astype(np.float32)
    save_params(dst / "params.msgpack", params)
    return dst


@pytest.fixture(scope="module")
def packs(tiny_pack_dir, tmp_path_factory):
    """The shared tiny pack (`tiny_pack_dir`, depth 2) and a depth-4 pack, both
    materialized by the JAX package, gates opened → {name: (pack, NFE)}."""
    root = tmp_path_factory.mktemp("sweep_packs")
    deep = tiny_config(model_cache_dir=str(root / "deep_src"), dit_depth=4, nfe_step=8)
    ModelSessionManager(deep).load_models()
    tiny = Path(tiny_config(model_cache_dir=tiny_pack_dir).model_path)
    return {"tiny": (_gated_copy(tiny, root / "tiny" / tiny.name, 5), 4),
            "deep": (_gated_copy(Path(deep.model_path), root / "deep" / tiny.name, 6), 8)}


def _oracle_ref(pack: Path, nfe_step: int, n_frames=128, ref_len=32, seed=0) -> dict:
    """A reference-side dict whose ref_mel is the JAX engine's f32 latent for
    a known noise (``tests/test_golden.py:_oracle_ref``)."""
    from vietvoice_tts_tpu.pipeline.text import TextProcessor

    cfg = jax_config_from_pack(pack, nfe_step=nfe_step, use_pallas=False,
                               compute_dtype="float32", transfer_dtype="float32")
    core = JaxCore(cfg, load_params(pack / "params.msgpack"), cfg.vocab_size)
    rng = np.random.default_rng(seed)
    hop = cfg.hop_length
    audio = rng.uniform(-0.3, 0.3, ref_len * hop).astype(np.float32)
    wave = np.zeros((1, n_frames * hop), np.float32)
    wave[0, : len(audio)] = audio
    combined = "xin chào đây là giọng tham khảo. một câu để tổng hợp."
    ids, _ = TextProcessor(str(pack / "vocab.txt")).encode_padded(combined, n_frames)
    x0 = rng.standard_normal((1, n_frames, cfg.n_mels)).astype(np.float32)
    latent = core.mel_latent_batch(
        wave, np.asarray([ref_len], np.int32), ids[None],
        np.asarray([n_frames], np.int32), x0=x0,
    )
    return {
        "audio": wave[0],
        "combined_text": combined,
        "noise": x0,
        "ref_mel": np.asarray(latent),
        "ref_signal_len": ref_len,
        "nfe_step": nfe_step,
    }


def _settings_of(rows) -> list:
    """The sweep settings of a record's rows, in order."""
    return [r["uncond_interval"] if "uncond_interval" in r
            else (r["deep_cache_interval"], r["deep_cache_blocks"]) for r in rows]


def _spy(mp: pytest.MonkeyPatch, cls) -> list:
    """Record every ``mel_latent_batch`` call of ``cls``: (compute dtype,
    positional inputs, x0, latent), all as numpy."""
    calls = []
    orig = cls.mel_latent_batch

    def spy(self, *args, **kw):
        out = orig(self, *args, **kw)
        calls.append((str(self.config.compute_dtype), [np.asarray(a) for a in args],
                      np.asarray(kw["x0"]), np.asarray(out)))
        return out

    mp.setattr(cls, "mel_latent_batch", spy)
    return calls


def _run_both(fn_name: str, jax_kw: dict, torch_kw: dict, *args, **kw):
    """One harness function of each package → ((record, calls) JAX,
    (record, calls) port)."""
    out = []
    for mod, cls, extra in ((jax_golden, JaxCore, jax_kw), (tgolden, TorchCore, torch_kw)):
        with pytest.MonkeyPatch.context() as mp:
            calls = _spy(mp, cls)
            out.append((getattr(mod, fn_name)(*args, **kw, **extra), calls))
    return out


@pytest.fixture(scope="module")
def refs(packs):
    return {name: _oracle_ref(pack, nfe) for name, (pack, nfe) in packs.items()}


@pytest.fixture(scope="module", params=sorted(SWEEPS))
def sweep(request, packs, refs):
    fn_name, arg, settings, pack_name = SWEEPS[request.param]
    pack = packs[pack_name][0]
    (jrec, jcalls), (trec, tcalls) = _run_both(
        fn_name,
        {"use_pallas": False, "compute_dtype": "float32", "transfer_dtype": "float32"},
        {"device": "cpu", "compute_dtype": "float32"},
        pack, refs[pack_name], repeats=1, **{arg: settings},
    )
    return {"settings": settings, "jax": jrec, "torch": trec,
            "jcalls": jcalls, "tcalls": tcalls}


def test_sweep_record_has_jax_keys_and_setting_order(sweep):
    jrec, trec = sweep["jax"], sweep["torch"]
    assert list(trec) == list(jrec)
    assert trec["metric"] == jrec["metric"] and trec["frames"] == jrec["frames"] == 128
    assert [list(r) for r in trec["rows"]] == [list(r) for r in jrec["rows"]]
    assert _settings_of(trec["rows"]) == _settings_of(jrec["rows"]) == list(sweep["settings"])


def test_sweep_exact_row_is_zero(sweep):
    for rec in (sweep["jax"], sweep["torch"]):
        exact = rec["rows"][0]
        assert exact["mel_mae_vs_exact"] == 0.0 and exact["mel_max_abs_vs_exact"] == 0.0
        assert exact["speedup_vs_exact"] == 1.0
        assert all(r["latent_ms"] > 0 for r in rec["rows"])
    # Every approximate setting moves the latent.
    assert all(r["mel_mae_vs_exact"] > 0 for r in sweep["torch"]["rows"][1:])


def test_sweep_latents_match_jax(sweep):
    """One untimed and one timed solve per setting (repeats=1), the same
    inputs on both sides, each latent within LATENT_TOL of JAX's."""
    jcalls, tcalls = sweep["jcalls"], sweep["tcalls"]
    assert len(tcalls) == len(jcalls) == 2 * len(sweep["settings"])
    for (_, jargs, jx0, jlat), (_, targs, tx0, tlat) in zip(jcalls, tcalls):
        for a, b in zip(jargs, targs):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(jx0, tx0)
        assert np.abs(tlat - jlat).max() <= LATENT_TOL
    # The timed solve repeats the untimed one exactly.
    for first, again in zip(tcalls[::2], tcalls[1::2]):
        np.testing.assert_array_equal(first[3], again[3])


def test_sweep_drift_matches_jax(sweep):
    for jrow, trow in zip(sweep["jax"]["rows"], sweep["torch"]["rows"]):
        for key in ("mel_mae_vs_exact", "mel_max_abs_vs_exact", "mel_mae_vs_onnx"):
            assert abs(trow[key] - jrow[key]) <= DRIFT_TOL, (key, trow, jrow)


# -- precision_drift --------------------------------------------------------------


@pytest.fixture(scope="module")
def drift(packs):
    pack = packs["tiny"][0]
    (jrec, jcalls), (trec, tcalls) = _run_both(
        "precision_drift", {}, {"device": "cpu"}, pack, frames=(96, 128), ref_frames=32, seed=3)
    return {"jax": jrec, "torch": trec, "jcalls": jcalls, "tcalls": tcalls}


def test_precision_drift_record_has_jax_keys(drift):
    jrec, trec = drift["jax"], drift["torch"]
    assert list(trec) == list(jrec)
    assert trec["metric"] == "serving_precision_drift" and trec["ref_frames"] == 32
    assert trec["compute_dtype"] == jrec["compute_dtype"] == "bfloat16"
    assert [list(r) for r in trec["rows"]] == [list(r) for r in jrec["rows"]]
    assert [r["frames"] for r in trec["rows"]] == [96, 128]
    for row in trec["rows"]:
        assert 0 < row["mel_mae"] <= row["mel_max_abs"] and row["rel_mae"] > 0


def test_precision_drift_feeds_jax_inputs_bit_for_bit(drift):
    """Per bucket the f32 solve then the serving one, each on the inputs the
    JAX harness draws from the same seed."""
    jcalls, tcalls = drift["jcalls"], drift["tcalls"]
    assert [c[0] for c in tcalls] == ["float32", "bfloat16"] * 2
    assert [c[0] for c in jcalls] == ["float32", "bfloat16"] * 2
    for (_, jargs, jx0, _), (_, targs, tx0, _) in zip(jcalls, tcalls):
        assert [a.dtype for a in targs] == [a.dtype for a in jargs]
        for a, b in zip(jargs, targs):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(jx0, tx0)


def test_precision_drift_f32_latents_match_jax(drift):
    for jcall, tcall in zip(drift["jcalls"][::2], drift["tcalls"][::2]):
        assert np.abs(tcall[3] - jcall[3]).max() <= DRIFT_F32_TOL


# -- The port's repair: the baseline must be exact --------------------------------


@pytest.mark.parametrize("fn_name, kw", [
    ("cfg_cache_sweep", {"intervals": (2, 4)}),
    ("deep_cache_sweep", {"settings": ((2, 1), (3, 1))}),
])
def test_non_exact_first_setting_raises(fn_name, kw, tmp_path):
    """Checked before the pack is read: the pack here does not exist."""
    with pytest.raises(ValueError, match="first setting must be exact"):
        getattr(tgolden, fn_name)(tmp_path / "absent", {"nfe_step": 4}, **kw)


# -- The command line ---------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_npz(packs, refs, tmp_path_factory):
    """Each pack's reference in ``--save-ref``'s format."""
    out = {}
    for name, ref in refs.items():
        path = tmp_path_factory.mktemp("ref") / f"{name}.npz"
        np.savez(path, **{k: np.asarray(v) for k, v in ref.items() if k != "combined_text"},
                 combined_text=np.asarray(str(ref["combined_text"])))
        out[name] = path
    return out


@pytest.mark.parametrize("flag, value, pack_name, metric, settings", [
    ("--cfg-cache-sweep", "1,2", "tiny", "cfg_cache_price", [1, 2]),
    ("--deep-cache-sweep", "1:2,2:2", "deep", "deep_cache_price", [(1, 2), (2, 2)]),
])
def test_cli_sweep_prints_one_json_line(flag, value, pack_name, metric, settings,
                                        packs, ref_npz, capsys):
    rc = tgolden.main(["--cpu", flag, value, "--ref-npz", str(ref_npz[pack_name]),
                       "--pack", str(packs[pack_name][0])])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["metric"] == metric and rec["precision"] == "float32"
    assert _settings_of(rec["rows"]) == settings
    # The reference is the JAX engine's exact f32 latent.
    assert rec["rows"][0]["mel_mae_vs_onnx"] < 1e-5


def test_cli_precision_drift(packs, capsys):
    rc = tgolden.main(["--cpu", "--precision-drift", "256", "--pack", str(packs["tiny"][0])])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["metric"] == "serving_precision_drift"
    assert [r["frames"] for r in rec["rows"]] == [256]
    # Without --pack it is skipped, as the JAX harness does.
    assert tgolden.main(["--cpu", "--precision-drift", "256"]) == 0
    assert json.loads(capsys.readouterr().out)["status"] == "skipped"


@pytest.mark.parametrize("argv", [
    ["--cfg-cache-sweep", "2,4"],
    ["--deep-cache-sweep", "2:1"],
    ["--deep-cache-sweep", "1:1,2"],
    ["--cfg-cache-sweep", "1,x"],
])
def test_cli_bad_sweep_settings_exit_2(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        tgolden.main(["--cpu", *argv])
    assert exc.value.code == 2
    assert "usage" in capsys.readouterr().err
