"""The PyTorch port's conversion toolchain against the JAX package's, on one
tiny F5-shaped fixture tarball made from a seed (CPU, float32).

Both packages build the same fixture, probe it alike, evaluate its graphs to
the same bits, verify its topology alike, convert it into array-equal packs
that each package reads, and preflight it alike except for the attention
route advice (each names its own kernels). The port's golden harness
(``vietvoice_tts_tpu_torch/golden.py``) against the JAX harness's
``tpu_side``: the same latent within 1e-5, both within 1e-4 mel MAE of the
ONNX reference side. Last, the whole conversion day runs in a fresh
interpreter with jax, flax, msgpack, ml_dtypes and onnxruntime blocked.
"""

import json
import os
import subprocess
import sys
import tarfile
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest

import golden as jax_golden
from vietvoice_tts_tpu.models import convert as jconvert
from vietvoice_tts_tpu.models import f5_fixture as jfixture
from vietvoice_tts_tpu.models import onnx_eval as jeval
from vietvoice_tts_tpu.models import onnx_pb as jpb
from vietvoice_tts_tpu.models import preflight as jpreflight
from vietvoice_tts_tpu.models import probe as jprobe
from vietvoice_tts_tpu.models import topology as jtopology
from vietvoice_tts_tpu.runtime import serialization as jser
from vietvoice_tts_tpu_torch import golden as tgolden
from vietvoice_tts_tpu_torch.models import convert as tconvert
from vietvoice_tts_tpu_torch.models import f5_fixture as tfixture
from vietvoice_tts_tpu_torch.models import onnx_eval as teval
from vietvoice_tts_tpu_torch.models import onnx_pb as tpb
from vietvoice_tts_tpu_torch.models import preflight as tpreflight
from vietvoice_tts_tpu_torch.models import probe as tprobe
from vietvoice_tts_tpu_torch.models import topology as ttopology
from vietvoice_tts_tpu_torch.runtime import serialization as tser

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "vietvoice_tts_tpu_torch"

SEED = 7
NFE = 8
TEXT = "xin chào"


def _spec(mod):
    """The tiny spec at a head shape kernel 1 takes (2 × 64)."""
    return mod.FixtureSpec(
        dim=128, depth=2, heads=2, ff_mult=2, n_mels=20, text_dim=32,
        text_conv_layers=2, vocab_size=211, voc_dim=48, voc_inter=96,
        voc_layers=2, nfe_step=NFE,
    )


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp("parity")
    jtar, jmap, jparams = jfixture.write_fixture_tarball(
        root / "jax" / "model-bin.pt", _spec(jfixture), seed=SEED, ref_seconds=0.5)
    ttar, tmap, tparams = tfixture.write_fixture_tarball(
        root / "torch" / "model-bin.pt", _spec(tfixture), seed=SEED, ref_seconds=0.5)
    # One tarball feeds both converters.
    jrep = jconvert.convert_reference_tarball(jtar, root / "jpack", name_map=jmap)
    trep = tconvert.convert_reference_tarball(jtar, root / "tpack", name_map=tmap)
    return dict(root=root, tar=jtar, ttar=ttar, jmap=jmap, tmap=tmap,
                jparams=jparams, tparams=tparams, jrep=jrep, trep=trep,
                jpack=root / "jpack", tpack=root / "tpack")


@pytest.fixture(scope="module")
def reference(fixture):
    return tgolden.reference_side(str(fixture["tar"]), TEXT, nfe_step=NFE)


def _flat(tree):
    return tconvert._flatten(tree)


def _graphs(tar):
    with tarfile.open(tar) as t:
        return {Path(m.name).stem: t.extractfile(m).read()
                for m in t.getmembers() if m.name.endswith(".onnx")}


# -- The fixture ---------------------------------------------------------------


def test_fixture_tarballs_are_byte_equal(fixture):
    """One seed gives one fixture in both packages: the port's numpy
    initialisers draw in the JAX order, AdaLN gates included."""
    with tarfile.open(fixture["tar"]) as a, tarfile.open(fixture["ttar"]) as b:
        names = a.getnames()
        assert names == b.getnames()
        for n in names:
            assert a.extractfile(n).read() == b.extractfile(n).read(), n
    assert fixture["jmap"] == fixture["tmap"]
    jp, tp = _flat(fixture["jparams"]), _flat(fixture["tparams"])
    assert set(jp) == set(tp)
    for k in jp:
        np.testing.assert_array_equal(np.asarray(jp[k]), tp[k], err_msg=k)
    # The gates are open, so the rehearsal tests attention, not a zero.
    assert np.abs(tp["dit.blocks.ada.w"]).max() > 0


def test_committed_name_maps_agree():
    jmap = json.loads((REPO / "vietvoice_tts_tpu/models/f5_name_map.json").read_text())
    tmap = json.loads((PACKAGE / "models/f5_name_map.json").read_text())
    assert jmap == tmap == tfixture.build_name_map(tfixture.FixtureSpec())


# -- Reader, probe, evaluator, topology ------------------------------------------


def test_parse_and_probe_agree(fixture):
    for stem, data in _graphs(fixture["tar"]).items():
        jm, tm = jpb.parse_model(data), tpb.parse_model(data)
        assert [(n.op_type, n.inputs, n.outputs) for n in jm.graph.nodes] == [
            (n.op_type, n.inputs, n.outputs) for n in tm.graph.nodes], stem
        assert set(jm.graph.initializers) == set(tm.graph.initializers)
        for name, t in jm.graph.initializers.items():
            np.testing.assert_array_equal(t.array, tm.graph.initializers[name].array)
    jr = jprobe.probe_tarball(fixture["tar"])
    tr = tprobe.probe_tarball(fixture["tar"])
    assert json.dumps(jr, sort_keys=True, default=str) == json.dumps(
        tr, sort_keys=True, default=str)


def test_evaluator_bit_equal_on_all_three_graphs(fixture):
    graphs = _graphs(fixture["tar"])
    spec = _spec(tfixture)
    rng = np.random.default_rng(SEED)
    audio = (rng.uniform(-0.5, 0.5, (1, 1, 12000)) * 32767).astype(np.float32)
    ids = rng.integers(0, spec.vocab_size, (1, 20)).astype(np.int64)
    outs = {}
    for name, mod in (("jax", jeval), ("torch", teval)):
        pre = mod.EvalSession(graphs["preprocess"])
        feeds = dict(zip([i.name for i in pre.get_inputs()],
                         (audio, ids, np.asarray([90], np.int64))))
        p = pre.run(None, feeds)
        trans = mod.EvalSession(graphs["transformer"])
        t_names = [i.name for i in trans.get_inputs()]
        state = list(p[: len(t_names) - 1]) + [np.asarray([3], np.int32)]
        t = trans.run(None, dict(zip(t_names, state)))
        dec = mod.EvalSession(graphs["decode"])
        d = dec.run(None, {"noise": t[0], "ref_signal_len": p[-1]})
        outs[name] = p + t + d
    for a, b in zip(outs["jax"], outs["torch"]):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_topology_verdicts_agree(fixture):
    graphs = _graphs(fixture["tar"])
    facts = tprobe.infer_architecture(
        {k: tpb.parse_model(v) for k, v in graphs.items()})["facts"]
    jt = jtopology.verify_transformer(jpb.parse_model(graphs["transformer"]), facts)
    tt = ttopology.verify_transformer(tpb.parse_model(graphs["transformer"]), facts)
    assert tt["ok"] and jt == tt
    jp = jtopology.verify_preprocess(jpb.parse_model(graphs["preprocess"]), facts)
    tp = ttopology.verify_preprocess(tpb.parse_model(graphs["preprocess"]), facts)
    assert tp["ok"] and json.dumps(jp, sort_keys=True, default=str) == json.dumps(
        tp, sort_keys=True, default=str)


def test_preflight_agrees_except_route_advice(fixture):
    jr = jpreflight.preflight_report(fixture["tar"], name_map=fixture["jmap"])
    tr = tpreflight.preflight_report(fixture["tar"], name_map=fixture["tmap"])
    assert jr["ok"] and tr["ok"]
    route = tr["architecture"].pop("attention_route")
    assert route["kernel"] == 1
    jnotes, tnotes = jr["architecture"].pop("notes"), tr["architecture"].pop("notes")
    assert tnotes == [route["advice"]]
    assert jnotes == ["heads=2 head_dim=64: fused Pallas attention applies"]
    assert json.dumps(jr, sort_keys=True, default=str) == json.dumps(
        tr, sort_keys=True, default=str)


# -- Conversion -------------------------------------------------------------------


def test_converted_packs_are_array_equal(fixture):
    assert fixture["trep"]["weights"]["unresolved"] == []
    assert fixture["jrep"]["weights"] == fixture["trep"]["weights"]
    assert fixture["jrep"]["architecture"] == fixture["trep"]["architecture"]
    jp = _flat(jser.load_params(fixture["jpack"] / "params.msgpack"))
    tp = _flat(tser.load_params(fixture["tpack"] / "params.msgpack"))
    assert set(jp) == set(tp)
    for k in jp:
        assert np.asarray(jp[k]).dtype == tp[k].dtype, k
        np.testing.assert_array_equal(np.asarray(jp[k]), tp[k], err_msg=k)
    # And both equal the parameters the fixture was exported from.
    src = _flat(fixture["tparams"])
    for k in src:
        np.testing.assert_array_equal(src[k], tp[k], err_msg=k)


def test_model_meta_equal(fixture):
    jm = json.loads((fixture["jpack"] / "model_meta.json").read_text())
    tm = json.loads((fixture["tpack"] / "model_meta.json").read_text())
    assert jm == tm
    assert tm["synthetic"] is False and tm["dit"]["heads"] == 2
    for name in ("vocab.txt", "audio_metadata.json", "audios/ref.wav"):
        assert (fixture["jpack"] / name).read_bytes() == (fixture["tpack"] / name).read_bytes()


def test_each_package_reads_the_others_pack(fixture):
    for pack in (fixture["jpack"], fixture["tpack"]):
        a = _flat(jser.load_params(pack / "params.msgpack"))
        b = _flat(tser.load_params(pack / "params.msgpack"))
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), b[k], err_msg=k)
    from vietvoice_tts_tpu.runtime.session import config_from_pack as jcfg
    from vietvoice_tts_tpu_torch.runtime.session import config_from_pack as tcfg

    for pack in (fixture["jpack"], fixture["tpack"]):
        j, t = jcfg(pack), tcfg(pack, device="cpu")
        for f in ("dit_dim", "dit_depth", "dit_heads", "text_dim", "text_conv_layers",
                  "vocab_size", "n_mels", "vocoder_dim", "vocoder_num_layers",
                  "vocoder_intermediate_dim", "model_name"):
            assert getattr(j, f) == getattr(t, f), f


def test_apply_probed_architecture_builds_a_host_config(fixture):
    """With no config the probe's facts build one on the CPU (conversion is
    host work; the default device would need a card)."""
    arch = tprobe.probe_tarball(fixture["tar"])["architecture"]
    cfg = tconvert.apply_probed_architecture(None, arch)
    assert cfg.device == "cpu" and cfg.dit_heads == 2 and cfg.head_dim == 64
    jcfg = jconvert.apply_probed_architecture(None, arch)
    for f in tconvert._ARCH_FIELD_MAP.values():
        assert getattr(cfg, f) == getattr(jcfg, f), f


# -- The golden harness --------------------------------------------------------------


def test_reference_sides_agree(fixture, reference):
    jref = jax_golden.reference_side(str(fixture["tar"]), TEXT, nfe_step=NFE)
    assert set(jref) == set(reference)
    for k, v in jref.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(v, reference[k], err_msg=k)
        else:
            assert v == reference[k], k
    assert reference["ref_signal_len"] == 46  # 0.5 s / 256-sample hop


def test_torch_side_against_jax_tpu_side(fixture, reference):
    """f32 on the CPU: the port's latent within 1e-5 of the JAX harness's,
    both within 1e-4 mel MAE of the ONNX reference, over the valid frames."""
    from vietvoice_tts_tpu.runtime.engine_core import EngineCore as JaxEngineCore
    from vietvoice_tts_tpu.runtime.session import config_from_pack as jcfg

    latent, info = tgolden.torch_latent(
        fixture["tpack"], reference, device="cpu", compute_dtype="float32")
    # The JAX harness's tpu_side, keeping its latent.
    pack = fixture["jpack"]
    cfg = jcfg(pack, nfe_step=NFE, compute_dtype="float32", transfer_dtype="float32",
               use_pallas=False)
    core = JaxEngineCore(cfg, jser.load_params(pack / "params.msgpack"), cfg.vocab_size)
    wave, ref_len, ids, n, noise, ref_mel = jax_golden._latent_inputs(cfg, pack, reference)
    with jax.default_matmul_precision("highest"):
        jlatent = core.mel_latent_batch(
            wave, np.asarray([ref_len], np.int32), ids[None],
            np.asarray([n], np.int32), x0=noise)
    valid = slice(ref_len, n)
    assert np.abs(latent[0, valid] - np.asarray(jlatent)[0, valid]).max() <= 1e-5

    trep = tgolden.torch_side(fixture["tpack"], reference, device="cpu",
                              compute_dtype="float32")
    jrep = jax_golden.tpu_side(pack, reference, compute_dtype="float32",
                               transfer_dtype="float32")
    for rep in (trep, jrep):
        assert rep["allclose"] and rep["mel_mae"] < 1e-4, rep
    assert set(trep) == set(jrep)
    assert (trep["frames"], trep["ref_frames"]) == (jrep["frames"], jrep["ref_frames"])
    # The JAX-converted pack serves the port alike.
    other, _ = tgolden.torch_latent(fixture["jpack"], reference, device="cpu",
                                    compute_dtype="float32")
    np.testing.assert_array_equal(other, latent)


def test_golden_cli_on_the_cpu(fixture, capsys):
    """``python -m vietvoice_tts_tpu_torch.golden --cpu``: both sides from the
    tarball, one JSON line, exit 0 when allclose."""
    name_map = fixture["root"] / "name_map.json"
    name_map.write_text(json.dumps(fixture["tmap"]))
    rc = tgolden.main(["--cpu", "--onnx-tarball", str(fixture["tar"]),
                       "--name-map", str(name_map),
                       "--text", TEXT, "--nfe-step", str(NFE),
                       "--save-ref", str(fixture["root"] / "ref.npz")])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["status"] == "ok" and out["precision"] == "float32"
    assert out["mel_mae"] < 1e-4
    rc = tgolden.main(["--cpu", "--ref-npz", str(fixture["root"] / "ref.npz"),
                       "--pack", str(fixture["tpack"])])
    again = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and again["mel_mae"] == out["mel_mae"]
    assert tgolden.main([]) == 0
    assert json.loads(capsys.readouterr().out)["status"] == "skipped"


# -- Independence ------------------------------------------------------------------------


def test_port_imports_no_ml_dtypes_and_onnxruntime_only_in_golden():
    for path in PACKAGE.rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.strip().split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                root = words[1].split(".")[0]
                assert root != "ml_dtypes", f"{path}: {line}"
                if root == "onnxruntime":
                    assert path == PACKAGE / "golden.py", f"{path}: {line}"


def test_conversion_day_with_jax_blocked(tmp_path):
    """A fresh interpreter in which jax, flax, msgpack, ml_dtypes and
    onnxruntime cannot be imported: fixture → preflight → convert →
    reference_side → torch_side on the CPU, then one TTSApi request served
    from the converted pack with synthetic packs refused."""
    code = textwrap.dedent(
        f"""
        import sys
        for name in ("jax", "flax", "msgpack", "ml_dtypes", "onnxruntime"):
            sys.modules[name] = None
        import numpy as np
        import vietvoice_tts_tpu_torch as vt
        from vietvoice_tts_tpu_torch.golden import reference_side, torch_side
        from vietvoice_tts_tpu_torch.models import onnx_pb
        from vietvoice_tts_tpu_torch.models.convert import convert_reference_tarball
        from vietvoice_tts_tpu_torch.models.f5_fixture import FixtureSpec, write_fixture_tarball
        from vietvoice_tts_tpu_torch.models.preflight import preflight_report

        root = {str(tmp_path)!r}
        spec = FixtureSpec(dim=128, depth=2, heads=2, ff_mult=2, n_mels=20, text_dim=16,
                           text_conv_layers=2, vocab_size=211, voc_dim=32, voc_inter=64,
                           voc_layers=2, nfe_step=4)
        tar, name_map, _ = write_fixture_tarball(root + "/model-bin.pt", spec, seed=1,
                                                 ref_seconds=0.5)
        # As the fixture's CLI does: the sibling map conversion finds itself.
        import json
        tar.with_suffix(".name_map.json").write_text(json.dumps(name_map))
        report = preflight_report(tar)
        assert report["ok"], report["blockers"]
        assert report["architecture"]["attention_route"]["kernel"] == 1
        conv = convert_reference_tarball(tar, root + "/packs/vietvoice-tpu-v1")
        assert conv["weights"]["unresolved"] == []
        ref = reference_side(str(tar), "xin chào", nfe_step=4)
        rep = torch_side(root + "/packs/vietvoice-tpu-v1", ref, device="cpu",
                         compute_dtype="float32")
        assert rep["allclose"] and rep["mel_mae"] < 1e-4, rep
        # bfloat16 initializers decode without ml_dtypes.
        bits = np.asarray([0x3F80, 0xC020], np.uint16)
        t = onnx_pb.parse_model(onnx_pb.make_model(onnx_pb.make_graph("g", [], [
            bytes([0x08, 2, 0x10, 16, 0x42, 1, 0x62]) + bytes([0x4A, 4]) + bits.tobytes()
        ]))).graph.initializers["b"]
        assert t.array.tolist() == [1.0, -2.5]
        from vietvoice_tts_tpu_torch.runtime.session import config_from_pack
        cfg = config_from_pack(root + "/packs/vietvoice-tpu-v1", device="cpu",
                               allow_synthetic_pack=False, nfe_step=4,
                               compute_dtype="float32", frame_buckets=(128, 256))
        assert (cfg.dit_heads, cfg.head_dim) == (2, 64)
        wave, _ = vt.TTSApi(cfg).synthesize("Xin chào.")
        assert wave.dtype == np.int16 and wave.size > 0
        assert not any(m.split(".")[0] in ("jax", "flax", "msgpack", "ml_dtypes",
                                           "onnxruntime", "vietvoice_tts_tpu")
                       for m, mod in sys.modules.items() if mod is not None)
        print("OK", rep["mel_mae"], wave.size)
        """
    )
    env = {**os.environ, "VIETVOICE_LOG_LEVEL": "WARNING"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK")
