"""The port's training data, loop and entry point against the JAX package.

CPU, ``conftest.tiny_config`` dims, float32. ``TextMelDataset`` gives the
JAX loader's batches in the same order (text ids and lengths equal, the
log-mel within 1e-4 at 99.9% of values, see MEL_ATOL); ``train()`` runs, resumes, checkpoints and exports a pack
that the JAX package reads, and whose DiT the JAX ``dit_forward`` runs to
the port's output within 1e-4; ``python -m vietvoice_tts_tpu_torch.training``
trains on the CPU with JAX, flax, msgpack, optax and orbax blocked.
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_config
from test_torch_slice import REPO, port_config

from vietvoice_tts_tpu.models import dit as jdit
from vietvoice_tts_tpu.runtime.serialization import load_params as jax_load_params
from vietvoice_tts_tpu.training import data as jdata
from vietvoice_tts_tpu_torch.models import dit as tdit
from vietvoice_tts_tpu_torch.models.params import dit_state, to_jax_tree
from vietvoice_tts_tpu_torch.runtime.serialization import load_params
from vietvoice_tts_tpu_torch.training import __main__ as tmain
from vietvoice_tts_tpu_torch.training import data as tdata
from vietvoice_tts_tpu_torch.training import loop as tloop
from vietvoice_tts_tpu_torch.training.checkpoint import CheckpointManager
from vietvoice_tts_tpu_torch.training.train import TrainConfig


# Log-mel, port against JAX. Both front ends are plain float32 products of
# the same bases and differ only in summation order, but the bins far below
# a frame's loud harmonics are ill-conditioned: on the tiny pack's clips
# 0.029-0.036% of the values differ by more than 1e-4, by up to 8.8e-4 (at
# log-mel ≈ −4.7, float64 puts JAX 1.6e-4 and the port 4.0e-4 off), and the
# mean difference is 1.3e-6 to 1.4e-6. Bounds: 1e-4 for all but 0.1% of the
# values, MEL_ATOL for every value, MEL_MEAN_ATOL for the mean.
MEL_ATOL = 3e-3
MEL_MEAN_ATOL = 1e-5


@pytest.fixture
def pack(tiny_pack_dir):
    return Path(tiny_pack_dir) / "vietvoice-tpu-v1"


@pytest.fixture
def pack_copy(tiny_pack_dir, tmp_path):
    """A private copy of the tiny pack: ``train()`` exports into its pack."""
    root = tmp_path / "models"
    shutil.copytree(Path(tiny_pack_dir) / "vietvoice-tpu-v1", root / "vietvoice-tpu-v1")
    return root


def _run(**kw):
    defaults = dict(steps=3, batch_size=2, checkpoint_every=1, log_every=1)
    defaults.update(kw)
    return tloop.TrainRunConfig(**defaults)


# -- Manifest and dataset --------------------------------------------------------


class TestManifest:
    def test_from_pack_matches_jax(self, pack):
        assert tdata.manifest_from_pack(pack) == jdata.manifest_from_pack(pack)
        assert len(tdata.manifest_from_pack(pack)) == 42

    def test_jsonl_round_trip_and_malformed_record(self, pack, tmp_path):
        records = tdata.manifest_from_pack(pack)[:3]
        path = tmp_path / "m.jsonl"
        path.write_text("".join(json.dumps(r, ensure_ascii=False) + "\n\n" for r in records))
        assert tdata.load_manifest(path) == jdata.load_manifest(path) == records
        bad = tmp_path / "bad.jsonl"
        bad.write_text('{"audio": "x.wav"}\n')
        with pytest.raises(ValueError):
            tdata.load_manifest(bad)


@pytest.mark.parametrize("batch_size,seed,drop_last", [(4, 1, False), (8, None, True), (5, 0, False)])
def test_dataset_matches_jax(pack, tiny_pack_dir, batch_size, seed, drop_last):
    """Same batches in the same order: text ids and lengths equal, mel as
    close as MEL_ATOL says; iterating twice gives the same batches again
    (the shuffle is re-seeded per ``__iter__``)."""
    records = tdata.manifest_from_pack(pack)
    jcfg = tiny_config(model_cache_dir=tiny_pack_dir)
    tcfg = port_config(model_cache_dir=tiny_pack_dir)
    kw = dict(batch_size=batch_size, shuffle_seed=seed, drop_last=drop_last)
    ref = list(jdata.TextMelDataset(records, jcfg, pack / "vocab.txt", **kw))
    ds = tdata.TextMelDataset(records, tcfg, pack / "vocab.txt", **kw)
    got = list(ds)
    assert len(got) == len(ref) > 1
    for (mel, ids, lengths), (rmel, rids, rlengths) in zip(got, ref):
        assert mel.dtype == np.float32 and mel.shape == rmel.shape
        assert mel.shape[1] in tcfg.frame_buckets and mel.shape[2] == tcfg.n_mels
        np.testing.assert_array_equal(ids, np.asarray(rids))
        np.testing.assert_array_equal(lengths, np.asarray(rlengths))
        diff = np.abs(mel - np.asarray(rmel))
        assert (diff > 1e-4).mean() <= 1e-3, (diff > 1e-4).mean()
        assert diff.max() <= MEL_ATOL and diff.mean() <= MEL_MEAN_ATOL, (diff.max(), diff.mean())
    for (a, _, _), (b, _, _) in zip(got, ds):
        np.testing.assert_array_equal(a, b)


# -- The loop ---------------------------------------------------------------------


def test_train_resume_and_export_read_back_by_jax(pack_copy, tmp_path):
    """3 steps, then resumed to 5 (tests/test_data_pipeline.py:70-105); the
    export replaces only ``dit`` and is the last checkpoint's DiT; the JAX
    package reads it and its dit_forward agrees with the port's."""
    cfg = port_config(model_cache_dir=str(pack_copy))
    pack = Path(cfg.model_path)
    before = load_params(pack / "params.msgpack")
    ckpt_dir = str(tmp_path / "ckpt")
    tcfg = TrainConfig(warmup_steps=1)
    first = tloop.train(cfg, tcfg, _run(checkpoint_dir=ckpt_dir, export_to_pack=False))
    assert first["final_step"] == 3 and len(first["losses"]) == 3
    assert np.isfinite(first["final_loss"]) and len(first["step_seconds"]) == 3
    second = tloop.train(cfg, tcfg, _run(steps=5, checkpoint_dir=ckpt_dir))
    assert second["final_step"] == 5 and len(second["losses"]) == 2
    assert CheckpointManager(ckpt_dir).all_steps() == [3, 4, 5]

    exported = jax_load_params(pack / "params.msgpack")
    model_state, _, step = CheckpointManager(ckpt_dir).restore()
    assert step == 5
    for a, b in zip(_flat(exported["dit"]), _flat(to_jax_tree(model_state))):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_flat(exported["vocoder"]), _flat(before["vocoder"])):
        np.testing.assert_array_equal(a, b)
    assert any(not np.array_equal(a, b) for a, b in zip(_flat(exported["dit"]), _flat(before["dit"])))

    dims = dict(dim=cfg.dit_dim, depth=cfg.dit_depth, heads=cfg.dit_heads, ff_mult=cfg.dit_ff_mult,
                n_mels=cfg.n_mels, text_dim=cfg.text_dim, text_conv_layers=cfg.text_conv_layers,
                vocab_size=json.loads((pack / "model_meta.json").read_text())["vocab_size"])
    rng = np.random.default_rng(3)
    b, n = 2, 64
    x, cond = (rng.standard_normal((b, n, cfg.n_mels)).astype(np.float32) for _ in range(2))
    ids = rng.integers(-1, dims["vocab_size"], (b, n)).astype(np.int32)
    t = np.array([0.3, 0.8], np.float32)
    mask = np.arange(n)[None, :] < np.array([n, 40])[:, None]
    ref = jdit.dit_forward(exported["dit"], jdit.DiTConfig(**dims, compute_dtype=jnp.float32),
                           *map(jnp.asarray, (x, cond, ids, t, mask)))
    dit = tdit.DiT(tdit.DiTConfig(**dims, compute_dtype=torch.float32))
    dit.load_state_dict(dit_state(load_params(pack / "params.msgpack")["dit"], torch.float32),
                        assign=True)
    with torch.no_grad():
        out = dit(*map(torch.from_numpy, (x, cond, ids, t, mask)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-4)


def _flat(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flat(tree[k])]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in _flat(v)]
    return [np.asarray(tree)]


def test_training_steps_run_without_kernels(pack_copy, tmp_path, monkeypatch):
    """Even with ``use_kernels=True`` in the model config, every step
    ``train()`` takes runs a DiT built with ``use_kernels=False``."""
    seen = []
    real = tloop.make_train_step

    def recording(dit_cfg, train_cfg, *mesh):
        step = real(dit_cfg, train_cfg, *mesh)

        def wrapped(dit, *args):
            seen.append(dit.cfg.use_kernels)
            return step(dit, *args)

        return wrapped

    monkeypatch.setattr(tloop, "make_train_step", recording)
    cfg = port_config(model_cache_dir=str(pack_copy), use_pallas=True)
    assert cfg.use_kernels
    tloop.train(cfg, TrainConfig(compute_dtype="bfloat16"),
                _run(steps=2, checkpoint_dir=str(tmp_path / "c"), export_to_pack=False))
    assert seen == [False, False]


@pytest.mark.parametrize("mesh", [(2, 1), (1, 4)])
def test_mesh_axes_raise_until_parallel_is_ported(mesh, tmp_path):
    """Mesh axes of (data, model) in the config make ``train`` build that
    mesh; in a process with no group of that many ranks it raises, naming
    ``torchrun``, before anything is loaded or written."""
    run = _run(checkpoint_dir=str(tmp_path / "ckpt"))
    cfg = port_config(model_cache_dir=str(tmp_path), mesh_data_axis=mesh[0],
                      mesh_model_axis=mesh[1])
    with pytest.raises(ValueError, match="torchrun"):
        tloop.train(cfg, TrainConfig(), run)
    assert not any(tmp_path.iterdir())


# -- The entry point ----------------------------------------------------------------


def test_entry_point_without_a_card_exits_1(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["x", "--steps", "1", "--checkpoint-dir", str(tmp_path)])
    with pytest.raises(SystemExit) as exc:
        tmain.main()
    assert exc.value.code == 1
    assert "CUDA" in capsys.readouterr().err
    assert not any(tmp_path.iterdir())


def test_entry_point_flags_are_the_jax_ones_without_mesh():
    opts = {a.dest for a in tmain.build_parser()._actions}
    assert opts == {"help", "manifest", "steps", "batch_size", "learning_rate",
                    "checkpoint_dir", "model_cache_dir", "device", "mesh_data", "mesh_model"}
    assert tmain.build_parser().parse_args([]).device == "cuda"


def test_trains_on_the_cpu_with_jax_blocked(pack_copy, tmp_path):
    """A fresh interpreter in which importing jax, flax, msgpack, optax or
    orbax fails runs ``python -m vietvoice_tts_tpu_torch.training --device
    cpu`` for two steps on the tiny pack (whose widths it adopts)."""
    code = textwrap.dedent(
        f"""
        import runpy, sys
        for name in ("jax", "flax", "msgpack", "optax", "orbax", "vietvoice_tts_tpu"):
            sys.modules[name] = None
        sys.argv = ["vietvoice-tts-torch-train", "--device", "cpu", "--steps", "2",
                    "--batch-size", "2", "--model-cache-dir", {str(pack_copy)!r},
                    "--checkpoint-dir", {str(tmp_path / "ckpt")!r}]
        runpy.run_module("vietvoice_tts_tpu_torch.training", run_name="__main__")
        assert not any(m.split(".")[0] in ("jax", "flax", "msgpack", "optax", "orbax",
                                           "vietvoice_tts_tpu")
                       for m, mod in sys.modules.items() if mod is not None)
        """
    )
    env = {**os.environ, "VIETVOICE_LOG_LEVEL": "WARNING"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Device: cpu" in proc.stdout
    summary = proc.stdout.strip().splitlines()[-1]
    assert "'final_step': 2" in summary and np.isfinite(float(summary.split("'final_loss': ")[1][:-1]))
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["1.pt", "2.pt"]
