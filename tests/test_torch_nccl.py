"""The mesh on NCCL: two ranks, each on a card of its own.

On such a host ``parallel/mesh.py`` joins the ranks with the backend
``cpu:gloo,cuda:nccl``: CUDA tensors go over NCCL, and host tensors (the
checkpoint's gather of a tensor-parallel model's shards) over gloo in the
same groups. This file drives that through the trainer: a DP 2 and a TP 2
step from one tree, batch and draws, and ``train(mesh=TP 2)`` with
whole-model checkpoints (``tests/torch_parallel_proc.py``'s rank body). The
CPU tests run the same body on gloo against JAX; here the TP step is held
to the DP step at those gates (loss 1e-5 relative, each parameter leaf 1e-4
of its max-abs), both float32 with TF32 off.

Marked ``cuda``; skips with fewer than two cards. It imports no JAX:

    python -m pytest tests/test_torch_nccl.py -m cuda --noconftest
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_parallel_proc import run_ranks, training

from vietvoice_tts_tpu_torch.config import ModelConfig
from vietvoice_tts_tpu_torch.models import dit as tdit
from vietvoice_tts_tpu_torch.parallel.mesh import default_backend
from vietvoice_tts_tpu_torch.runtime.session import ModelSessionManager
from vietvoice_tts_tpu_torch.training import train as ttrain
from vietvoice_tts_tpu_torch.training.checkpoint import CheckpointManager

pytestmark = pytest.mark.cuda

TRAIN_KW = dict(warmup_steps=1, learning_rate=1e-3, max_grad_norm=0.1)


def _open(tree: dict, seed: int = 11) -> dict:
    """The pack's DiT tree with random biases and AdaLN gates (from zero,
    Adam's first update of a bias rides on its gradient's last bits)."""
    rng = np.random.default_rng(seed)

    def walk(node, key=None, gate=False):
        if isinstance(node, dict):
            return {k: walk(v, k, gate or k in ("ada", "final_ada")) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, key, gate) for v in node]
        if gate or key == "b":
            return rng.normal(0.0, 0.05, node.shape).astype(np.float32)
        return node

    return walk(tree)


def test_tp_and_dp_train_and_checkpoint_over_nccl(tmp_path, monkeypatch):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs (NCCL takes one card per rank)")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    backend = default_backend()
    assert backend == "cpu:gloo,cuda:nccl"
    cfg = ModelConfig(device="cuda", dit_dim=64, dit_depth=2, dit_heads=4, text_dim=32,
                      text_conv_layers=1, vocoder_dim=64, vocoder_intermediate_dim=128,
                      vocoder_num_layers=2, nfe_step=4, frame_buckets=(128, 256),
                      max_batch_size=4, use_kernels=False, compute_dtype="float32",
                      model_cache_dir=str(tmp_path / "models"))
    mgr = ModelSessionManager(cfg)
    mgr.load_models()
    dims = dict(dim=cfg.dit_dim, depth=cfg.dit_depth, heads=cfg.dit_heads,
                ff_mult=cfg.dit_ff_mult, n_mels=cfg.n_mels, text_dim=cfg.text_dim,
                text_conv_layers=cfg.text_conv_layers, vocab_size=mgr.vocab_size)
    rng = np.random.default_rng(0)
    n = 64
    text = rng.integers(0, mgr.vocab_size, (4, n)).astype(np.int32)
    lengths = np.array([n, n // 2, 48, 20], np.int32)
    for row, length in enumerate(lengths):
        text[row, length:] = -1
    batch = (rng.standard_normal((4, n, cfg.n_mels)).astype(np.float32), text, lengths)
    draws = ttrain.draw(torch.Generator().manual_seed(3), 4, n, cfg.n_mels,
                        ttrain.TrainConfig(**TRAIN_KW))
    data = dict(
        train_cfg=TRAIN_KW, dit_dims=dims, tree=_open(mgr.params["dit"]), batch=batch,
        draws=[d.numpy() for d in dataclasses.astuple(draws)],
        config=cfg.to_dict(), ckpt_dir=str(tmp_path / "ckpt"), device="cuda",
    )
    del mgr
    results, _ = run_ranks(training, 2, tmp_path / "ranks", data, timeout=180,
                           backend=backend)

    for r in results:
        np.testing.assert_allclose(r["tp_loss"], r["dp_loss"], rtol=1e-5, atol=0)
        for path, ref in _leaves(r["dp_params"]):
            got = _leaf(r["tp_params"], path)
            assert got.shape == ref.shape, path
            scale = max(float(np.abs(ref).max()), 1e-30)
            assert float(np.abs(got - ref).max()) <= 1e-4 * scale, path
    assert all(r["tp_sharded_shape"] == (3 * cfg.dit_dim // 2, cfg.dit_dim) for r in results)
    assert results[0]["train_losses"] == results[1]["train_losses"]
    assert np.isfinite(results[0]["train_losses"]).all()
    ckpt = CheckpointManager(tmp_path / "ckpt")
    assert ckpt.all_steps() == [1, 2]
    model_state, _, step = ckpt.restore()
    assert step == 2
    dit = tdit.DiT(tdit.DiTConfig(**dims))
    dit.load_state_dict(model_state)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, np.asarray(tree)


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)
