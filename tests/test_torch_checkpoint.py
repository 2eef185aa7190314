"""The port's ``CheckpointManager`` (``torch.save``) against the JAX one (orbax).

The same sequence of ``save(step, force)`` calls keeps the same steps in
both, at save intervals 1 and 2 with ``max_to_keep`` 3; a forced save over a
step that exists raises in both. The round trip, ``latest_step``, the error
on an empty directory and the export contract are
``tests/test_checkpoint_convert.py:23-63`` carried over. CPU, tiny dims.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vietvoice_tts_tpu.models.dit import DiTConfig as JaxDiTConfig
from vietvoice_tts_tpu.models.dit import init_dit_params
from vietvoice_tts_tpu.runtime.serialization import load_params as jax_load_params
from vietvoice_tts_tpu.training.checkpoint import CheckpointManager as JaxCheckpointManager
from vietvoice_tts_tpu_torch.models import dit as tdit
from vietvoice_tts_tpu_torch.models.params import to_jax_tree
from vietvoice_tts_tpu_torch.training import train as ttrain
from vietvoice_tts_tpu_torch.training.checkpoint import CheckpointManager

DIMS = dict(dim=32, depth=1, heads=2, n_mels=8, text_dim=16, text_conv_layers=1, vocab_size=16)
JCFG = JaxDiTConfig(**DIMS, compute_dtype=jnp.float32)
TCFG = tdit.DiTConfig(**DIMS)

# (step, force) sequences: in order, repeats, a forced save below the latest
# and over an existing step, and interval skips.
SEQUENCES = [
    [(0, False), (1, False), (2, False), (3, False), (4, False), (5, False)],
    [(1, False), (2, False), (3, False), (2, False), (3, True), (4, True), (4, False)],
    [(5, False), (9, True), (6, True), (7, True), (3, True), (8, False), (10, False)],
    [(1, False), (2, False), (3, False), (4, False), (5, False), (6, False), (7, True),
     (8, False), (9, False), (10, False)],
]


def _state():
    """A trained-looking (DiT, optimizer): two updates, so moments exist."""
    dit, opt = ttrain.init_train_state(init_dit_params(0, JCFG), TCFG, ttrain.TrainConfig(), "cpu")
    for _ in range(2):
        for p in dit.parameters():
            p.grad = torch.full_like(p, 0.01)
        ttrain.apply_update(opt, ttrain.TrainConfig(warmup_steps=0))
    return dit, opt


def _decisions(seq, save, steps):
    """(step, force, saved — or "exists" where it raised —, kept steps,
    latest step) after each call."""
    out = []
    for step, force in seq:
        try:
            saved = bool(save(step, force))
        except Exception as e:  # noqa: BLE001 — the type is compared below
            saved = "exists" if "exist" in type(e).__name__.lower() else repr(e)
        out.append((step, force, saved, *steps()))
    return out


@pytest.mark.parametrize("interval", [1, 2])
@pytest.mark.parametrize("seq", SEQUENCES)
def test_save_decisions_and_retention_match_orbax(tmp_path, interval, seq):
    params = init_dit_params(0, JCFG)
    jmgr = JaxCheckpointManager(tmp_path / "jax", max_to_keep=3, save_interval_steps=interval)

    def jax_save(step, force):
        saved = jmgr.save(step, params, {"count": np.zeros(())}, force=force)
        jmgr.manager.wait_until_finished()
        return saved

    ref = _decisions(seq, jax_save, lambda: (tuple(jmgr.manager.all_steps()), jmgr.latest_step()))
    jmgr.close()
    dit, opt = _state()
    mgr = CheckpointManager(tmp_path / "port", max_to_keep=3, save_interval_steps=interval)
    got = _decisions(seq, lambda s, f: mgr.save(s, dit, opt, force=f),
                     lambda: (tuple(mgr.all_steps()), mgr.latest_step()))
    assert got == ref
    kept = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert kept == sorted(f"{s}.pt" for s in mgr.all_steps())
    # A manager opened on the directory finds the steps in step order, as orbax's.
    assert CheckpointManager(tmp_path / "port").all_steps() == sorted(mgr.all_steps())


def test_save_restore_round_trip(tmp_path):
    dit, opt = _state()
    mgr = CheckpointManager(tmp_path, save_interval_steps=1)
    assert mgr.save(0, dit, opt, force=True)
    model_state, opt_state, step = mgr.restore()
    assert step == 0
    for name, t in dit.state_dict().items():
        assert model_state[name].dtype == torch.float32 and torch.equal(model_state[name], t)
    fresh, fresh_opt = ttrain.init_train_state(
        init_dit_params(1, JCFG), TCFG, ttrain.TrainConfig(), "cpu")
    fresh.load_state_dict(model_state)
    fresh_opt.load_state_dict(opt_state)
    assert ttrain.update_count(fresh_opt) == ttrain.update_count(opt) == 2
    for p, q in zip(opt.param_groups[0]["params"], fresh_opt.param_groups[0]["params"]):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(opt.state[p][key], fresh_opt.state[q][key])
    assert not list(tmp_path.glob("*.tmp"))


def test_latest_step_tracking(tmp_path):
    dit, opt = _state()
    mgr = CheckpointManager(tmp_path, save_interval_steps=1)
    mgr.save(0, dit, opt, force=True)
    mgr.save(5, dit, opt, force=True)
    assert mgr.latest_step() == 5
    assert mgr.restore(0)[2] == 0


def test_restore_empty_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path).restore()


def test_export_for_inference(tmp_path):
    """The tree given is written as params.msgpack, read back by the JAX
    package's loader bit for bit."""
    dit, opt = _state()
    tree = to_jax_tree(dit)
    CheckpointManager(tmp_path / "ckpt").export_for_inference(tree, tmp_path)
    back = jax_load_params(Path(tmp_path) / "params.msgpack")
    np.testing.assert_array_equal(tree["final_proj"]["w"], back["final_proj"]["w"])
    np.testing.assert_array_equal(tree["blocks"]["qkv"]["w"], back["blocks"]["qkv"]["w"])
    assert back["text_embed"]["blocks"][0]["dwconv"]["w"].shape == (7, 1, DIMS["text_dim"])
