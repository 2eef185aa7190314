"""End-to-end training loop: data → train steps → checkpoints → weight pack.

Port of ``vietvoice_tts_tpu/training/loop.py``: one callable, so
``python -m vietvoice_tts_tpu_torch.training`` can train the DiT from a
manifest. It resumes from the latest checkpoint when one exists (the step
count carries on; the random draws are re-seeded from
``ModelConfig.random_seed`` and the data iterator restarts, as the JAX loop's
key and iterator do), and on completion exports the trained DiT into the
pack it started from, replacing only ``dit`` in ``params.msgpack``. On the
card off a mesh every step is a replay of the CUDA graph captured for its
shape (``train.TrainStep``), as the JAX loop's step is compiled once per
shape; the checkpoint is restored before the first step, since the graphs
read the optimizer's state by address.

On a mesh (``mesh=``, or ``ModelConfig.mesh_data_axis`` ×
``mesh_model_axis`` > 1 in a process group that has that many ranks) every
rank runs this function: it loads the whole pack and keeps its tensor-
parallel shard, reads the same global batches and draws the same global
noise, and the step splits them (``train.make_train_step``). Rank 0 writes
the checkpoints and the export, the shards gathered first.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..models.dit import DiTConfig
from ..models.params import to_jax_tree
from ..parallel.mesh import make_mesh
from ..parallel.sharding import gather_tree, param_pspecs, shard_tree
from ..runtime import graphs
from ..runtime.serialization import load_params, save_params
from ..runtime.session import ModelSessionManager
from ..utils.logging import get_logger
from .checkpoint import CheckpointManager, shard_state, whole_state
from .data import TextMelDataset, load_manifest, manifest_from_pack
from .train import TrainConfig, as_tensors, draw, init_train_state, make_train_step

log = get_logger("train_loop")


@dataclass
class TrainRunConfig:
    steps: int = 10_000
    batch_size: int = 8
    checkpoint_dir: str = "checkpoints/dit"
    checkpoint_every: int = 500
    log_every: int = 50
    export_to_pack: bool = True


def train(
    model_config: Optional[ModelConfig] = None,
    train_config: Optional[TrainConfig] = None,
    run_config: Optional[TrainRunConfig] = None,
    manifest_path: Optional[str] = None,
    mesh=None,
) -> dict:
    """Train the flow-matching DiT on ``model_config.device``; returns
    ``{"final_step", "final_loss", "losses", "step_seconds", "step_shapes",
    "graph_captures", "graph_replays"}``: per step of this run its loss, its
    wall time from the batch's copy to the device (data loading excluded) to
    the host read of its loss (which waits for the device), and its (batch,
    frames); then the train-step graphs this run captured and replayed (on
    the card off a mesh one capture per key, whose eager run is that step,
    and a replay for every other step; none elsewhere,
    ``train.TrainStep``). ``mesh`` is a ``parallel.make_mesh``
    mesh; without one, the config's mesh axes make one when their product
    is above 1 (a ``ValueError`` before anything is loaded when the process
    group has another number of ranks)."""
    model_config = model_config or ModelConfig()
    if mesh is None and model_config.mesh_data_axis * model_config.mesh_model_axis > 1:
        mesh = make_mesh(model_config.mesh_data_axis, model_config.mesh_model_axis)
    tp_group = mesh.model_group if mesh is not None else None
    writer = mesh is None or mesh.rank == 0
    train_config = train_config or TrainConfig()
    run = run_config or TrainRunConfig()
    device = torch.device(model_config.device)

    # Weight pack gives us vocab + init params (+ toy manifest fallback).
    session = ModelSessionManager(model_config)
    session.load_models()
    records = (
        load_manifest(manifest_path)
        if manifest_path
        else manifest_from_pack(model_config.model_path)
    )
    dataset = TextMelDataset(
        records, model_config, session.vocab_path, batch_size=run.batch_size
    )

    dit_cfg = DiTConfig(
        dim=model_config.dit_dim,
        depth=model_config.dit_depth,
        heads=model_config.dit_heads,
        ff_mult=model_config.dit_ff_mult,
        n_mels=model_config.n_mels,
        text_dim=model_config.text_dim,
        text_conv_layers=model_config.text_conv_layers,
        vocab_size=session.vocab_size,
        model_group=tp_group,
    )
    specs = param_pspecs(dit_cfg, None)["dit"]
    tree = session.params["dit"]
    if tp_group is not None:
        tree = shard_tree(tree, specs, mesh.model_index, mesh.model)
    dit, opt = init_train_state(tree, dit_cfg, train_config, device)

    ckpt = CheckpointManager(
        run.checkpoint_dir, save_interval_steps=run.checkpoint_every, writer=writer
    )
    start_step = 0
    if ckpt.latest_step() is not None:
        model_state, opt_state, start_step = ckpt.restore()
        model_state, opt_state = shard_state(dit, model_state, opt_state, mesh)
        dit.load_state_dict(model_state)
        opt.load_state_dict(opt_state)
        log.info("Resumed from checkpoint step %d", start_step)

    def checkpoint(step: int, force: bool = False) -> None:
        if force or ckpt.should_save(step):
            ckpt.save_state(step, *whole_state(dit, opt, tp_group))

    step_fn = make_train_step(dit_cfg, train_config, mesh)
    generator = torch.Generator().manual_seed(model_config.random_seed)
    losses: list[float] = []
    seconds: list[float] = []
    shapes: list[tuple[int, int]] = []
    captured, replayed = graphs.captures, graphs.replays
    step = start_step
    data_iter = iter(dataset)
    while step < run.steps:
        try:
            mel, text_ids, lengths = next(data_iter)
        except StopIteration:
            data_iter = iter(dataset)
            continue
        t0 = time.perf_counter()
        mel, text_ids, lengths = as_tensors(mel, text_ids, lengths, device)
        b, n, m = mel.shape
        draws = draw(generator, b, n, m, train_config).to(device)
        loss = step_fn(dit, opt, draws, mel, text_ids, lengths)
        losses.append(loss.item())
        seconds.append(time.perf_counter() - t0)
        shapes.append((b, n))
        step += 1
        if step % run.log_every == 0:
            log.info("step %d: loss %.4f", step, np.mean(losses[-run.log_every:]))
        checkpoint(step)

    if ckpt.latest_step() != step:
        checkpoint(step, force=True)
    if run.export_to_pack:
        trained = gather_tree(to_jax_tree(dit), specs, tp_group)
        if writer:
            pack = Path(model_config.model_path)
            full = load_params(pack / "params.msgpack")
            full["dit"] = trained
            save_params(pack / "params.msgpack", full)
            log.info("Exported trained DiT into %s", pack)
    ckpt.close()
    return {
        "final_step": step,
        "final_loss": losses[-1] if losses else None,
        "losses": losses,
        "step_seconds": seconds,
        "step_shapes": shapes,
        "graph_captures": graphs.captures - captured,
        "graph_replays": graphs.replays - replayed,
    }
