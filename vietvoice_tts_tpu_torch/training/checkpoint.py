"""Training checkpoint/resume on ``torch.save``.

Port of ``vietvoice_tts_tpu/training/checkpoint.py``, which wraps orbax's
``CheckpointManager``. Same interface and the same decisions, without orbax:
a checkpoint is one file, ``<directory>/<step>.pt``, holding ``{"model": the
DiT's float32 state dict, "optimizer": the optimizer's state dict, "step"}``
on the CPU, written to a temporary file and renamed into place, read back
with ``torch.load(weights_only=True)``.

Which calls save and which checkpoints stay are orbax's rules (orbax 0.11,
``CheckpointManager`` with ``max_to_keep`` and ``save_interval_steps``):

- ``save(step)`` saves when no checkpoint exists yet, or when ``step`` is a
  multiple of ``save_interval_steps`` — and never when ``step`` is at or
  below the latest saved step;
- ``save(step, force=True)`` saves regardless, except over a step that
  exists, which raises (orbax: ``StepAlreadyExistsError``);
- the latest step is the last one saved (steps found on disk count in step
  order); past ``max_to_keep`` the earliest-saved checkpoint is deleted.

On a mesh every rank keeps the same record of saved steps and only the
writer (rank 0) writes (``writer=``). A checkpoint always holds the whole
model: under tensor parallelism :func:`whole_state` gathers the shards
before a save (every rank of the model group takes part), and
:func:`shard_state` cuts a restored checkpoint to this rank's shard, so a
checkpoint written on a mesh resumes on one device and the other way round.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Optional

import torch

from ..models.params import dit_state, to_jax_tree
from ..parallel.sharding import gather_tree, param_pspecs, shard_tree
from ..runtime.serialization import save_params
from ..utils.logging import get_logger

log = get_logger("checkpoint")

_FILE = re.compile(r"^(\d+)\.pt$")


def _to_cpu(obj):
    """A copy of a (nested) state dict with every tensor on the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


class CheckpointManager:
    """Saves and restores (model, optimizer, step) under ``directory``."""

    def __init__(
        self,
        directory: str | Path,
        max_to_keep: int = 3,
        save_interval_steps: int = 1000,
        writer: bool = True,
    ):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.writer = writer
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        # Saved steps, oldest save first.
        self._steps = sorted(
            int(m.group(1)) for p in self.directory.iterdir() if (m := _FILE.match(p.name))
        )

    def _path(self, step: int) -> Path:
        return self.directory / f"{step}.pt"

    def should_save(self, step: int) -> bool:
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        return not self._steps or step % self.save_interval_steps == 0

    def save(self, step: int, model: torch.nn.Module, optimizer, force: bool = False) -> bool:
        """Save ``model``'s state and ``optimizer``'s at ``step`` if the rules
        above say so; returns whether it saved."""
        if not force and not self.should_save(step):
            return False
        self.save_state(step, model.state_dict(), optimizer.state_dict())
        return True

    def save_state(self, step: int, model_state: dict, optimizer_state: dict) -> None:
        """Write the state dicts at ``step`` (the writer only; every rank
        records the step)."""
        if step in self._steps:
            raise FileExistsError(f"checkpoint step {step} already exists in {self.directory}")
        if self.writer:
            payload = {
                "model": _to_cpu(model_state),
                "optimizer": _to_cpu(optimizer_state),
                "step": int(step),
            }
            tmp = self.directory / f".{step}.pt.tmp"
            torch.save(payload, tmp)
            os.replace(tmp, self._path(step))
        self._steps.append(step)
        while len(self._steps) > self.max_to_keep:
            old = self._steps.pop(0)
            if self.writer:
                self._path(old).unlink(missing_ok=True)
        log.info("Saved checkpoint at step %d → %s", step, self.directory)

    def all_steps(self) -> list[int]:
        return list(self._steps)

    def latest_step(self) -> Optional[int]:
        return self._steps[-1] if self._steps else None

    def restore(self, step: Optional[int] = None):
        """(model state dict, optimizer state dict, step) at ``step``
        (default: latest), tensors on the CPU; load them with
        ``load_state_dict`` (the optimizer's moves its state to the
        parameters' device)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"No checkpoints in {self.directory}")
        payload = torch.load(self._path(step), map_location="cpu", weights_only=True)
        log.info("Restored checkpoint step %d", step)
        return payload["model"], payload["optimizer"], payload["step"]

    def export_for_inference(self, params, pack_dir: str | Path) -> None:
        """Write the pytree ``params`` (numpy leaves, e.g.
        ``models.params.to_jax_tree`` of the trained DiT) as
        ``<pack_dir>/params.msgpack``."""
        save_params(Path(pack_dir) / "params.msgpack", params)
        log.info("Exported params to %s", pack_dir)

    def close(self) -> None:
        """Nothing to wait for: every save is written before it returns."""


def _each_tree(dit, model_state: dict, optimizer_state: dict, fn):
    """(model state, optimizer state) with ``fn`` applied to the DiT-shaped
    pack tree of the weights and of each Adam moment."""
    names = [n for n, _ in dit.named_parameters()]
    model = dit_state(fn(to_jax_tree(model_state)), torch.float32)
    state = {i: dict(st) for i, st in optimizer_state["state"].items()}
    for key in ("exp_avg", "exp_avg_sq"):
        if state:
            moved = dit_state(
                fn(to_jax_tree({names[i]: st[key] for i, st in state.items()})), torch.float32
            )
            for i, st in state.items():
                st[key] = moved[names[i]]
    return model, {"state": state, "param_groups": optimizer_state["param_groups"]}


def whole_state(dit, optimizer, model_group=None):
    """The whole model's (DiT state dict, optimizer state dict) from this
    rank's tensor-parallel shard; every rank of ``model_group`` calls it
    (all-gathers). Without a group, the module's and optimizer's own."""
    if model_group is None:
        return dit.state_dict(), optimizer.state_dict()
    specs = param_pspecs(dit.cfg, None)["dit"]
    return _each_tree(
        dit, dit.state_dict(), optimizer.state_dict(),
        lambda tree: gather_tree(tree, specs, model_group),
    )


def shard_state(dit, model_state: dict, optimizer_state: dict, mesh=None):
    """This rank's shard of a whole-model checkpoint, for ``dit`` built on
    ``mesh``'s model axis (unchanged without tensor parallelism)."""
    if mesh is None or dit.cfg.model_group is None:
        return model_state, optimizer_state
    specs = param_pspecs(dit.cfg, None)["dit"]
    return _each_tree(
        dit, model_state, optimizer_state,
        lambda tree: shard_tree(tree, specs, mesh.model_index, mesh.model),
    )
