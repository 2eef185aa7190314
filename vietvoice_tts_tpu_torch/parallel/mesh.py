"""Data × model mesh of ``torch.distributed`` ranks.

Port of ``vietvoice_tts_tpu/parallel/mesh.py``. In JAX one controller drives
every device of a ``jax.sharding.Mesh``; in PyTorch every rank is a process
of its own (SPMD, started by ``torchrun`` or ``torch.multiprocessing``), and
a collective returns only when every rank of its group enters it with the
same shapes. A mesh here is therefore this rank's place in the grid and
one process group per axis:

- ``data``  — utterance/chunk batches: each rank runs its rows of a batch;
- ``model`` — tensor parallelism for the DiT heads/FFN and vocoder channels
  (``parallel/sharding.py``), or, with ``ModelConfig.sequence_parallel``,
  the DiT's frame axis (``parallel/sequence.py``).

Ranks are laid out data-major with the model axis innermost,
``rank = d·model + m``, as the JAX function lays out its devices, so on a
host with one card per rank the tensor-parallel collectives stay between
neighbouring cards.

Backend: when every rank of the host has a card of its own, NCCL for CUDA
tensors and gloo for CPU tensors in the same groups (``cpu:gloo,cuda:nccl``:
the checkpoint's gather of the sharded weights moves host arrays); gloo
alone on the CPU and when ranks share a card (NCCL refuses two ranks on one
device). The collectives go through ``parallel/comm.py``, which stages CUDA
tensors through pinned host memory where gloo alone must take them.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import torch
import torch.distributed as dist

MODEL_AXIS = "model"


def default_backend() -> str:
    """``"cpu:gloo,cuda:nccl"`` when CUDA is present and every local rank
    has a card of its own (NCCL takes only CUDA tensors), else ``"gloo"``."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))
    if torch.cuda.is_available() and dist.is_nccl_available() and torch.cuda.device_count() >= local:
        return "cpu:gloo,cuda:nccl"
    return "gloo"


def initialize_distributed() -> None:
    """Join the default process group when the launcher's environment says
    ``WORLD_SIZE > 1`` (``torchrun`` sets it, with ``RANK``, ``MASTER_ADDR``
    and ``MASTER_PORT``); a no-op for a single process or a group already
    joined. Under NCCL this rank's card becomes the current device, so
    ``device="cuda"`` means it."""
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return
    backend = default_backend()
    if "nccl" in backend:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend=backend)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in a (data × model) grid and the group of each axis.

    ``data_group`` holds the ranks that share this rank's model index (the
    ranks a batch is split over), ``model_group`` those that share its data
    index (the ranks a layer or the frame axis is split over). An axis of
    size 1 has no group: it needs no collective."""

    data: int
    model: int
    rank: int
    data_group: Any = None
    model_group: Any = None

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model


def make_mesh(data: Optional[int] = None, model: int = 1) -> Mesh:
    """Build a (data × model) mesh over the ranks of the default process
    group (a single rank when there is none).

    ``data=None`` uses every rank left after the model axis. Every rank must
    call this, in the same order as any other group it creates: each axis
    group is made by ``dist.new_group``, which all ranks enter."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if model < 1 or world % model != 0:
        raise ValueError(
            f"model axis {model} does not divide the world size {world}: start one "
            "process per rank, e.g. torchrun --nproc-per-node <data × model> ..."
        )
    data = world // model if data is None else data
    if data < 1 or data * model != world:
        raise ValueError(
            f"a {data} × {model} mesh needs {data * model} ranks, and this process "
            f"group has {world}: start one process per rank, e.g. "
            f"torchrun --nproc-per-node {data * model} ..."
        )
    groups = {}
    if data > 1:
        for m in range(model):
            ranks = [d * model + m for d in range(data)]
            group = dist.new_group(ranks)
            if rank in ranks:
                groups["data_group"] = group
    if model > 1:
        for d in range(data):
            ranks = [d * model + m for m in range(model)]
            group = dist.new_group(ranks)
            if rank in ranks:
                groups["model_group"] = group
    return Mesh(data=data, model=model, rank=rank, **groups)


def launch_mesh(data: int = 1, model: int = 1) -> Optional[Mesh]:
    """The command lines' mesh: None for 1 × 1, else the process group
    joined (``torchrun``'s environment) and a ``data × model`` mesh made.
    Outside a launch with that many ranks, ``make_mesh``'s ``ValueError``,
    which names ``torchrun``."""
    if data * model == 1:
        return None
    initialize_distributed()
    return make_mesh(data, model)


def mesh_axis_sizes(mesh: Mesh) -> tuple[int, int]:
    return mesh.data, mesh.model
