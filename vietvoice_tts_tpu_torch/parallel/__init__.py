"""Mesh of ranks, tensor-parallel weight layout, sequence parallelism and
the collectives they use (``torch.distributed``)."""

from .mesh import make_mesh, mesh_axis_sizes
from .sharding import param_pspecs, shard_batch, shard_params

__all__ = [
    "make_mesh",
    "mesh_axis_sizes",
    "shard_params",
    "shard_batch",
    "param_pspecs",
]
