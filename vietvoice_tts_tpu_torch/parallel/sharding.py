"""Tensor-parallel layout of the weights, and the batch split.

Port of ``vietvoice_tts_tpu/parallel/sharding.py``. Megatron-style
column→row pairs, so each pair needs exactly one all-reduce of its output:

- DiT ``qkv.w [dim, 3·dim]``   → the output dim over ``model`` (heads split)
- DiT ``attn_out.w [dim, dim]`` → the input dim over ``model``
- DiT ``ff1.w [dim, ff·dim]`` / ``ff2.w [ff·dim, dim]`` → the same pairing
- text blocks and vocoder ``pw1`` / ``pw2`` → the same pairing over the
  intermediate dim
- everything else replicated, the vocoder head included (2·n_freqs = 1026
  divides by no common size; it is one small matmul).

The spec tree has the params tree's structure, as in JAX (a
:class:`P` names the mesh axis of each dim, ``None`` for an unsplit one). In
JAX a spec is a layout and XLA inserts the collectives; here
:func:`shard_params` slices the numpy tree into this rank's shard before
``models/params.py`` makes tensors of it, and the modules do the
all-reduces (``models/dit.py``, ``models/vocoder.py``).

**The packed qkv.** Its output dim is ``q ‖ k ‖ v``, each ``heads × head_dim``.
A contiguous slice would give rank 0 all of q and half of k; rank r instead
takes heads ``[r·H/tp, (r+1)·H/tp)`` of q, of k and of v, packed
``q_r ‖ k_r ‖ v_r`` — the layout the fused attention kernel reads. The
same holds for ``qkv.b``. Row-parallel biases (``attn_out.b``, ``ff2.b``,
``pw2.b``) are replicated and added once, after the all-reduce.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from . import comm
from .mesh import MODEL_AXIS, Mesh

PACKED_KEYS = {"qkv": 3}  # leaves whose split axis packs this many parts


class P(tuple):
    """A partition spec: the mesh axis of each dim (``None``: unsplit);
    ``P()`` is replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)


def _dit_block_spec() -> dict:
    # Blocks are stacked on a leading depth axis.
    return {
        "ada": {"w": P(), "b": P()},
        "qkv": {"w": P(None, None, MODEL_AXIS), "b": P(None, MODEL_AXIS)},
        "attn_out": {"w": P(None, MODEL_AXIS, None), "b": P()},
        "ff1": {"w": P(None, None, MODEL_AXIS), "b": P(None, MODEL_AXIS)},
        "ff2": {"w": P(None, MODEL_AXIS, None), "b": P()},
    }


def _text_block_spec() -> dict:
    return {
        "dwconv": {"w": P(), "b": P()},
        "pw1": {"w": P(None, MODEL_AXIS), "b": P(MODEL_AXIS)},
        "pw2": {"w": P(MODEL_AXIS, None), "b": P()},
    }


def _vocoder_block_spec() -> dict:
    # Stacked on a leading depth axis, like the DiT blocks.
    return {
        "dwconv": {"w": P(), "b": P()},
        "pw1": {"w": P(None, None, MODEL_AXIS), "b": P(None, MODEL_AXIS)},
        "pw2": {"w": P(None, MODEL_AXIS, None), "b": P()},
        "gamma": P(),
        "norm_scale": P(),
        "norm_bias": P(),
    }


def param_pspecs(dit_cfg, voc_cfg) -> dict:
    """Spec tree matching the params tree's structure."""
    return {
        "dit": {
            "text_embed": {
                "table": P(),
                "blocks": [_text_block_spec() for _ in range(dit_cfg.text_conv_layers)],
            },
            "time_embed": {
                "mlp1": {"w": P(), "b": P()},
                "mlp2": {"w": P(), "b": P()},
            },
            "input_proj": {"w": P(), "b": P()},
            "conv_pos": [{"w": P(), "b": P()} for _ in range(2)],
            "blocks": _dit_block_spec(),
            "final_ada": {"w": P(), "b": P()},
            "final_proj": {"w": P(), "b": P()},
        },
        "vocoder": {
            "embed": {"w": P(), "b": P()},
            "norm_in_scale": P(),
            "norm_in_bias": P(),
            "blocks": _vocoder_block_spec(),
            "norm_out_scale": P(),
            "norm_out_bias": P(),
            "head": {"w": P(), "b": P()},
        },
    }


def _map(fn, specs, *trees, path=()):
    """``fn(path, spec, *leaves)`` over the leaves of ``trees`` (one or more
    params trees of the spec tree's structure), as ``jax.tree.map``."""
    if isinstance(specs, P):
        return fn(path, specs, *trees)
    if isinstance(specs, dict):
        return {k: _map(fn, s, *(t[k] for t in trees), path=path + (k,)) for k, s in specs.items()}
    return [_map(fn, s, *(t[i] for t in trees), path=path + (i,)) for i, s in enumerate(specs)]


def _split_axis(spec: P) -> int | None:
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


def _parts(path) -> int:
    return max((PACKED_KEYS.get(k, 1) for k in path if isinstance(k, str)), default=1)


def shard_tree(tree: dict, specs: dict, rank: int, size: int) -> dict:
    """This model-axis rank's shard of a params tree (numpy leaves), split
    as ``specs`` say; replicated leaves are returned as they are."""

    def cut(path, spec, leaf):
        axis = _split_axis(spec)
        leaf = np.asarray(leaf)
        if axis is None or size == 1:
            return leaf
        parts = _parts(path)
        width = leaf.shape[axis]
        if width % (parts * size):
            raise ValueError(
                f"{'.'.join(map(str, path))}: dim {axis} of {leaf.shape} does not split "
                f"into {size} model-axis shards"
            )
        shape = leaf.shape[:axis] + (parts, size, width // (parts * size)) + leaf.shape[axis + 1:]
        piece = np.take(leaf.reshape(shape), rank, axis=axis + 1)
        return np.ascontiguousarray(piece.reshape(leaf.shape[:axis] + (-1,) + leaf.shape[axis + 1:]))

    return _map(cut, specs, tree)


def _join(path, spec, *leaves):
    """One leaf's shards, in model-axis rank order → the whole leaf."""
    axis = _split_axis(spec)
    leaves = [np.asarray(x) for x in leaves]
    if axis is None or len(leaves) == 1:
        return leaves[0]
    parts = _parts(path)
    split = [x.reshape(x.shape[:axis] + (parts, -1) + x.shape[axis + 1:]) for x in leaves]
    whole = np.stack(split, axis=axis + 1)
    return whole.reshape(leaves[0].shape[:axis] + (-1,) + leaves[0].shape[axis + 1:])


def unshard_tree(shards: list, specs: dict) -> dict:
    """The inverse of :func:`shard_tree`: the model-axis ranks' shards, in
    rank order, → the whole tree (replicated leaves from rank 0)."""
    return _map(_join, specs, *shards)


def gather_tree(tree: dict, specs: dict, group) -> dict:
    """The whole tree on every rank of the model ``group`` from each rank's
    shard (one all-gather per split leaf, the same on every rank)."""
    n = comm.size(group)

    def gather(path, spec, leaf):
        if n == 1 or _split_axis(spec) is None:
            return np.asarray(leaf)
        t = torch.from_numpy(np.ascontiguousarray(leaf, np.float32))
        parts = comm.all_gather(t[None], group, dim=0).numpy()
        return _join(path, spec, *parts)

    return _map(gather, specs, tree)


def shard_params(params: dict, mesh: Mesh, dit_cfg, voc_cfg) -> dict:
    """This rank's tensor-parallel shard of ``{"dit": …, "vocoder": …}``
    (numpy leaves) on ``mesh``'s model axis."""
    return shard_tree(params, param_pspecs(dit_cfg, voc_cfg), mesh.model_index, mesh.model)


def shard_batch(mesh: Mesh, *arrays: Any):
    """This rank's rows of each array: the leading batch dim split over the
    data axis (it must divide; ``EngineCore`` pads a batch to it)."""
    out = []
    for a in arrays:
        if a.shape[0] % mesh.data:
            raise ValueError(f"batch {a.shape[0]} does not split over data axis {mesh.data}")
        rows = a.shape[0] // mesh.data
        out.append(a[mesh.data_index * rows : (mesh.data_index + 1) * rows])
    return tuple(out)
