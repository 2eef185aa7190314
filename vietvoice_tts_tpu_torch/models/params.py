"""Weight-pack pytree ↔ module state dicts.

The pack stores the JAX package's pytree: dense weights ``[in, out]`` used
as ``x @ w``, depthwise conv weights ``[k, 1, C]``, dense conv weights
``[k, in, out]``, and block weights stacked on a leading depth axis.
:func:`from_jax_tree` maps it onto the port's modules — ``nn.Linear``'s
``[out, in]`` (the packed q‖k‖v output order is kept), ``nn.Conv1d``'s
``[out, in/groups, k]``, one ``ModuleList`` entry per depth index — and
applies the serving dtype policy of ``vietvoice_tts_tpu/runtime/
engine_core.py:151-170``: leaves under a matmul key (``qkv``, ``attn_out``,
``ff1``, ``ff2``, ``input_proj``, ``pw1``, ``pw2``, ``conv_pos``, ``ada``,
``final_ada``) are stored in the compute dtype, the rest in float32.
:func:`to_jax_tree` maps a DiT back to the pack's layout (the trainer's
export).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

MATMUL_KEYS = frozenset(
    {"qkv", "attn_out", "ff1", "ff2", "input_proj", "pw1", "pw2",
     "conv_pos", "ada", "final_ada"}
)

State = Dict[str, torch.Tensor]


class _StateBuilder:
    """Collects (module name → tensor), casting by the JAX key path."""

    def __init__(self, compute_dtype: torch.dtype):
        self.compute_dtype = compute_dtype
        self.state: State = {}

    def add(self, name: str, arr: np.ndarray, jax_keys: tuple) -> None:
        # An owned, C-contiguous copy (pack arrays are read-only views).
        t = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))
        if MATMUL_KEYS.intersection(jax_keys):
            t = t.to(self.compute_dtype)
        self.state[name] = t

    def dense(self, name: str, p: dict, jax_keys: tuple) -> None:
        """{w [in, out], b [out]} → nn.Linear {weight [out, in], bias}."""
        self.add(f"{name}.weight", np.asarray(p["w"]).T, jax_keys)
        self.add(f"{name}.bias", p["b"], jax_keys)

    def dwconv(self, name: str, p: dict, jax_keys: tuple) -> None:
        """{w [k, 1, C], b [C]} → depthwise nn.Conv1d {weight [C, 1, k], bias}."""
        self.add(f"{name}.weight", np.asarray(p["w"]).transpose(2, 1, 0), jax_keys)
        self.add(f"{name}.bias", p["b"], jax_keys)


def _layer(tree: dict, i: int) -> dict:
    """Slice depth index i out of a stacked sub-tree."""
    return {k: (_layer(v, i) if isinstance(v, dict) else np.asarray(v)[i])
            for k, v in tree.items()}


def dit_state(tree: dict, compute_dtype: torch.dtype) -> State:
    sb = _StateBuilder(compute_dtype)
    te = tree["text_embed"]
    sb.add("text_table.weight", te["table"], ("text_embed", "table"))
    for i, blk in enumerate(te["blocks"]):
        keys = ("text_embed", "blocks")
        sb.dwconv(f"text_blocks.{i}.dwconv", blk["dwconv"], keys + ("dwconv",))
        sb.dense(f"text_blocks.{i}.pw1", blk["pw1"], keys + ("pw1",))
        sb.dense(f"text_blocks.{i}.pw2", blk["pw2"], keys + ("pw2",))
    sb.dense("time_mlp1", tree["time_embed"]["mlp1"], ("time_embed", "mlp1"))
    sb.dense("time_mlp2", tree["time_embed"]["mlp2"], ("time_embed", "mlp2"))
    sb.dense("input_proj", tree["input_proj"], ("input_proj",))
    sb.dwconv("conv_pos_dw", tree["conv_pos"][0], ("conv_pos",))
    sb.dense("conv_pos_pw", tree["conv_pos"][1], ("conv_pos",))
    blocks = tree["blocks"]
    depth = np.asarray(blocks["qkv"]["w"]).shape[0]
    for i in range(depth):
        layer = _layer(blocks, i)
        for key in ("ada", "qkv", "attn_out", "ff1", "ff2"):
            sb.dense(f"blocks.{i}.{key}", layer[key], ("blocks", key))
    sb.dense("final_ada", tree["final_ada"], ("final_ada",))
    sb.dense("final_proj", tree["final_proj"], ("final_proj",))
    return sb.state


def vocoder_state(tree: dict, compute_dtype: torch.dtype) -> State:
    sb = _StateBuilder(compute_dtype)
    # Dense conv {w [k, in, out]} → nn.Conv1d weight [out, in, k].
    sb.add("embed.weight", np.asarray(tree["embed"]["w"]).transpose(2, 1, 0), ("embed",))
    sb.add("embed.bias", tree["embed"]["b"], ("embed",))
    sb.add("norm_in.weight", tree["norm_in_scale"], ("norm_in_scale",))
    sb.add("norm_in.bias", tree["norm_in_bias"], ("norm_in_bias",))
    blocks = tree["blocks"]
    depth = np.asarray(blocks["gamma"]).shape[0]
    for i in range(depth):
        layer = _layer(blocks, i)
        name = f"blocks.{i}"
        sb.dwconv(f"{name}.dwconv", layer["dwconv"], ("blocks", "dwconv"))
        sb.dense(f"{name}.pw1", layer["pw1"], ("blocks", "pw1"))
        sb.dense(f"{name}.pw2", layer["pw2"], ("blocks", "pw2"))
        sb.add(f"{name}.gamma", layer["gamma"], ("blocks", "gamma"))
        sb.add(f"{name}.norm.weight", layer["norm_scale"], ("blocks", "norm_scale"))
        sb.add(f"{name}.norm.bias", layer["norm_bias"], ("blocks", "norm_bias"))
    sb.add("norm_out.weight", tree["norm_out_scale"], ("norm_out_scale",))
    sb.add("norm_out.bias", tree["norm_out_bias"], ("norm_out_bias",))
    sb.dense("head", tree["head"], ("head",))
    return sb.state


def from_jax_tree(
    tree: dict, compute_dtype: torch.dtype = torch.float32
) -> Tuple[State, State]:
    """``{'dit': …, 'vocoder': …}`` pytree (numpy leaves) → (DiT state dict,
    Vocoder state dict) on the CPU, in the serving dtype policy."""
    return dit_state(tree["dit"], compute_dtype), vocoder_state(tree["vocoder"], compute_dtype)


def to_jax_tree(dit: torch.nn.Module) -> dict:
    """The inverse of :func:`dit_state`: a DiT's weights (or its state dict)
    → the pack's ``dit`` pytree, float32 numpy leaves — dense ``[in, out]``,
    depthwise conv ``[k, 1, C]``, block weights stacked on a leading depth
    axis. Widening a bfloat16 weight to float32 is exact, so
    ``dit_state(to_jax_tree(m), dtype)`` gives back ``m``'s tensors bit for
    bit. Export, checkpoint-to-pack and the gradient tests use it (on a
    dict of ``.grad`` tensors too)."""
    sd = dit.state_dict() if isinstance(dit, torch.nn.Module) else dit

    def leaf(name: str) -> np.ndarray:
        # An owned copy: the tensor may be a live parameter.
        return sd[name].detach().to("cpu", torch.float32).numpy().copy()

    def dense(name: str) -> dict:
        return {"w": np.ascontiguousarray(leaf(f"{name}.weight").T), "b": leaf(f"{name}.bias")}

    def dwconv(name: str) -> dict:
        w = leaf(f"{name}.weight").transpose(2, 1, 0)
        return {"w": np.ascontiguousarray(w), "b": leaf(f"{name}.bias")}

    n_text = len({k.split(".")[1] for k in sd if k.startswith("text_blocks.")})
    depth = len({k.split(".")[1] for k in sd if k.startswith("blocks.")})
    layers = [
        {key: dense(f"blocks.{i}.{key}") for key in ("ada", "qkv", "attn_out", "ff1", "ff2")}
        for i in range(depth)
    ]
    blocks = {
        key: {p: np.stack([layer[key][p] for layer in layers]) for p in ("w", "b")}
        for key in layers[0]
    }
    return {
        "text_embed": {
            "table": leaf("text_table.weight"),
            "blocks": [
                {
                    "dwconv": dwconv(f"text_blocks.{i}.dwconv"),
                    "pw1": dense(f"text_blocks.{i}.pw1"),
                    "pw2": dense(f"text_blocks.{i}.pw2"),
                }
                for i in range(n_text)
            ],
        },
        "time_embed": {"mlp1": dense("time_mlp1"), "mlp2": dense("time_mlp2")},
        "input_proj": dense("input_proj"),
        "conv_pos": [dwconv("conv_pos_dw"), dense("conv_pos_pw")],
        "blocks": blocks,
        "final_ada": dense("final_ada"),
        "final_proj": dense("final_proj"),
    }
