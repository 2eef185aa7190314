"""Seeded weights for a configuration, made on the device.

Every leaf is drawn from one ``torch.Generator`` on the run's device, in
two large calls: one standard-normal block for all the leaves the serving
program keeps in bfloat16 (the matrix products' weights and biases), drawn
and rounded in bfloat16, and one for the float32 leaves. Each leaf is then
a slice of its block, scaled (and shifted) by its rule (:func:`_scale`).
The tree has the weight pack's layout (``benchmark/pack.py``), and the
reference reads the same tree (``benchmark/reference/model.py``).

The scales differ from a freshly initialised model on purpose: the AdaLN
gates, the vocoder's LayerScale and the modulations are drawn non-zero, so
that every DiT block's attention and feed-forward and every vocoder block
reach the output, as in a trained model.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

# The top-level keys under which the program keeps a leaf in its compute
# dtype (bfloat16): every leaf on a path through one of them.
BF16_KEYS = frozenset({"qkv", "attn_out", "ff1", "ff2", "input_proj", "pw1", "pw2",
                       "conv_pos", "ada", "final_ada"})

TIME_FREQ_DIM = 256
CONV_POS_KERNEL = 31
TEXT_CONV_KERNEL = 7
VOC_KERNEL = 7


def _leaves(cfg: dict) -> List[Tuple[tuple, tuple, str, int]]:
    """(path, shape, rule, fan-in) of every leaf of the tree, in a fixed order."""
    d, depth, ff = cfg["dit"]["dim"], cfg["dit"]["depth"], cfg["dit"]["ff_mult"]
    td, nt = cfg["dit"]["text_dim"], cfg["dit"]["conv_layers"]
    m, v = cfg["audio"]["n_mels"], cfg["vocab_size"]
    vd, vi, vl = cfg["vocoder"]["dim"], cfg["vocoder"]["intermediate_dim"], cfg["vocoder"]["num_layers"]
    n_freqs = cfg["audio"]["n_fft"] // 2 + 1
    out: List[Tuple[tuple, tuple, str, int]] = [
        (("dit", "text_embed", "table"), (v + 1, td), "unit", 1)]

    def dense(path, fan_in, fan_out, lead=(), w_rule="fan_in", b_rule="bias"):
        out.append((path + ("w",), (*lead, fan_in, fan_out), w_rule, fan_in))
        out.append((path + ("b",), (*lead, fan_out), b_rule, fan_in))

    def leaf(path, shape, rule, fan_in=1):
        out.append((path, shape, rule, fan_in))

    for i in range(nt):
        base = ("dit", "text_embed", "blocks", i)
        leaf(base + ("dwconv", "w"), (TEXT_CONV_KERNEL, 1, td), "fan_in", TEXT_CONV_KERNEL)
        leaf(base + ("dwconv", "b"), (td,), "bias")
        dense(base + ("pw1",), td, 2 * td)
        dense(base + ("pw2",), 2 * td, td)
    dense(("dit", "time_embed", "mlp1"), TIME_FREQ_DIM, d)
    dense(("dit", "time_embed", "mlp2"), d, d)
    dense(("dit", "input_proj"), 2 * m + td, d)
    leaf(("dit", "conv_pos", 0, "w"), (CONV_POS_KERNEL, 1, d), "fan_in", CONV_POS_KERNEL)
    leaf(("dit", "conv_pos", 0, "b"), (d,), "bias")
    dense(("dit", "conv_pos", 1), d, d)
    dense(("dit", "blocks", "ada"), d, 6 * d, (depth,), "modulation", "modulation_bias")
    dense(("dit", "blocks", "qkv"), d, 3 * d, (depth,))
    dense(("dit", "blocks", "attn_out"), d, d, (depth,))
    dense(("dit", "blocks", "ff1"), d, ff * d, (depth,))
    dense(("dit", "blocks", "ff2"), ff * d, d, (depth,))
    dense(("dit", "final_ada"), d, 2 * d, (), "modulation", "modulation_bias")
    dense(("dit", "final_proj"), d, m, (), "velocity")
    leaf(("vocoder", "embed", "w"), (VOC_KERNEL, m, vd), "fan_in", VOC_KERNEL * m)
    leaf(("vocoder", "embed", "b"), (vd,), "bias")
    leaf(("vocoder", "norm_in_scale"), (vd,), "norm_scale")
    leaf(("vocoder", "norm_in_bias"), (vd,), "bias")
    leaf(("vocoder", "blocks", "dwconv", "w"), (vl, VOC_KERNEL, 1, vd), "fan_in", VOC_KERNEL)
    leaf(("vocoder", "blocks", "dwconv", "b"), (vl, vd), "bias")
    dense(("vocoder", "blocks", "pw1"), vd, vi, (vl,))
    dense(("vocoder", "blocks", "pw2"), vi, vd, (vl,))
    leaf(("vocoder", "blocks", "gamma"), (vl, vd), "layerscale")
    leaf(("vocoder", "blocks", "norm_scale"), (vl, vd), "norm_scale")
    leaf(("vocoder", "blocks", "norm_bias"), (vl, vd), "bias")
    leaf(("vocoder", "norm_out_scale"), (vd,), "norm_scale")
    leaf(("vocoder", "norm_out_bias"), (vd,), "bias")
    dense(("vocoder", "head"), vd, 2 * n_freqs, (), "head", "head_bias")
    return out


def _scale(x: torch.Tensor, rule: str, fan_in: int, n_freqs: int) -> torch.Tensor:
    """A standard-normal slice → the leaf, by its rule."""
    if rule == "unit":
        return x
    if rule == "fan_in":
        return x / math.sqrt(fan_in)
    if rule == "bias":
        return x * 0.02
    if rule == "modulation":  # AdaLN projections: shifts, scales and gates ~0.2
        return x * (0.3 / math.sqrt(fan_in))
    if rule == "modulation_bias":
        return x * 0.1
    if rule == "velocity":  # the DiT's output projection
        return x * (0.5 / math.sqrt(fan_in))
    if rule == "norm_scale":
        return 1.0 + 0.1 * x
    if rule == "layerscale":
        return 0.1 + 0.02 * x
    if rule == "head":  # log-magnitude and phase of the iSTFT head
        return x * (0.5 / math.sqrt(fan_in))
    if rule == "head_bias":  # log-magnitude around 2: a waveform RMS near 0.2
        out = 0.1 * x
        out[:n_freqs] += 2.0
        return out
    raise ValueError(rule)


def _is_bf16(path: tuple) -> bool:
    return bool(BF16_KEYS.intersection(k for k in path if isinstance(k, str)))


def _insert_path(tree, path: tuple, value) -> None:
    """Set ``tree[path[0]][path[1]]...`` = value, making dicts and lists."""
    node = tree
    for i, key in enumerate(path[:-1]):
        nxt = path[i + 1]
        if isinstance(node, list):
            while len(node) <= key:
                node.append(None)
            if node[key] is None:
                node[key] = [] if isinstance(nxt, int) else {}
            node = node[key]
        else:
            if key not in node:
                node[key] = [] if isinstance(nxt, int) else {}
            node = node[key]
    if isinstance(node, list):
        while len(node) <= path[-1]:
            node.append(None)
    node[path[-1]] = value


def make_weights(cfg: dict, seed: int, device) -> Dict:
    """The configuration's weights from ``seed``: {'dit': ..., 'vocoder': ...},
    float32 tensors on ``device`` (the bfloat16 leaves hold bfloat16 values)."""
    leaves = _leaves(cfg)
    n_freqs = cfg["audio"]["n_fft"] // 2 + 1
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    blocks = {}
    for bf16 in (True, False):
        n = sum(math.prod(s) for p, s, _, _ in leaves if _is_bf16(p) == bf16)
        dtype = torch.bfloat16 if bf16 else torch.float32
        blocks[bf16] = torch.randn((n,), generator=g, device=device, dtype=dtype)
    offsets = {True: 0, False: 0}
    tree: dict = {}
    for path, shape, rule, fan_in in leaves:
        bf16 = _is_bf16(path)
        size = math.prod(shape)
        x = blocks[bf16][offsets[bf16] : offsets[bf16] + size].view(shape)
        offsets[bf16] += size
        leaf = _scale(x.float(), rule, fan_in, n_freqs)
        if bf16:
            leaf = leaf.to(torch.bfloat16).float()
        _insert_path(tree, path, leaf)
    return tree


def parameter_count(cfg: dict) -> int:
    return sum(math.prod(s) for _, s, _, _ in _leaves(cfg))
