"""Seeded weights for a configuration, made on the device.

Every leaf is drawn from one ``torch.Generator`` on the run's device, in
two large calls: one standard-normal block for all the leaves the serving
program keeps in bfloat16 (the matrix products' weights and biases), drawn
and rounded in bfloat16, and one for the float32 leaves. Each leaf is then
a slice of its block, scaled (and shifted) by its rule (:func:`_scale`).
The backbone's leaves come first, in the order its architecture module
(``benchmark/archs/``) lists them, then the vocoder's. The tree has the
weight pack's layout (``benchmark/pack.py``), and the reference reads the
same tree (``benchmark/reference/model.py``).

The scales differ from a freshly initialised model on purpose: the
vocoder's LayerScale is drawn near 0.1, so that every vocoder block
reaches the output, as in a trained model.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from . import spec

# The vocoder's path keys under which the program keeps a leaf in its
# compute dtype (bfloat16); an architecture names its own (``BF16_KEYS``).
VOCODER_BF16_KEYS = frozenset({"pw1", "pw2"})

VOC_KERNEL = 7


def dense(out: list, path: tuple, fan_in: int, fan_out: int, lead: tuple = (),
          w_rule: str = "fan_in", b_rule: str = "bias") -> None:
    """Append a dense layer's weight [*lead, fan_in, fan_out] and bias."""
    out.append((path + ("w",), (*lead, fan_in, fan_out), w_rule, fan_in))
    out.append((path + ("b",), (*lead, fan_out), b_rule, fan_in))


def _vocoder_leaves(cfg: dict) -> List[Tuple[tuple, tuple, str, int]]:
    m = cfg["audio"]["n_mels"]
    voc = cfg["vocoder"]
    vd, vi, vl = voc["dim"], voc["intermediate_dim"], voc["num_layers"]
    n_freqs = cfg["audio"]["n_fft"] // 2 + 1
    out: List[Tuple[tuple, tuple, str, int]] = []

    def leaf(path, shape, rule, fan_in=1):
        out.append((path, shape, rule, fan_in))

    leaf(("vocoder", "embed", "w"), (VOC_KERNEL, m, vd), "fan_in", VOC_KERNEL * m)
    leaf(("vocoder", "embed", "b"), (vd,), "bias")
    leaf(("vocoder", "norm_in_scale"), (vd,), "norm_scale")
    leaf(("vocoder", "norm_in_bias"), (vd,), "bias")
    leaf(("vocoder", "blocks", "dwconv", "w"), (vl, VOC_KERNEL, 1, vd), "fan_in", VOC_KERNEL)
    leaf(("vocoder", "blocks", "dwconv", "b"), (vl, vd), "bias")
    dense(out, ("vocoder", "blocks", "pw1"), vd, vi, (vl,))
    dense(out, ("vocoder", "blocks", "pw2"), vi, vd, (vl,))
    leaf(("vocoder", "blocks", "gamma"), (vl, vd), "layerscale")
    leaf(("vocoder", "blocks", "norm_scale"), (vl, vd), "norm_scale")
    leaf(("vocoder", "blocks", "norm_bias"), (vl, vd), "bias")
    leaf(("vocoder", "norm_out_scale"), (vd,), "norm_scale")
    leaf(("vocoder", "norm_out_bias"), (vd,), "bias")
    dense(out, ("vocoder", "head"), vd, 2 * n_freqs, (), "head", "head_bias")
    return out


def _leaves(cfg: dict) -> List[Tuple[tuple, tuple, str, int, bool]]:
    """(path, shape, rule, fan-in, bfloat16) of every leaf of the tree, in
    draw order: the backbone's, then the vocoder's."""
    arch = spec.architecture(cfg["architecture"])
    return ([(*leaf, _has_key(leaf[0], arch.BF16_KEYS)) for leaf in arch.leaves(cfg)]
            + [(*leaf, _has_key(leaf[0], VOCODER_BF16_KEYS)) for leaf in _vocoder_leaves(cfg)])


def _scale(x: torch.Tensor, rule: str, fan_in: int, n_freqs: int, arch_rules: dict) -> torch.Tensor:
    """A standard-normal slice → the leaf, by its rule (the architecture's
    own rules in ``arch_rules``)."""
    if rule in arch_rules:
        return arch_rules[rule](x, fan_in)
    if rule == "unit":
        return x
    if rule == "fan_in":
        return x / math.sqrt(fan_in)
    if rule == "bias":
        return x * 0.02
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


def _has_key(path: tuple, keys: frozenset) -> bool:
    return bool(keys.intersection(k for k in path if isinstance(k, str)))


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
    rules = spec.architecture(cfg["architecture"]).SCALE_RULES
    n_freqs = cfg["audio"]["n_fft"] // 2 + 1
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    blocks = {}
    for bf16 in (True, False):
        n = sum(math.prod(s) for _, s, _, _, b in leaves if b == bf16)
        dtype = torch.bfloat16 if bf16 else torch.float32
        blocks[bf16] = torch.randn((n,), generator=g, device=device, dtype=dtype)
    offsets = {True: 0, False: 0}
    tree: dict = {}
    for path, shape, rule, fan_in, bf16 in leaves:
        size = math.prod(shape)
        x = blocks[bf16][offsets[bf16] : offsets[bf16] + size].view(shape)
        offsets[bf16] += size
        leaf = _scale(x.float(), rule, fan_in, n_freqs, rules)
        if bf16:
            leaf = leaf.to(torch.bfloat16).float()
        _insert_path(tree, path, leaf)
    return tree


def parameter_count(cfg: dict) -> int:
    return sum(math.prod(leaf[1]) for leaf in _leaves(cfg))
