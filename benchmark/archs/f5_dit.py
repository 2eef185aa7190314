"""F5-TTS's DiT (SWivid/F5-TTS, ``src/f5_tts/model/backbones/dit.py``), as
the port serves it: a character table and ConvNeXt text blocks, the input
projection of (x, cond, text) and a depthwise position conv, ``depth``
AdaLN-modulated blocks (RoPE on every head), a final AdaLN and the
velocity projection. The interface is the one ``benchmark/archs``
describes.

The weights' scales differ from a freshly initialised model on purpose:
the AdaLN modulations, gates among them, are drawn non-zero, so that every
block's attention and feed-forward reach the output, as in a trained
model.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import flops
from ..reference.model import Ops, depthwise_same, gelu_tanh, layernorm
from ..weights import dense

TIME_FREQ_DIM = 256
CONV_POS_KERNEL = 31
TEXT_CONV_KERNEL = 7
NEG_INF = -1e30

# The path keys under which the program keeps a leaf in its compute dtype
# (bfloat16): every leaf on a path through one of them.
BF16_KEYS = frozenset({"qkv", "attn_out", "ff1", "ff2", "input_proj", "pw1", "pw2",
                       "conv_pos", "ada", "final_ada"})


def backbone(mc: dict) -> dict:
    """A configuration's ModelConfig keys → the DiT's sizes."""
    return {"dim": mc["dit_dim"], "depth": mc["dit_depth"], "heads": mc["dit_heads"],
            "ff_mult": mc["dit_ff_mult"], "text_dim": mc["text_dim"],
            "conv_layers": mc["text_conv_layers"]}


def pack_meta(model: dict) -> dict:
    """The ``dit`` section of the pack's ``model_meta.json``."""
    dit = model["dit"]
    return {"dim": dit["dim"], "depth": dit["depth"], "heads": dit["heads"],
            "ff_mult": dit["ff_mult"], "text_dim": dit["text_dim"],
            "text_conv_layers": dit["conv_layers"]}


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def leaves(model: dict) -> list:
    """(path, shape, rule, fan-in) of every DiT leaf, in draw order."""
    d, depth, ff = model["dit"]["dim"], model["dit"]["depth"], model["dit"]["ff_mult"]
    td, nt = model["dit"]["text_dim"], model["dit"]["conv_layers"]
    m, v = model["audio"]["n_mels"], model["vocab_size"]
    out = [(("dit", "text_embed", "table"), (v + 1, td), "unit", 1)]
    for i in range(nt):
        base = ("dit", "text_embed", "blocks", i)
        out.append((base + ("dwconv", "w"), (TEXT_CONV_KERNEL, 1, td), "fan_in", TEXT_CONV_KERNEL))
        out.append((base + ("dwconv", "b"), (td,), "bias", 1))
        dense(out, base + ("pw1",), td, 2 * td)
        dense(out, base + ("pw2",), 2 * td, td)
    dense(out, ("dit", "time_embed", "mlp1"), TIME_FREQ_DIM, d)
    dense(out, ("dit", "time_embed", "mlp2"), d, d)
    dense(out, ("dit", "input_proj"), 2 * m + td, d)
    out.append((("dit", "conv_pos", 0, "w"), (CONV_POS_KERNEL, 1, d), "fan_in", CONV_POS_KERNEL))
    out.append((("dit", "conv_pos", 0, "b"), (d,), "bias", 1))
    dense(out, ("dit", "conv_pos", 1), d, d)
    dense(out, ("dit", "blocks", "ada"), d, 6 * d, (depth,), "modulation", "modulation_bias")
    dense(out, ("dit", "blocks", "qkv"), d, 3 * d, (depth,))
    dense(out, ("dit", "blocks", "attn_out"), d, d, (depth,))
    dense(out, ("dit", "blocks", "ff1"), d, ff * d, (depth,))
    dense(out, ("dit", "blocks", "ff2"), ff * d, d, (depth,))
    dense(out, ("dit", "final_ada"), d, 2 * d, (), "modulation", "modulation_bias")
    dense(out, ("dit", "final_proj"), d, m, (), "velocity")
    return out


def _modulation(x: torch.Tensor, fan_in: int) -> torch.Tensor:
    return x * (0.3 / math.sqrt(fan_in))  # AdaLN projections: shifts, scales and gates ~0.2


def _modulation_bias(x: torch.Tensor, fan_in: int) -> torch.Tensor:
    return x * 0.1


def _velocity(x: torch.Tensor, fan_in: int) -> torch.Tensor:
    return x * (0.5 / math.sqrt(fan_in))  # the DiT's output projection


SCALE_RULES = {"modulation": _modulation, "modulation_bias": _modulation_bias,
               "velocity": _velocity}


# ---------------------------------------------------------------------------
# Reference
# ---------------------------------------------------------------------------


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


def rope_tables(n: int, head_dim: int, device, theta: float = 10000.0):
    """cos, sin [n, head_dim], the half-dim frequencies repeated on both halves."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (np.arange(half, dtype=np.float64) / half))
    ang = np.arange(n, dtype=np.float64)[:, None] * freqs[None, :]
    cos = np.concatenate([np.cos(ang)] * 2, axis=-1).astype(np.float32)
    sin = np.concatenate([np.sin(ang)] * 2, axis=-1).astype(np.float32)
    return torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, H, N, D]: (x1, x2) → x·cos + (-x2, x1)·sin."""
    x1, x2 = x.chunk(2, dim=-1)
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


def attention(ops: Ops, qkv: torch.Tensor, mask: torch.Tensor, heads: int) -> torch.Tensor:
    """Packed q ‖ k ‖ v [B, N, 3·H·D] → RoPE on q and k → softmax attention
    over the valid keys → [B, N, H·D]."""
    b, n, three_hd = qkv.shape
    d = three_hd // (3 * heads)
    q, k, v = (t.reshape(b, n, heads, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    cos, sin = rope_tables(n, d, qkv.device)
    q, k = rotate(q, cos, sin), rotate(k, cos, sin)
    logits = (ops.r(q) @ ops.r(k).transpose(-1, -2)) * d**-0.5
    bias = torch.zeros(mask.shape, device=mask.device).masked_fill(~mask, NEG_INF)
    weights = torch.softmax(logits + bias[:, None, None, :], dim=-1)
    out = ops.r(weights) @ ops.r(v)
    return out.transpose(1, 2).reshape(b, n, heads * d)


def text_embed(ops: Ops, p: dict, ids: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Character ids [B, N] (-1 padded) → [B, N, text_dim]: the table row
    ids + 1 (row 0 the filler), then ConvNeXt blocks."""
    idx = torch.clamp(ids.long() + 1, 0, vocab_size)
    emb = p["table"][idx]
    for blk in p["blocks"]:
        h = layernorm(depthwise_same(emb, blk["dwconv"]))
        h = gelu_tanh(ops.dense(h, blk["pw1"]))
        emb = emb + ops.dense(h, blk["pw2"])
    return emb


def time_modulations(p: dict, t: torch.Tensor):
    """Flow times t [S] → (per-block modulations [S, depth, 6·dim], final
    modulation [S, 2·dim]); in float32 as the program keeps them."""
    half = TIME_FREQ_DIM // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, device=t.device) / half)
    args = t[:, None] * freqs[None, :] * 1000.0
    feats = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    te = p["time_embed"]
    h = F.silu(feats @ te["mlp1"]["w"] + te["mlp1"]["b"])
    t_emb = F.silu(h @ te["mlp2"]["w"] + te["mlp2"]["b"])
    ada = p["blocks"]["ada"]
    mods = torch.einsum("sd,ldk->slk", t_emb, ada["w"]) + ada["b"][None]
    fmod = t_emb @ p["final_ada"]["w"] + p["final_ada"]["b"]
    return mods, fmod


def dit_velocity(ops: Ops, p: dict, heads: int, x, cond, text_emb, mask, mods, fmod):
    """One DiT evaluation: x, cond [B, N, n_mels], text_emb [B, N, text_dim],
    mask [B, N], mods [depth, 6·dim], fmod [2·dim] → velocity [B, N, n_mels],
    zero on padding frames."""
    m = mask[..., None].float()
    h = ops.dense(torch.cat([x * m, cond * m, text_emb * m], dim=-1), p["input_proj"])
    pos = mish(depthwise_same(h, p["conv_pos"][0]))
    h = (h + ops.dense(pos, p["conv_pos"][1])) * m
    blocks = p["blocks"]
    depth = blocks["qkv"]["w"].shape[0]
    for i in range(depth):
        layer = {k: {"w": blocks[k]["w"][i], "b": blocks[k]["b"][i]}
                 for k in ("qkv", "attn_out", "ff1", "ff2")}
        sh_a, sc_a, g_a, sh_f, sc_f, g_f = mods[i].chunk(6, dim=-1)
        u = layernorm(h) * (1.0 + sc_a) + sh_a
        a = attention(ops, ops.dense(u, layer["qkv"]), mask, heads)
        h = h + g_a * ops.dense(a, layer["attn_out"])
        u = layernorm(h) * (1.0 + sc_f) + sh_f
        f = ops.dense(gelu_tanh(ops.dense(u, layer["ff1"])), layer["ff2"])
        h = h + g_f * f
    sh, sc = fmod.chunk(2, dim=-1)
    out = ops.f32_dense(layernorm(h) * (1.0 + sc) + sh, p["final_proj"])
    return torch.where(mask[..., None], out, torch.zeros((), device=out.device))


def prepare(ops: Ops, p: dict, model: dict, cond2, ids2, t_starts) -> dict:
    """The solve-wide state of the CFG-doubled rows: the flow times'
    modulations and the text embedding (``ids2`` [2B, N], the
    unconditioned half all -1)."""
    mods, fmod = time_modulations(p, t_starts)
    text2 = text_embed(ops, p["text_embed"], ids2, model["vocab_size"])
    return {"cond": cond2, "text": text2, "mods": mods, "fmod": fmod}


def velocity(ops: Ops, p: dict, model: dict, state: dict, x2, mask2, step: int):
    """One DiT evaluation of the CFG-doubled rows at the solve's ``step``."""
    return dit_velocity(ops, p, model["dit"]["heads"], x2, state["cond"], state["text"], mask2,
                        state["mods"][step], state["fmod"][step])


# ---------------------------------------------------------------------------
# Counts
# ---------------------------------------------------------------------------


def eval_flops(model: dict, valid: int) -> float:
    """One DiT evaluation of one row with ``valid`` frames: the dense
    products of every frame and attention over the valid keys."""
    d, depth = model["dit"]["dim"], model["dit"]["depth"]
    ff, td, m = model["dit"]["ff_mult"], model["dit"]["text_dim"], model["audio"]["n_mels"]
    per_frame = (2 * (2 * m + td) * d  # input projection
                 + 2 * CONV_POS_KERNEL * d + 2 * d * d  # position conv
                 + depth * 2 * d * d * (3 + 1 + 2 * ff)  # qkv, out, feed-forward
                 + 2 * d * m)  # output projection
    attention = depth * 4 * valid * valid * d  # QK^T and PV
    return per_frame * valid + attention


def embed_flops(model: dict, valid: int) -> float:
    """The text embedding of one row with ``valid`` frames."""
    td, layers = model["dit"]["text_dim"], model["dit"]["conv_layers"]
    return valid * layers * (2 * TEXT_CONV_KERNEL * td + 2 * 2 * (2 * td * td))


def attention_bound_s(model: dict, valid_lengths, bucket: int, dtype_bytes: int = 2) -> float:
    """The least time of one attention call (kernel 1) over a batch whose
    rows have these valid lengths (frames): max(flops on valid queries and
    keys over the peak, bytes read and written once over HBM's rate).
    Reads packed q, k, v of the valid frames, the rope tables and the mask;
    writes the output of the valid frames."""
    d = model["dit"]["dim"]
    hd = d // model["dit"]["heads"]
    work = sum(4 * n * n * d for n in valid_lengths)
    rows = sum(valid_lengths)
    bytes_moved = (rows * 4 * d * dtype_bytes + 2 * bucket * hd * dtype_bytes
                   + len(valid_lengths) * bucket)
    peak = flops.PEAK_FLOPS[model["compute_dtype"]]
    return max(work / peak, bytes_moved / flops.PEAK_HBM_BYTES_PER_S)


def attention_calls_per_batch(model: dict) -> int:
    """Attention calls of one dispatched batch: every block at every step."""
    return model["dit"]["depth"] * (model["sampler"]["nfe_step"] - 1)
