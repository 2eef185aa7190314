"""F5-export-shaped fixture tarball for rehearsing the real conversion.

Round-2 verdict: the only fixture exercising ``convert.py`` mirrored our own
pack layout, so the first contact with the real ``model-bin.pt`` would still
be the first contact. This module builds a tarball shaped like an actual
F5-TTS-family torch→ONNX export (reference layout:
``vietvoicetts/core/model.py:65-129``):

- **three graphs** with the reference's I/O contract
  (``core/tts_engine.py:228-230``): ``preprocess.onnx`` (audio/text →
  noise, 4 RoPE tables, cond/uncond embeddings, ref_signal_len),
  ``transformer.onnx`` (one CFG+Euler denoise step, looped by the caller),
  ``decode.onnx`` (Vocos-style iSTFT vocoder → int16 waveform);
- **torch-export weight layout**: Linear weights stored ``[out, in]`` and
  consumed by ``Gemm`` with ``transB=1``; Conv weights ``[out, in/g, k]``;
  per-layer initializers named ``blocks.{i}.attn.qkv.weight`` etc. (no
  depth stacking);
- **16 attention heads** (dim 1024 / head_dim 64) by default — the
  configuration the round-2 verdict flagged as the conversion landmine;
- assets: ``vocab.txt``, ``audio_metadata.json``, ``cleaned_audios/*.wav``.

The graphs compute the *same functions* as the model (``models/dit.py``,
``models/vocoder.py``, ``ops/stft.py``), so running them with the numpy
evaluator (``models/onnx_eval.py``) through the golden harness's reference
side (``golden.py:reference_side``) and comparing against the converted pack
through its ``torch_side`` is a true end-to-end rehearsal: probe → convert (orientation/permute/stacking) →
golden mel comparison.

``build_name_map`` emits the committed starter name map
(``models/f5_name_map.json`` beside this module is generated from it) that
pins every parameter leaf to its export name — the artifact conversion day
needs.
"""

from __future__ import annotations

import dataclasses
import json
import tarfile
from pathlib import Path
from typing import Dict, List

import numpy as np

from ..ops.stft import _dft_bases, mel_filterbank
from . import onnx_pb as ox

F32, I16, I32, I64 = 1, 5, 6, 7


@dataclasses.dataclass(frozen=True)
class FixtureSpec:
    """Architecture of the fixture export (defaults = expected real model)."""

    dim: int = 1024
    depth: int = 22
    heads: int = 16  # head_dim = dim/heads = 64: the F5 convention
    ff_mult: int = 2
    n_mels: int = 100
    text_dim: int = 512
    text_conv_layers: int = 4
    vocab_size: int = 211
    voc_dim: int = 512
    voc_inter: int = 1536
    voc_layers: int = 8
    n_fft: int = 1024
    win_length: int = 1024
    hop_length: int = 256
    sample_rate: int = 24000
    nfe_step: int = 32
    cfg_strength: float = 2.0
    sway_sampling_coef: float = -1.0
    time_freq_dim: int = 256

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads

    @property
    def n_freqs(self) -> int:
        return self.n_fft // 2 + 1


# ---------------------------------------------------------------------------
# Tiny graph-construction DSL over onnx_pb.make_* helpers
# ---------------------------------------------------------------------------


class _GB:
    def __init__(self) -> None:
        self.nodes: List[bytes] = []
        self.inits: List[bytes] = []
        self._ctr = 0
        self._init_names: set = set()

    def _t(self, hint: str) -> str:
        self._ctr += 1
        return f"{hint}_{self._ctr}"

    def init(self, name: str, arr: np.ndarray) -> str:
        # Weight sharing (CFG cond/uncond branches reference the same
        # initializers) must not duplicate tensors in the file.
        if name not in self._init_names:
            self._init_names.add(name)
            self.inits.append(ox.make_tensor(name, np.ascontiguousarray(arr)))
        return name

    def c(self, arr, hint: str = "const") -> str:
        return self.init(self._t(hint), np.asarray(arr))

    def n(self, op: str, inputs: List[str], n_out: int = 1, hint: str | None = None, **attrs):
        outs = [self._t(hint or op.lower()) for _ in range(n_out)]
        self.nodes.append(ox.make_node(op, list(inputs), outs, **attrs))
        return outs[0] if n_out == 1 else outs

    def out(self, op: str, inputs: List[str], out_name: str, **attrs) -> str:
        self.nodes.append(ox.make_node(op, list(inputs), [out_name], **attrs))
        return out_name


def _linear(gb: _GB, x: str, prefix: str, w_oi: np.ndarray, b: np.ndarray) -> str:
    """torch Linear: weight [out, in] via Gemm transB=1 (+ bias). x 2-D."""
    w = gb.init(f"{prefix}.weight", w_oi)
    bb = gb.init(f"{prefix}.bias", b)
    return gb.n("Gemm", [x, w, bb], transB=1)


def _ln(gb: _GB, x: str, scale: str, bias: str | None = None) -> str:
    ins = [x, scale] + ([bias] if bias else [])
    return gb.n("LayerNormalization", ins, epsilon=1e-6)


def _ln_decomposed(gb: _GB, x: str, scale: str) -> str:
    """The torch-export spelling of LayerNorm: ReduceMean / Sub / Pow /
    ReduceMean / Add eps / Sqrt / Div / Mul scale (older opsets and
    constant-folded exports emit this instead of the fused op)."""
    mean = gb.n("ReduceMean", [x], axes=[-1], keepdims=1, hint="ln_mean")
    centered = gb.n("Sub", [x, mean], hint="ln_centered")
    var = gb.n(
        "ReduceMean",
        [gb.n("Pow", [centered, gb.c(np.float32(2.0), "two")])],
        axes=[-1], keepdims=1, hint="ln_var",
    )
    denom = gb.n("Sqrt", [gb.n("Add", [var, gb.c(np.float32(1e-6), "ln_eps")])])
    return gb.n("Mul", [gb.n("Div", [centered, denom]), scale], hint="ln_out")


def _gelu_erf(gb: _GB, x: str) -> str:
    """Exact GELU as torch exports it without the Gelu op:
    0.5 * x * (1 + Erf(x / sqrt(2)))."""
    inner = gb.n("Erf", [gb.n("Div", [x, gb.c(np.float32(2.0**0.5), "sqrt2")])])
    one = gb.n("Add", [inner, gb.c(np.float32(1.0), "one_gelu")])
    return gb.n("Mul", [gb.n("Mul", [x, one]), gb.c(np.float32(0.5), "half")])


def _gelu(gb: _GB, x: str) -> str:
    return gb.n("Gelu", [x], approximate="tanh")


def _silu(gb: _GB, x: str) -> str:
    return gb.n("Mul", [x, gb.n("Sigmoid", [x])])


def _mish(gb: _GB, x: str) -> str:
    return gb.n("Mul", [x, gb.n("Tanh", [gb.n("Softplus", [x])])])


def _dwconv2d(gb: _GB, x: str, prefix: str, w_cik: np.ndarray, b: np.ndarray) -> str:
    """Depthwise SAME conv on [N, C] (torch weight [C, 1, k], group=C)."""
    c, _, k = w_cik.shape
    lo = (k - 1) // 2
    w = gb.init(f"{prefix}.weight", w_cik)
    bb = gb.init(f"{prefix}.bias", b)
    h = gb.n("Transpose", [x], perm=[1, 0])  # [C, N]
    h = gb.n("Unsqueeze", [h], axes=[0])  # [1, C, N]
    h = gb.n("Conv", [h, w, bb], group=c, pads=[lo, k - 1 - lo], strides=[1])
    h = gb.n("Squeeze", [h], axes=[0])
    return gb.n("Transpose", [h], perm=[1, 0])  # [N, C]


def _text_stack(gb: _GB, spec: FixtureSpec, ids2d: str, w: dict, scope: str) -> str:
    """Char ids [1, N] (already +1, 0 = filler) → features [N, text_dim]."""
    emb = gb.n("Gather", [w["table_name"], ids2d], axis=0, hint=f"{scope}_emb")
    h = gb.n("Squeeze", [emb], axes=[0])  # [N, text_dim]
    ones = gb.c(np.ones((spec.text_dim,), np.float32), "ln_ones")
    for i, blk in enumerate(w["text_blocks"]):
        d = _dwconv2d(gb, h, f"text_blocks.{i}.dwconv", blk["dw_w"], blk["dw_b"])
        d = _ln(gb, d, ones)
        d = _gelu(gb, _linear(gb, d, f"text_blocks.{i}.pw1", blk["pw1_w"], blk["pw1_b"]))
        d = _linear(gb, d, f"text_blocks.{i}.pw2", blk["pw2_w"], blk["pw2_b"])
        h = gb.n("Add", [h, d])
    return h


# ---------------------------------------------------------------------------
# Weight generation: our pytree → torch-export layout
# ---------------------------------------------------------------------------


def make_params(spec: FixtureSpec, seed: int = 0):
    """Random params in OUR pytree layout (AdaLN randomized — the zero init
    would make the fixture numerics trivially insensitive to mapping bugs)."""
    from .dit import DiTConfig, init_dit_params
    from .vocoder import VocoderConfig, init_vocoder_params

    rng = np.random.default_rng(seed)
    dit_cfg = DiTConfig(
        dim=spec.dim, depth=spec.depth, heads=spec.heads, ff_mult=spec.ff_mult,
        n_mels=spec.n_mels, text_dim=spec.text_dim,
        text_conv_layers=spec.text_conv_layers, vocab_size=spec.vocab_size,
    )
    voc_cfg = VocoderConfig(
        dim=spec.voc_dim, intermediate_dim=spec.voc_inter,
        num_layers=spec.voc_layers, n_mels=spec.n_mels, n_fft=spec.n_fft,
        hop_length=spec.hop_length,
    )
    dit = init_dit_params(rng, dit_cfg)
    s = 0.02
    for leaf in ("ada",):
        dit["blocks"][leaf]["w"] = rng.normal(0, s, dit["blocks"][leaf]["w"].shape).astype(np.float32)
        dit["blocks"][leaf]["b"] = rng.normal(0, s, dit["blocks"][leaf]["b"].shape).astype(np.float32)
    dit["final_ada"]["w"] = rng.normal(0, s, dit["final_ada"]["w"].shape).astype(np.float32)
    dit["final_ada"]["b"] = rng.normal(0, s, dit["final_ada"]["b"].shape).astype(np.float32)
    voc = init_vocoder_params(rng, voc_cfg)
    return {"dit": dit, "vocoder": voc}


def _export_dit(params: dict) -> dict:
    """Our dit pytree → per-graph export arrays (torch layouts)."""
    dit = params["dit"]
    text_blocks = []
    for blk in dit["text_embed"]["blocks"]:
        text_blocks.append(
            {
                "dw_w": np.transpose(blk["dwconv"]["w"], (2, 1, 0)),  # [C,1,k]
                "dw_b": blk["dwconv"]["b"],
                "pw1_w": blk["pw1"]["w"].T,  # [out, in]
                "pw1_b": blk["pw1"]["b"],
                "pw2_w": blk["pw2"]["w"].T,
                "pw2_b": blk["pw2"]["b"],
            }
        )
    blocks = []
    bl = dit["blocks"]
    for i in range(bl["qkv"]["w"].shape[0]):
        blocks.append(
            {
                "ada_w": bl["ada"]["w"][i].T,
                "ada_b": bl["ada"]["b"][i],
                "qkv_w": bl["qkv"]["w"][i].T,
                "qkv_b": bl["qkv"]["b"][i],
                "out_w": bl["attn_out"]["w"][i].T,
                "out_b": bl["attn_out"]["b"][i],
                "ff1_w": bl["ff1"]["w"][i].T,
                "ff1_b": bl["ff1"]["b"][i],
                "ff2_w": bl["ff2"]["w"][i].T,
                "ff2_b": bl["ff2"]["b"][i],
            }
        )
    return {
        "table": dit["text_embed"]["table"],
        "text_blocks": text_blocks,
        "time_mlp1_w": dit["time_embed"]["mlp1"]["w"].T,
        "time_mlp1_b": dit["time_embed"]["mlp1"]["b"],
        "time_mlp2_w": dit["time_embed"]["mlp2"]["w"].T,
        "time_mlp2_b": dit["time_embed"]["mlp2"]["b"],
        "input_proj_w": dit["input_proj"]["w"].T,
        "input_proj_b": dit["input_proj"]["b"],
        "conv_pos_dw_w": np.transpose(dit["conv_pos"][0]["w"], (2, 1, 0)),
        "conv_pos_dw_b": dit["conv_pos"][0]["b"],
        "conv_pos_pw_w": dit["conv_pos"][1]["w"].T,
        "conv_pos_pw_b": dit["conv_pos"][1]["b"],
        "blocks": blocks,
        "final_ada_w": dit["final_ada"]["w"].T,
        "final_ada_b": dit["final_ada"]["b"],
        "final_proj_w": dit["final_proj"]["w"].T,
        "final_proj_b": dit["final_proj"]["b"],
    }


# ---------------------------------------------------------------------------
# Graph construction
# ---------------------------------------------------------------------------


def build_preprocess(spec: FixtureSpec, params: dict, seed: int = 9527,
                     variant: str = "f5") -> bytes:
    """(audio [1,1,T] f32 int16-scale, text_ids [1,L] i64, max_duration [1]
    i64) → (noise, rope_cos_q, rope_sin_q, rope_cos_k, rope_sin_k,
    cat_mel_text, cat_mel_text_drop, ref_signal_len).

    ``variant="swapped_concat"`` emits ``Concat(text, mel)`` instead of
    ``Concat(mel, text)`` — a hostile export the topology verifier must
    flag (the converted input_proj's column blocks would be swapped)."""
    gb = _GB()
    exp = _export_dit(params)
    hop, win, n_fft = spec.hop_length, spec.win_length, spec.n_fft

    table = gb.init("text_embed.weight", exp["table"])
    tw = {"table_name": table, "text_blocks": exp["text_blocks"]}

    # ---- sample-count arithmetic (all dynamic via Shape ops) ----
    t_len = gb.n(
        "Slice",
        [gb.n("Shape", ["audio"]), gb.c(np.array([2], np.int64)), gb.c(np.array([3], np.int64))],
        hint="t_len",
    )  # [1] int64
    total = gb.n("Mul", ["max_duration", gb.c(np.array([hop], np.int64))], hint="total_samples")
    pad_end = gb.n("Sub", [total, t_len], hint="pad_end")
    ref_len = gb.n("Div", [t_len, gb.c(np.array([hop], np.int64))], hint="ref_len")

    # ---- mel of the zero-padded composite waveform (engine parity:
    # runtime/engine_core.py pads the wave to the bucket before the mel) ----
    wave = gb.n("Mul", ["audio", gb.c(np.float32(1.0 / 32768.0))], hint="wave_norm")
    pads6 = gb.n(
        "Concat", [gb.c(np.zeros((5,), np.int64)), pad_end], axis=0, hint="pads_zero"
    )
    wave = gb.n("Pad", [wave, pads6], mode="constant", hint="wave_padded")
    p = n_fft // 2
    refl = gb.c(np.array([0, 0, p, 0, 0, p], np.int64), "pads_reflect")
    wave = gb.n("Pad", [wave, refl], mode="reflect", hint="wave_reflect")
    cos_b, sin_b = _dft_bases(n_fft, win)  # [win, F] each
    dft_w = np.concatenate([cos_b.T, sin_b.T], axis=0)[:, None, :]  # [2F, 1, win]
    dft = gb.init("mel.dft.weight", dft_w.astype(np.float32))
    spec_2f = gb.n("Conv", [wave, dft], strides=[hop], pads=[0, 0], hint="dft")
    re, im = gb.n("Split", [spec_2f], n_out=2, axis=1, hint="reim")
    mag = gb.n(
        "Sqrt",
        [
            gb.n(
                "Add",
                [
                    gb.n("Add", [gb.n("Mul", [re, re]), gb.n("Mul", [im, im])]),
                    gb.c(np.float32(1e-12)),
                ],
            )
        ],
        hint="mag",
    )  # [1, F, N+1]
    mag = gb.n("Transpose", [mag], perm=[0, 2, 1], hint="mag_t")  # [1, N+1, F]
    starts = gb.c(np.array([0, 0], np.int64))
    # keep exactly max_duration frames (Conv yields one extra)
    md_pair = gb.n("Concat", [gb.c(np.array([2**31 - 1], np.int64)), "max_duration"], axis=0)
    mag = gb.n(
        "Slice", [mag, starts, md_pair, gb.c(np.array([0, 1], np.int64))], hint="mag_n"
    )
    fb = gb.init("mel.fbank", mel_filterbank(spec.sample_rate, n_fft, spec.n_mels))
    mel = gb.n("MatMul", [mag, fb], hint="mel")
    mel = gb.n("Log", [gb.n("Max", [mel, gb.c(np.float32(1e-5))])], hint="logmel")

    # ---- conditioning: reference prefix only ----
    n_scalar = gb.n("Squeeze", ["max_duration"], axes=[0], hint="n_scalar")
    frame_idx = gb.n(
        "Range",
        [gb.c(np.int64(0)), n_scalar, gb.c(np.int64(1))],
        hint="frame_idx",
    )
    is_ref = gb.n("Less", [frame_idx, ref_len], hint="is_ref")
    ref_mask = gb.n("Cast", [is_ref], to=F32)
    ref_mask = gb.n("Unsqueeze", [ref_mask], axes=[0, 2], hint="ref_mask")  # [1,N,1]
    cond = gb.n("Mul", [mel, ref_mask], hint="cond")

    # ---- text features (cond and CFG-dropped filler branches) ----
    l_len = gb.n(
        "Slice",
        [gb.n("Shape", ["text_ids"]), gb.c(np.array([1], np.int64)), gb.c(np.array([2], np.int64))],
        hint="l_len",
    )
    ids1 = gb.n("Add", ["text_ids", gb.c(np.int64(1))], hint="ids_plus1")
    pad_ids = gb.n("Sub", [gb.n("Reshape", [n_scalar, gb.c(np.array([1], np.int64))]), l_len])
    pads_ids = gb.n(
        "Concat",
        [gb.c(np.zeros((3,), np.int64)), pad_ids],
        axis=0,
        hint="pads_ids",
    )
    ids_padded = gb.n("Pad", [ids1, pads_ids, gb.c(np.int64(0))], mode="constant", hint="ids_padded")
    text_feat = _text_stack(gb, spec, ids_padded, tw, "cond")  # [N, text_dim]
    # CFG-dropped branch: all-filler ids (row 0 of the table).
    ids_zero = gb.n("Mul", [ids_padded, gb.c(np.int64(0))], hint="ids_zero")
    text_drop = _text_stack(gb, spec, ids_zero, tw, "drop")

    text3 = gb.n("Unsqueeze", [text_feat], axes=[0])
    drop3 = gb.n("Unsqueeze", [text_drop], axes=[0])
    zcond = gb.n("Mul", [cond, gb.c(np.float32(0.0))], hint="zero_cond")
    if variant == "swapped_concat":
        gb.out("Concat", [text3, cond], "cat_mel_text", axis=2)
        gb.out("Concat", [drop3, zcond], "cat_mel_text_drop", axis=2)
    else:
        gb.out("Concat", [cond, text3], "cat_mel_text", axis=2)
        gb.out("Concat", [zcond, drop3], "cat_mel_text_drop", axis=2)

    # ---- RoPE tables (ops/rope.py semantics: half-dim freqs duplicated) ----
    half = spec.head_dim // 2
    inv_freq = (1.0 / (10000.0 ** (np.arange(half) / half))).astype(np.float32)
    pos = gb.n("Cast", [frame_idx], to=F32)
    ang = gb.n(
        "Mul",
        [gb.n("Unsqueeze", [pos], axes=[1]), gb.init("rope.inv_freq", inv_freq)],
        hint="ang",
    )  # [N, half]
    cosv = gb.n("Cos", [ang])
    sinv = gb.n("Sin", [ang])
    cos2 = gb.n("Unsqueeze", [gb.n("Concat", [cosv, cosv], axis=1)], axes=[0])
    sin2 = gb.n("Unsqueeze", [gb.n("Concat", [sinv, sinv], axis=1)], axes=[0])
    gb.out("Identity", [cos2], "rope_cos_q")
    gb.out("Identity", [sin2], "rope_sin_q")
    gb.out("Identity", [cos2], "rope_cos_k")
    gb.out("Identity", [sin2], "rope_sin_k")

    # ---- noise + ref length ----
    gb.out("RandomNormalLike", [cond], "noise", dtype=F32, seed=float(seed))
    gb.out("Identity", [ref_len], "ref_signal_len")

    hd, nm = spec.head_dim, spec.n_mels
    graph = ox.make_graph(
        "preprocess",
        gb.nodes,
        gb.inits,
        inputs=[
            ox.make_value_info("audio", F32, [1, 1, "T"]),
            ox.make_value_info("text_ids", I64, [1, "L"]),
            ox.make_value_info("max_duration", I64, [1]),
        ],
        outputs=[
            ox.make_value_info("noise", F32, [1, "N", nm]),
            ox.make_value_info("rope_cos_q", F32, [1, "N", hd]),
            ox.make_value_info("rope_sin_q", F32, [1, "N", hd]),
            ox.make_value_info("rope_cos_k", F32, [1, "N", hd]),
            ox.make_value_info("rope_sin_k", F32, [1, "N", hd]),
            ox.make_value_info("cat_mel_text", F32, [1, "N", nm + spec.text_dim]),
            ox.make_value_info("cat_mel_text_drop", F32, [1, "N", nm + spec.text_dim]),
            ox.make_value_info("ref_signal_len", I64, [1]),
        ],
    )
    return ox.make_model(graph)


def _dit_branch(gb: _GB, spec: FixtureSpec, exp: dict, x2d: str, cat: str,
                t_emb: str, variant: str = "f5") -> str:
    """One DiT forward (models/dit.py:dit_forward_embedded, full mask):
    x2d [N, n_mels], cat [N, n_mels+text_dim], t_emb [1, dim] (SiLU'd).

    ``variant`` builds HOSTILE exports for topology-verifier tests
    (models/topology.py must DETECT these, never convert them silently):

    - ``"f5"`` — the faithful pre-norm AdaLN-Zero block (default);
    - ``"post_norm"`` — no norm before QKV; the norm runs after the
      residual add (a structurally different transformer family);
    - ``"mod_before_norm"`` — AdaLN scale/shift applied BEFORE the norm
      (the norm then erases the modulation — wrong op order);
    - ``"no_gate"`` — plain residual adds without the AdaLN-Zero gates;
    - ``"rope_swapped"`` — HOSTILE: the cos/sin RoPE tables exchanged in
      the application (same symbolic shape, wrong rotation direction);
    - ``"torch_decomposed"`` — a BENIGN spelling variant (must VERIFY, not
      be flagged): decomposed LayerNorm (ReduceMean/Sub/Pow/Sqrt/Div),
      separate q/k/v Gemms instead of the packed projection, and
      erf-GELU instead of the Gelu op — the shapes real torch exports
      emit on older opsets;
    - ``"matmul_add"`` — BENIGN: every block projection spelled as
      ``MatMul`` + bias ``Add`` instead of ``Gemm`` (the dynamo/older-
      opset export form); the verifier must cross the bias Add, never
      mistake it for the residual add;
    - ``"scale_on_q"`` — BENIGN: the 1/√d_k attention scale multiplied
      into Q before the QK MatMul (one SDPA decomposition) instead of
      applied to the logits.
    """
    if variant == "matmul_add":
        def lin(x: str, prefix: str, w_oi: np.ndarray, b: np.ndarray) -> str:
            w = gb.init(f"{prefix}.weight", np.ascontiguousarray(w_oi.T))
            bb = gb.init(f"{prefix}.bias", b)
            return gb.n("Add", [gb.n("MatMul", [x, w]), bb])
    else:
        def lin(x: str, prefix: str, w_oi: np.ndarray, b: np.ndarray) -> str:
            return _linear(gb, x, prefix, w_oi, b)
    d = spec.dim
    ones_d = gb.c(np.ones((d,), np.float32), "ln_ones_d")
    h_in = gb.n("Concat", [x2d, cat], axis=1, hint="h_in")
    h = _linear(gb, h_in, "input_proj", exp["input_proj_w"], exp["input_proj_b"])

    pos = _dwconv2d(gb, h, "conv_pos.dwconv", exp["conv_pos_dw_w"], exp["conv_pos_dw_b"])
    pos = _linear(gb, _mish(gb, pos), "conv_pos.proj", exp["conv_pos_pw_w"], exp["conv_pos_pw_b"])
    h = gb.n("Add", [h, pos])

    heads, hd = spec.heads, spec.head_dim
    head_shape = gb.c(np.array([-1, heads, hd], np.int64), "head_shape")
    merge_shape = gb.c(np.array([-1, heads * hd], np.int64), "merge_shape")
    scale = gb.c(np.float32(hd**-0.5), "attn_scale")
    one_f = gb.c(np.float32(1.0), "one")

    def heads_split(x: str) -> str:
        r = gb.n("Reshape", [x, head_shape])
        return gb.n("Transpose", [r], perm=[1, 0, 2])  # [H, N, hd]

    def rope(x: str) -> str:
        x1, x2 = gb.n("Split", [x], n_out=2, axis=2, hint="rope_split")
        rot = gb.n("Concat", [gb.n("Neg", [x2]), x1], axis=2)
        if variant == "rope_swapped":  # HOSTILE: cos/sin tables exchanged
            return gb.n(
                "Add",
                [gb.n("Mul", [x, "rope_sin_2d"]), gb.n("Mul", [rot, "rope_cos_2d"])],
            )
        return gb.n(
            "Add",
            [gb.n("Mul", [x, "rope_cos_2d"]), gb.n("Mul", [rot, "rope_sin_2d"])],
        )

    for i, blk in enumerate(exp["blocks"]):
        pre = f"blocks.{i}"
        mod = _linear(gb, t_emb, f"{pre}.ada", blk["ada_w"], blk["ada_b"])
        sh_a, sc_a, g_a, sh_f, sc_f, g_f = gb.n(
            "Split", [mod], n_out=6, axis=1, hint="mod_split"
        )
        norm1_w = gb.init(f"{pre}.norm1.weight", np.ones((d,), np.float32))
        norm = _ln_decomposed if variant == "torch_decomposed" else (
            lambda g, x, w: _ln(g, x, w)
        )
        if variant == "post_norm":
            u = gb.n("Add", [gb.n("Mul", [h, gb.n("Add", [sc_a, one_f])]), sh_a])
        elif variant == "mod_before_norm":
            u = gb.n("Add", [gb.n("Mul", [h, gb.n("Add", [sc_a, one_f])]), sh_a])
            u = _ln(gb, u, norm1_w)
        else:
            u = norm(gb, h, norm1_w)
            u = gb.n("Add", [gb.n("Mul", [u, gb.n("Add", [sc_a, one_f])]), sh_a])
        if variant == "torch_decomposed":
            q = lin(u, f"{pre}.attn.q", blk["qkv_w"][:d], blk["qkv_b"][:d])
            k = lin(u, f"{pre}.attn.k", blk["qkv_w"][d:2 * d], blk["qkv_b"][d:2 * d])
            v = lin(u, f"{pre}.attn.v", blk["qkv_w"][2 * d:], blk["qkv_b"][2 * d:])
        else:
            qkv = lin(u, f"{pre}.attn.qkv", blk["qkv_w"], blk["qkv_b"])
            q, k, v = gb.n("Split", [qkv], n_out=3, axis=1, hint="qkv_split")
        q, k, v = heads_split(q), heads_split(k), heads_split(v)
        q, k = rope(q), rope(k)
        if variant == "scale_on_q":
            q = gb.n("Mul", [q, scale], hint="q_scaled")
            logits = gb.n(
                "MatMul", [q, gb.n("Transpose", [k], perm=[0, 2, 1])],
                hint="logits",
            )
        else:
            logits = gb.n(
                "Mul",
                [gb.n("MatMul", [q, gb.n("Transpose", [k], perm=[0, 2, 1])]), scale],
                hint="logits",
            )
        attnw = gb.n("Softmax", [logits], axis=-1)
        av = gb.n("MatMul", [attnw, v])  # [H, N, hd]
        av = gb.n("Reshape", [gb.n("Transpose", [av], perm=[1, 0, 2]), merge_shape])
        attn = lin(av, f"{pre}.attn.out", blk["out_w"], blk["out_b"])
        if variant == "no_gate":
            h = gb.n("Add", [h, attn])
        else:
            h = gb.n("Add", [h, gb.n("Mul", [g_a, attn])])
        if variant == "post_norm":
            h = _ln(gb, h, norm1_w)

        norm2_w = gb.init(f"{pre}.norm2.weight", np.ones((d,), np.float32))
        if variant == "post_norm":
            u = gb.n("Add", [gb.n("Mul", [h, gb.n("Add", [sc_f, one_f])]), sh_f])
        elif variant == "mod_before_norm":
            u = gb.n("Add", [gb.n("Mul", [h, gb.n("Add", [sc_f, one_f])]), sh_f])
            u = _ln(gb, u, norm2_w)
        else:
            u = norm(gb, h, norm2_w)
            u = gb.n("Add", [gb.n("Mul", [u, gb.n("Add", [sc_f, one_f])]), sh_f])
        act = _gelu_erf if variant == "torch_decomposed" else _gelu
        f = act(gb, lin(u, f"{pre}.ff.0", blk["ff1_w"], blk["ff1_b"]))
        f = lin(f, f"{pre}.ff.2", blk["ff2_w"], blk["ff2_b"])
        if variant == "no_gate":
            h = gb.n("Add", [h, f])
        else:
            h = gb.n("Add", [h, gb.n("Mul", [g_f, f])])
        if variant == "post_norm":
            h = _ln(gb, h, norm2_w)

    fmod = _linear(gb, t_emb, "final_ada", exp["final_ada_w"], exp["final_ada_b"])
    f_sh, f_sc = gb.n("Split", [fmod], n_out=2, axis=1, hint="fmod_split")
    h = _ln(gb, h, ones_d)
    h = gb.n("Add", [gb.n("Mul", [h, gb.n("Add", [f_sc, one_f])]), f_sh])
    return _linear(gb, h, "final_proj", exp["final_proj_w"], exp["final_proj_b"])


def build_transformer(spec: FixtureSpec, params: dict,
                      variant: str = "f5") -> bytes:
    """One CFG+Euler denoise step; looped by the caller exactly like the
    reference (``core/tts_engine.py:148-174``).

    ``variant`` (see ``_dit_branch``) additionally supports ``"no_cfg"``
    (the output is plain v_cond — no classifier-free guidance
    combination), for topology-verifier detection tests."""
    gb = _GB()
    exp = _export_dit(params)
    nm, hd, td = spec.n_mels, spec.head_dim, spec.text_dim

    # Sway time grid (models/sampler.py:sway_time_grid), embedded as tables.
    t = np.linspace(0.0, 1.0, spec.nfe_step, dtype=np.float32)
    s = spec.sway_sampling_coef
    if s:
        t = t + s * (np.cos(np.pi / 2.0 * t) - 1.0 + t)
    starts, dts = t[:-1], np.diff(t)
    # variant="clamped_schedule" (benign): the gather index is clipped into
    # range instead of erroring past the table — some exports spell the
    # final-step guard this way; the topology verifier's grid extraction
    # must truncate the resulting trailing stall, not flag a mismatch.
    step_idx = "time_step"
    if variant == "clamped_schedule":
        step_idx = gb.n(
            "Clip",
            ["time_step", gb.c(np.array(0, np.int32), "idx_lo"),
             gb.c(np.array(len(starts) - 1, np.int32), "idx_hi")],
            hint="step_clamped",
        )
    t_cur = gb.n("Gather", [gb.init("sway.t", starts), step_idx], axis=0, hint="t_cur")
    dt = gb.n("Gather", [gb.init("sway.dt", dts), step_idx], axis=0, hint="dt")

    # Time embedding (models/dit.py:_time_embedding + the sampler's SiLU).
    half = spec.time_freq_dim // 2
    freqs1000 = (np.exp(-np.log(10000.0) * np.arange(half) / half) * 1000.0).astype(np.float32)
    args = gb.n(
        "Mul",
        [gb.n("Unsqueeze", [t_cur], axes=[1]), gb.init("time.freqs", freqs1000)],
        hint="targs",
    )  # [1, half]
    feats = gb.n("Concat", [gb.n("Cos", [args]), gb.n("Sin", [args])], axis=1)
    te = _silu(gb, _linear(gb, feats, "time_embed.mlp.0", exp["time_mlp1_w"], exp["time_mlp1_b"]))
    te = _linear(gb, te, "time_embed.mlp.2", exp["time_mlp2_w"], exp["time_mlp2_b"])
    t_emb = _silu(gb, te)  # [1, dim]

    x2d = gb.n("Squeeze", ["noise"], axes=[0], hint="x2d")
    cat = gb.n("Squeeze", ["cat_mel_text"], axes=[0], hint="cat2d")
    cat_drop = gb.n("Squeeze", ["cat_mel_text_drop"], axes=[0], hint="drop2d")
    gb.out("Squeeze", ["rope_cos_q"], "rope_cos_2d", axes=[0])
    gb.out("Squeeze", ["rope_sin_q"], "rope_sin_2d", axes=[0])

    branch_variant = "f5" if variant == "no_cfg" else variant
    v_cond = _dit_branch(gb, spec, exp, x2d, cat, t_emb, branch_variant)
    if variant == "no_cfg":
        v = v_cond
    else:
        v_uncond = _dit_branch(gb, spec, exp, x2d, cat_drop, t_emb, branch_variant)
        v = gb.n(
            "Add",
            [
                v_cond,
                gb.n(
                    "Mul",
                    [gb.c(np.float32(spec.cfg_strength), "cfg"), gb.n("Sub", [v_cond, v_uncond])],
                ),
            ],
            hint="v_cfg",
        )
    x_next = gb.n("Add", [x2d, gb.n("Mul", [dt, v])], hint="x_next")
    gb.out("Unsqueeze", [x_next], "noise_out", axes=[0])
    gb.out("Add", ["time_step", gb.c(np.int32(1))], "time_step_out")

    graph = ox.make_graph(
        "transformer",
        gb.nodes,
        gb.inits,
        inputs=[
            ox.make_value_info("noise", F32, [1, "N", nm]),
            ox.make_value_info("rope_cos_q", F32, [1, "N", hd]),
            ox.make_value_info("rope_sin_q", F32, [1, "N", hd]),
            ox.make_value_info("rope_cos_k", F32, [1, "N", hd]),
            ox.make_value_info("rope_sin_k", F32, [1, "N", hd]),
            ox.make_value_info("cat_mel_text", F32, [1, "N", nm + td]),
            ox.make_value_info("cat_mel_text_drop", F32, [1, "N", nm + td]),
            ox.make_value_info("time_step", I32, [1]),
        ],
        outputs=[
            ox.make_value_info("noise_out", F32, [1, "N", nm]),
            ox.make_value_info("time_step_out", I32, [1]),
        ],
    )
    return ox.make_model(graph)


def build_decode(spec: FixtureSpec, params: dict) -> bytes:
    """Vocos-style decode (models/vocoder.py): trim the reference prefix,
    ConvNeXt trunk, log-mag/phase head, iSTFT via ConvTranspose overlap-add,
    int16 PCM out — the reference decode contract (noise, ref_signal_len) →
    waveform."""
    from .vocoder import LOG_MAG_CLIP, _hann_periodic, _idft_basis

    gb = _GB()
    voc = params["vocoder"]
    d, nm, n_fft, hop = spec.voc_dim, spec.n_mels, spec.n_fft, spec.hop_length

    big = gb.c(np.array([2**31 - 1], np.int64), "int_max")
    ax1 = gb.c(np.array([1], np.int64), "axis1")
    latent = gb.n("Slice", ["noise", "ref_signal_len", big, ax1], hint="trimmed")

    # Embed conv: torch weight [d, n_mels, 7]; ours is [7, n_mels, d].
    w_embed = np.transpose(voc["embed"]["w"], (2, 1, 0))
    h = gb.n("Transpose", [latent], perm=[0, 2, 1])  # [1, nm, N']
    h = gb.n(
        "Conv",
        [h, gb.init("backbone.embed.weight", w_embed), gb.init("backbone.embed.bias", voc["embed"]["b"])],
        pads=[3, 3],
        strides=[1],
    )
    h = gb.n("Squeeze", [gb.n("Transpose", [h], perm=[0, 2, 1])], axes=[0])  # [N', d]
    h = _ln(
        gb,
        h,
        gb.init("backbone.norm_in.weight", voc["norm_in_scale"]),
        gb.init("backbone.norm_in.bias", voc["norm_in_bias"]),
    )

    bl = voc["blocks"]
    for i in range(bl["pw1"]["w"].shape[0]):
        pre = f"backbone.blocks.{i}"
        x = _dwconv2d(
            gb,
            h,
            f"{pre}.dwconv",
            np.transpose(bl["dwconv"]["w"][i], (2, 1, 0)),
            bl["dwconv"]["b"][i],
        )
        x = _ln(
            gb,
            x,
            gb.init(f"{pre}.norm.weight", bl["norm_scale"][i]),
            gb.init(f"{pre}.norm.bias", bl["norm_bias"][i]),
        )
        x = _gelu(gb, _linear(gb, x, f"{pre}.pw1", bl["pw1"]["w"][i].T, bl["pw1"]["b"][i]))
        x = _linear(gb, x, f"{pre}.pw2", bl["pw2"]["w"][i].T, bl["pw2"]["b"][i])
        h = gb.n("Add", [h, gb.n("Mul", [gb.init(f"{pre}.gamma", bl["gamma"][i]), x])])

    h = _ln(
        gb,
        h,
        gb.init("backbone.norm_out.weight", voc["norm_out_scale"]),
        gb.init("backbone.norm_out.bias", voc["norm_out_bias"]),
    )
    head = _linear(gb, h, "head", voc["head"]["w"].T, voc["head"]["b"])  # [N', 2F]
    log_mag, phase = gb.n("Split", [head], n_out=2, axis=1, hint="head_split")
    mag = gb.n(
        "Exp",
        [gb.n("Clip", [log_mag, gb.c(np.float32(-LOG_MAG_CLIP)), gb.c(np.float32(LOG_MAG_CLIP))])],
        hint="mag",
    )
    real = gb.n("Mul", [mag, gb.n("Cos", [phase])])
    imag = gb.n("Mul", [mag, gb.n("Sin", [phase])])

    cos_b, sin_b = _idft_basis(n_fft)  # [F, n_fft]
    frames = gb.n(
        "Add",
        [
            gb.n("MatMul", [real, gb.init("istft.cos_basis", cos_b)]),
            gb.n("MatMul", [imag, gb.init("istft.sin_basis", sin_b)]),
        ],
        hint="frames",
    )
    win = _hann_periodic(n_fft)
    frames = gb.n("Mul", [frames, gb.init("istft.window", win)], hint="frames_win")

    # Overlap-add as ConvTranspose (identity kernel, stride = hop).
    ola_w = np.zeros((n_fft, 1, n_fft), np.float32)
    ola_w[np.arange(n_fft), 0, np.arange(n_fft)] = 1.0
    f3 = gb.n("Unsqueeze", [gb.n("Transpose", [frames], perm=[1, 0])], axes=[0])
    buf = gb.n(
        "ConvTranspose",
        [f3, gb.init("istft.ola.weight", ola_w)],
        strides=[hop],
        hint="ola",
    )  # [1, 1, (N'-1)*hop + n_fft]

    np_shape = gb.n("Shape", [latent])
    n_prime = gb.n("Slice", [np_shape, ax1, gb.c(np.array([2], np.int64))], hint="n_prime")
    ones_shape = gb.n("Concat", [gb.c(np.array([1, 1], np.int64)), n_prime], axis=0)
    # ConstantOfShape defaults to f32 zeros; +1 gives the ones the window-
    # energy envelope needs (tensor-valued attrs stay out of the DSL).
    ones = gb.n(
        "Add",
        [gb.n("ConstantOfShape", [ones_shape], hint="zeros"), gb.c(np.float32(1.0))],
        hint="ones",
    )
    env_w = (win.astype(np.float64) ** 2).astype(np.float32)[None, None, :]
    env = gb.n(
        "ConvTranspose",
        [ones, gb.init("istft.env.weight", env_w)],
        strides=[hop],
        hint="env",
    )
    wav = gb.n("Div", [buf, gb.n("Max", [env, gb.c(np.float32(1e-8))])], hint="wav_norm")

    pad = n_fft // 2
    out_len = gb.n(
        "Add",
        [gb.n("Mul", [n_prime, gb.c(np.array([hop], np.int64))]), gb.c(np.array([pad], np.int64))],
        hint="out_end",
    )
    wav = gb.n(
        "Slice",
        [wav, gb.c(np.array([pad], np.int64)), out_len, gb.c(np.array([2], np.int64))],
        hint="wav_trim",
    )
    wav = gb.n("Squeeze", [wav], axes=[1])  # [1, T']
    pcm = gb.n(
        "Mul",
        [gb.n("Clip", [wav, gb.c(np.float32(-1.0)), gb.c(np.float32(1.0))]), gb.c(np.float32(32767.0))],
    )
    gb.out("Cast", [pcm], "waveform", to=I16)

    graph = ox.make_graph(
        "decode",
        gb.nodes,
        gb.inits,
        inputs=[
            ox.make_value_info("noise", F32, [1, "N", nm]),
            ox.make_value_info("ref_signal_len", I64, [1]),
        ],
        outputs=[ox.make_value_info("waveform", I16, [1, "T"])],
    )
    return ox.make_model(graph)


# ---------------------------------------------------------------------------
# Name map + tarball assembly
# ---------------------------------------------------------------------------


def build_name_map(spec: FixtureSpec) -> Dict[str, object]:
    """Starter name map: every parameter leaf pinned to its export name.

    Committed as ``models/f5_name_map.json`` so conversion day starts from a
    complete map instead of heuristics; keys are our pytree paths, values
    carry explicit transpose/perm where torch layouts differ from ours."""
    P = {"perm": [2, 1, 0]}
    T = {"transpose": True}
    nm: Dict[str, object] = {
        "dit.text_embed.table": "preprocess.text_embed.weight",
        "dit.time_embed.mlp1.w": {"name": "transformer.time_embed.mlp.0.weight", **T},
        "dit.time_embed.mlp1.b": "transformer.time_embed.mlp.0.bias",
        "dit.time_embed.mlp2.w": {"name": "transformer.time_embed.mlp.2.weight", **T},
        "dit.time_embed.mlp2.b": "transformer.time_embed.mlp.2.bias",
        "dit.input_proj.w": {"name": "transformer.input_proj.weight", **T},
        "dit.input_proj.b": "transformer.input_proj.bias",
        "dit.conv_pos.0.w": {"name": "transformer.conv_pos.dwconv.weight", **P},
        "dit.conv_pos.0.b": "transformer.conv_pos.dwconv.bias",
        "dit.conv_pos.1.w": {"name": "transformer.conv_pos.proj.weight", **T},
        "dit.conv_pos.1.b": "transformer.conv_pos.proj.bias",
        "dit.final_ada.w": {"name": "transformer.final_ada.weight", **T},
        "dit.final_ada.b": "transformer.final_ada.bias",
        "dit.final_proj.w": {"name": "transformer.final_proj.weight", **T},
        "dit.final_proj.b": "transformer.final_proj.bias",
        "vocoder.embed.w": {"name": "decode.backbone.embed.weight", **P},
        "vocoder.embed.b": "decode.backbone.embed.bias",
        "vocoder.norm_in_scale": "decode.backbone.norm_in.weight",
        "vocoder.norm_in_bias": "decode.backbone.norm_in.bias",
        "vocoder.norm_out_scale": "decode.backbone.norm_out.weight",
        "vocoder.norm_out_bias": "decode.backbone.norm_out.bias",
        "vocoder.head.w": {"name": "decode.head.weight", **T},
        "vocoder.head.b": "decode.head.bias",
    }
    for i in range(spec.text_conv_layers):
        p = f"dit.text_embed.blocks.{i}"
        s = f"preprocess.text_blocks.{i}"
        nm[f"{p}.dwconv.w"] = {"name": f"{s}.dwconv.weight", **P}
        nm[f"{p}.dwconv.b"] = f"{s}.dwconv.bias"
        nm[f"{p}.pw1.w"] = {"name": f"{s}.pw1.weight", **T}
        nm[f"{p}.pw1.b"] = f"{s}.pw1.bias"
        nm[f"{p}.pw2.w"] = {"name": f"{s}.pw2.weight", **T}
        nm[f"{p}.pw2.b"] = f"{s}.pw2.bias"

    def stack(leaf: str, export: str, spec_extra: dict | None = None):
        nm[f"dit.blocks.{leaf}"] = [
            ({"name": f"transformer.blocks.{i}.{export}", **spec_extra} if spec_extra
             else f"transformer.blocks.{i}.{export}")
            for i in range(spec.depth)
        ]

    stack("ada.w", "ada.weight", T)
    stack("ada.b", "ada.bias")
    stack("qkv.w", "attn.qkv.weight", T)
    stack("qkv.b", "attn.qkv.bias")
    stack("attn_out.w", "attn.out.weight", T)
    stack("attn_out.b", "attn.out.bias")
    stack("ff1.w", "ff.0.weight", T)
    stack("ff1.b", "ff.0.bias")
    stack("ff2.w", "ff.2.weight", T)
    stack("ff2.b", "ff.2.bias")

    def vstack(leaf: str, export: str, spec_extra: dict | None = None):
        nm[f"vocoder.blocks.{leaf}"] = [
            ({"name": f"decode.backbone.blocks.{i}.{export}", **spec_extra} if spec_extra
             else f"decode.backbone.blocks.{i}.{export}")
            for i in range(spec.voc_layers)
        ]

    vstack("dwconv.w", "dwconv.weight", P)
    vstack("dwconv.b", "dwconv.bias")
    vstack("norm_scale", "norm.weight")
    vstack("norm_bias", "norm.bias")
    vstack("pw1.w", "pw1.weight", T)
    vstack("pw1.b", "pw1.bias")
    vstack("pw2.w", "pw2.weight", T)
    vstack("pw2.b", "pw2.bias")
    vstack("gamma", "gamma")
    return nm


def write_fixture_tarball(
    out_path, spec: FixtureSpec, seed: int = 0, ref_seconds: float = 2.0,
    ref_text: str = "xin chào các bạn.",
):
    """Assemble the F5-export-shaped ``model-bin.pt`` fixture.

    Returns (tar_path, name_map, params) — ``params`` is the ground-truth
    pytree the graphs were exported from, so tests can assert the conversion
    reproduces it bit-exactly."""
    import io

    from ..runtime.session import default_vocab_chars
    from ..utils.wavio import wav_bytes

    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    params = make_params(spec, seed)

    chars = default_vocab_chars()[: spec.vocab_size]
    if len(chars) < spec.vocab_size:
        chars = chars + [chr(0x100 + i) for i in range(spec.vocab_size - len(chars))]
    vocab_txt = ("\n".join(chars) + "\n").encode("utf-8")

    rng = np.random.default_rng(seed + 1)
    t = np.arange(int(ref_seconds * spec.sample_rate)) / spec.sample_rate
    clip = np.sin(2 * np.pi * 160.0 * t) * 0.5 + 0.1 * rng.standard_normal(t.shape)
    clip = (np.clip(clip, -1, 1) * 20000).astype(np.int16)
    wav_data = wav_bytes(clip, spec.sample_rate)

    metadata = [
        {
            "file_name": "ref.wav",
            "text": ref_text,
            "gender": "female",
            "group": "news",
            "area": "northern",
            "emotion": "neutral",
        }
    ]

    def add_bytes(tar: tarfile.TarFile, name: str, data: bytes) -> None:
        info = tarfile.TarInfo(name)
        info.size = len(data)
        tar.addfile(info, io.BytesIO(data))

    with tarfile.open(out_path, "w") as tar:
        add_bytes(tar, "preprocess.onnx", build_preprocess(spec, params))
        add_bytes(tar, "transformer.onnx", build_transformer(spec, params))
        add_bytes(tar, "decode.onnx", build_decode(spec, params))
        add_bytes(tar, "vocab.txt", vocab_txt)
        add_bytes(tar, "audio_metadata.json", json.dumps(metadata).encode())
        add_bytes(tar, "cleaned_audios/ref.wav", wav_data)
    return out_path, build_name_map(spec), params


if __name__ == "__main__":  # pragma: no cover — thin CLI
    import sys

    dest = sys.argv[1] if len(sys.argv) > 1 else "f5_fixture.pt"
    path, name_map, _ = write_fixture_tarball(dest, FixtureSpec())
    map_path = Path(dest).with_suffix(".name_map.json")
    map_path.write_text(json.dumps(name_map, indent=1))
    print(f"wrote {path} and {map_path}")
