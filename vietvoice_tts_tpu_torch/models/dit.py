"""Flow-matching DiT denoiser (port of ``vietvoice_tts_tpu/models/dit.py``).

Same network and numerics as the JAX module, written as an ``nn.Module``:

- AdaLN-Zero conditioning from the flow time; the per-block modulations
  depend only on t, so the sampler computes them for the whole time grid
  once (:meth:`DiT.time_modulations`) and passes them in.
- Packed QKV ``[q_heads ‖ k_heads ‖ v_heads]`` along the feature dim, and
  two attention routes, picked once per forward from (heads, head_dim), as
  the JAX module picks them: where the fused RoPE-attention kernel's
  ``supports_shape`` holds (head_dim 64 or a multiple of 128 up to 1024,
  where JAX's fused kernel runs) the packed projection goes to its wrapper
  (``ops/kernels/fused_rope_attention.py``); any other head shape takes the
  split-heads route of ``vietvoice_tts_tpu/models/dit.py:415-423``: split
  into ``[B, H, N, D]``, ``apply_rope`` on q and k in plain ops, then
  ``ops/attention.py:attention``, whose kernel is ``flash_attention``
  (head_dim a multiple of 8 up to 1024: 32, 48, 72, 96, 192, 320, ...).
  With ``use_kernels`` each wrapper launches its CUDA kernel on CUDA
  tensors or raises (a head_dim neither kernel takes — not a multiple of 8,
  or above 1024 — is never served by a plain version on the card); without
  it, and for CPU tensors, the plain versions run.
- The sampler's deep-block cache (``shallow_blocks`` / ``deep_state`` /
  ``return_deep_state`` of :meth:`DiT.forward_embedded`).
- The residual stream and matmuls are in ``compute_dtype``; LayerNorm
  statistics, modulation math, the time embedding, the text embedding's
  residual stream and the final projection are float32.
- Text and mel share the sequence axis (F5-style): character IDs padded with
  -1 to the frame bucket are embedded through a small ConvNeXt stack.
- Tensor parallelism (``DiTConfig.model_group``): the module holds this
  rank's shard (``parallel/sharding.py``): ``heads/tp`` heads of the packed
  qkv, ``1/tp`` of the FFN and text-block widths. Each column→row pair ends
  in one all-reduce (after ``attn_out``, ``ff2`` and the text blocks'
  ``pw2``); the row-parallel bias is added once, after it, and the AdaLN
  gate multiplies the sum. Megatron's f and g (``parallel/comm.py``) make
  it trainable. The attention kernels run on the local heads.
- Sequence parallelism (``DiTConfig.seq_group``): the forward takes the
  whole ``x`` (the sampler is unchanged), runs the residual stream on this
  rank's ``N/sp`` frames, attends through ``parallel/sequence.py``, and
  all-gathers the ``[B, N, n_mels]`` velocity. The conv position
  embedding needs 15 frames on each side of the slice: every rank holds the
  whole input, so it projects its slice with that halo and keeps its rows,
  and no frames are exchanged. The text embedding runs on all N frames on
  every rank, before the slice.

Layouts at the public methods match the JAX functions: activations are
``[B, N, C]``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention
from ..ops.kernels.fused_rope_attention import (
    fused_qkv_rope_attention,
    fused_qkv_rope_attention_reference,
    supports_shape as fused_supports_shape,
)
from ..ops.rope import apply_rope, rope_tables
from ..parallel import comm
from ..parallel.sequence import sp_attention

TIME_FREQ_DIM = 256  # sinusoidal feature width for the flow time
CONV_POS_KERNEL = 31
TEXT_CONV_KERNEL = 7
LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    dim: int = 1024
    depth: int = 22
    heads: int = 8
    ff_mult: int = 2
    n_mels: int = 100
    text_dim: int = 512
    text_conv_layers: int = 4
    vocab_size: int = 256
    compute_dtype: torch.dtype = torch.bfloat16
    norm_dtype: torch.dtype = torch.float32
    use_kernels: bool = False
    # Tensor parallelism: the model-axis process group (parallel/mesh.py)
    # the weights are split over, or None.
    model_group: Any = None
    # Sequence parallelism: the group the frame axis is split over, or None.
    # The weights are whole on every rank; exclusive with model_group.
    seq_group: Any = None

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads

    @property
    def tp(self) -> int:
        """Tensor-parallel size (1 without a model group)."""
        return comm.size(self.model_group)


# ---------------------------------------------------------------------------
# Initialization (numpy; the same RNG draws in the same order as the JAX
# package's init_dit_params, so one seed gives one pack in both packages)
# ---------------------------------------------------------------------------


def _as_rng(seed) -> np.random.Generator:
    if isinstance(seed, np.random.Generator):
        return seed
    return np.random.default_rng(seed)


def _dense(rng: np.random.Generator, fan_in: int, fan_out: int, *lead: int):
    """LeCun-normal weight [*, fan_in, fan_out] + zero bias."""
    std = 1.0 / np.sqrt(fan_in)
    w = rng.normal(0.0, std, (*lead, fan_in, fan_out)).astype(np.float32)
    b = np.zeros((*lead, fan_out), np.float32)
    return {"w": w, "b": b}


def _text_block(rng: np.random.Generator, dim: int) -> dict:
    inter = 2 * dim
    k = TEXT_CONV_KERNEL
    return {
        "dwconv": {
            "w": rng.normal(0.0, 1.0 / np.sqrt(k), (k, 1, dim)).astype(np.float32),
            "b": np.zeros((dim,), np.float32),
        },
        "pw1": _dense(rng, dim, inter),
        "pw2": _dense(rng, inter, dim),
    }


def init_dit_params(seed, cfg: DiTConfig) -> dict:
    """Random-init parameter tree in the JAX package's layout (numpy float32
    leaves; ``models/params.py`` turns it into module weights)."""
    rng = _as_rng(seed)
    d, depth = cfg.dim, cfg.depth
    # AdaLN-Zero: modulation projections start at exactly zero.
    ada = {
        "w": np.zeros((depth, d, 6 * d), np.float32),
        "b": np.zeros((depth, 6 * d), np.float32),
    }
    blocks = {
        "ada": ada,
        "qkv": _dense(rng, d, 3 * d, depth),
        "attn_out": _dense(rng, d, d, depth),
        "ff1": _dense(rng, d, cfg.ff_mult * d, depth),
        "ff2": _dense(rng, cfg.ff_mult * d, d, depth),
    }
    k = CONV_POS_KERNEL
    conv_pos: List[dict] = [
        {
            "w": rng.normal(0.0, 1.0 / np.sqrt(k), (k, 1, d)).astype(np.float32),
            "b": np.zeros((d,), np.float32),
        },
        _dense(rng, d, d),
    ]
    return {
        "text_embed": {
            # Row 0 is the filler token (pad id -1 → index 0).
            "table": (
                rng.normal(0.0, 0.02, (cfg.vocab_size + 1, cfg.text_dim))
            ).astype(np.float32),
            "blocks": [_text_block(rng, cfg.text_dim) for _ in range(cfg.text_conv_layers)],
        },
        "time_embed": {
            "mlp1": _dense(rng, TIME_FREQ_DIM, d),
            "mlp2": _dense(rng, d, d),
        },
        "input_proj": _dense(rng, 2 * cfg.n_mels + cfg.text_dim, d),
        "conv_pos": conv_pos,
        "blocks": blocks,
        "final_ada": {
            "w": np.zeros((d, 2 * d), np.float32),
            "b": np.zeros((2 * d,), np.float32),
        },
        "final_proj": _dense(rng, d, cfg.n_mels),
    }


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def dwconv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Depthwise 1-D conv with XLA SAME padding on x [B, N, C].

    weight [C, 1, k], bias [C], both cast to x's dtype. Padding is
    ``lo = (k-1)//2`` before and ``k-1-lo`` after, as XLA pads SAME."""
    k = weight.shape[-1]
    lo = (k - 1) // 2
    xt = F.pad(x.transpose(1, 2), (lo, k - 1 - lo))
    y = F.conv1d(xt, weight.to(x.dtype), bias.to(x.dtype), groups=x.shape[-1])
    return y.transpose(1, 2)


def layernorm(x: torch.Tensor, stats_dtype=torch.float32) -> torch.Tensor:
    """Non-affine LayerNorm, eps 1e-6, statistics in ``stats_dtype``;
    returns float32."""
    xs = x.to(stats_dtype)
    return F.layer_norm(xs, (xs.shape[-1],), eps=LN_EPS).float()


def linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """``x @ W + b`` in x's dtype (weights are stored in the policy dtype)."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


def column_linear(x: torch.Tensor, layer: nn.Linear, group) -> torch.Tensor:
    """A column-parallel layer (this rank's output columns); its input
    passes Megatron's f. Without a group, :func:`linear`."""
    return linear(comm.copy_to_group(x, group), layer)


def _float32_product(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``x @ weightᵀ`` with a float32 result from x's dtype. On the card a
    bfloat16 or float16 product is one tensor-core GEMM with a float32
    output (``torch.mm(..., out_dtype=)``, which has no backward); where
    autograd follows the product, and on the CPU, it is a float32 GEMM of
    the same products, which are exact in float32."""
    w = weight.to(x.dtype)
    tracked = torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)
    if x.is_cuda and x.dtype != torch.float32 and not tracked:
        y = torch.mm(x.reshape(-1, x.shape[-1]), w.t(), out_dtype=torch.float32)
        return y.view(*x.shape[:-1], w.shape[0])
    return F.linear(x.float(), w.float())


def row_linear(x: torch.Tensor, layer: nn.Linear, group) -> torch.Tensor:
    """A row-parallel layer: this rank's partial product, summed over the
    group (Megatron's g), then the replicated bias, added once. Without a
    group, :func:`linear`.

    The partial product and the sum are float32 and the result is rounded
    once to x's dtype, as one matmul's accumulator is. A bfloat16 partial,
    rounded before the sum, rounds every output twice: in a bfloat16 solve
    at small widths on the CPU that put the latent 3.7e-2 max-abs from one
    rank's, against 0 with float32 partials."""
    if group is None:
        return linear(x, layer)
    partial = _float32_product(x, layer.weight)
    return (comm.reduce_from_group(partial, group) + layer.bias.float()).to(x.dtype)


class TextBlock(nn.Module):
    """ConvNeXt-1D residual block on the text embedding."""

    def __init__(self, dim: int, group=None):
        super().__init__()
        self.group = group
        inter = 2 * dim // comm.size(group)
        self.dwconv = nn.Conv1d(dim, dim, TEXT_CONV_KERNEL, groups=dim)
        self.pw1 = nn.Linear(dim, inter)
        self.pw2 = nn.Linear(inter, dim)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """x: [B, N, C] float32 → float32."""
        h = dwconv(x, self.dwconv.weight, self.dwconv.bias)
        h = layernorm(h).to(dtype)
        h = F.gelu(column_linear(h, self.pw1, self.group), approximate="tanh")
        h = row_linear(h, self.pw2, self.group)
        return x + h.float()


class DiTBlock(nn.Module):
    """One transformer block; ``ada`` is applied outside, hoisted. Under
    tensor parallelism it holds this rank's shard of qkv, attn_out, ff1
    and ff2."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        d, tp = cfg.dim, cfg.tp
        self.ada = nn.Linear(d, 6 * d)
        self.qkv = nn.Linear(d, 3 * d // tp)
        self.attn_out = nn.Linear(d // tp, d)
        self.ff1 = nn.Linear(d, cfg.ff_mult * d // tp)
        self.ff2 = nn.Linear(cfg.ff_mult * d // tp, d)


class DiT(nn.Module):
    """Velocity-field network. Build it, then load weights made by
    ``models/params.py:from_jax_tree`` with ``load_state_dict(..., assign=True)``
    (that keeps each weight's policy dtype)."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        if cfg.model_group is not None and cfg.seq_group is not None:
            raise ValueError("the model axis carries either weight shards or frames, not both")
        if cfg.heads % cfg.tp:
            raise ValueError(f"heads {cfg.heads} do not split over tensor-parallel size {cfg.tp}")
        self.cfg = cfg
        d = cfg.dim
        self.text_table = nn.Embedding(cfg.vocab_size + 1, cfg.text_dim)
        self.text_blocks = nn.ModuleList(
            [TextBlock(cfg.text_dim, cfg.model_group) for _ in range(cfg.text_conv_layers)]
        )
        self.time_mlp1 = nn.Linear(TIME_FREQ_DIM, d)
        self.time_mlp2 = nn.Linear(d, d)
        self.input_proj = nn.Linear(2 * cfg.n_mels + cfg.text_dim, d)
        self.conv_pos_dw = nn.Conv1d(d, d, CONV_POS_KERNEL, groups=d)
        self.conv_pos_pw = nn.Linear(d, d)
        self.blocks = nn.ModuleList([DiTBlock(cfg) for _ in range(cfg.depth)])
        self.final_ada = nn.Linear(d, 2 * d)
        self.final_proj = nn.Linear(d, cfg.n_mels)
        self._rope_cache: dict = {}

    # -- Hoisted pieces ----------------------------------------------------

    def text_embed(self, text_ids: torch.Tensor) -> torch.Tensor:
        """Character IDs [B, N] (-1 padded) → text features [B, N, text_dim]
        float32. Independent of x and t: computed once per solve."""
        ids = torch.clamp(text_ids.long() + 1, 0, self.cfg.vocab_size)
        emb = F.embedding(ids, self.text_table.weight).float()
        for blk in self.text_blocks:
            emb = blk(emb, self.cfg.compute_dtype)
        return emb

    def time_embedding(self, t: torch.Tensor) -> torch.Tensor:
        """Sinusoidal features of the flow time → MLP. t [B] → [B, dim] f32."""
        half = TIME_FREQ_DIM // 2
        freqs = torch.exp(
            -math.log(10000.0)
            * torch.arange(half, dtype=torch.float32, device=t.device)
            / half
        )
        args = t.float()[:, None] * freqs[None, :] * 1000.0
        feats = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
        h = F.silu(F.linear(feats, self.time_mlp1.weight.float(), self.time_mlp1.bias.float()))
        return F.linear(h, self.time_mlp2.weight.float(), self.time_mlp2.bias.float())

    def time_modulations(self, t: torch.Tensor):
        """AdaLN modulations for flow times t [S] → (mods [S, depth, 6d],
        fmod [S, 2d]), float32 (weights stored in compute dtype are widened,
        as JAX promotes them in the product)."""
        t_emb = F.silu(self.time_embedding(t))
        mods = torch.stack(
            [
                F.linear(t_emb, blk.ada.weight.float(), blk.ada.bias.float())
                for blk in self.blocks
            ],
            dim=1,
        )
        fmod = F.linear(t_emb, self.final_ada.weight.float(), self.final_ada.bias.float())
        return mods, fmod

    def _rope(self, n: int, device: torch.device):
        key = (n, device)
        if key not in self._rope_cache:
            cos, sin = rope_tables(n, self.cfg.head_dim)
            dtype = self.cfg.compute_dtype
            self._rope_cache[key] = (
                torch.from_numpy(cos).to(device=device, dtype=dtype),
                torch.from_numpy(sin).to(device=device, dtype=dtype),
            )
        return self._rope_cache[key]

    def _frame_slice(self, n: int) -> tuple[int, int]:
        """This rank's frames [lo, hi) of an N-frame forward (all of them
        without sequence parallelism)."""
        group = self.cfg.seq_group
        sp = comm.size(group)
        if n % sp:
            raise ValueError(f"frames {n} not divisible by sequence-parallel size {sp}")
        r = comm.rank(group)
        return r * n // sp, (r + 1) * n // sp

    # -- Forward -----------------------------------------------------------

    def forward(
        self,
        x: torch.Tensor,  # [B, N, n_mels] noisy latent
        cond: torch.Tensor,  # [B, N, n_mels] masked-infill conditioning mel
        text_ids: torch.Tensor,  # [B, N] int, -1 padded
        t: torch.Tensor,  # [B] flow time in [0, 1]
        mask: torch.Tensor,  # [B, N] bool, True = valid frame
    ) -> torch.Tensor:
        """Full forward, text embedding included (the JAX ``dit_forward``):
        the velocity field [B, N, n_mels] float32. The trainer's entry; it
        is differentiable when the attention route is (``use_kernels=False``
        or CPU tensors: the CUDA kernels have no backward and refuse
        inputs that require grad)."""
        return self.forward_embedded(x, cond, self.text_embed(text_ids), t, mask)

    def attention_kernel(self, n: int) -> str | None:
        """The kernel (its ``ops/kernels`` module name) that a forward at
        ``n`` frames launches on CUDA tensors; None without ``use_kernels``."""
        cfg = self.cfg
        if not cfg.use_kernels:
            return None
        fused = fused_supports_shape(cfg.heads // cfg.tp, cfg.head_dim, n)
        return "fused_rope_attention" if fused else "flash_attention"

    def _packed_attention(self, qkv, cos, sin, mask, heads: int) -> torch.Tensor:
        """Attention on packed qkv [B, N, 3·heads·D] → [B, N, heads·D], by
        the route the head shape picks; the wrappers decide between kernel
        and plain version by device."""
        cfg = self.cfg
        b, n, _ = qkv.shape
        hd = cfg.head_dim
        if fused_supports_shape(heads, hd, n):
            fused = (
                fused_qkv_rope_attention if cfg.use_kernels
                else fused_qkv_rope_attention_reference
            )
            return fused(qkv, cos, sin, mask, heads)
        # Views into the packed projection: v reaches the kernel uncopied.
        q, k, v = (
            t.reshape(b, n, heads, hd).transpose(1, 2) for t in qkv.chunk(3, dim=-1)
        )
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        out = attention(q, k, v, mask, use_kernels=cfg.use_kernels)
        return out.transpose(1, 2).reshape(b, n, heads * hd)

    def _attend(self):
        """The attention of this forward: packed qkv of this rank's heads (and
        frames), the whole sequence's rope tables and mask → [B, N, H·D]."""
        cfg = self.cfg
        heads = cfg.heads // cfg.tp
        if cfg.seq_group is None:
            return lambda qkv, cos, sin, mask: self._packed_attention(qkv, cos, sin, mask, heads)

        def sequence_parallel(qkv, cos, sin, mask):
            b, nl, _ = qkv.shape
            q, k, v = (t.reshape(b, nl, heads, -1) for t in qkv.chunk(3, dim=-1))
            out = sp_attention(q, k, v, cos, sin, mask, cfg.seq_group, self._packed_attention)
            return out.reshape(b, nl, -1)

        return sequence_parallel

    def forward_embedded(
        self,
        x: torch.Tensor,  # [B, N, n_mels] noisy latent
        cond: torch.Tensor,  # [B, N, n_mels] masked-infill conditioning mel
        text_emb: torch.Tensor,  # [B, N, text_dim] from text_embed
        t: torch.Tensor,  # [B] flow time in [0, 1]
        mask: torch.Tensor,  # [B, N] bool, True = valid frame
        time_mod=None,  # optional (mods [depth, B', 6d], fmod [B', 2d])
        shallow_blocks: int | None = None,
        deep_state: torch.Tensor | None = None,
        return_deep_state: bool = False,
    ):
        """Predict the flow velocity field [B, N, n_mels] float32; masked
        frames return exactly 0. ``time_mod`` carries modulations hoisted by
        the sampler (B' = 1 broadcasts); when None they come from ``t``.

        Deep-block caching (opt-in via the sampler): with ``shallow_blocks=j``,
        ``return_deep_state=True`` runs all blocks and also returns the deep
        trunk's residual contribution ``h_L − h_j`` as ``(out, state)``;
        ``deep_state=state`` runs only blocks ``0..j`` on the fresh input and
        adds the cached contribution (``h ≈ h_j + state``), skipping
        ``depth − j`` blocks."""
        cfg = self.cfg
        dtype = cfg.compute_dtype
        tp_group = cfg.model_group
        b, n, _ = x.shape
        mask_f = mask[..., None].float()

        # Zero padding frames on the way in so convs can't leak garbage inward.
        h_in = torch.cat(
            [x.float() * mask_f, cond.float() * mask_f, text_emb * mask_f], dim=-1
        ).to(dtype)
        lo, hi = self._frame_slice(n)
        if (lo, hi) != (0, n):
            # Sequence parallelism: this rank's frames, projected with the
            # halo the position conv reads on each side (zero-padded only
            # at the sequence's own ends, as without the split).
            halo = CONV_POS_KERNEL // 2
            a, z = max(0, lo - halo), min(n, hi + halo)
            h_in, mask_f = h_in[:, a:z], mask_f[:, a:z]
        h = linear(h_in, self.input_proj)  # [B, N, dim] compute dtype

        # Convolutional position embedding (depthwise → Mish → pointwise).
        pos = F.mish(dwconv(h, self.conv_pos_dw.weight, self.conv_pos_dw.bias))
        h = (h + linear(pos, self.conv_pos_pw)) * mask_f.to(dtype)
        if (lo, hi) != (0, n):
            h = h[:, lo - a : hi - a]

        if time_mod is None:
            mods, fmod = self.time_modulations(t)
            mods = mods.transpose(0, 1)  # [depth, B, 6d]
        else:
            mods, fmod = time_mod

        cos, sin = self._rope(n, x.device)
        attend = self._attend()

        def modulated_norm(h, sc, sh):
            # sc/sh: [B', dim] f32; B' = 1 broadcasts over the batch.
            return (
                layernorm(h, cfg.norm_dtype) * (1.0 + sc[:, None]) + sh[:, None]
            ).to(dtype)

        def run_blocks(h, start, stop):
            for i in range(start, stop):
                blk = self.blocks[i]
                sh_a, sc_a, g_a, sh_f, sc_f, g_f = mods[i].chunk(6, dim=-1)
                u = modulated_norm(h, sc_a, sh_a)
                qkv = column_linear(u, blk.qkv, tp_group)
                attn = attend(qkv, cos, sin, mask)
                attn = row_linear(attn, blk.attn_out, tp_group)
                h = h + g_a[:, None].to(dtype) * attn

                u = modulated_norm(h, sc_f, sh_f)
                f = F.gelu(column_linear(u, blk.ff1, tp_group), approximate="tanh")
                f = row_linear(f, blk.ff2, tp_group)
                h = h + g_f[:, None].to(dtype) * f
            return h

        deep_out = None
        if shallow_blocks is None:
            h = run_blocks(h, 0, cfg.depth)
        else:
            # The blocks are a ModuleList, so the split is a slice of it; the
            # JAX function's ``presplit_blocks`` (weights pre-sliced outside
            # a scan, so XLA does not re-slice them every step) has no
            # counterpart here.
            j = int(shallow_blocks)
            if not 1 <= j < cfg.depth:
                raise ValueError(f"shallow_blocks={j} must be in [1, depth={cfg.depth})")
            h = run_blocks(h, 0, j)
            if deep_state is not None:
                h = h + deep_state.to(h.dtype)
            else:
                h_deep = run_blocks(h, j, cfg.depth)
                deep_out = h_deep - h
                h = h_deep

        sh, sc = fmod.chunk(2, dim=-1)
        h = layernorm(h) * (1.0 + sc[:, None]) + sh[:, None]
        out = F.linear(h, self.final_proj.weight.float(), self.final_proj.bias.float())
        out = comm.all_gather(out, cfg.seq_group, dim=1)
        out = torch.where(mask[..., None], out, torch.zeros((), device=out.device))
        if return_deep_state:
            return out, deep_out
        return out
