"""Vocos-style neural vocoder (port of ``vietvoice_tts_tpu/models/vocoder.py``).

ConvNeXt-1D trunk (depthwise conv, affine LayerNorm, pointwise matmuls in
the compute dtype, LayerScale residual), then an iSTFT head: a linear layer
predicts per-frame log-magnitude and phase, the inverse real DFT is one
basis matmul, and ``n_fft/hop`` strided overlap-adds rebuild the waveform.
Batched ``[B, N, …]``; the output is a ``[B, N·hop]`` float32 waveform.

Under tensor parallelism (``VocoderConfig.model_group``) each block holds
this rank's ``1/tp`` of the intermediate width: ``pw1`` is column-parallel,
``pw2`` row-parallel with one all-reduce, its bias added once after it and
LayerScale's ``gamma`` after that. The head stays whole on every rank.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import comm
from .dit import _as_rng, _dense, column_linear, dwconv, row_linear

DW_KERNEL = 7
LAYERSCALE_INIT = 1e-6
LOG_MAG_CLIP = 10.0  # e**10 ≈ 22000 — safety clip before exp
LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class VocoderConfig:
    dim: int = 512
    intermediate_dim: int = 1536
    num_layers: int = 8
    n_mels: int = 100
    n_fft: int = 1024
    hop_length: int = 256
    compute_dtype: torch.dtype = torch.float32
    # Tensor parallelism: the model-axis process group, or None.
    model_group: Any = None

    @property
    def n_freqs(self) -> int:
        return self.n_fft // 2 + 1


def init_vocoder_params(seed, cfg: VocoderConfig) -> dict:
    """Random-init tree in the JAX package's layout (numpy float32), drawn in
    the same order as its ``init_vocoder_params``."""
    rng = _as_rng(seed)
    d, inter, L, k = cfg.dim, cfg.intermediate_dim, cfg.num_layers, DW_KERNEL
    return {
        "embed": {
            # Conv1d(n_mels → dim, kernel 7) input embedding.
            "w": rng.normal(0.0, 1.0 / np.sqrt(k * cfg.n_mels), (k, cfg.n_mels, d)).astype(
                np.float32
            ),
            "b": np.zeros((d,), np.float32),
        },
        "norm_in_scale": np.ones((d,), np.float32),
        "norm_in_bias": np.zeros((d,), np.float32),
        "blocks": {
            "dwconv": {
                "w": rng.normal(0.0, 1.0 / np.sqrt(k), (L, k, 1, d)).astype(np.float32),
                "b": np.zeros((L, d), np.float32),
            },
            "pw1": _dense(rng, d, inter, L),
            "pw2": _dense(rng, inter, d, L),
            "gamma": np.full((L, d), LAYERSCALE_INIT, np.float32),
            "norm_scale": np.ones((L, d), np.float32),
            "norm_bias": np.zeros((L, d), np.float32),
        },
        "norm_out_scale": np.ones((d,), np.float32),
        "norm_out_bias": np.zeros((d,), np.float32),
        "head": _dense(rng, d, 2 * cfg.n_freqs),
    }


# ---------------------------------------------------------------------------
# iSTFT via iDFT matmul + strided overlap-add
# ---------------------------------------------------------------------------


@lru_cache(maxsize=8)
def _idft_basis(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Real/imag inverse-rDFT bases, each [n_freqs, n_fft] float32.

    frame[t] = Σ_k w_k/n_fft · (Re_k·cos(2πkt/n) − Im_k·sin(2πkt/n)),
    w_k = 1 at DC and Nyquist, 2 elsewhere (conjugate-symmetric doubling).
    """
    n_freqs = n_fft // 2 + 1
    k = np.arange(n_freqs)[:, None]
    t = np.arange(n_fft)[None, :]
    ang = 2.0 * np.pi * k * t / n_fft
    w = np.full((n_freqs, 1), 2.0)
    w[0] = 1.0
    w[-1] = 1.0
    cos_b = (w * np.cos(ang) / n_fft).astype(np.float32)
    sin_b = (-w * np.sin(ang) / n_fft).astype(np.float32)
    return cos_b, sin_b


@lru_cache(maxsize=8)
def _hann_periodic(n_fft: int) -> np.ndarray:
    return np.hanning(n_fft + 1)[:-1].astype(np.float32)


@lru_cache(maxsize=32)
def _ola_envelope(n: int, n_fft: int, hop: int) -> np.ndarray:
    """Overlapped squared-window envelope [(n + r - 1)·hop], floored at 1e-8."""
    r = n_fft // hop
    env = np.zeros(((n + r - 1) * hop,), np.float64)
    win = _hann_periodic(n_fft).astype(np.float64)
    for j in range(r):
        env[j * hop : j * hop + n * hop] += np.tile(win[j * hop : (j + 1) * hop] ** 2, n)
    return np.maximum(env, 1e-8).astype(np.float32)


def _on_device(arrays, device: torch.device):
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(a).to(device) for a in arrays)


# The iSTFT's constants on the device, cached: copied from pageable host
# memory on every call, each copy would first wait for the device to drain
# its stream, and a batch could not be queued behind one that is still
# running. Never evicted: a CUDA graph captured over the vocoder reads them
# by address.


@lru_cache(maxsize=None)
def _idft_constants(n_fft: int, device: torch.device):
    """(cos basis, sin basis, synthesis window) on ``device``."""
    return _on_device((*_idft_basis(n_fft), _hann_periodic(n_fft)), device)


@lru_cache(maxsize=None)
def _ola_envelope_on(n: int, n_fft: int, hop: int, device: torch.device):
    return _on_device((_ola_envelope(n, n_fft, hop),), device)[0]


def istft_overlap_add(
    real: torch.Tensor,  # [B, N, n_freqs]
    imag: torch.Tensor,  # [B, N, n_freqs]
    n_fft: int,
    hop: int,
) -> torch.Tensor:
    """Inverse STFT (centred, periodic Hann, NOLA-normalized) → [B, N·hop].

    Matches the front-end's convention (``ops/stft.py``): reflect-padded by
    n_fft/2 and windowed on analysis; synthesis windows again and divides by
    the overlapped window-energy envelope."""
    if n_fft % hop != 0:
        raise ValueError(f"n_fft {n_fft} must be a multiple of hop {hop}")
    b, n, _ = real.shape
    dev = real.device
    cos_b, sin_b, win = _idft_constants(n_fft, dev)
    frames = (real @ cos_b + imag @ sin_b) * win  # [B, N, n_fft]

    r = n_fft // hop
    buf = torch.zeros((b, (n + r - 1) * hop), dtype=frames.dtype, device=dev)
    for j in range(r):
        # Within phase j the hop-sized pieces tile contiguously: one strided
        # add at offset j·hop, in the JAX package's order.
        seg = frames[:, :, j * hop : (j + 1) * hop].reshape(b, n * hop)
        buf[:, j * hop : j * hop + n * hop] += seg
    buf = buf / _ola_envelope_on(n, n_fft, hop, dev)
    pad = n_fft // 2
    return buf[:, pad : pad + n * hop]


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


class VocoderBlock(nn.Module):
    def __init__(self, dim: int, inter: int, group=None):
        super().__init__()
        self.group = group
        inter //= comm.size(group)
        self.dwconv = nn.Conv1d(dim, dim, DW_KERNEL, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.pw1 = nn.Linear(dim, inter)
        self.pw2 = nn.Linear(inter, dim)
        self.gamma = nn.Parameter(torch.empty(dim))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """x: [B, N, C] float32 → float32."""
        h = dwconv(x, self.dwconv.weight, self.dwconv.bias)
        h = self.norm(h).to(dtype)
        h = F.gelu(column_linear(h, self.pw1, self.group), approximate="tanh")
        h = row_linear(h, self.pw2, self.group)
        return x + self.gamma * h.float()


class Vocoder(nn.Module):
    """Log-mel [B, N, n_mels] → waveform [B, N·hop] float32."""

    def __init__(self, cfg: VocoderConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.dim
        self.embed = nn.Conv1d(cfg.n_mels, d, DW_KERNEL)
        self.norm_in = nn.LayerNorm(d, eps=LN_EPS)
        self.blocks = nn.ModuleList(
            [VocoderBlock(d, cfg.intermediate_dim, cfg.model_group)
             for _ in range(cfg.num_layers)]
        )
        self.norm_out = nn.LayerNorm(d, eps=LN_EPS)
        self.head = nn.Linear(d, 2 * cfg.n_freqs)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        k = self.embed.weight.shape[-1]
        lo = (k - 1) // 2  # XLA SAME padding
        x = F.conv1d(F.pad(mel.float().transpose(1, 2), (lo, k - 1 - lo)),
                     self.embed.weight, self.embed.bias).transpose(1, 2)
        x = self.norm_in(x)
        for blk in self.blocks:
            x = blk(x, cfg.compute_dtype)
        x = self.norm_out(x)
        h = self.head(x)  # [B, N, 2·n_freqs] f32
        log_mag, phase = h.chunk(2, dim=-1)
        mag = torch.exp(torch.clamp(log_mag, -LOG_MAG_CLIP, LOG_MAG_CLIP))
        return istft_overlap_add(
            mag * torch.cos(phase), mag * torch.sin(phase), cfg.n_fft, cfg.hop_length
        )
