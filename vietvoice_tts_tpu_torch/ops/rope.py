"""Rotary position embeddings (port of ``vietvoice_tts_tpu/ops/rope.py``).

One ``[N, head_dim]`` cos/sin pair per frame count, shared by q and k, with
the half-split (GPT-NeoX) rotation: ``(x1, x2) → (-x2, x1)``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=32)
def rope_tables(seq_len: int, head_dim: int, theta: float = 10000.0):
    """Precompute (cos, sin), each [seq_len, head_dim] float32 numpy.

    The half-dim frequency vector is duplicated across both halves so that
    ``apply_rope`` is one elementwise multiply per table. Callers must not
    write to the cached arrays."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (np.arange(0, half, dtype=np.float64) / half))
    ang = np.arange(seq_len, dtype=np.float64)[:, None] * freqs[None, :]  # [N, half]
    cos = np.concatenate([np.cos(ang), np.cos(ang)], axis=-1).astype(np.float32)
    sin = np.concatenate([np.sin(ang), np.sin(ang)], axis=-1).astype(np.float32)
    return cos, sin


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """[..., d] → [..., d] with (x1, x2) → (-x2, x1) on the half split."""
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate q or k: x [B, H, N, D], cos/sin [N, D] (broadcast over B, H)."""
    return x * cos + rotate_half(x) * sin
