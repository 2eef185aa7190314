"""Sequence (context) parallelism: attention over a frame-split stream.

Port of ``vietvoice_tts_tpu/parallel/sequence.py``. The DiT's residual
stream holds ``N/sp`` frames per rank of the sequence group (the model axis
under ``ModelConfig.sequence_parallel``); attention is the only op that
needs the other frames:

- **Ulysses** (heads divide ``sp``): one all-to-all scatters heads and
  gathers frames, ``[B, N/sp, H, D] → [B, N, H/sp, D]``, full-sequence
  attention runs on the local heads, and a second all-to-all sends the
  frames back. The all-to-all moves q, k and v as one ``[B, N/sp, 3, H, D]``
  tensor, so what arrives is ``[B, N, 3·(H/sp)·D]``, the packed layout the
  fused RoPE-attention kernel reads.
- **The ring** (heads do not divide ``sp``): K, V and the key mask travel
  round the group (``ring_shift``, one step per rank) while each rank folds
  the visiting block into a float32 online softmax — the arithmetic of the
  JAX ring (``sequence.py:134-178``) step for step: RoPE at global positions
  from the local rows of the tables, float32 logits and accumulators, the
  −1e30 bias of the visiting keys, the weights cast to v's dtype before
  P·V, and ``o / max(l, 1e-30)`` at the end. It has no kernel, as in JAX.

Every function takes this rank's frames of q, k and v (``[B, N/sp, H, D]``)
and the whole sequence's RoPE tables (``[N, D]``) and key mask (``[B, N]``),
and returns this rank's frames of the output. ``N % sp`` must be 0.
The data axis never reaches these functions: ``EngineCore`` gives each
data rank its own rows before the DiT runs.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops.attention import NEG_INF, attention
from ..ops.rope import apply_rope
from . import comm


def plain_attend(qkv, cos, sin, mask, heads: int) -> torch.Tensor:
    """JAX Ulysses' local attention (``use_pallas=False``): packed
    ``[B, N, 3·H·D]`` → split heads, RoPE in the tables' dtype, reference
    attention → ``[B, N, H·D]``."""
    b, n, _ = qkv.shape
    q, k, v = (t.reshape(b, n, heads, -1).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    out = attention(apply_rope(q, cos, sin), apply_rope(k, cos, sin), v, mask)
    return out.transpose(1, 2).reshape(b, n, -1)


def _frames(cos: torch.Tensor, group, q: torch.Tensor) -> int:
    """The whole sequence's frame count, checked against the group."""
    sp, n = comm.size(group), cos.shape[0]
    if n % sp:
        raise ValueError(f"frames {n} not divisible by sequence-parallel size {sp}")
    if q.shape[1] != n // sp:
        raise ValueError(f"q holds {q.shape[1]} frames; {n} frames over {sp} ranks is {n // sp}")
    return n


def sp_attention(q, k, v, cos, sin, mask, group, attend: Optional[Callable] = None):
    """Sequence-parallel attention, picking the algorithm as JAX does:
    Ulysses when the head count divides the group size, the ring otherwise."""
    if q.shape[2] % comm.size(group) == 0:
        return ulysses_attention(q, k, v, cos, sin, mask, group, attend)
    return ring_attention(q, k, v, cos, sin, mask, group)


def ulysses_attention(q, k, v, cos, sin, mask, group, attend: Optional[Callable] = None):
    """Ulysses attention → this rank's frames ``[B, N/sp, H, D]``.

    ``attend(qkv, cos, sin, mask, heads)`` is the local attention on packed
    ``[B, N, 3·(H/sp)·D]``; the DiT passes its own route (a CUDA kernel on
    the card), the default is :func:`plain_attend`."""
    sp = comm.size(group)
    b, nl, h, d = q.shape
    if h % sp:
        raise ValueError(f"heads {h} not divisible by sequence-parallel size {sp}")
    n = _frames(cos, group, q)
    qkv = comm.all_to_all(torch.stack((q, k, v), dim=2), group, split_dim=3, concat_dim=1)
    out = (attend or plain_attend)(qkv.reshape(b, n, -1), cos, sin, mask, h // sp)
    out = out.reshape(b, n, h // sp, d)
    return comm.all_to_all(out, group, split_dim=1, concat_dim=2)


def ring_attention(q, k, v, cos, sin, mask, group):
    """Ring attention → this rank's frames ``[B, N/sp, H, D]``, for any head
    count."""
    sp = comm.size(group)
    b, nl, h, d = q.shape
    _frames(cos, group, q)
    lo = comm.rank(group) * nl
    cos_l, sin_l = cos[lo : lo + nl], sin[lo : lo + nl]
    q_b = apply_rope(q.transpose(1, 2), cos_l, sin_l)  # [B, H, nl, D]
    k_c = apply_rope(k.transpose(1, 2), cos_l, sin_l)
    v_c = v.transpose(1, 2)
    m_c = mask[:, lo : lo + nl]
    scale = d**-0.5
    o = torch.zeros((b, h, nl, d), dtype=torch.float32, device=q.device)
    l_acc = torch.zeros((b, h, nl), dtype=torch.float32, device=q.device)
    m_acc = torch.full_like(l_acc, float("-inf"))
    for step in range(sp):
        s = torch.einsum("bhqd,bhkd->bhqk", q_b.float(), k_c.float()) * scale
        s = torch.where(m_c[:, None, None, :], s, torch.full((), NEG_INF, device=s.device))
        m_new = torch.maximum(m_acc, s.amax(dim=-1))
        alpha = torch.exp(m_acc - m_new)
        p = torch.exp(s - m_new[..., None])
        l_acc = l_acc * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(v_c.dtype).float(), v_c.float()
        )
        m_acc = m_new
        if step < sp - 1:  # the JAX scan's last rotation feeds nothing
            k_c, v_c, m_c = comm.ring_shift([k_c, v_c, m_c], group)
    o = o / torch.clamp(l_acc[..., None], min=1e-30)
    return o.to(q.dtype).transpose(1, 2)
