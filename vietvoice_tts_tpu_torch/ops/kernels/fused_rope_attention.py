"""RoPE-fused attention on the packed QKV projection: CUDA kernel + plain version.

Port of the Pallas TPU kernel ``fused_qkv_rope_attention``
(``vietvoice_tts_tpu/ops/pallas/fused_rope_attention.py:123``). The kernel
itself is ``csrc/fused_rope_attention.cu`` (its header says how it is laid
out on the card). It has two variants, chosen from (dtype, head_dim) alone
(:func:`kernel_variant`): ``"wgmma"``, bfloat16 (the serving type), runs both
products on Hopper's tensor cores and rounds the softmax weights to bfloat16
for P·V; ``"simt"``, float32, computes on the SIMT pipes. This module holds

- :func:`fused_qkv_rope_attention`, the wrapper: it checks its inputs,
  launches the kernel for CUDA tensors (or raises) and runs the plain
  version for CPU tensors;
- :func:`fused_qkv_rope_attention_reference`, the plain PyTorch version of
  the same function (split, ``apply_rope``, reference attention, merge),
  which is also the DiT's non-kernel path;
- ``launches``, a count of kernel launches, so a run can show that the main
  path went through the kernel;
- :func:`supports_shape`, the shapes the kernel takes, and
  :func:`kernel_variant`, which variant serves a dtype and head_dim.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..attention import attention
from ..rope import apply_rope
from . import refuse_autograd
from .build import load_library

KERNEL = "fused_rope_attention"
HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # kernel launches by this process; callers may reset it to 0


def supports_shape(heads: int, head_dim: int, n: int) -> bool:
    """True when the CUDA kernel has a code path for this attention shape
    (any frame count; head_dim 64 or 128, which covers the default 8×128
    model and converted F5 models, 16×64)."""
    return heads >= 1 and n >= 1 and head_dim in HEAD_DIMS


def kernel_variant(dtype: torch.dtype, head_dim: int) -> str:
    """The variant of the CUDA kernel that serves this dtype and head_dim:
    ``"wgmma"`` (tensor cores) or ``"simt"`` (float32 pipes). The choice the C
    entry point makes, restated here so that tests without a card hold it."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"the fused attention kernel takes float32 or bfloat16, got {dtype}")
    if head_dim not in HEAD_DIMS:
        raise ValueError(
            f"the fused attention kernel takes head_dim in {HEAD_DIMS}, got {head_dim}"
        )
    return "wgmma" if dtype == torch.bfloat16 else "simt"


def fused_qkv_rope_attention_reference(
    qkv: torch.Tensor,  # [B, N, 3·H·D] packed q ‖ k ‖ v projection output
    cos: torch.Tensor,  # [N, D] rope tables
    sin: torch.Tensor,
    mask: torch.Tensor | None,  # [B, N] bool, True = valid key
    heads: int,
) -> torch.Tensor:
    """Plain PyTorch version → [B, N, H·D] in qkv's dtype.

    The JAX package's non-kernel DiT path (``models/dit.py:416-423``): RoPE
    with the tables cast to the compute dtype, then reference attention
    (float32 logits and softmax). RoPE is computed in float32 and rounded
    once to the compute dtype, as the CUDA kernel does."""
    b, n, three_hd = qkv.shape
    d = three_hd // (3 * heads)
    q, k, v = (
        t.reshape(b, n, heads, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1)
    )
    cos = cos.to(qkv.dtype).float()
    sin = sin.to(qkv.dtype).float()
    q, k = (apply_rope(t.float(), cos, sin).to(qkv.dtype) for t in (q, k))
    out = attention(q, k, v, mask)
    return out.transpose(1, 2).reshape(b, n, heads * d)


def _check_inputs(qkv, cos, sin, mask, heads) -> int:
    """Validate shapes and dtypes for both paths; returns head_dim."""
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"qkv must be float32 or bfloat16, got {qkv.dtype}")
    if qkv.dim() != 3 or heads < 1 or qkv.shape[2] % (3 * heads):
        raise ValueError(
            f"qkv must be [B, N, 3·heads·D] with heads={heads}; got {tuple(qkv.shape)}"
        )
    b, n, three_hd = qkv.shape
    d = three_hd // (3 * heads)
    for name, t in (("cos", cos), ("sin", sin)):
        if tuple(t.shape) != (n, d):
            raise ValueError(f"{name} must be [{n}, {d}], got {tuple(t.shape)}")
        if not t.is_floating_point():
            raise TypeError(f"{name} must be floating point, got {t.dtype}")
    if mask is not None:
        if tuple(mask.shape) != (b, n):
            raise ValueError(f"mask must be [{b}, {n}], got {tuple(mask.shape)}")
        if mask.dtype not in (torch.bool, torch.uint8):
            raise TypeError(f"mask must be bool or uint8, got {mask.dtype}")
    return d


def fused_qkv_rope_attention(
    qkv: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    mask: torch.Tensor | None,
    heads: int,
) -> torch.Tensor:
    """Multi-head RoPE attention on packed QKV → [B, N, H·D].

    CUDA tensors launch the kernel, or raise on anything it does not take
    (:func:`supports_shape`, and inputs that require grad: the kernel has no
    backward); CPU tensors, which the kernel cannot read, run
    :func:`fused_qkv_rope_attention_reference`, which is differentiable."""
    global launches
    d = _check_inputs(qkv, cos, sin, mask, heads)
    if qkv.device.type == "cpu":
        return fused_qkv_rope_attention_reference(
            qkv, cos, sin, None if mask is None else mask.bool(), heads
        )
    refuse_autograd(KERNEL, qkv, cos, sin)
    b, n, _ = qkv.shape
    if not supports_shape(heads, d, n):
        raise ValueError(
            f"the fused attention kernel takes head_dim in {HEAD_DIMS}; got "
            f"heads={heads} head_dim={d} frames={n}"
        )
    if qkv.device.type != "cuda":
        raise ValueError(f"fused attention runs on cuda or cpu, not {qkv.device}")
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    if mask is None:
        mask = torch.ones((b, n), dtype=torch.uint8, device=qkv.device)
    for name, t in (("cos", cos), ("sin", sin), ("mask", mask)):
        if t.device != qkv.device:
            raise ValueError(f"{name} is on {t.device}, qkv on {qkv.device}")
    # The tables are rounded to the compute dtype, as both JAX paths do.
    cos = cos.to(qkv.dtype).contiguous()
    sin = sin.to(qkv.dtype).contiguous()
    mask = mask.contiguous().view(torch.uint8)
    out = torch.empty((b, n, heads * d), dtype=qkv.dtype, device=qkv.device)
    entry = _kernel_entry()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = entry(
            qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(), mask.data_ptr(),
            out.data_ptr(), b, n, heads, d, _DTYPE_CODES[qkv.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_rope_attention launch failed: CUDA error {err}")
    launches += 1
    return out


@functools.cache
def _kernel_entry():
    """The C entry point, built and loaded at first use."""
    fn = load_library(KERNEL).vv_fused_rope_attention
    # Pointers and the stream as c_void_p: ctypes would pass a bare Python
    # int as a 32-bit C int and cut the address.
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return fn
