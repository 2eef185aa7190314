"""Exact-softmax attention on unpacked q, k, v: the CUDA kernel's wrapper.

Port of the Pallas TPU kernel ``flash_attention``
(``vietvoice_tts_tpu/ops/pallas/flash_attention.py:53``). The kernel itself
is ``csrc/flash_attention.cu`` (its header says how it is laid out on the
card). It takes every head_dim that is a multiple of 8 up to
:data:`MAX_HEAD_DIM` (1024), and has two variants, chosen from the dtype
alone (:func:`kernel_variant`), both on Hopper's tensor cores: ``"wgmma"``,
bfloat16 (up to 256 at the smallest tile width of 32, 64, 128, 192 or 256
that holds the head, its extra columns zero; above 256 in column blocks of
at most 256 columns, ``csrc/attention_strided.cuh``), rounds the softmax
weights to bfloat16 for P·V; ``"tf32x3"``, float32
(``csrc/attention_tf32.cuh``), splits every operand into two TF32 parts and
takes each product as three (lo·hi + hi·lo + hi·hi), about 2⁻²¹ relative
per product, with float32 softmax and weights. This module holds

- :func:`flash_attention`, the wrapper: it checks its inputs, launches the
  kernel for CUDA tensors (or raises) and runs the plain version for CPU
  tensors;
- ``launches``, a count of kernel launches, so a run can show that the main
  path went through the kernel;
- :func:`supports_shape`, the shapes the kernel takes, and
  :func:`kernel_variant`, which variant serves a dtype and head_dim;
- :func:`attention_tf32x3`, a plain emulation of the float32 variant's
  products (tests and ``chip_smoke.py`` hold the kernel against it; the
  main path never calls it).

The plain PyTorch version of the same function is
``ops/attention.py:attention``; ``attention(..., use_kernels=True)`` is how
the rest of the package reaches this wrapper.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..attention import NEG_INF, attention
from . import MAX_HEAD_DIM, refuse_autograd, tf32x3_matmul
from .build import load_library

KERNEL = "flash_attention"
HEAD_DIM_RULE = f"a multiple of 8 up to {MAX_HEAD_DIM}"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches by this process; callers may reset it to 0. A CUDA graph's
# replay adds the launches its capture recorded (``ops/kernels/__init__.py:
# add_launches``), so the count is of kernels that ran for a batch.
launches = 0


def supports_shape(heads: int, head_dim: int, n: int) -> bool:
    """True when the CUDA kernel has a code path for this attention shape:
    any head and frame count, head_dim a multiple of 8 (rows of 16 bytes in
    bfloat16) up to :data:`MAX_HEAD_DIM`."""
    return heads >= 1 and n >= 1 and 8 <= head_dim <= MAX_HEAD_DIM and head_dim % 8 == 0


def kernel_variant(dtype: torch.dtype, head_dim: int) -> str:
    """The variant of the CUDA kernel that serves this dtype and head_dim:
    ``"wgmma"`` (bfloat16) or ``"tf32x3"`` (float32 in split TF32), both on
    the tensor cores. The choice the C entry point makes, restated here so
    that tests without a card hold it."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"the attention kernel takes float32 or bfloat16, got {dtype}")
    if not supports_shape(1, head_dim, 1):
        raise ValueError(f"the attention kernel takes head_dim {HEAD_DIM_RULE}, got {head_dim}")
    return "wgmma" if dtype == torch.bfloat16 else "tf32x3"


def attention_tf32x3(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """[B, H, N, D] attention with the float32 kernel's products: q·kᵀ and
    p·v each as three TF32 products (:func:`tf32x3_matmul`), p the
    unnormalized weights exp(s − max), the output divided by their sum.
    Tests and ``chip_smoke.py`` hold the kernel against it; the main path
    never calls it."""
    scale = q.shape[-1] ** -0.5
    logits = tf32x3_matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        bias = torch.zeros(mask.shape, dtype=torch.float32, device=mask.device)
        logits = logits + bias.masked_fill(~mask.bool(), NEG_INF)[:, None, None, :]
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    out = tf32x3_matmul(p, v.float()) / p.sum(-1, keepdim=True)
    return out.to(q.dtype)


def _check_inputs(q, k, v, mask) -> None:
    """Validate shapes and dtypes for both paths."""
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"q must be [B, H, N, D], got {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape:
            raise ValueError(
                f"{name} must have q's shape {tuple(q.shape)}, got {tuple(t.shape)}"
            )
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    if mask is not None:
        b, _, n, _ = q.shape
        if tuple(mask.shape) != (b, n):
            raise ValueError(f"mask must be [{b}, {n}], got {tuple(mask.shape)}")
        if mask.dtype not in (torch.bool, torch.uint8):
            raise TypeError(f"mask must be bool or uint8, got {mask.dtype}")


def flash_attention(
    q: torch.Tensor,  # [B, H, N, D], any batch, head and frame strides
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor | None = None,  # [B, N] bool, True = valid key
) -> torch.Tensor:
    """Bidirectional multi-head attention → [B, H, N, D] in q's dtype.

    CUDA tensors launch the kernel, or raise on anything it does not take
    (:func:`supports_shape`; unit stride along D; inputs that require grad,
    since the kernel has no backward); CPU tensors, which the kernel cannot
    read, run the plain (differentiable) ``ops.attention.attention``. The
    kernel's result is a view of a ``[B, N, H, D]`` buffer, so
    ``out.transpose(1, 2).reshape(B, N, H·D)`` copies nothing."""
    global launches
    _check_inputs(q, k, v, mask)
    if q.device.type == "cpu":
        return attention(q, k, v, None if mask is None else mask.bool())
    refuse_autograd(KERNEL, q, k, v)
    b, heads, n, d = q.shape
    if not supports_shape(heads, d, n):
        raise ValueError(
            f"the attention kernel takes head_dim {HEAD_DIM_RULE}; got "
            f"heads={heads} head_dim={d} frames={n}"
        )
    strides = []
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(
                f"{name} must have unit stride along head_dim, got strides {t.stride()}"
            )
        strides.extend(t.stride()[:3])
        # Both variants copy 16 bytes at a time.
        if t.data_ptr() % 16 or any(st % (16 // t.element_size()) for st in t.stride()[:3]):
            raise ValueError(
                f"{name} must have 16-byte-aligned rows: "
                f"data_ptr % 16 = {t.data_ptr() % 16}, strides {t.stride()}"
            )
    if q.device.type != "cuda":
        raise ValueError(f"attention runs on cuda or cpu, not {q.device}")
    for name, t in (("k", k), ("v", v), ("mask", mask)):
        if t is not None and t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if mask is not None:
        mask = mask.contiguous().view(torch.uint8)
    out = torch.empty((b, n, heads, d), dtype=q.dtype, device=q.device)
    entry = _kernel_entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            (ctypes.c_longlong * 9)(*strides), b, heads, n, d,
            _DTYPE_CODES[q.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    launches += 1
    return out.transpose(1, 2)


@functools.cache
def _kernel_entry():
    """The C entry point, built and loaded at first use."""
    fn = load_library(KERNEL).vv_flash_attention
    # Pointers and the stream as c_void_p: ctypes would pass a bare Python
    # int as a 32-bit C int and cut the address.
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 5
        + [ctypes.POINTER(ctypes.c_longlong)]
        + [ctypes.c_int] * 5
        + [ctypes.c_void_p]
    )
    return fn
