"""Exact-softmax attention on unpacked q, k, v: the CUDA kernel's wrapper.

Port of the Pallas TPU kernel ``flash_attention``
(``vietvoice_tts_tpu/ops/pallas/flash_attention.py:53``). The kernel itself
is ``csrc/flash_attention.cu`` (its header says how it is laid out on the
card). It has two variants, chosen from (dtype, head_dim) alone
(:func:`kernel_variant`): ``"wgmma"``, bfloat16 at head_dim 32, 64 and 128,
runs both products on Hopper's tensor cores and rounds the softmax weights
to bfloat16 for P·V; ``"simt"``, float32 at every head_dim and bfloat16 at 96
and 256, computes in float32 on the SIMT pipes. This module holds

- :func:`flash_attention`, the wrapper: it checks its inputs, launches the
  kernel for CUDA tensors (or raises) and runs the plain version for CPU
  tensors;
- ``launches``, a count of kernel launches, so a run can show that the main
  path went through the kernel;
- :func:`supports_shape`, the shapes the kernel takes, and
  :func:`kernel_variant`, which variant serves a dtype and head_dim.

The plain PyTorch version of the same function is
``ops/attention.py:attention``; ``attention(..., use_kernels=True)`` is how
the rest of the package reaches this wrapper.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..attention import attention
from . import refuse_autograd
from .build import load_library

KERNEL = "flash_attention"
HEAD_DIMS = (32, 64, 96, 128, 256)
WGMMA_HEAD_DIMS = (32, 64, 128)  # bfloat16 on the tensor cores
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # kernel launches by this process; callers may reset it to 0


def supports_shape(heads: int, head_dim: int, n: int) -> bool:
    """True when the CUDA kernel has a code path for this attention shape:
    any head and frame count, head_dim in :data:`HEAD_DIMS`."""
    return heads >= 1 and n >= 1 and head_dim in HEAD_DIMS


def kernel_variant(dtype: torch.dtype, head_dim: int) -> str:
    """The variant of the CUDA kernel that serves this dtype and head_dim:
    ``"wgmma"`` (tensor cores) or ``"simt"`` (float32 pipes). The choice the C
    entry point makes, restated here so that tests without a card hold it."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"the attention kernel takes float32 or bfloat16, got {dtype}")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"the attention kernel takes head_dim in {HEAD_DIMS}, got {head_dim}")
    return "wgmma" if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS else "simt"


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
            f"the attention kernel takes head_dim in {HEAD_DIMS}; got "
            f"heads={heads} head_dim={d} frames={n}"
        )
    strides = []
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(
                f"{name} must have unit stride along head_dim, got strides {t.stride()}"
            )
        strides.extend(t.stride()[:3])
        # The tensor-core variant copies 16 bytes at a time.
        if kernel_variant(q.dtype, d) == "wgmma" and (
            t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3])
        ):
            raise ValueError(
                f"{name} must have 16-byte-aligned rows for bfloat16 at head_dim {d}: "
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
