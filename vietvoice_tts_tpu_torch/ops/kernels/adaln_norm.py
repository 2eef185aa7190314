"""The DiT block's gated residual and modulated LayerNorm in one pass: the
CUDA kernel's wrapper and its plain version.

Replaces no TPU kernel: the JAX DiT leaves this chain to XLA, which fuses
it (``vietvoice_tts_tpu/models/dit.py:368-372``). Eager PyTorch, inside a
CUDA graph too, runs each op of it as a pass of its own over the residual
stream, about 18 launches a block. The kernel is ``csrc/adaln_norm.cu`` (its
header says how it is laid out on the card). One call computes, on the
residual stream h [B, N, dim] and float32 modulation rows [B', dim] (B' = 1
broadcasts over the batch; strided views of the hoisted modulations, read
where they lie):

- (b) ``h' = h + g·x`` (the gated residual), then ``u = LN(h')·(1 + sc) +
  sh``, rounded once to ``out_dtype``;
- (a) with no ``gate``/``update``: u from h;
- (c) with no ``scale``/``shift``: h' alone.

The result is ``(h', u)``: h' is h itself in form (a), u is None in form (c).
This module holds

- :func:`adaln_norm`, the wrapper: it checks its inputs, launches the kernel
  for CUDA tensors (or raises) and runs the plain version for CPU tensors;
- :func:`adaln_norm_reference`, the plain PyTorch version, which is the
  DiT's non-kernel path (training, the CPU) and :func:`layernorm`;
- ``launches``, a count of kernel launches, so a run can show that the main
  path went through the kernel;
- :func:`launch_shape`, the threads and vectors a thread the kernel runs
  with at a width and dtype.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import refuse_autograd
from .build import load_library

KERNEL = "adaln_norm"
LN_EPS = 1e-6
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# A block has at most MAX_THREADS threads, each holding one or two vectors
# of 16 bytes of its row in registers (csrc/adaln_norm.cu): widths up to
# 4096 in bfloat16 and 2048 in float32, past every width the DiT serves.
MAX_THREADS = 256
_VECTORS_PER_THREAD = (1, 2)

# Kernel launches by this process; callers may reset it to 0. A CUDA graph's
# replay adds the launches its capture recorded (``ops/kernels/__init__.py:
# add_launches``), so the count is of kernels that ran for a batch.
launches = 0


def layernorm(x: torch.Tensor, stats_dtype=torch.float32) -> torch.Tensor:
    """Non-affine LayerNorm, eps 1e-6, statistics in ``stats_dtype``;
    returns float32."""
    xs = x.to(stats_dtype)
    return F.layer_norm(xs, (xs.shape[-1],), eps=LN_EPS).float()


def adaln_norm_reference(
    h: torch.Tensor,  # [B, N, dim] residual stream, compute dtype
    gate: torch.Tensor | None = None,  # [B', dim] float32
    update: torch.Tensor | None = None,  # [B, N, dim], h's dtype
    scale: torch.Tensor | None = None,  # [B', dim] float32
    shift: torch.Tensor | None = None,  # [B', dim] float32
    *,
    norm_dtype: torch.dtype = torch.float32,
    out_dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Plain PyTorch version → (h', u), the DiT block's eager chain: ``h' =
    h + gate.to(dtype)·update`` (each op rounded to h's dtype), then ``u =
    (layernorm(h', norm_dtype)·(1 + scale) + shift).to(out_dtype or h's
    dtype)``, the modulation in float32. Either half may be left out."""
    if gate is not None:
        h = h + gate[:, None].to(h.dtype) * update
    if scale is None:
        return h, None
    u = layernorm(h, norm_dtype) * (1.0 + scale[:, None]) + shift[:, None]
    return h, u.to(out_dtype or h.dtype)


def launch_shape(dim: int, dtype: torch.dtype) -> tuple[int, int]:
    """(threads, vectors a thread) of the kernel's one block a row at this
    width and dtype: a row is ``dim / (16 / itemsize)`` 16-byte vectors; the
    fewest vectors a thread that keep the block within :data:`MAX_THREADS`,
    then the threads that cover the row, in whole warps. Raises where the
    kernel has no shape: dim not a multiple of 8 (rows of 16 bytes in
    bfloat16), a dtype other than float32 and bfloat16, or a row wider than
    MAX_THREADS × 2 vectors."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"the AdaLN norm kernel takes float32 or bfloat16, got {dtype}")
    if dim < 8 or dim % 8:
        raise ValueError(f"the AdaLN norm kernel takes a width that is a multiple of 8, got {dim}")
    vectors = dim * dtype.itemsize // 16
    for vpt in _VECTORS_PER_THREAD:
        threads = -(-vectors // vpt)
        if threads <= MAX_THREADS:
            return 32 * -(-threads // 32), vpt
    raise ValueError(
        f"the AdaLN norm kernel takes widths up to {MAX_THREADS * 2 * 16 // dtype.itemsize} "
        f"in {dtype}, got {dim}"
    )


def _check_inputs(h, gate, update, scale, shift, norm_dtype, out_dtype) -> None:
    """Validate the form, shapes and dtypes for both paths."""
    if h.dim() != 3:
        raise ValueError(f"h must be [B, N, dim], got {tuple(h.shape)}")
    if h.dtype not in _DTYPE_CODES:
        raise TypeError(f"h must be float32 or bfloat16, got {h.dtype}")
    if (gate is None) != (update is None) or (scale is None) != (shift is None):
        raise ValueError("gate and update come together, and so do scale and shift")
    if gate is None and scale is None:
        raise ValueError("give a residual (gate, update), a modulation (scale, shift) or both")
    if update is not None and (update.shape != h.shape or update.dtype != h.dtype):
        raise ValueError(
            f"update must be h's {tuple(h.shape)} {h.dtype}, got {tuple(update.shape)} "
            f"{update.dtype}"
        )
    b, _, dim = h.shape
    for name, t in (("gate", gate), ("scale", scale), ("shift", shift)):
        if t is not None and (t.dim() != 2 or t.shape[1] != dim or t.shape[0] not in (1, b)):
            raise ValueError(f"{name} must be [1 or {b}, {dim}], got {tuple(t.shape)}")
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if norm_dtype not in _DTYPE_CODES:
        raise TypeError(f"norm_dtype must be float32 or bfloat16, got {norm_dtype}")
    if out_dtype not in (None, h.dtype, torch.float32):
        raise TypeError(f"out_dtype must be h's dtype or float32, got {out_dtype}")


def _aligned(t: torch.Tensor, strides) -> bool:
    """Every row of t starts on a 16-byte boundary."""
    elems = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(s % elems == 0 for s in strides)


def adaln_norm(
    h: torch.Tensor,
    gate: torch.Tensor | None = None,
    update: torch.Tensor | None = None,
    scale: torch.Tensor | None = None,
    shift: torch.Tensor | None = None,
    *,
    norm_dtype: torch.dtype = torch.float32,
    out_dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Gated residual and modulated norm → (h', u), as
    :func:`adaln_norm_reference` computes them: h' bit for bit, u within
    the last bit of its type (the kernel sums the statistics in another
    order than ``F.layer_norm``).

    CUDA tensors launch the kernel, or raise on anything it does not take
    (:func:`launch_shape`; unit stride along dim, rows 16-byte aligned;
    inputs that require grad, since the kernel has no backward); CPU
    tensors, which the kernel cannot read, run the plain version. h and
    update may be strided over batch and frames; h' and u are new
    contiguous tensors."""
    global launches
    _check_inputs(h, gate, update, scale, shift, norm_dtype, out_dtype)
    kw = dict(norm_dtype=norm_dtype, out_dtype=out_dtype)
    if h.device.type == "cpu":
        return adaln_norm_reference(h, gate, update, scale, shift, **kw)
    refuse_autograd(KERNEL, *(t for t in (h, gate, update, scale, shift) if t is not None))
    if h.device.type != "cuda":
        raise ValueError(f"the AdaLN norm runs on cuda or cpu, not {h.device}")
    b, n, dim = h.shape
    threads, vpt = launch_shape(dim, h.dtype)
    strides = []
    for name, t, lead in (("h", h, 2), ("update", update, 2), ("gate", gate, 1),
                          ("scale", scale, 1), ("shift", shift, 1)):
        if t is None:
            strides.extend([0] * lead)
            continue
        if t.device != h.device:
            raise ValueError(f"{name} is on {t.device}, h on {h.device}")
        # A dimension of size 1 is never stepped over: stride 0 (B' = 1
        # broadcasts the modulation row).
        st = [s if size > 1 else 0 for s, size in zip(t.stride()[:lead], t.shape[:lead])]
        if t.stride(-1) != 1 or not _aligned(t, st):
            raise ValueError(
                f"{name} must have unit stride along dim and 16-byte-aligned rows: "
                f"data_ptr % 16 = {t.data_ptr() % 16}, strides {t.stride()}"
            )
        strides.extend(st)
    h_out = None if gate is None else torch.empty((b, n, dim), dtype=h.dtype, device=h.device)
    u = (None if scale is None
         else torch.empty((b, n, dim), dtype=out_dtype or h.dtype, device=h.device))
    entry = _kernel_entry()
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = entry(
            h.data_ptr(), *(None if t is None else t.data_ptr()
                            for t in (update, gate, scale, shift, h_out, u)),
            (ctypes.c_longlong * 7)(*strides), b, n, dim, _DTYPE_CODES[h.dtype],
            int(u is not None and u.dtype != h.dtype), int(norm_dtype == torch.bfloat16),
            threads, vpt, stream,
        )
    if err != 0:
        raise RuntimeError(f"adaln_norm launch failed: CUDA error {err}")
    launches += 1
    return (h if h_out is None else h_out), u


@functools.cache
def _kernel_entry():
    """The C entry point, built and loaded at first use."""
    fn = load_library(KERNEL).vv_adaln_norm
    # Pointers and the stream as c_void_p: ctypes would pass a bare Python
    # int as a 32-bit C int and cut the address.
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 7
        + [ctypes.POINTER(ctypes.c_longlong)]
        + [ctypes.c_int] * 8
        + [ctypes.c_void_p]
    )
    return fn
