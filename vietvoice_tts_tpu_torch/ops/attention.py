"""Self-attention for the DiT (port of ``vietvoice_tts_tpu/ops/attention.py``).

:func:`attention` is the plain version that both CUDA attention kernels are
held against: float32 logits from the (possibly bf16) q and k, scale on the
logits, an additive -1e30 key-padding bias, float32 softmax, and a float32
weighted sum of the values, cast to q's dtype at the end. With
``use_kernels=True`` (the JAX function's ``use_pallas``) it hands the call to
the CUDA kernel's wrapper, ``ops/kernels/flash_attention.py``, which launches
the kernel on CUDA tensors or raises, and runs this plain body on CPU
tensors. There is no quiet fallback from a kernel that fails.

Two roundings differ from the JAX function in bfloat16 (in float32 the two
are the same function). JAX casts the softmax weights to q's dtype before
the weighted sum (its einsum takes one input dtype); here they stay float32.
And the fused path's RoPE (``ops/kernels/fused_rope_attention.py``) is
computed in float32 and rounded once. Both follow the CUDA kernel, so that
kernel and plain version round alike and their comparison isolates faults of
the kernel. It is not closer end to end: on the full 31-step solve the two
choices of the weights' rounding gave 1.6e-2 and 1.4e-2..1.5e-2 mel
max-abs, kernel vs plain, inside the 1.1e-2..1.7e-2 noise floor of that
solve (NVIDIA H100 80GB HBM3, 700 W; ``PERF.md``). How far the bf16 path
stays from the JAX one is held by ``tests/test_torch_kernels.py`` against
the Pallas kernel.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor | None = None,
    use_kernels: bool = False,
) -> torch.Tensor:
    """Bidirectional multi-head attention.

    q, k, v: [B, H, N, D]; mask: [B, N] bool (True = valid frame) or None.
    Returns [B, H, N, D] in q's dtype.
    """
    if use_kernels:
        # Imported here: the wrapper's module imports this one for its
        # plain version.
        from .kernels.flash_attention import flash_attention

        return flash_attention(q, k, v, mask)
    scale = q.shape[-1] ** -0.5
    # bf16 → f32 is exact, so these products match an f32-accumulating
    # bf16 matmul (JAX's preferred_element_type=float32).
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        bias = torch.zeros(mask.shape, dtype=torch.float32, device=mask.device)
        bias = bias.masked_fill(~mask, NEG_INF)
        logits = logits + bias[:, None, None, :]
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", weights, v.float())
    return out.to(q.dtype)
