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
computed in float32 and rounded once.

The CUDA kernels' bfloat16 variants run P·V on the tensor cores, which take
bfloat16 operands, so they do round the (unnormalized) weights to bfloat16,
as the TPU kernels and the JAX function do. This plain version keeps its
float32 weights all the same: it is the more exact of the two, every CPU
parity test against the JAX package stands on it unchanged, and the card
shows the kernels inside the tolerances that stand with it: per call 9.8e-4
to 3.9e-3 max-abs at every serving shape (bound 1e-2), and 1.6e-2 to 2.0e-2
on the full 31-step mel latent, where that solve's own noise floor under a
change of float32 summation order is 1.1e-2 to 1.7e-2 (bound 5e-2; NVIDIA
H100 80GB HBM3, 700 W; ``chip_smoke.py``, ``PERF.md``).
``tests/test_torch_attention_mma.py`` models the kernels' arithmetic in
PyTorch and holds it against this function, the JAX one and the Pallas
kernels on the CPU.
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
