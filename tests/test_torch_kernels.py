"""Fused QKV-RoPE attention of the PyTorch port against the Pallas kernel.

The JAX Pallas kernel runs in interpret mode on the CPU (as in
``test_ops.py``); the port's plain version and its wrapper on CPU tensors
must agree with it on valid query rows. The CUDA kernel itself runs only on
a card: its tests are in ``test_torch_cuda.py``, which imports no JAX so
that it also runs where JAX is absent.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vietvoice_tts_tpu.ops.pallas.fused_rope_attention import (
    fused_qkv_rope_attention as pallas_fused,
)
from vietvoice_tts_tpu_torch.ops.kernels import fused_rope_attention as fra
from vietvoice_tts_tpu_torch.ops.rope import rope_tables


def _inputs(b, n, heads, head_dim, valid, seed=0):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, n, 3 * heads * head_dim)).astype(np.float32)
    mask = np.arange(n)[None, :] < np.asarray(valid)[:, None]
    cos, sin = rope_tables(n, head_dim)
    return qkv, mask, cos, sin


def _torch(qkv, mask, cos, sin):
    """→ (qkv, cos, sin, mask) tensors, the wrapper's argument order."""
    return (torch.from_numpy(qkv), torch.from_numpy(cos),
            torch.from_numpy(sin), torch.from_numpy(mask))


@pytest.mark.parametrize("n", [128, 768])
@pytest.mark.parametrize("heads,head_dim", [(2, 128), (4, 64)])
def test_plain_version_matches_pallas_interpret(heads, head_dim, n):
    """Both head layouts of the TPU kernel (one head per cell, head pairs)
    at a bucket where block_q divides (128) and where it must shrink (768).
    Tolerance as in test_ops.py: max-abs < 5e-3 on valid rows."""
    valid = [n - 40, n]
    qkv, mask, cos, sin = _inputs(2, n, heads, head_dim, valid)
    ref = np.asarray(
        pallas_fused(jnp.asarray(qkv), jnp.asarray(cos), jnp.asarray(sin),
                     jnp.asarray(mask), heads=heads, interpret=True)
    )
    out = fra.fused_qkv_rope_attention_reference(*_torch(qkv, mask, cos, sin), heads)
    out = out.numpy()
    assert out.shape == ref.shape
    for row, v in enumerate(valid):
        assert np.abs(out[row, :v] - ref[row, :v]).max() < 5e-3


@pytest.mark.parametrize("n", [128, 768])
@pytest.mark.parametrize("heads,head_dim", [(2, 128), (4, 64)])
def test_bf16_plain_version_matches_pallas_interpret(heads, head_dim, n):
    """In bfloat16 the port rounds RoPE once and keeps the softmax weights in
    float32, as its CUDA kernel does, where the Pallas kernel rounds the
    weights to bf16 before P·V. The two stay within 1e-2 max-abs on valid
    rows (about two bf16 ulps of outputs below 1), the per-call bf16
    tolerance of kernel vs plain on the card."""
    valid = [n - 40, n]
    qkv, mask, cos, sin = _inputs(2, n, heads, head_dim, valid)
    ref = pallas_fused(jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(cos),
                       jnp.asarray(sin), jnp.asarray(mask), heads=heads,
                       interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    qkv_t, cos_t, sin_t, mask_t = _torch(qkv, mask, cos, sin)
    out = fra.fused_qkv_rope_attention_reference(qkv_t.bfloat16(), cos_t, sin_t,
                                                 mask_t, heads)
    assert out.dtype == torch.bfloat16
    out = out.float().numpy()
    for row, v in enumerate(valid):
        assert np.abs(out[row, :v] - ref[row, :v]).max() < 1e-2


def test_wrapper_on_cpu_runs_plain_version_without_counting():
    qkv, mask, cos, sin = _inputs(2, 96, 2, 128, [50, 96], seed=3)
    args = _torch(qkv, mask, cos, sin)
    before = fra.launches
    out = fra.fused_qkv_rope_attention(*args, 2)
    assert fra.launches == before
    ref = fra.fused_qkv_rope_attention_reference(*args, 2)
    assert torch.equal(out, ref)
    # A uint8 mask and no mask are accepted too.
    out_u8 = fra.fused_qkv_rope_attention(*args[:3], args[3].to(torch.uint8), 2)
    assert torch.equal(out_u8, ref)
    assert fra.fused_qkv_rope_attention(*args[:3], None, 2).shape == (2, 96, 256)


def test_bf16_plain_version_close_to_f32():
    qkv, mask, cos, sin = _inputs(1, 64, 2, 64, [40])
    args = _torch(qkv, mask, cos, sin)
    f32 = fra.fused_qkv_rope_attention_reference(*args, 2)
    bf16 = fra.fused_qkv_rope_attention_reference(args[0].bfloat16(), *args[1:], 2)
    assert bf16.dtype == torch.bfloat16
    assert (bf16.float() - f32)[:, :40].abs().max() < 5e-2


def test_supports_shape():
    assert fra.supports_shape(8, 128, 512)
    assert fra.supports_shape(16, 64, 512)  # converted F5 shape
    assert fra.supports_shape(3, 64, 500)  # any head count, any frame count
    assert not fra.supports_shape(8, 96, 512)
    # Served since the two-pass widths (JAX's D % 128 == 0 up to 1024).
    assert fra.supports_shape(2, 256, 512)
    assert fra.supports_shape(3, 384, 437)
    assert not fra.supports_shape(2, 320, 512)
    assert not fra.supports_shape(1, 1152, 512)
    assert not fra.supports_shape(8, 128, 0)


@pytest.mark.parametrize(
    "change,error",
    [
        (lambda a: {**a, "qkv": a["qkv"].half()}, TypeError),
        (lambda a: {**a, "qkv": a["qkv"].long()}, TypeError),
        (lambda a: {**a, "qkv": a["qkv"][0]}, ValueError),
        (lambda a: {**a, "qkv": a["qkv"][..., :-1]}, ValueError),
        (lambda a: {**a, "heads": 3}, ValueError),  # head_dim 128·2/3 invalid
        (lambda a: {**a, "cos": a["cos"][:-1]}, ValueError),
        (lambda a: {**a, "sin": a["sin"].long()}, TypeError),
        (lambda a: {**a, "mask": a["mask"][:, :-1]}, ValueError),
        (lambda a: {**a, "mask": a["mask"].float()}, TypeError),
    ],
)
def test_wrapper_rejects_bad_inputs(change, error):
    qkv, mask, cos, sin = _inputs(2, 64, 2, 128, [30, 64])
    t = _torch(qkv, mask, cos, sin)
    args = change({"qkv": t[0], "cos": t[1], "sin": t[2], "mask": t[3], "heads": 2})
    with pytest.raises(error):
        fra.fused_qkv_rope_attention(
            args["qkv"], args["cos"], args["sin"], args["mask"], args["heads"]
        )


def test_head_dim_96_rejected():
    """Tensors that would go to the kernel (anything not on the CPU) are held
    to its head dims before any launch; meta tensors reach that check
    without a card (test_torch_cuda.py checks it on one)."""
    qkv, mask, cos, sin = _inputs(1, 32, 2, 96, [32])
    args = [t.to("meta") for t in _torch(qkv, mask, cos, sin)]
    before = fra.launches
    with pytest.raises(ValueError, match="head_dim"):
        fra.fused_qkv_rope_attention(*args, 2)
    assert fra.launches == before


def test_head_dim_96_runs_plain_version_on_cpu():
    """On CPU tensors the wrapper is the plain version for any head dim."""
    qkv, mask, cos, sin = _inputs(1, 32, 2, 96, [20])
    args = _torch(qkv, mask, cos, sin)
    out = fra.fused_qkv_rope_attention(*args, 2)
    assert torch.equal(out, fra.fused_qkv_rope_attention_reference(*args, 2))
