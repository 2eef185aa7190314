"""The arithmetic of the port's tensor-core attention kernels, modelled in
plain PyTorch and held on the CPU against everything the kernels must agree
with.

The bfloat16 variants of ``csrc/flash_attention.cu`` and
``csrc/fused_rope_attention.cu`` (``csrc/attention_mma.cuh``) walk the keys
in tiles of 64 with an online softmax in the log2 domain: the float32 logits
are scaled by ``log2(e)/sqrt(D)`` and biased, ``p = exp2(s - m)``, the row sum
is taken in float32 from p, p is rounded to bfloat16 for P·V, and m, l and
the output accumulator stay float32. A CUDA kernel has no CPU mode, so
:func:`mma_attention_model` repeats that arithmetic with torch operations.
It is held against the port's plain versions (``ops.attention.attention``,
``fused_qkv_rope_attention_reference``, whose softmax weights stay float32),
against the JAX package's ``attention`` and against its two Pallas kernels in
interpret mode: the rounding the kernels chose fits the tolerances that
stand (float32 max-abs 1e-5, bfloat16 1e-2 on valid rows; float32 against the
fused Pallas kernel 5e-3, as ``test_torch_kernels.py`` holds it).

Also here: which variant serves which (dtype, head_dim), and that a change
to the tile-step header rebuilds the libraries.
"""

import math
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vietvoice_tts_tpu.ops.attention import attention as jax_attention
from vietvoice_tts_tpu.ops.pallas import flash_attention as jflash
from vietvoice_tts_tpu.ops.pallas.fused_rope_attention import (
    fused_qkv_rope_attention as pallas_fused,
)
from vietvoice_tts_tpu_torch.ops.attention import NEG_INF, attention
from vietvoice_tts_tpu_torch.ops.kernels import build
from vietvoice_tts_tpu_torch.ops.kernels import flash_attention as fa
from vietvoice_tts_tpu_torch.ops.kernels import fused_rope_attention as fra
from vietvoice_tts_tpu_torch.ops.rope import apply_rope, rope_tables

BK = 64  # keys per tile (attention_mma.cuh)
LOG2E = 1.4426950408889634
TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def mma_attention_model(q, k, v, mask=None):
    """[B, H, N, D] attention with the tensor-core kernels' arithmetic.

    For bfloat16 inputs every rounding of the kernel is repeated; for
    float32 inputs (which the kernels serve on the SIMT pipes) the weights
    are not rounded, so the algorithm alone is on trial."""
    b, heads, n, d = q.shape
    scale_log2 = float(np.float32(LOG2E) / np.float32(math.sqrt(d)))
    bias = torch.zeros((b, n), dtype=torch.float32)
    if mask is not None:
        bias = bias.masked_fill(~mask, float(np.float32(NEG_INF) * np.float32(LOG2E)))
    qf = q.float()
    m = torch.full((b, heads, n), -math.inf)
    l = torch.zeros((b, heads, n))
    o = torch.zeros((b, heads, n, d))
    for k0 in range(0, n, BK):
        kt, vt = k[:, :, k0:k0 + BK].float(), v[:, :, k0:k0 + BK].float()
        # bf16 × bf16 products are exact in float32, as on the tensor cores.
        s = qf @ kt.transpose(-1, -2) * scale_log2 + bias[:, None, None, k0:k0 + BK]
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * alpha + p.sum(-1)  # from p before it is rounded
        if q.dtype == torch.bfloat16:
            p = p.bfloat16().float()
        o = o * alpha[..., None] + p @ vt
        m = m_new
    return (o / l[..., None]).to(q.dtype)


def mma_fused_model(qkv, cos, sin, mask, heads):
    """Packed-QKV RoPE attention with the tensor-core kernel's arithmetic:
    RoPE in float32 rounded once, 1/sqrt(D) on the logits, then the tiles."""
    b, n, three_hd = qkv.shape
    d = three_hd // (3 * heads)
    q, k, v = (t.reshape(b, n, heads, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    cos, sin = cos.to(qkv.dtype).float(), sin.to(qkv.dtype).float()
    q, k = (apply_rope(t.float(), cos, sin).to(qkv.dtype) for t in (q, k))
    return mma_attention_model(q, k, v, mask).transpose(1, 2).reshape(b, n, heads * d)


def _qkv(b, heads, n, d, valid, dtype, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, heads, n, d)).astype(np.float32) for _ in range(3))
    mask = np.arange(n)[None, :] < np.asarray(valid)[:, None]
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v))
    return (q, k, v, mask), (tq, tk, tv, torch.from_numpy(mask))


def _packed(b, n, heads, d, valid, seed=0):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, n, 3 * heads * d)).astype(np.float32)
    mask = np.arange(n)[None, :] < np.asarray(valid)[:, None]
    cos, sin = rope_tables(n, d)
    return qkv, cos, sin, mask


def _valid_err(out, ref, valid, frame_axis):
    """max-abs over each batch row's valid frames."""
    worst = 0.0
    for row, nv in enumerate(valid):
        a = np.take(out[row], np.arange(nv), axis=frame_axis - 1)
        r = np.take(ref[row], np.arange(nv), axis=frame_axis - 1)
        worst = max(worst, float(np.abs(a - r).max()))
    return worst


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("n", [40, 64, 200])
def test_model_matches_plain_attention(n, d, dtype):
    """One partial tile, one full tile, three full tiles and a ragged one;
    the second batch row has padded keys."""
    valid = [n, n - n // 3]
    _, (q, k, v, mask) = _qkv(2, 3, n, d, valid, dtype, seed=n + d)
    out = mma_attention_model(q, k, v, mask)
    assert out.dtype == q.dtype
    assert _valid_err(_np(out), _np(attention(q, k, v, mask)), valid, 2) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_takes_no_mask_and_a_fully_padded_later_tile(dtype):
    """Without a mask every key is valid. With keys 64.. all padded the later
    tiles add nothing: p = exp2(-1.44e30 - m) is 0, never NaN."""
    _, (q, k, v, _) = _qkv(2, 2, 200, 64, [200, 200], dtype, seed=5)
    out = mma_attention_model(q, k, v, None)
    assert _valid_err(_np(out), _np(attention(q, k, v, None)), [200, 200], 2) <= TOL[dtype]
    mask = torch.zeros((2, 200), dtype=torch.bool)
    mask[0, :50] = True
    mask[1, :64] = True
    out = mma_attention_model(q, k, v, mask)
    assert torch.isfinite(out).all()
    assert _valid_err(_np(out), _np(attention(q, k, v, mask)), [50, 64], 2) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads,d", [(2, 128), (4, 64)])
@pytest.mark.parametrize("n", [40, 64, 200])
def test_fused_model_matches_plain_version(n, heads, d, dtype):
    valid = [n, n - n // 3]
    qkv, cos, sin, mask = (torch.from_numpy(a) for a in _packed(2, n, heads, d, valid, seed=n))
    qkv = qkv.to(getattr(torch, dtype))
    out = mma_fused_model(qkv, cos, sin, mask, heads)
    ref = fra.fused_qkv_rope_attention_reference(qkv, cos, sin, mask, heads)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert _valid_err(_np(out), _np(ref), valid, 1) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_model_matches_jax_attention(d, dtype):
    """The JAX function rounds the normalized weights to bf16 where the
    model rounds the unnormalized ones; both stay inside the tolerance."""
    valid = [70, 112]
    (q, k, v, mask), tensors = _qkv(2, 3, 112, d, valid, dtype, seed=d)
    ref = jax_attention(*(jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)),
                        jnp.asarray(mask))
    out = mma_attention_model(*tensors)
    assert _valid_err(_np(out), np.asarray(ref.astype(jnp.float32)), valid, 2) <= TOL[dtype]


class _InterpretPallas:
    """``jax.experimental.pallas`` with ``pallas_call`` forced to interpret
    mode, so the TPU kernel body runs on the CPU."""

    def __init__(self, pl):
        self._pl = pl

    def __getattr__(self, name):
        return getattr(self._pl, name)

    def pallas_call(self, *args, **kw):
        return self._pl.pallas_call(*args, interpret=True, **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,heads,n,d", [(2, 4, 128, 32), (1, 2, 96, 64)])
def test_model_matches_pallas_flash_attention(monkeypatch, b, heads, n, d, dtype):
    monkeypatch.setattr(jflash, "pl", _InterpretPallas(jflash.pl))
    valid = [n - 30, n][:b]
    (q, k, v, mask), tensors = _qkv(b, heads, n, d, valid, dtype, seed=n)
    ref = jflash.flash_attention.__wrapped__(
        *(jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)), jnp.asarray(mask))
    out = mma_attention_model(*tensors)
    assert _valid_err(_np(out), np.asarray(ref.astype(jnp.float32)), valid, 2) <= TOL[dtype]


@pytest.mark.parametrize("dtype,tol", [("float32", 5e-3), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("n", [128, 768])
@pytest.mark.parametrize("heads,d", [(2, 128), (4, 64)])
def test_fused_model_matches_pallas_fused_kernel(heads, d, n, dtype, tol):
    """Both head layouts of the TPU kernel at a bucket where block_q divides
    (128) and where it must shrink (768)."""
    valid = [n - 40, n]
    qkv, cos, sin, mask = _packed(2, n, heads, d, valid)
    ref = pallas_fused(jnp.asarray(qkv, getattr(jnp, dtype)), jnp.asarray(cos),
                       jnp.asarray(sin), jnp.asarray(mask), heads=heads, interpret=True)
    out = mma_fused_model(torch.from_numpy(qkv).to(getattr(torch, dtype)),
                          torch.from_numpy(cos), torch.from_numpy(sin),
                          torch.from_numpy(mask), heads)
    assert _valid_err(_np(out), np.asarray(ref.astype(jnp.float32)), valid, 1) < tol


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 32, "wgmma"), (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 96, "simt"),
    (torch.bfloat16, 256, "simt"), (torch.float32, 32, "simt"),
    (torch.float32, 64, "simt"), (torch.float32, 96, "simt"),
    (torch.float32, 128, "simt"), (torch.float32, 256, "simt"),
])
def test_flash_kernel_variant(dtype, d, want):
    assert fa.supports_shape(5, d, 437)
    assert fa.kernel_variant(dtype, d) == want


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.float32, 64, "simt"), (torch.float32, 128, "simt"),
])
def test_fused_kernel_variant(dtype, d, want):
    assert fra.supports_shape(8, d, 437)
    assert fra.kernel_variant(dtype, d) == want


@pytest.mark.parametrize("module,d", [(fa, 48), (fa, 512), (fra, 32), (fra, 96), (fra, 256)])
def test_kernel_variant_refuses_what_the_kernel_does_not_take(module, d):
    assert not module.supports_shape(4, d, 128)
    with pytest.raises(ValueError, match="head_dim"):
        module.kernel_variant(torch.bfloat16, d)
    with pytest.raises(TypeError):
        module.kernel_variant(torch.float16, 64)


def test_bf16_operands_with_unaligned_rows_are_refused_before_any_launch():
    """The tensor-core variant copies 16 bytes at a time: a bf16 operand whose
    frame stride is not a multiple of 8 elements is refused by the wrapper
    (meta tensors reach that check without a card)."""
    q = torch.empty((1, 2, 64, 64), dtype=torch.bfloat16, device="meta")
    odd = torch.empty((1, 2, 64, 68), dtype=torch.bfloat16, device="meta")[..., :64]
    before = fa.launches
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention(q, q, odd, None)
    assert fa.launches == before


@pytest.mark.parametrize("name", [fa.KERNEL, fra.KERNEL])
def test_library_hash_follows_the_tile_step_header(monkeypatch, tmp_path, name):
    """A library's file name carries a hash of its source and of every
    header beside it, so editing attention_mma.cuh rebuilds both kernels."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    before = build.library_path(name)
    assert before == build.library_path(name)
    with open(csrc / "attention_mma.cuh", "a") as f:
        f.write("// edited\n")
    assert build.library_path(name) != before
