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

Head widths. A head of width d up to 256 runs at the tile width that holds
it (:func:`tile_width`), its extra columns zero; a wider one in column
blocks (:func:`wide_columns`), each of which computes the logits anew. Both
restate the layout that ``csrc/attention_strided.cuh:launch_strided`` and
``wide_block_width`` choose.
The model does the same: it pads q, k and v with zero columns and walks the
column blocks, and :func:`rope_pass_model` repeats the first pass of the
fused kernel's two-pass widths (from 256): q and k rotated once, 8-column
chunk c paired with chunk c + d/2, before the tiles.

The float32 variants (``csrc/attention_tf32.cuh``, ``"tf32x3"``) take both
products on the tensor cores in split TF32: every operand split into
hi = TF32(x) and lo = TF32(x − hi), each product as lo·hi + hi·lo + hi·hi.
The wrappers' plain emulations of that arithmetic
(``flash_attention.attention_tf32x3``,
``fused_rope_attention.fused_qkv_rope_attention_tf32x3``, on
``ops.kernels.tf32_split``) are held here against the JAX function, both
Pallas kernels in interpret mode and the JAX sampler (float32 max-abs
1e-5 per call: the split leaves ~2⁻²¹ per product; the sampled latent
within the 1e-3 of ``test_torch_slice.py``'s latent test).

Also here: which variant serves which (dtype, head_dim), and that a change
to the tile-step header rebuilds the libraries.
"""

import math
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vietvoice_tts_tpu.models.dit import _pallas_supports
from vietvoice_tts_tpu.ops.attention import attention as jax_attention
from vietvoice_tts_tpu.ops.pallas import flash_attention as jflash
from vietvoice_tts_tpu.ops.pallas.fused_rope_attention import (
    fused_qkv_rope_attention as pallas_fused,
)
from vietvoice_tts_tpu_torch.models import dit as tdit
from vietvoice_tts_tpu_torch.ops.attention import NEG_INF, attention
from vietvoice_tts_tpu_torch.ops.kernels import build, round_tf32, tf32_split, tf32x3_matmul
from vietvoice_tts_tpu_torch.ops.kernels import flash_attention as fa
from vietvoice_tts_tpu_torch.ops.kernels import fused_rope_attention as fra
from vietvoice_tts_tpu_torch.ops.rope import apply_rope, rope_tables

BK = 64  # keys per tile (attention_mma.cuh)
LOG2E = 1.4426950408889634
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
TILE_WIDTHS = (32, 64, 128, 192, 256)  # tile widths of the tile step
WIDE_MAX_COLS = 256  # output columns of a block of the wide kernel, at most


def tile_width(d):
    """The tile width that serves head width d (<= 256): the smallest that
    holds it (``launch_strided``)."""
    return next(w for w in TILE_WIDTHS if w >= d)


def wide_columns(d):
    """(column blocks, block width) of the wide kernel at head width d: the
    fewest blocks of at most 256 output columns, each the narrowest multiple
    of 64 that covers d / blocks (``wide_block_width``)."""
    blocks = -(-d // WIDE_MAX_COLS)
    cols = -(-d // blocks)
    return blocks, -(-cols // 64) * 64


def column_blocks(d):
    """[(first column, width)] of the output blocks the bfloat16 kernels run
    at head width d: one tile up to 256, else the wide kernel's column
    blocks."""
    if d <= 256:
        return [(0, tile_width(d))]
    blocks, width = wide_columns(d)
    return [(j * width, width) for j in range(blocks)]


def mma_attention_model(q, k, v, mask=None):
    """[B, H, N, D] attention with the tensor-core kernels' arithmetic.

    For bfloat16 inputs every rounding of the kernel is repeated; for
    float32 inputs the products are exact float32 and the weights are not
    rounded, so the algorithm alone (tiles, padding, column blocks) is on
    trial; the float32 kernels' split-TF32 products are the emulations'
    (``attention_tf32x3``), tested below. q and k are padded
    with zero columns to the tile width (to whole 64-column atoms in column
    blocks), v to the column blocks' end; each column block walks the keys
    with logits of its own, and the columns past D are cut off."""
    b, heads, n, d = q.shape
    blocks = column_blocks(d)
    contraction = tile_width(d) if d <= 256 else -(-d // 64) * 64
    covered = blocks[-1][0] + blocks[-1][1]
    scale_log2 = float(np.float32(LOG2E) / np.float32(math.sqrt(d)))
    bias = torch.zeros((b, n), dtype=torch.float32)
    if mask is not None:
        bias = bias.masked_fill(~mask, float(np.float32(NEG_INF) * np.float32(LOG2E)))
    qf = torch.nn.functional.pad(q.float(), (0, contraction - d))
    kf = torch.nn.functional.pad(k.float(), (0, contraction - d))
    vf = torch.nn.functional.pad(v.float(), (0, covered - d))
    outs = []
    for c0, width in blocks:
        m = torch.full((b, heads, n), -math.inf)
        l = torch.zeros((b, heads, n))
        o = torch.zeros((b, heads, n, width))
        for k0 in range(0, n, BK):
            kt, vt = kf[:, :, k0:k0 + BK], vf[:, :, k0:k0 + BK, c0:c0 + width]
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
        outs.append(o / l[..., None])
    return torch.cat(outs, dim=-1)[..., :d].to(q.dtype)


def rope_pass_model(qkv, cos, sin, heads):
    """The fused kernel's first pass at its two-pass widths: q and k of every
    head rotated once into [B, H, N, D] each. Each 8-column chunk of the low
    half is paired with the chunk d/2 further on: lo·cos − hi·sin and
    hi·cos + lo·sin, every product and the sum rounded to float32, then once
    to the input type."""
    b, n, three_hd = qkv.shape
    d = three_hd // (3 * heads)
    half = d // 2
    cos = cos.to(qkv.dtype).float()
    sin = sin.to(qkv.dtype).float()
    rotated = []
    for t in qkv.chunk(3, dim=-1)[:2]:
        x = t.reshape(b, n, heads, d).transpose(1, 2).float()
        chunks = []
        for c in range(0, half, 8):
            lo, hi = x[..., c:c + 8], x[..., half + c:half + c + 8]
            cl, ch = cos[:, c:c + 8], cos[:, half + c:half + c + 8]
            sl, sh = sin[:, c:c + 8], sin[:, half + c:half + c + 8]
            chunks.append((lo * cl + (-hi) * sl, hi * ch + lo * sh))
        out = torch.cat([lo for lo, _ in chunks] + [hi for _, hi in chunks], dim=-1)
        rotated.append(out.to(qkv.dtype))
    return rotated


def mma_fused_model(qkv, cos, sin, mask, heads):
    """Packed-QKV RoPE attention with the tensor-core kernel's arithmetic:
    RoPE in float32 rounded once (as the first pass does it where the call
    runs two: bfloat16 from 256, float32 always), 1/sqrt(D) on the logits,
    then the tiles."""
    b, n, three_hd = qkv.shape
    d = three_hd // (3 * heads)
    q, k, v = (t.reshape(b, n, heads, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    if d >= fra.SCRATCH_FROM[qkv.dtype]:
        q, k = rope_pass_model(qkv, cos, sin, heads)
    else:
        cos, sin = cos.to(qkv.dtype).float(), sin.to(qkv.dtype).float()
        q, k = (apply_rope(t.float(), cos, sin).to(qkv.dtype) for t in (q, k))
    out = mma_attention_model(q, k, v, mask)
    return out.transpose(1, 2).reshape(b, n, heads * d)


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
@pytest.mark.parametrize("d", [32, 64, 128, 8, 48, 72, 96, 136, 200, 256, 264, 320, 512])
@pytest.mark.parametrize("n", [40, 64, 200])
def test_model_matches_plain_attention(n, d, dtype):
    """One partial tile, one full tile, three full tiles and a ragged one;
    the second batch row has padded keys. Head widths at a tile width,
    between tile widths (zero columns up to the next) and above 256 (column
    blocks of 192 or 256, the logits once per block)."""
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


@pytest.mark.parametrize("d,want", [
    (8, [(0, 32)]), (72, [(0, 128)]), (96, [(0, 128)]), (200, [(0, 256)]),
    (256, [(0, 256)]), (264, [(0, 192), (192, 192)]), (384, [(0, 192), (192, 192)]),
    (512, [(0, 256), (256, 256)]), (1024, [(0, 256), (256, 256), (512, 256), (768, 256)]),
])
def test_column_blocks_cover_the_head(d, want):
    """csrc/attention_strided.cuh:wide_block_width restated: the fewest blocks
    of at most 256 columns, each a multiple of 64 that covers d / blocks."""
    assert column_blocks(d) == want
    assert column_blocks(d)[-1][0] < d <= sum(w for _, w in column_blocks(d))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [256, 512])
def test_rope_pass_pairs_chunks_as_the_plain_version_rotates(d, dtype):
    """The first pass's chunk pairing (c with c + d/2, 8 columns at a time)
    gives the plain version's rotated q and k bit for bit."""
    heads, n = 2, 40
    qkv, cos, sin, _ = (torch.from_numpy(a) for a in _packed(2, n, heads, d, [n, n], seed=d))
    qkv = qkv.to(getattr(torch, dtype))
    q, k = rope_pass_model(qkv, cos, sin, heads)
    c, s_ = cos.to(qkv.dtype).float(), sin.to(qkv.dtype).float()
    for got, t in zip((q, k), qkv.chunk(3, dim=-1)[:2]):
        x = t.reshape(2, n, heads, d).transpose(1, 2)
        assert torch.equal(got, apply_rope(x.float(), c, s_).to(qkv.dtype))


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
@pytest.mark.parametrize("b,heads,n,d", [
    (2, 4, 128, 32), (1, 2, 96, 64),
    # Widths served since the padded tiles and the wide kernel.
    (1, 2, 96, 48), (1, 2, 128, 72), (1, 2, 96, 96), (1, 1, 64, 256), (1, 1, 64, 320),
])
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
@pytest.mark.parametrize("heads,d", [(2, 128), (4, 64), (2, 256), (1, 384), (1, 512)])
def test_fused_model_matches_pallas_fused_kernel(heads, d, n, dtype, tol):
    """Both head layouts of the TPU kernel at a bucket where block_q divides
    (128) and where it must shrink (768). From 256 the model runs the
    rotation pass, then the tile step at width 256, or two column blocks
    (384: 192 each; 512: 256 each)."""
    valid = [n - 40, n]
    qkv, cos, sin, mask = _packed(2, n, heads, d, valid)
    ref = pallas_fused(jnp.asarray(qkv, getattr(jnp, dtype)), jnp.asarray(cos),
                       jnp.asarray(sin), jnp.asarray(mask), heads=heads, interpret=True)
    out = mma_fused_model(torch.from_numpy(qkv).to(getattr(torch, dtype)),
                          torch.from_numpy(cos), torch.from_numpy(sin),
                          torch.from_numpy(mask), heads)
    assert _valid_err(_np(out), np.asarray(ref.astype(jnp.float32)), valid, 1) < tol


# -- the float32 variants: split TF32 -----------------------------------------


def test_tf32_split_is_the_kernels_rounding():
    """hi is x rounded to TF32 (low 13 bits zero, nearest, ties away from
    zero) and lo the same of x − hi: |x − hi| ≤ 2⁻¹¹|x| and
    |x − hi − lo| ≤ 2⁻²²|x| for normal x, each at most half a last place of
    the subnormal pattern (2⁻¹³⁷) where a part is subnormal.
    Zero stays zero, inf and nan pass through hi (lo is nan), and a value
    that rounds past the largest float becomes inf, as round-to-nearest
    makes it (its lo is then −inf)."""
    rng = np.random.default_rng(0)
    finite = np.concatenate([
        rng.standard_normal(4096) * 10.0 ** rng.integers(-30, 30, 4096),
        [0.0, -0.0, 1.0, -1.0, 1e-40, -3e-39, 2.0 ** -126, 1.5 * 2.0 ** -140, 3.4e38],
        # Ties: the 13 dropped bits exactly 0x1000 round away from zero.
        np.array([0x3F801000, 0xBF801000, 0x3F803000], np.uint32).view(np.float32),
    ]).astype(np.float32)
    x = torch.from_numpy(finite)
    hi, lo = tf32_split(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    x64, hi64, lo64 = (t.double() for t in (x, hi, lo))
    assert ((x64 - hi64).abs() <= torch.clamp(2.0 ** -11 * x64.abs(), min=2.0 ** -137)).all()
    assert ((x64 - hi64 - lo64).abs() <= torch.clamp(2.0 ** -22 * x64.abs(), min=2.0 ** -137)).all()
    bits = x.view(torch.int32)
    assert torch.equal(hi.view(torch.int32)[-3:],
                       torch.tensor([0x3F802000, 0xBF802000 - 2 ** 32, 0x3F804000],
                                    dtype=torch.int32))
    assert torch.equal(hi.view(torch.int32)[bits == 0], bits[bits == 0])
    special = torch.tensor([float("inf"), float("-inf"), float("nan"), 3.4028235e38])
    hi, lo = tf32_split(special)
    assert hi[0] == math.inf and hi[1] == -math.inf and hi[2].isnan() and hi[3] == math.inf
    assert lo[:3].isnan().all() and lo[3] == -math.inf
    assert torch.equal(round_tf32(hi[:2]), hi[:2]) and round_tf32(hi[2:3]).isnan().all()


def test_tf32x3_product_error_is_about_2_to_the_minus_21():
    """The three-product emulation is within 3·2⁻²² Σ|a||b| (plus float32
    summation) of the exact product, and a single TF32 product is not: the
    split is what keeps float32 parity."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((64, 256)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((256, 48)).astype(np.float32))
    exact = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    err = (tf32x3_matmul(a, b).double() - exact).abs()
    assert (err <= (3 * 2.0 ** -22 + 256 * 2.0 ** -24) * scale).all()
    single = (round_tf32(a) @ round_tf32(b)).double()
    assert (single - exact).abs().max() > 100 * err.max()


@pytest.mark.parametrize("d", [32, 64, 72, 96, 128, 256, 512])
def test_emulated_flash_kernel_matches_pallas_flash_attention(monkeypatch, d):
    """The float32 kernel's products (``attention_tf32x3``) against JAX's
    Pallas flash attention in interpret mode and its XLA attention, padded
    keys on one batch row: within 1e-5."""
    monkeypatch.setattr(jflash, "pl", _InterpretPallas(jflash.pl))
    valid = [98, 128]
    (q, k, v, mask), tensors = _qkv(2, 2, 128, d, valid, "float32", seed=d)
    args = [jnp.asarray(a) for a in (q, k, v, mask)]
    out = _np(fa.attention_tf32x3(*tensors))
    for ref in (jflash.flash_attention.__wrapped__(*args), jax_attention(*args)):
        assert _valid_err(out, np.asarray(ref), valid, 2) <= TOL["float32"]


@pytest.mark.parametrize("heads,d", [(4, 64), (2, 128), (1, 256), (1, 512)])
def test_emulated_fused_kernel_matches_pallas_fused_kernel(heads, d):
    """The float32 fused kernel's arithmetic (RoPE as the plain version
    rotates it, then split TF32) against JAX's Pallas fused kernel in
    interpret mode, padded keys on one batch row: within 1e-5."""
    valid = [88, 128]
    qkv, cos, sin, mask = _packed(2, 128, heads, d, valid, seed=d)
    ref = pallas_fused(jnp.asarray(qkv), jnp.asarray(cos), jnp.asarray(sin), jnp.asarray(mask),
                       heads=heads, interpret=True)
    out = fra.fused_qkv_rope_attention_tf32x3(
        *(torch.from_numpy(a) for a in (qkv, cos, sin, mask)), heads)
    assert out.shape == (2, 128, heads * d) and out.dtype == torch.float32
    assert _valid_err(_np(out), np.asarray(ref), valid, 1) <= TOL["float32"]


def test_sampled_latent_with_emulated_attention_matches_jax(tiny_pack_dir, monkeypatch):
    """``tiny_config``'s whole float32 solve with the float32 kernel's
    arithmetic in place of the plain attention (its 4 × 16 heads take kernel
    2's route) against the JAX package's, AdaLN gates opened so that
    attention reaches the latent: within the 1e-3 that holds the plain path
    (``test_torch_slice.py``)."""
    from pathlib import Path

    from conftest import tiny_config
    from test_torch_slice import _batch, _open_gates, pack_tree, port_config  # noqa: F401

    from vietvoice_tts_tpu.runtime.engine_core import EngineCore as JaxEngineCore
    from vietvoice_tts_tpu_torch.runtime import serialization as tser
    from vietvoice_tts_tpu_torch.runtime.engine_core import EngineCore as TorchEngineCore

    pack = Path(tiny_pack_dir) / "vietvoice-tpu-v1"
    params = _open_gates(tser.load_params(pack / "params.msgpack"))
    vocab = len((pack / "vocab.txt").read_text().splitlines())
    calls = []

    def emulated(q, k, v, mask=None, use_kernels=False):
        calls.append(q.shape)
        return fa.attention_tf32x3(q, k, v, mask)

    monkeypatch.setattr(tdit, "attention", emulated)
    jcore = JaxEngineCore(
        tiny_config(model_cache_dir=tiny_pack_dir, transfer_dtype="float32"), params, vocab)
    tcore = TorchEngineCore(port_config(model_cache_dir=tiny_pack_dir), params, vocab)
    wave, ref_len, ids, total_len, x0 = _batch()
    ref = jcore.mel_latent_batch(wave, ref_len, ids, total_len, x0=x0)
    out = tcore.mel_latent_batch(wave, ref_len, ids, total_len, x0=x0)
    assert calls and all(shape[-1] == 16 for shape in calls)
    assert np.abs(ref).max() > 1.0
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=0)


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 32, "wgmma"), (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 96, "wgmma"),
    (torch.bfloat16, 256, "wgmma"), (torch.float32, 32, "tf32x3"),
    (torch.float32, 64, "tf32x3"), (torch.float32, 96, "tf32x3"),
    (torch.float32, 128, "tf32x3"), (torch.float32, 256, "tf32x3"),
    # Refused before the padded tiles and the wide kernel; served since.
    (torch.bfloat16, 48, "wgmma"), (torch.bfloat16, 72, "wgmma"),
    (torch.bfloat16, 320, "wgmma"), (torch.bfloat16, 512, "wgmma"),
    (torch.bfloat16, 8, "wgmma"), (torch.bfloat16, 1024, "wgmma"),
    (torch.float32, 72, "tf32x3"), (torch.float32, 512, "tf32x3"),
])
def test_flash_kernel_variant(dtype, d, want):
    assert fa.supports_shape(5, d, 437)
    assert fa.kernel_variant(dtype, d) == want


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.float32, 64, "tf32x3"), (torch.float32, 128, "tf32x3"),
    # The JAX kernel's D % 128 == 0 widths, served in two passes since.
    (torch.bfloat16, 256, "wgmma"), (torch.bfloat16, 384, "wgmma"),
    (torch.bfloat16, 512, "wgmma"), (torch.bfloat16, 1024, "wgmma"),
    (torch.float32, 256, "tf32x3"), (torch.float32, 512, "tf32x3"),
])
def test_fused_kernel_variant(dtype, d, want):
    assert fra.supports_shape(8, d, 437)
    assert fra.kernel_variant(dtype, d) == want


@pytest.mark.parametrize("module,d", [
    (fra, 32), (fra, 96),
    # Rows of 16 bytes and at most 1024 columns: 36 and 1032 have no kernel.
    (fa, 36), (fa, 1032), (fa, 4), (fa, 1040), (fra, 36), (fra, 1032), (fra, 1152), (fra, 320),
])
def test_kernel_variant_refuses_what_the_kernel_does_not_take(module, d):
    assert not module.supports_shape(4, d, 128)
    with pytest.raises(ValueError, match="head_dim"):
        module.kernel_variant(torch.bfloat16, d)
    with pytest.raises(TypeError):
        module.kernel_variant(torch.float16, 64)


@pytest.mark.parametrize("heads,d,n", [
    (8, 64, 384), (3, 64, 384), (16, 64, 448), (8, 128, 448), (4, 256, 448), (3, 384, 448),
    (2, 512, 448), (1, 1024, 256), (16, 72, 448), (12, 96, 448), (32, 32, 448),
    (4, 320, 448), (2, 1152, 448),
])
def test_fused_kernel_takes_what_the_jax_kernel_takes(heads, d, n):
    """Wherever the JAX fused kernel's supports_shape holds up to head_dim
    1024, the port's does (the port also takes odd heads at 64 and frame
    counts that are no multiple of 8)."""
    if _pallas_supports(heads, d, n) and d <= 1024:
        assert fra.supports_shape(heads, d, n)
    if not fra.supports_shape(heads, d, n):
        assert d > 1024 or not _pallas_supports(heads, d, n)


@pytest.mark.parametrize("dim,heads,want", [
    (1024, 4, "fused_rope_attention"),  # head_dim 256: JAX's fused kernel too
    (1152, 3, "fused_rope_attention"),  # 384
    (1024, 2, "fused_rope_attention"),  # 512
    (1152, 16, "flash_attention"),  # 72, DiT-XL/2's heads: JAX's XLA route
    (1152, 12, "flash_attention"),  # 96
    (1024, 8, "fused_rope_attention"),  # the default model
])
def test_dit_picks_the_route_jax_picks(dim, heads, want):
    """DiT.attention_kernel names kernel 1 exactly where JAX's DiT runs its
    fused kernel (``_pallas_supports``) at the serving buckets."""
    dit = tdit.DiT.__new__(tdit.DiT)
    dit.cfg = tdit.DiTConfig(dim=dim, heads=heads, use_kernels=True)
    for n in (384, 448, 2048):
        assert dit.attention_kernel(n) == want
        assert (want == "fused_rope_attention") == _pallas_supports(heads, dim // heads, n)


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
