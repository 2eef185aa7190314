"""CUDA kernels of the PyTorch port on the card, against their plain versions.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU: a CUDA
kernel has no CPU mode. The file imports no JAX, so it also runs where JAX is
absent; on such a machine run it without the JAX-importing ``conftest.py``:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

Tolerances: float32 max-abs 1e-4 (both sides true float32, TF32 off) and
F32_EMULATION_TOL against the emulation of the float32 kernels' split-TF32
products, bfloat16 max-abs 1e-2 (about one bf16 ulp of an output below 2).
"""

import ctypes
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from vietvoice_tts_tpu_torch.models import dit as tdit
from vietvoice_tts_tpu_torch.models.params import dit_state
from vietvoice_tts_tpu_torch.models.sampler import SamplerConfig, flow_matching_sample
from vietvoice_tts_tpu_torch.ops.attention import attention
from vietvoice_tts_tpu_torch.ops.kernels import flash_attention as fa
from vietvoice_tts_tpu_torch.ops.kernels import fused_rope_attention as fra
from vietvoice_tts_tpu_torch.ops.kernels import tf32_split, tf32x3_matmul
from vietvoice_tts_tpu_torch.ops.kernels.build import count_sass, load_library
from vietvoice_tts_tpu_torch.ops.rope import rope_tables

pytestmark = pytest.mark.cuda

# The float32 kernels against the plain emulation of their own products
# (attention_tf32x3): the same split, summed in another order and with an
# online softmax, so float32 summation order is all that is left between
# them (up to 1.3e-5 at head_dim 1024 on an H100); five times inside the
# 1e-4 against plain.
F32_EMULATION_TOL = 2e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _attention_inputs(b, n, heads, head_dim, valid, device, dtype, seed=7):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, n, 3 * heads * head_dim)).astype(np.float32)
    mask = np.arange(n)[None, :] < np.asarray(valid)[:, None]
    cos, sin = rope_tables(n, head_dim)
    return (
        torch.from_numpy(qkv).to(device, dtype),
        torch.from_numpy(cos).to(device),
        torch.from_numpy(sin).to(device),
        torch.from_numpy(mask).to(device),
    )


# -- the two wgmma products of attention_mma.cuh, one tile each ---------------


def _probe(product, a, b, out, head_dim):
    fn = load_library("attention_mma_probe").vv_attention_mma_probe
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    err = fn(product, a.data_ptr(), b.data_ptr(), out.data_ptr(), head_dim,
             torch.cuda.current_stream().cuda_stream)
    assert err == 0, f"probe launch failed: CUDA error {err}"
    torch.cuda.synchronize()


@pytest.mark.parametrize("head_dim", [32, 64, 128])
def test_cuda_wgmma_qk_product_single_tile(cuda_device, head_dim):
    """S = Q·Kᵀ of one [64, D] × [64, D] tile: bf16 products are exact in
    float32, so only the summation order differs from torch's (≤ 1e-4 at
    these magnitudes). A wrong descriptor or swizzle permutes or drops terms
    and misses by O(1)."""
    rng = np.random.default_rng(head_dim)
    q, k = (torch.from_numpy(rng.standard_normal((64, head_dim)).astype(np.float32))
            .to(cuda_device, torch.bfloat16) for _ in range(2))
    out = torch.full((64, 64), float("nan"), device=cuda_device)
    _probe(0, q, k, out, head_dim)
    ref = q.float() @ k.float().T
    assert (out - ref).abs().max().item() <= 1e-4


@pytest.mark.parametrize("head_dim", [32, 64, 128])
def test_cuda_wgmma_pv_product_single_tile(cuda_device, head_dim):
    """O = P·V of one tile, P handed over in registers (rounded to bf16) and V
    read MN-major as it lies. Against torch on the same rounded P."""
    rng = np.random.default_rng(100 + head_dim)
    p = torch.from_numpy(rng.random((64, 64)).astype(np.float32)).to(cuda_device)
    v = torch.from_numpy(rng.standard_normal((64, head_dim)).astype(np.float32))
    v = v.to(cuda_device, torch.bfloat16)
    out = torch.full((64, head_dim), float("nan"), device=cuda_device)
    _probe(1, p, v, out, head_dim)
    ref = p.to(torch.bfloat16).float() @ v.float()
    assert (out - ref).abs().max().item() <= 1e-4


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_VARIANT_NAMES = {1: "wgmma", 2: "tf32x3"}


def _c_variant(module, dtype, head_dim):
    """The variant the library's own dispatch takes for (dtype, head_dim)."""
    fn = getattr(load_library(module.KERNEL), f"vv_{module.KERNEL}_variant")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    return _VARIANT_NAMES.get(fn(head_dim, _DTYPE_CODES[dtype]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("module,head_dim", [
    (fa, 32), (fa, 64), (fa, 96), (fa, 128), (fa, 256), (fa, 48),
    (fra, 64), (fra, 128), (fra, 96),
    (fa, 72), (fa, 320), (fa, 1024), (fa, 36), (fa, 1032),
    (fra, 256), (fra, 384), (fra, 512), (fra, 320), (fra, 1152),
])
def test_cuda_wrapper_and_library_choose_the_same_variant(cuda_device, module, head_dim, dtype):
    if module.supports_shape(2, head_dim, 64):
        assert _c_variant(module, dtype, head_dim) == module.kernel_variant(dtype, head_dim)
    else:
        assert _c_variant(module, dtype, head_dim) is None


def test_cuda_bf16_paths_are_on_the_tensor_cores(cuda_device):
    """Both libraries hold HGMMA, the machine instruction behind wgmma."""
    for name in (fra.KERNEL, fa.KERNEL):
        assert count_sass(name, "HGMMA") > 0, name


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("b,n,heads,head_dim", [(2, 512, 8, 128), (2, 512, 16, 64),
                                                (2, 200, 2, 256), (2, 437, 3, 384),
                                                (2, 130, 1, 1024),
                                                (2, 437, 8, 128), (2, 200, 2, 512)])
def test_cuda_kernel_matches_plain(cuda_device, dtype, tol, b, n, heads, head_dim):
    """Against the plain version; in float32 also against the emulation of
    the kernel's split-TF32 products (F32_EMULATION_TOL)."""
    valid = [n - 77, n]
    qkv, cos, sin, mask = _attention_inputs(b, n, heads, head_dim, valid,
                                            cuda_device, dtype)
    want = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
    assert _c_variant(fra, dtype, head_dim) == fra.kernel_variant(dtype, head_dim) == want
    before = fra.launches
    out = fra.fused_qkv_rope_attention(qkv, cos, sin, mask, heads)
    torch.cuda.synchronize()
    assert fra.launches == before + 1
    ref = fra.fused_qkv_rope_attention_reference(qkv, cos, sin, mask, heads)
    emu = (fra.fused_qkv_rope_attention_tf32x3(qkv, cos, sin, mask, heads)
           if dtype == torch.float32 else None)
    for row, v in enumerate(valid):
        err = (out[row, :v].float() - ref[row, :v].float()).abs().max().item()
        assert err <= tol
        if emu is not None:
            assert (out[row, :v] - emu[row, :v]).abs().max().item() <= F32_EMULATION_TOL


def test_cuda_wrapper_raises_on_mixed_devices(cuda_device):
    qkv, cos, sin, mask = _attention_inputs(1, 64, 2, 64, [64], cuda_device,
                                            torch.float32)
    before = fra.launches
    with pytest.raises(ValueError, match="cos"):
        fra.fused_qkv_rope_attention(qkv, cos.cpu(), sin, mask, 2)
    strided = torch.cat([qkv, qkv], dim=-1)[..., : qkv.shape[-1]]
    with pytest.raises(ValueError, match="contiguous"):
        fra.fused_qkv_rope_attention(strided, cos, sin, None, 2)
    assert fra.launches == before


def test_cuda_kernels_refuse_autograd_and_run_under_no_grad(cuda_device):
    """Neither kernel has a backward: with grad enabled and an input that
    requires grad, both wrappers raise rather than return a result with no
    ``grad_fn`` (a trainer would silently lose attention's gradient); under
    ``no_grad`` and ``inference_mode`` they launch. CPU tensors keep
    running the plain versions, which autograd differentiates."""
    qkv, cos, sin, mask = _attention_inputs(1, 64, 2, 64, [64], cuda_device, torch.bfloat16)
    q = qkv[..., :128].reshape(1, 64, 2, 64).transpose(1, 2).contiguous()
    qkv.requires_grad_(True)
    q.requires_grad_(True)
    before = fra.launches, fa.launches
    with pytest.raises(RuntimeError, match="no backward"):
        fra.fused_qkv_rope_attention(qkv, cos, sin, mask, 2)
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_attention(q, q, q, mask)
    assert (fra.launches, fa.launches) == before
    for mode in (torch.no_grad, torch.inference_mode):
        with mode():
            out = fra.fused_qkv_rope_attention(qkv, cos, sin, mask, 2)
            out2 = fa.flash_attention(q, q, q, mask)
        assert out.grad_fn is None and out2.grad_fn is None
    torch.cuda.synchronize()
    assert (fra.launches, fa.launches) == (before[0] + 2, before[1] + 2)
    cpu_qkv = qkv.detach().float().cpu().requires_grad_(True)
    out = fra.fused_qkv_rope_attention(cpu_qkv, cos.cpu(), sin.cpu(), mask.cpu(), 2)
    out.float().sum().backward()
    assert cpu_qkv.grad is not None and fra.launches == before[0] + 2


def test_cuda_wrapper_and_dit_raise_on_unsupported_head_dim(cuda_device):
    """head_dim 96 is not the fused kernel's: its wrapper raises on the card.
    head_dim 36 (rows of 72 bytes, no multiple of 16) has no kernel at all:
    the flash_attention wrapper raises, and so does a DiT built with
    use_kernels; nothing falls back to a plain version."""
    qkv, cos, sin, mask = _attention_inputs(1, 64, 2, 96, [64], cuda_device,
                                            torch.float32)
    before = fra.launches, fa.launches
    with pytest.raises(ValueError, match="head_dim"):
        fra.fused_qkv_rope_attention(qkv, cos, sin, mask, 2)
    q = torch.zeros((1, 2, 64, 36), device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q, None)

    dims = dict(dim=72, depth=1, heads=2, ff_mult=2, n_mels=16, text_dim=32,
                text_conv_layers=1, vocab_size=40)
    tree = tdit.init_dit_params(np.random.default_rng(0), tdit.DiTConfig(**dims))
    dit = tdit.DiT(tdit.DiTConfig(**dims, compute_dtype=torch.float32, use_kernels=True))
    dit.load_state_dict(dit_state(tree, torch.float32), assign=True)
    dit = dit.to(cuda_device).eval()
    b, n = 1, 64
    x = torch.zeros((b, n, 16), device=cuda_device)
    ids = torch.zeros((b, n), dtype=torch.int64, device=cuda_device)
    valid = torch.ones((b, n), dtype=torch.bool, device=cuda_device)
    with torch.inference_mode(), pytest.raises(ValueError, match="head_dim"):
        dit.forward_embedded(x, x, dit.text_embed(ids), torch.zeros(b, device=cuda_device),
                             valid)
    assert (fra.launches, fa.launches) == before


@pytest.mark.parametrize("dim,heads", [(256, 2), (512, 2), (768, 2)])
def test_cuda_dit_forward_runs_kernel_in_every_block(cuda_device, dim, heads):
    """The DiT dispatches to the kernel once per block on CUDA tensors with
    use_kernels (head_dim 128; 256 and 384 in the kernel's two passes, where
    JAX's DiT runs its fused kernel too), and its output matches the plain
    path's (gates opened)."""
    dims = dict(dim=dim, depth=3, heads=heads, ff_mult=2, n_mels=16, text_dim=32,
                text_conv_layers=1, vocab_size=40)
    rng = np.random.default_rng(0)
    tree = tdit.init_dit_params(rng, tdit.DiTConfig(**dims))
    for gates in (tree["blocks"]["ada"], tree["final_ada"]):
        for k in gates:
            gates[k] = rng.normal(0.0, 0.05, gates[k].shape).astype(np.float32)
    state = dit_state(tree, torch.float32)

    b, n = 2, 200
    x, cond = (torch.from_numpy(rng.standard_normal((b, n, 16)).astype(np.float32))
               .to(cuda_device) for _ in range(2))
    ids = torch.from_numpy(rng.integers(-1, 40, (b, n))).to(cuda_device)
    mask = torch.from_numpy(np.arange(n)[None, :] < np.array([150, n])[:, None])
    mask = mask.to(cuda_device)
    t = torch.tensor([0.3, 0.7], device=cuda_device)

    outs, counts = {}, {}
    for use_kernels in (True, False):
        dit = tdit.DiT(tdit.DiTConfig(**dims, compute_dtype=torch.float32,
                                      use_kernels=use_kernels))
        dit.load_state_dict(state, assign=True)
        dit = dit.to(cuda_device).eval()
        before = fra.launches
        with torch.inference_mode():
            outs[use_kernels] = dit.forward_embedded(x, cond, dit.text_embed(ids), t, mask)
        torch.cuda.synchronize()
        counts[use_kernels] = fra.launches - before
    assert counts == {True: dims["depth"], False: 0}
    err = (outs[True] - outs[False]).abs().max().item()
    assert np.isfinite(err) and err <= 1e-4


# -- flash_attention (unpacked q, k, v; the DiT's split-heads route) ----------


def _qkv_inputs(b, heads, n, d, valid, device, dtype, packed, seed=11):
    """q, k, v [B, H, N, D] and mask; with ``packed`` v is a strided view of
    a packed [B, N, 3·H·D] projection, as in the DiT's split-heads route."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(
        rng.standard_normal((b, n, 3 * heads * d)).astype(np.float32)
    ).to(device, dtype)
    q, k, v = (t.reshape(b, n, heads, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    if not packed:
        q, k, v = (t.contiguous() for t in (q, k, v))
    mask = torch.from_numpy(np.arange(n)[None, :] < np.asarray(valid)[:, None]).to(device)
    return q, k, v, mask


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("b,heads,n,d", [(2, 4, 437, 32), (2, 3, 300, 64), (2, 3, 200, 96),
                                         (2, 2, 437, 8), (2, 3, 200, 72), (2, 2, 130, 200),
                                         (2, 2, 200, 264), (2, 2, 437, 520), (2, 1, 130, 1024),
                                         (2, 2, 437, 128), (2, 2, 200, 256), (2, 2, 200, 320),
                                         (2, 2, 200, 512)])
def test_cuda_flash_kernel_matches_plain(cuda_device, dtype, tol, packed, b, heads, n, d):
    """Against the plain version; in float32 also against the emulation of
    the kernel's split-TF32 products (F32_EMULATION_TOL)."""
    valid = [n - 77, n]
    q, k, v, mask = _qkv_inputs(b, heads, n, d, valid, cuda_device, dtype, packed)
    want = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
    assert _c_variant(fa, dtype, d) == fa.kernel_variant(dtype, d) == want
    before = fa.launches
    out = fa.flash_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert out.shape == q.shape and out.dtype == dtype
    # [B, N, H, D] memory order: merging the heads is a free reshape.
    assert out.transpose(1, 2).is_contiguous()
    ref = attention(q, k, v, mask)
    emu = fa.attention_tf32x3(q, k, v, mask) if dtype == torch.float32 else None
    for row, nv in enumerate(valid):
        err = (out[row, :, :nv].float() - ref[row, :, :nv].float()).abs().max().item()
        assert err <= tol
        if emu is not None:
            assert (out[row, :, :nv] - emu[row, :, :nv]).abs().max().item() <= F32_EMULATION_TOL


def test_cuda_flash_kernel_without_mask_and_with_a_fully_padded_row(cuda_device):
    """No mask is all keys valid. A batch row whose keys are all padded gets
    uniform weights (as the plain version gives it) and no NaN anywhere."""
    q, k, v, _ = _qkv_inputs(2, 2, 150, 32, [150, 150], cuda_device, torch.float32, True)
    out = fa.flash_attention(q, k, v, None)
    assert (out - attention(q, k, v, None)).abs().max().item() <= 1e-4
    mask = torch.zeros((2, 150), dtype=torch.bool, device=cuda_device)
    mask[1, :100] = True
    out = fa.flash_attention(q, k, v, mask)
    ref = attention(q, k, v, mask)
    assert torch.isfinite(out).all()
    assert (out[1, :, :100] - ref[1, :, :100]).abs().max().item() <= 1e-4
    assert (out[0] - ref[0]).abs().max().item() <= 1e-4


@pytest.mark.parametrize("d", [32, 64, 128, 72, 256, 320])
def test_cuda_wgmma_flash_kernel_edge_tiles(cuda_device, d):
    """The tensor-core variant on what its tiles make hard: later key tiles
    that are padded throughout (their weights are exactly 0, no NaN), a batch
    row whose keys are all padded (uniform weights, as the plain version
    gives), no mask, a single partial tile, and v as a strided view."""
    q, k, v, _ = _qkv_inputs(2, 2, 200, d, [200, 200], cuda_device, torch.bfloat16, True)
    mask = torch.zeros((2, 200), dtype=torch.bool, device=cuda_device)
    mask[0, :50] = True
    out, ref = fa.flash_attention(q, k, v, mask), attention(q, k, v, mask)
    assert torch.isfinite(out).all()
    assert (out[0, :, :50].float() - ref[0, :, :50].float()).abs().max().item() <= 1e-2
    assert (out[1].float() - ref[1].float()).abs().max().item() <= 1e-2
    out = fa.flash_attention(q, k, v, None)
    assert (out.float() - attention(q, k, v, None).float()).abs().max().item() <= 1e-2
    q, k, v, mask = _qkv_inputs(1, 3, 40, d, [33], cuda_device, torch.bfloat16, True)
    out, ref = fa.flash_attention(q, k, v, mask), attention(q, k, v, mask)
    assert (out[0, :, :33].float() - ref[0, :, :33].float()).abs().max().item() <= 1e-2


def test_cuda_fused_kernel_with_padded_later_tiles(cuda_device):
    qkv, cos, sin, _ = _attention_inputs(2, 200, 2, 128, [200, 200], cuda_device,
                                         torch.bfloat16)
    mask = torch.zeros((2, 200), dtype=torch.bool, device=cuda_device)
    mask[0, :50] = True
    mask[1, :130] = True
    out = fra.fused_qkv_rope_attention(qkv, cos, sin, mask, 2)
    ref = fra.fused_qkv_rope_attention_reference(qkv, cos, sin, mask, 2)
    assert torch.isfinite(out).all()
    for row, nv in enumerate((50, 130)):
        assert (out[row, :nv].float() - ref[row, :nv].float()).abs().max().item() <= 1e-2


def test_cuda_bf16_head_dim_96_runs_the_padded_wgmma_tile(cuda_device):
    """bf16 at head_dim 96 ran on the SIMT pipes until its padded tile
    (width 128) moved it to the tensor cores; it still matches the plain
    version."""
    q, k, v, mask = _qkv_inputs(2, 3, 200, 96, [150, 200], cuda_device, torch.bfloat16, True)
    assert _c_variant(fa, torch.bfloat16, 96) == "wgmma"
    before = fa.launches
    out = fa.flash_attention(q, k, v, mask)
    assert fa.launches == before + 1
    ref = attention(q, k, v, mask)
    for row, nv in enumerate((150, 200)):
        assert (out[row, :, :nv].float() - ref[row, :, :nv].float()).abs().max().item() <= 1e-2


def test_cuda_tf32_split_is_the_emulation_bit_for_bit(cuda_device):
    """The kernels split with ``cvt.rna.tf32.f32`` (probe 4); the emulation
    (``ops.kernels.tf32_split``) with bit arithmetic. Both give the same
    bits for every finite input: random values over the whole exponent
    range, random bit patterns, ties and subnormals."""
    rng = np.random.default_rng(4)
    x = np.concatenate([
        (rng.standard_normal(1 << 18) * 10.0 ** rng.integers(-40, 38, 1 << 18)).astype(np.float32),
        rng.integers(0, 2 ** 32, 1 << 18, dtype=np.uint64).astype(np.uint32).view(np.float32),
        (np.arange(1 << 16, dtype=np.uint32) << 13 | 0x1000).view(np.float32),
        np.array([0.0, -0.0, 1e-40, -1e-45, 3.4028235e38], np.float32)])
    x = x[np.isfinite(x)]
    xt = torch.from_numpy(x).to(cuda_device)
    hi, lo = (torch.empty(xt.shape, dtype=torch.int32, device=cuda_device) for _ in range(2))
    _probe(4, xt, hi, lo, xt.numel())
    want_hi, want_lo = tf32_split(torch.from_numpy(x))
    assert torch.equal(hi.cpu(), want_hi.view(torch.int32))
    assert torch.equal(lo.cpu(), want_lo.view(torch.int32))


@pytest.mark.parametrize("product", ["qk", "pv"])
def test_cuda_tf32_product_single_tile(cuda_device, product):
    """One split-TF32 product of attention_tf32.cuh on one tile (probes 2
    and 3): S = Q·Kᵀ of a 32-column atom, and P·V of 64 keys with V
    transposed and its keys permuted in shared memory, P split in
    registers. Within F32_EMULATION_TOL of the emulation of the same
    products (sums of up to 192 terms of magnitude ~1: a few float32 ulps of
    the result), within 1e-4 of the exact product; a product that dropped a
    term or misread a key would miss both by 1e-3 or more."""
    rng = np.random.default_rng(3)
    if product == "qk":
        a, b = (torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
                .to(cuda_device) for _ in range(2))
        b_mat, out = b.T, torch.full((64, 64), float("nan"), device=cuda_device)
    else:
        a = torch.from_numpy(rng.random((64, 64)).astype(np.float32)).to(cuda_device)
        b = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32)).to(cuda_device)
        b_mat, out = b, torch.full((64, 32), float("nan"), device=cuda_device)
    _probe(2 if product == "qk" else 3, a, b, out, 32)
    exact = (a.double() @ b_mat.double()).float()
    assert (out - tf32x3_matmul(a, b_mat)).abs().max().item() <= F32_EMULATION_TOL
    assert (out - exact).abs().max().item() <= 1e-4


def test_cuda_wgmma_variant_refuses_unaligned_rows(cuda_device):
    """16-byte copies: a bf16 v whose frame stride is not a multiple of 8
    elements is refused by the wrapper, and by the library itself."""
    q, k, v, mask = _qkv_inputs(1, 2, 64, 64, [64], cuda_device, torch.bfloat16, False)
    odd = torch.zeros((1, 2, 64, 68), dtype=torch.bfloat16, device=cuda_device)[..., :64]
    before = fa.launches
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention(q, k, odd, mask)
    assert fa.launches == before
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3], *odd.stride()[:3])
    out = torch.empty((1, 64, 2, 64), dtype=torch.bfloat16, device=cuda_device)
    err = fa._kernel_entry()(q.data_ptr(), k.data_ptr(), odd.data_ptr(), None, out.data_ptr(),
                             strides, 1, 2, 64, 64, 1,
                             torch.cuda.current_stream().cuda_stream)
    assert err == 716  # cudaErrorMisalignedAddress


def test_cuda_flash_wrapper_refusals_and_attention_switch(cuda_device):
    q, k, v, mask = _qkv_inputs(1, 2, 64, 32, [64], cuda_device, torch.float32, False)
    before = fa.launches
    with pytest.raises(ValueError, match="unit stride"):
        fa.flash_attention(q, k, v.transpose(2, 3).contiguous().transpose(2, 3), mask)
    with pytest.raises(ValueError, match="mask"):
        fa.flash_attention(q, k, v, mask.cpu())
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), k.half(), v.half(), mask)
    assert fa.launches == before
    out = attention(q, k, v, mask, use_kernels=True)  # the package's entry
    assert fa.launches == before + 1
    assert (out - attention(q, k, v, mask)).abs().max().item() <= 1e-4


def _gated_dit(dims, device, use_kernels, seed=0):
    rng = np.random.default_rng(seed)
    tree = tdit.init_dit_params(rng, tdit.DiTConfig(**dims))
    for gates in (tree["blocks"]["ada"], tree["final_ada"]):
        for key in gates:
            gates[key] = rng.normal(0.0, 0.05, gates[key].shape).astype(np.float32)
    dit = tdit.DiT(tdit.DiTConfig(**dims, compute_dtype=torch.float32,
                                  use_kernels=use_kernels))
    dit.load_state_dict(dit_state(tree, torch.float32), assign=True)
    return dit.to(device).eval()


@pytest.mark.parametrize("dim,heads", [(64, 2), (288, 3), (640, 2), (144, 2)])
def test_cuda_dit_split_heads_route_runs_flash_kernel(cuda_device, dim, heads):
    """head_dim 32, 96, 320 and 72: the DiT takes the split-heads route, one
    flash_attention launch per block and none of the fused kernel, and
    agrees with the plain path (gates opened)."""
    dims = dict(dim=dim, depth=3, heads=heads, ff_mult=2, n_mels=16, text_dim=32,
                text_conv_layers=1, vocab_size=40)
    rng = np.random.default_rng(1)
    b, n = 2, 200
    x, cond = (torch.from_numpy(rng.standard_normal((b, n, 16)).astype(np.float32))
               .to(cuda_device) for _ in range(2))
    ids = torch.from_numpy(rng.integers(-1, 40, (b, n))).to(cuda_device)
    mask = torch.from_numpy(np.arange(n)[None, :] < np.array([150, n])[:, None])
    mask = mask.to(cuda_device)
    t = torch.tensor([0.3, 0.7], device=cuda_device)
    outs, counts = {}, {}
    for use_kernels in (True, False):
        dit = _gated_dit(dims, cuda_device, use_kernels)
        before = fa.launches, fra.launches
        with torch.inference_mode():
            outs[use_kernels] = dit.forward_embedded(x, cond, dit.text_embed(ids), t, mask)
        torch.cuda.synchronize()
        counts[use_kernels] = (fa.launches - before[0], fra.launches - before[1])
    assert counts == {True: (3, 0), False: (0, 0)}
    err = (outs[True] - outs[False]).abs().max().item()
    assert np.isfinite(err) and err <= 1e-4


@pytest.mark.parametrize("cache,want", [
    ({}, 7 * 4),
    ({"uncond_interval": 2}, 7 * 4),  # 4 doubled + 3 cond-only evals
    ({"deep_cache_interval": 2, "deep_cache_blocks": 1}, 4 * 4 + 3 * 1),
])
def test_cuda_sampler_cache_launch_counts(cuda_device, cache, want):
    """8 grid points = 7 evals of a 4-block DiT; each cache launches the
    kernel as often as its schedule says and agrees with its plain run."""
    dims = dict(dim=64, depth=4, heads=2, ff_mult=2, n_mels=16, text_dim=32,
                text_conv_layers=1, vocab_size=40)
    rng = np.random.default_rng(2)
    b, n = 2, 96
    cond, x0 = (torch.from_numpy(rng.standard_normal((b, n, 16)).astype(np.float32))
                .to(cuda_device) for _ in range(2))
    ids = torch.from_numpy(rng.integers(-1, 40, (b, n))).to(cuda_device)
    mask = torch.from_numpy(np.arange(n)[None, :] < np.array([70, n])[:, None])
    mask = mask.to(cuda_device)
    scfg = SamplerConfig(nfe_step=8, **cache)
    outs = {}
    for use_kernels in (True, False):
        dit = _gated_dit(dims, cuda_device, use_kernels)
        before = fa.launches
        with torch.inference_mode():
            outs[use_kernels] = flow_matching_sample(dit, scfg, cond, ids, mask, [0, 1], x0=x0)
        torch.cuda.synchronize()
        assert fa.launches - before == (want if use_kernels else 0)
    assert torch.isfinite(outs[True]).all()
    assert (outs[True] - outs[False]).abs().max().item() <= 1e-3


def _tiny_cuda_config(cache_dir, **kw):
    import vietvoice_tts_tpu_torch as vt

    return vt.ModelConfig(
        device="cuda", dit_dim=64, dit_depth=2, dit_heads=2, text_dim=32,
        text_conv_layers=1, vocoder_dim=64, vocoder_intermediate_dim=128,
        vocoder_num_layers=2, nfe_step=4, frame_buckets=(256, 512),
        max_batch_size=4, compute_dtype="float32", model_cache_dir=str(cache_dir), **kw
    )


def test_cuda_streaming_matches_blocking(cuda_device, tmp_path):
    """Streaming runs each chunk as a batch of one, blocking as one batch per
    bucket, and cuBLAS may sum in another order at another batch size. In
    float32 with TF32 off that moves a sample across an int16 truncation
    step here and there, and the cross-fade's RMS matching (ratio up to 1.5)
    scales the step: at most 4 of 32767 (2 measured on an H100)."""
    import vietvoice_tts_tpu_torch as vt

    text = " ".join(f"Câu số {i} trong đoạn văn dài." for i in range(60))
    with vt.TTSApi(_tiny_cuda_config(tmp_path)) as api:
        wave, _ = api.synthesize(text)
        pieces = list(api.synthesize_streaming(text))
    assert len(pieces) >= 2 and all(p.dtype == np.int16 for p in pieces)
    stream = np.concatenate(pieces)
    assert stream.shape == wave.shape
    diff = np.abs(stream.astype(np.int32) - wave.astype(np.int32))
    assert diff.max() <= 4, f"largest sample difference {diff.max()}, mean {diff.mean():.4f}"


def test_cuda_deterministic_setup_gives_identical_audio(cuda_device, tmp_path):
    """A fresh process with setup_deterministic_tts (strict mode: an
    operation without a deterministic implementation would raise)
    synthesizes the same audio twice."""
    code = textwrap.dedent(
        f"""
        import numpy as np
        import vietvoice_tts_tpu_torch as vt
        vt.setup_deterministic_tts()
        cfg = vt.ModelConfig(
            device="cuda", dit_dim=64, dit_depth=2, dit_heads=2, text_dim=32,
            text_conv_layers=1, vocoder_dim=64, vocoder_intermediate_dim=128,
            vocoder_num_layers=2, nfe_step=4, frame_buckets=(256, 512),
            model_cache_dir={str(tmp_path)!r},
        )
        api = vt.TTSApi(cfg)
        a, _ = api.synthesize("Xin chào, hôm nay trời rất đẹp.")
        b, _ = api.synthesize("Xin chào, hôm nay trời rất đẹp.")
        assert a.size and np.array_equal(a, b)
        print("OK", a.size)
        """
    )
    repo = Path(__file__).resolve().parent.parent
    env = {**os.environ, "VIETVOICE_LOG_LEVEL": "WARNING"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK")


# -- concurrent serving: the micro-batcher, memory statistics, the REST app -----


def test_cuda_eight_threads_through_the_batcher_match_solo(cuda_device, tmp_path):
    """Eight client threads share device batches. Per-row seeds make a row's
    noise independent of its batchmates; cuBLAS may sum in another order at
    another batch size, which in float32 with TF32 off moves a sample across
    an int16 truncation step here and there: at most 2 of 32767 against the
    same request run alone. Every dispatched batch launches the attention
    kernel once per block and per DiT evaluation."""
    import threading

    import vietvoice_tts_tpu_torch as vt

    texts = [f"Xin chào, đây là câu số {i}." for i in range(8)]
    cfg = dataclasses.replace(_tiny_cuda_config(tmp_path), max_batch_size=8)
    with vt.TTSApi(cfg) as api:
        solo = {t: api.synthesize(t)[0] for t in texts}
        batcher = api.engine.enable_micro_batching(max_wait_ms=50)
        api.engine.warmup(buckets=(256,))
        torch.cuda.synchronize()
        start = threading.Barrier(len(texts))
        got, errors = {}, []

        def client(text):
            try:
                start.wait(timeout=60)
                got[text] = api.synthesize(text)[0]
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)

        before = fa.launches
        threads = [threading.Thread(target=client, args=(t,)) for t in texts]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        torch.cuda.synchronize()
        launched = fa.launches - before
        stats = batcher.stats
        assert not errors and set(got) == set(texts)
        assert stats.jobs == 8 and stats.failures == 0 and stats.retries == 0
        assert stats.mean_batch_size > 1
        assert launched == stats.batches * cfg.dit_depth * (cfg.nfe_step - 1)
        for t in texts:
            assert got[t].shape == solo[t].shape and np.any(got[t])
            diff = np.abs(got[t].astype(np.int32) - solo[t].astype(np.int32))
            assert diff.max() <= 2, f"{t!r}: largest sample difference {diff.max()}"
    assert not batcher.healthy
    with pytest.raises(RuntimeError):
        batcher.submit(None)


def test_cuda_device_memory_stats(cuda_device):
    from vietvoice_tts_tpu_torch.utils.profiling import device_memory_stats, log_memory

    keep = torch.ones(1 << 20, device=cuda_device)
    stats = device_memory_stats()
    assert stats["bytes_in_use"] >= keep.numel() * 4
    assert stats["peak_bytes_in_use"] >= stats["bytes_in_use"]
    assert stats["bytes_limit"] > stats["bytes_reserved"] >= stats["bytes_in_use"]
    assert 0 < stats["bytes_free"] < stats["bytes_limit"]
    assert device_memory_stats(cuda_device) == device_memory_stats(0)
    assert device_memory_stats("cpu") == {}
    log_memory("test")


def test_cuda_rest_health_reports_cuda(cuda_device, tmp_path):
    pytest.importorskip("pydantic")
    pytest.importorskip("anyio")
    import asyncio
    import importlib

    from vietvoice_tts_tpu_torch.api import tts_engine as te
    from vietvoice_tts_tpu_torch.api.testing import AsyncTestClient

    app_module = importlib.import_module("vietvoice_tts_tpu_torch.api.app")
    old = te._engine_config
    te.reset_engine()
    te._engine_config = _tiny_cuda_config(tmp_path)
    client = AsyncTestClient(app_module.app)
    try:
        async def drive():
            posted = await asyncio.gather(
                *(client.post("/api/v1/synthesize", json={"text": f"Xin chào số {i}."})
                  for i in range(3)))
            return (posted, (await client.get("/api/v1/health")).json(),
                    (await client.get("/api/v1/stats")).json())

        posted, health, stats = asyncio.run(drive())
        assert all(r.status_code == 200 and r.content[:4] == b"RIFF" for r in posted)
        assert health["backend"] == "cuda"
        assert health["device_count"] == torch.cuda.device_count()
        assert health["engine_loaded"] and health["batcher_healthy"]
        assert stats["hbm"]["bytes_in_use"] > 0
        assert stats["batcher"]["jobs"] == 3 and stats["batcher"]["failures"] == 0
    finally:
        te.reset_engine()
        te._engine_config = old


# -- conversion day: a converted F5-shaped pack served through kernel 1 ----------


def test_cuda_converted_pack_serves_through_kernel_1(cuda_device, tmp_path):
    """The F5 fixture at head_dim 64 (dim 128, 2 heads, depth 1, NFE 4):
    preflight names kernel 1, the converter leaves nothing unresolved, and the
    converted pack's mel latent on the card, from the ONNX graphs' own noise,
    is within 1e-4 mel MAE (and allclose at 1e-2) of the numpy evaluator's in
    float32 and within 5e-2 max-abs in bfloat16, with depth × (NFE − 1) = 3
    launches of kernel 1 per solve and none of kernel 2."""
    from vietvoice_tts_tpu_torch.config import ModelConfig
    from vietvoice_tts_tpu_torch.golden import reference_side, torch_side
    from vietvoice_tts_tpu_torch.models.convert import convert_reference_tarball
    from vietvoice_tts_tpu_torch.models.f5_fixture import FixtureSpec, write_fixture_tarball
    from vietvoice_tts_tpu_torch.models.preflight import preflight_report

    spec = FixtureSpec(dim=128, depth=1, heads=2, ff_mult=2, n_mels=20, text_dim=32,
                       text_conv_layers=2, vocab_size=211, voc_dim=48, voc_inter=96,
                       voc_layers=2, nfe_step=4)
    tar, name_map, _ = write_fixture_tarball(tmp_path / "model-bin.pt", spec, seed=3)
    report = preflight_report(tar, name_map=name_map)
    assert report["architecture"]["attention_route"]["kernel"] == 1
    # The probe needs two layers to see a depth, so depth 1 is configured.
    cfg = ModelConfig(device="cpu", dit_dim=128, dit_depth=1, dit_heads=2, n_mels=20,
                      text_dim=32, text_conv_layers=2, vocoder_dim=48,
                      vocoder_intermediate_dim=96, vocoder_num_layers=2)
    pack = tmp_path / "pack"
    conv = convert_reference_tarball(tar, pack, config=cfg, name_map=name_map)
    assert conv["weights"]["unresolved"] == []
    ref = reference_side(str(tar), "xin chào", nfe_step=spec.nfe_step)
    for dtype in ("float32", "bfloat16"):
        before = fra.launches, fa.launches
        rep = torch_side(pack, ref, device="cuda", compute_dtype=dtype)
        torch.cuda.synchronize()
        assert (fra.launches - before[0], fa.launches - before[1]) == (3, 0)
        if dtype == "float32":
            assert rep["allclose"] and rep["mel_mae"] < 1e-4, rep
        else:
            assert rep["mel_max_abs"] <= 5e-2, rep


# -- tensor parallelism: the row-parallel partial product ------------------------


def test_cuda_row_parallel_product_is_float32_from_bf16_inputs(cuda_device):
    """A row-parallel layer's partial (``models/dit.py``), at the default
    model's FFN width split over two ranks: from bfloat16 inputs a float32
    result within 1e-2 of the exact product (a bfloat16 result is off by up
    to half an ulp of outputs near 100, ~0.25); with autograd following,
    the float32 GEMM, whose gradient reaches x."""
    from vietvoice_tts_tpu_torch.models.dit import _float32_product

    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 384, 1024, generator=g).to(cuda_device, torch.bfloat16)
    w = torch.randn(512, 1024, generator=g).to(cuda_device, torch.bfloat16)
    exact = torch.nn.functional.linear(x.double(), w.double())
    with torch.inference_mode():
        got = _float32_product(x, w)
    assert got.dtype == torch.float32 and got.shape == (2, 384, 512)
    assert (got.double() - exact).abs().max().item() <= 1e-2
    xg = x.clone().requires_grad_(True)
    tracked = _float32_product(xg, w)
    tracked.sum().backward()
    assert (tracked.double() - exact).abs().max().item() <= 1e-2
    assert xg.grad is not None and xg.grad.shape == x.shape


# -- the train step as a captured graph -----------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_train_step_replays_equal_eager_steps(cuda_device, dtype):
    """Four train steps as graph replays against four eager steps from the
    same state, at the default widths and 2 layers, AdaLN gates opened, in
    two keys (batch × frames 2 × 256, 2 × 256, 1 × 128, 2 × 256), with a
    learning rate that changes every step (``warmup_steps=2``): the same
    kernels in the same order, so every loss, parameter and Adam moment is
    equal bit for bit. One capture per key; its eager run is that key's
    first step."""
    from vietvoice_tts_tpu_torch.training import train as ttrain

    dcfg = tdit.DiTConfig(depth=2, vocab_size=32)
    tree = tdit.init_dit_params(np.random.default_rng(0), dcfg)
    rng = np.random.default_rng(1)
    for gates in (tree["blocks"]["ada"], tree["final_ada"]):
        for k in gates:
            gates[k] = rng.normal(0.0, 0.01, gates[k].shape).astype(np.float32)
    tcfg = ttrain.TrainConfig(compute_dtype=dtype, warmup_steps=2)
    shapes = [(2, 256), (2, 256), (1, 128), (2, 256)]
    batches = {}
    for b, n in set(shapes):
        mel = rng.standard_normal((b, n, dcfg.n_mels)).astype(np.float32) - 4.0
        ids = rng.integers(-1, dcfg.vocab_size, (b, n)).astype(np.int32)
        batches[b, n] = ttrain.as_tensors(mel, ids, np.array([n, n - 60][:b], np.int32),
                                          cuda_device)

    def run(graphs: bool):
        dit, opt = ttrain.init_train_state(tree, dcfg, tcfg, cuda_device)
        step = ttrain.make_train_step(dcfg, tcfg)
        if not graphs:
            step.graphs = None
        losses = []
        for i, (b, n) in enumerate(shapes):
            draws = ttrain.draw(torch.Generator().manual_seed(i), b, n, dcfg.n_mels, tcfg)
            losses.append(step(dit, opt, draws.to(cuda_device), *batches[b, n]).item())
        return dit, opt, step, losses

    dit_g, opt_g, step_g, losses_g = run(True)
    dit_e, opt_e, step_e, losses_e = run(False)
    assert step_e.graphs is None
    assert (step_g.graphs.captures, step_g.graphs.replays) == (2, 2)
    assert losses_g == losses_e and all(np.isfinite(losses_g))
    assert ttrain.update_count(opt_g) == ttrain.update_count(opt_e) == len(shapes)
    assert all(p.grad is None for p in dit_g.parameters())
    for (name, p), q in zip(dit_g.named_parameters(), dit_e.parameters(), strict=True):
        assert torch.equal(p, q), name
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(opt_g.state[p][k], opt_e.state[q][k]), (name, k)


# -- memset and memcpy nodes of a captured graph rewritten as kernels ----------


def _capture(fn, rewrite: bool):
    """``fn`` captured into a graph kept after capture; with ``rewrite`` its
    memset and memcpy nodes are replaced by kernels
    (``graphs.rewrite_graph``) before instantiation. Returns (graph, nodes
    by type as captured, nodes by type after)."""
    from vietvoice_tts_tpu_torch.runtime import graphs

    graph = torch.cuda.CUDAGraph(keep_graph=True)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.graph(graph, stream=stream):
        fn()
    raw = graph.raw_cuda_graph()
    captured = graphs.graph_node_types(raw)
    rewritten = (graphs.rewrite_graph(raw, torch.device("cuda")) if rewrite
                 else {"memset": 0, "memcpy": 0})
    after = graphs.graph_node_types(raw)
    assert rewritten["memset"] == (captured["memset"] if rewrite else 0)
    assert after["memcpy"] == captured["memcpy"] - rewritten["memcpy"]
    graph.instantiate()
    return graph, captured, after


_DRIVER_MEMSETS = {1: ("cuMemsetD8Async", "cuMemsetD2D8Async", ctypes.c_ubyte),
                   2: ("cuMemsetD16Async", "cuMemsetD2D16Async", ctypes.c_ushort),
                   4: ("cuMemsetD32Async", "cuMemsetD2D32Async", ctypes.c_uint)}


@pytest.mark.parametrize("element_size", [1, 2, 4])
def test_cuda_rewritten_memsets_write_the_same_bytes(cuda_device, element_size):
    """Three memsets queued on the capture stream through the CUDA driver (what
    ``cudaMemsetAsync`` and ``cudaMemset2DAsync`` call) between two kernels:
    a flat one and one of 5 rows with a pitch, both starting off a 16-byte
    boundary and ending off one, and a flat one of 24 MiB (more 16-byte
    chunks than the fill kernel's grid has threads). Captured, they are 3
    memset nodes. Rewritten, the graph holds none and as many nodes; its
    replay equals the captured graph's replay and numpy's fill byte for
    byte."""
    d8, d2d, value_type = _DRIVER_MEMSETS[element_size]
    cuda = ctypes.CDLL("libcuda.so.1")
    value = {1: 0xA7, 2: 0xB2A7, 4: 0xD4C3B2A7}[element_size]
    offset, width, pitch, rows = 3 * element_size, 1001, 4096 + 8 * element_size, 5
    offset2 = offset + 4096  # the 2D memset's first row
    offset3, width3 = offset2 + rows * pitch, (24 << 20) // element_size  # the large one
    start = torch.from_numpy(np.random.default_rng(element_size).integers(
        0, 256, offset3 + (24 << 20) + 16, dtype=np.uint8)).to(cuda_device)
    buf, out = torch.empty_like(start), torch.empty_like(start)

    def program():
        buf.bitwise_xor_(0x5A)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        fn = getattr(cuda, d8)
        fn.argtypes = [ctypes.c_ulonglong, value_type, ctypes.c_size_t, ctypes.c_void_p]
        assert fn(buf.data_ptr() + offset, value, width, stream) == 0
        assert fn(buf.data_ptr() + offset3, value, width3, stream) == 0
        fn = getattr(cuda, d2d)
        fn.argtypes = [ctypes.c_ulonglong, ctypes.c_size_t, value_type, ctypes.c_size_t,
                       ctypes.c_size_t, ctypes.c_void_p]
        assert fn(buf.data_ptr() + offset2, pitch, value, width, rows, stream) == 0
        torch.bitwise_xor(buf, 0x3C, out=out)

    results = []
    for rewrite in (False, True):
        graph, captured, after = _capture(program, rewrite)
        assert captured["memset"] == 3
        if rewrite:
            assert after["memset"] == 0 and after["kernel"] == captured["kernel"] + 3
            assert sum(after.values()) == sum(captured.values())
        buf.copy_(start)
        graph.replay()
        torch.cuda.synchronize()
        results.append(out.cpu().numpy())
    want = start.cpu().numpy() ^ 0x5A
    pattern = np.frombuffer(np.array([value], f"<u{element_size}").tobytes() * width, np.uint8)
    want[offset: offset + pattern.size] = pattern
    for r in range(rows):
        row = offset2 + r * pitch
        want[row: row + pattern.size] = pattern
    want[offset3: offset3 + (24 << 20)] = np.resize(pattern, 24 << 20)
    np.testing.assert_array_equal(results[0], want ^ 0x3C)
    np.testing.assert_array_equal(results[1], results[0])


class _Memcpy2D(ctypes.Structure):
    """The driver's CUDA_MEMCPY2D."""

    _fields_ = [(f"{side}{name}", kind) for side in ("src", "dst") for name, kind in (
        ("XInBytes", ctypes.c_size_t), ("Y", ctypes.c_size_t), ("MemoryType", ctypes.c_int),
        ("Host", ctypes.c_void_p), ("Device", ctypes.c_ulonglong), ("Array", ctypes.c_void_p),
        ("Pitch", ctypes.c_size_t))] + [("WidthInBytes", ctypes.c_size_t),
                                        ("Height", ctypes.c_size_t)]


def test_cuda_rewritten_memcpys_copy_the_same_bytes(cuda_device):
    """Device-to-device copies between two kernels: two flat ones
    (``copy_`` of contiguous slices, one off every word boundary, one on
    16-byte boundaries) and one of 3 rows with pitches and offsets
    (``cuMemcpy2DAsync``), captured as 3 memcpy nodes. Rewritten, the graph
    holds none and as many nodes; its replay equals the captured graph's and
    numpy's copy byte for byte."""
    cuda = ctypes.CDLL("libcuda.so.1")
    rng = np.random.default_rng(11)
    start = torch.from_numpy(rng.integers(0, 256, 3 * 4112, dtype=np.uint8)).to(cuda_device)
    src, dst, out = (torch.empty_like(start) for _ in range(3))
    flat = ((3, 5, 1001), (8192, 4096, 1024))  # (src offset, dst offset, bytes)
    rows = dict(src_x=7, src_y=1, src_pitch=4112, dst_x=1, dst_y=0, dst_pitch=2052,
                width=1000, height=2)

    def program():
        src.bitwise_xor_(0x5A)
        for so, do, n in flat:
            dst[do:do + n].copy_(src[so:so + n])
        copy = _Memcpy2D(
            srcXInBytes=rows["src_x"], srcY=rows["src_y"], srcMemoryType=2,
            srcDevice=src.data_ptr(), srcPitch=rows["src_pitch"], dstXInBytes=rows["dst_x"],
            dstY=rows["dst_y"], dstMemoryType=2, dstDevice=dst.data_ptr() + 6144,
            dstPitch=rows["dst_pitch"], WidthInBytes=rows["width"], Height=rows["height"])
        fn = cuda.cuMemcpy2DAsync_v2
        fn.argtypes = [ctypes.POINTER(_Memcpy2D), ctypes.c_void_p]
        assert fn(ctypes.byref(copy), torch.cuda.current_stream().cuda_stream) == 0
        torch.bitwise_xor(dst, 0x3C, out=out)

    results = []
    for rewrite in (False, True):
        graph, captured, after = _capture(program, rewrite)
        assert captured["memcpy"] == 3
        if rewrite:
            assert after["memcpy"] == 0 and after["kernel"] == captured["kernel"] + 3
            assert sum(after.values()) == sum(captured.values())
        src.copy_(start)
        dst.zero_()
        graph.replay()
        torch.cuda.synchronize()
        results.append(out.cpu().numpy())
    a = start.cpu().numpy() ^ 0x5A
    want = np.zeros_like(a)
    for so, do, n in flat:
        want[do:do + n] = a[so:so + n]
    for r in range(rows["height"]):
        s0 = (rows["src_y"] + r) * rows["src_pitch"] + rows["src_x"]
        d0 = 6144 + (rows["dst_y"] + r) * rows["dst_pitch"] + rows["dst_x"]
        want[d0:d0 + rows["width"]] = a[s0:s0 + rows["width"]]
    np.testing.assert_array_equal(results[0], want ^ 0x3C)
    np.testing.assert_array_equal(results[1], results[0])


def test_cuda_three_outstanding_fetches_of_one_graph(cuda_device, tmp_path):
    """Three batches of one shape (one graph) queued before any is fetched,
    then fetched newest first: each equals its own batch run alone. The
    static output is copied out behind each replay, on the same stream,
    before the next replay overwrites it."""
    import vietvoice_tts_tpu_torch as vt

    with vt.TTSApi(_tiny_cuda_config(tmp_path)) as api:
        engine = api.engine
        core = engine.engine_core
        ref_audio, ref_text = engine.model_session_manager.select_sample()
        ref = engine._load_ref(ref_audio).astype(np.float32) / 32768.0
        (plan,) = engine._plan_chunks(ref, ref_text, "Xin chào, hôm nay trời rất đẹp.")
        wave, ids = engine._chunk_row(plan, ref)
        args = (wave[None], np.array([plan.ref_len]), ids[None], np.array([plan.total_len]))
        alone = [core.synthesize_batch(*args, seed=s) for s in (0, 1, 2)]
        replays = core.graph_replays
        fetches = [core.synthesize_batch_async(*args, seed=s) for s in (0, 1, 2)]
        got = [f() for f in reversed(fetches)][::-1]
        assert core.graph_replays - replays == 3 and core.graph_captures == 1
    assert not np.array_equal(alone[0], alone[1])
    for g, want in zip(got, alone, strict=True):
        np.testing.assert_array_equal(g, want)
