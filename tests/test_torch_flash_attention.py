"""The port's attention (plain version of the ``flash_attention`` CUDA kernel)
and the DiT's split-heads route against the JAX package.

On the CPU the port runs the plain PyTorch version; the JAX side is the XLA
``attention`` and the Pallas kernel ``flash_attention`` in interpret mode.
The JAX function has no ``interpret`` argument, so the test swaps the
module's ``pl`` for a proxy whose ``pallas_call`` adds ``interpret=True`` and
calls the un-jitted function (no jit cache is reused). The CUDA kernel
itself runs only on a card: its tests are in ``test_torch_cuda.py``.

Tolerances: float32 max-abs 1e-5 per attention call (both sides true
float32 on the CPU); bfloat16 max-abs 1e-2, which bounds the one rounding
the port places differently (softmax weights stay float32 for P·V where
JAX rounds them to bf16); DiT forward float32 max-abs 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vietvoice_tts_tpu.models import dit as jdit
from vietvoice_tts_tpu.ops.attention import attention as jax_attention
from vietvoice_tts_tpu.ops.pallas import flash_attention as jflash
from vietvoice_tts_tpu_torch.models import dit as tdit
from vietvoice_tts_tpu_torch.models.params import dit_state
from vietvoice_tts_tpu_torch.ops.attention import attention
from vietvoice_tts_tpu_torch.ops.kernels import flash_attention as fa
from vietvoice_tts_tpu_torch.ops.kernels import fused_rope_attention as fra

TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _inputs(b, heads, n, d, valid=None, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, heads, n, d)).astype(np.float32) for _ in range(3))
    mask = None
    if valid is not None:
        mask = np.arange(n)[None, :] < np.asarray(valid)[:, None]
    return q, k, v, mask


def _port(q, k, v, mask, dtype, **kw):
    tm = None if mask is None else torch.from_numpy(mask)
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v))
    out = attention(tq, tk, tv, tm, **kw)
    assert out.dtype == getattr(torch, dtype)
    return out.float().numpy()


def _jax_args(q, k, v, mask, dtype):
    jm = None if mask is None else jnp.asarray(mask)
    return (*(jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)), jm)


def _valid_err(out, ref, valid):
    n = out.shape[2]
    return max(
        np.abs(out[row, :, :nv] - ref[row, :, :nv]).max()
        for row, nv in enumerate(valid or [n] * out.shape[0])
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_mask", [True, False])
@pytest.mark.parametrize("d", [32, 64, 96])
def test_attention_matches_jax(d, with_mask, dtype):
    valid = [70, 112] if with_mask else None
    q, k, v, mask = _inputs(2, 3, 112, d, valid, seed=d)
    ref = jax_attention(*_jax_args(q, k, v, mask, dtype))
    ref = np.asarray(ref.astype(jnp.float32))
    out = _port(q, k, v, mask, dtype)
    assert out.shape == ref.shape
    assert _valid_err(out, ref, valid) <= TOL[dtype]


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
def test_attention_matches_pallas_kernel_in_interpret_mode(monkeypatch, b, heads, n, d, dtype):
    monkeypatch.setattr(jflash, "pl", _InterpretPallas(jflash.pl))
    valid = [n - 30, n][:b]
    q, k, v, mask = _inputs(b, heads, n, d, valid, seed=n)
    ref = jflash.flash_attention.__wrapped__(*_jax_args(q, k, v, mask, dtype))
    ref = np.asarray(ref.astype(jnp.float32))
    out = _port(q, k, v, mask, dtype)
    assert _valid_err(out, ref, valid) <= TOL[dtype]


def test_wrapper_on_cpu_runs_plain_version_without_counting():
    q, k, v, mask = (torch.from_numpy(a) for a in _inputs(2, 2, 48, 96, [30, 48], seed=3))
    before = fa.launches
    ref = attention(q, k, v, mask)
    assert torch.equal(fa.flash_attention(q, k, v, mask), ref)
    assert torch.equal(attention(q, k, v, mask, use_kernels=True), ref)
    assert torch.equal(fa.flash_attention(q, k, v, mask.to(torch.uint8)), ref)
    assert fa.flash_attention(q, k, v).shape == q.shape
    # Head dims without a kernel run the plain version on CPU tensors too.
    assert fa.flash_attention(q[..., :36], k[..., :36], v[..., :36], mask).shape == (2, 2, 48, 36)
    assert fa.launches == before


def test_supports_shape():
    for d in (32, 64, 96, 128, 256):
        assert fa.supports_shape(5, d, 437)  # any head and frame count
    # Every multiple of 8 up to 1024 since the padded tiles and the wide
    # kernel (16, 48, 80, 192 and 512 were refused before).
    for d in (8, 16, 48, 72, 80, 192, 320, 512, 1024):
        assert fa.supports_shape(4, d, 128)
    for d in (4, 36, 100, 1032, 1040):
        assert not fa.supports_shape(4, d, 128)
    assert not fa.supports_shape(4, 32, 0)
    # Every head_dim the fused kernel takes, the split-heads route's takes too.
    for d in range(8, 1025, 8):
        assert not fra.supports_shape(4, d, 128) or fa.supports_shape(4, d, 128)


@pytest.mark.parametrize(
    "change,error",
    [
        (lambda a: {**a, "q": a["q"].half(), "k": a["k"].half(), "v": a["v"].half()}, TypeError),
        (lambda a: {**a, "q": a["q"].long()}, TypeError),
        (lambda a: {**a, "k": a["k"].bfloat16()}, TypeError),
        (lambda a: {**a, "q": a["q"][0]}, ValueError),
        (lambda a: {**a, "v": a["v"][:, :, :-1]}, ValueError),
        (lambda a: {**a, "k": a["k"][..., :-1]}, ValueError),
        (lambda a: {**a, "mask": a["mask"][:, :-1]}, ValueError),
        (lambda a: {**a, "mask": a["mask"].float()}, TypeError),
    ],
)
def test_wrapper_rejects_bad_inputs(change, error):
    q, k, v, mask = (torch.from_numpy(a) for a in _inputs(2, 2, 32, 32, [20, 32]))
    args = change({"q": q, "k": k, "v": v, "mask": mask})
    with pytest.raises(error):
        fa.flash_attention(args["q"], args["k"], args["v"], args["mask"])


def test_tensors_for_the_kernel_are_held_to_its_shapes():
    """Tensors that would go to the kernel (anything not on the CPU) are
    checked before any launch; meta tensors reach those checks without a
    card (test_torch_cuda.py checks them on one)."""
    before = fa.launches
    q = torch.zeros((1, 2, 32, 36), device="meta")
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q, None)
    with pytest.raises(ValueError, match="head_dim"):
        attention(q, q, q, None, use_kernels=True)  # no quiet plain version
    q = torch.zeros((1, 2, 32, 32), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_attention(q, q, q, None)
    assert fa.launches == before


# -- The DiT's routes ----------------------------------------------------------

DIT_DIMS = dict(depth=2, ff_mult=2, n_mels=16, text_dim=32, text_conv_layers=1, vocab_size=40)


def _dit_pair(dim, heads, use_kernels):
    """(JAX params, JAX cfg, port DiT) with opened AdaLN gates."""
    dims = dict(DIT_DIMS, dim=dim, heads=heads)
    jcfg = jdit.DiTConfig(**dims, compute_dtype=jnp.float32)
    rng = np.random.default_rng(dim + heads)
    params = jdit.init_dit_params(rng, jcfg)
    for tree in (params["blocks"]["ada"], params["final_ada"]):
        for key in tree:
            tree[key] = rng.normal(0.0, 0.05, tree[key].shape).astype(np.float32)
    dit = tdit.DiT(tdit.DiTConfig(**dims, compute_dtype=torch.float32,
                                  use_kernels=use_kernels))
    dit.load_state_dict(dit_state(params, torch.float32), assign=True)
    return params, jcfg, dit.eval()


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("dim,heads", [(64, 2), (192, 3), (192, 2), (64, 4)])
def test_dit_forward_at_heads_the_fused_kernel_rejects(dim, heads, use_kernels):
    """2×32, 2×96 and 4×16 take the port's split-heads route; 3×64 is
    rejected by the JAX gate (odd head count) and taken by the port's fused
    route. With use_kernels the wrappers run their plain versions on CPU
    tensors, so both settings must agree with JAX."""
    params, jcfg, dit = _dit_pair(dim, heads, use_kernels)
    assert not jdit._pallas_supports(heads, dim // heads, 48)
    rng = np.random.default_rng(1)
    b, n = 2, 48
    x, cond = (rng.standard_normal((b, n, 16)).astype(np.float32) for _ in range(2))
    ids = rng.integers(-1, 40, (b, n)).astype(np.int32)
    mask = np.arange(n)[None, :] < np.array([n - 11, n])[:, None]
    t = np.array([0.2, 0.8], np.float32)
    temb = jdit.dit_text_embed(params, jcfg, jnp.asarray(ids))
    ref = np.asarray(jdit.dit_forward_embedded(
        params, jcfg, jnp.asarray(x), jnp.asarray(cond), temb, jnp.asarray(t),
        jnp.asarray(mask),
    ))
    before = fa.launches, fra.launches
    with torch.no_grad():
        out = dit.forward_embedded(
            torch.from_numpy(x), torch.from_numpy(cond), torch.from_numpy(np.array(temb)),
            torch.from_numpy(t), torch.from_numpy(mask),
        ).numpy()
    assert (fa.launches, fra.launches) == before  # no kernel on CPU tensors
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)
    assert (out[0, n - 11:] == 0).all()


@pytest.mark.parametrize("dim,heads,route", [
    (256, 1, "fused_rope_attention"),  # head_dim 256: the fused route, as in JAX
    (144, 2, "flash_attention"),  # head_dim 72: split heads, JAX's XLA route
])
def test_dit_forward_at_the_widths_served_since_the_wide_kernels(dim, heads, route):
    """Head widths the card serves since kernel 1 took JAX's D % 128 == 0
    widths and kernel 2 every multiple of 8: the port's DiT (use_kernels, so
    on CPU tensors the wrappers' plain versions) against the JAX DiT."""
    params, jcfg, dit = _dit_pair(dim, heads, True)
    assert dit.attention_kernel(48) == route
    assert jdit._pallas_supports(heads, dim // heads, 48) == (route == "fused_rope_attention")
    rng = np.random.default_rng(2)
    b, n = 2, 48
    x, cond = (rng.standard_normal((b, n, 16)).astype(np.float32) for _ in range(2))
    ids = rng.integers(-1, 40, (b, n)).astype(np.int32)
    mask = np.arange(n)[None, :] < np.array([n - 11, n])[:, None]
    t = np.array([0.2, 0.8], np.float32)
    temb = jdit.dit_text_embed(params, jcfg, jnp.asarray(ids))
    ref = np.asarray(jdit.dit_forward_embedded(
        params, jcfg, jnp.asarray(x), jnp.asarray(cond), temb, jnp.asarray(t),
        jnp.asarray(mask),
    ))
    with torch.no_grad():
        out = dit.forward_embedded(
            torch.from_numpy(x), torch.from_numpy(cond), torch.from_numpy(np.array(temb)),
            torch.from_numpy(t), torch.from_numpy(mask),
        ).numpy()
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_route_is_picked_from_the_head_shape():
    """The fused route where kernel 1's gate holds, else split heads."""
    calls = []

    def spy(name):
        def attend(qkv, cos, sin, mask, heads):
            calls.append(name)
            return fra.fused_qkv_rope_attention_reference(qkv, cos, sin, mask, heads)
        return attend

    for dim, heads, want in ((128, 2, ["fused"] * 2), (64, 2, [])):
        _, _, dit = _dit_pair(dim, heads, True)
        calls.clear()
        x = torch.zeros((1, 24, 16))
        saved = tdit.fused_qkv_rope_attention
        tdit.fused_qkv_rope_attention = spy("fused")
        try:
            with torch.no_grad():
                dit.forward_embedded(x, x, torch.zeros((1, 24, 32)), torch.zeros(1),
                                     torch.ones((1, 24), dtype=torch.bool))
        finally:
            tdit.fused_qkv_rope_attention = saved
        assert calls == want
