"""Each module of the PyTorch port against the JAX function it replaces.

Small dims, float32 on both sides, inputs from numpy seeds, and parameters
carried from the JAX pytree by ``models/params.py:from_jax_tree``. The
AdaLN gates are opened (random ``ada``/``final_ada``): with the zero-init
gates every block is an identity and attention would not reach the output.
Tolerance: max-abs 1e-4 (both sides true float32 on the CPU).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vietvoice_tts_tpu.models import dit as jdit
from vietvoice_tts_tpu.models import vocoder as jvoc
from vietvoice_tts_tpu.ops.attention import attention as jax_attention
from vietvoice_tts_tpu.ops import rope as jrope
from vietvoice_tts_tpu.ops import stft as jstft
from vietvoice_tts_tpu_torch.models import dit as tdit
from vietvoice_tts_tpu_torch.models import vocoder as tvoc
from vietvoice_tts_tpu_torch.models.params import from_jax_tree
from vietvoice_tts_tpu_torch.ops.attention import attention as torch_attention
from vietvoice_tts_tpu_torch.ops import rope as trope
from vietvoice_tts_tpu_torch.ops import stft as tstft

ATOL = 1e-4
DIMS = dict(dim=64, depth=2, heads=2, ff_mult=2, n_mels=16, text_dim=32,
            text_conv_layers=2, vocab_size=40)
VOC_DIMS = dict(dim=48, intermediate_dim=96, num_layers=2, n_mels=16, n_fft=256,
                hop_length=64)


def _close(a, b, atol=ATOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=0)


@pytest.fixture(scope="module")
def models():
    """(JAX params, JAX cfgs, port DiT, port Vocoder) with opened gates."""
    jcfg = jdit.DiTConfig(**DIMS, compute_dtype=jnp.float32)
    vcfg = jvoc.VocoderConfig(**VOC_DIMS, compute_dtype=jnp.float32)
    rng = np.random.default_rng(0)
    params = {"dit": jdit.init_dit_params(rng, jcfg),
              "vocoder": jvoc.init_vocoder_params(rng, vcfg)}
    ada = params["dit"]["blocks"]["ada"]
    for tree in (ada, params["dit"]["final_ada"]):
        for k in tree:
            tree[k] = rng.normal(0.0, 0.05, tree[k].shape).astype(np.float32)
    dit_state, voc_state = from_jax_tree(params, torch.float32)
    dit = tdit.DiT(tdit.DiTConfig(**DIMS, compute_dtype=torch.float32))
    dit.load_state_dict(dit_state, assign=True)
    voc = tvoc.Vocoder(tvoc.VocoderConfig(**VOC_DIMS))
    voc.load_state_dict(voc_state, assign=True)
    return params, jcfg, vcfg, dit.eval(), voc.eval()


def _seq_inputs(b=2, n=48, n_mels=16, vocab=40, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, n_mels)).astype(np.float32)
    cond = rng.standard_normal((b, n, n_mels)).astype(np.float32)
    ids = rng.integers(-1, vocab + 3, (b, n)).astype(np.int32)  # incl. pad, OOV
    mask = np.arange(n)[None, :] < np.array([n - 11, n])[:, None]
    t = rng.uniform(0.0, 1.0, (b,)).astype(np.float32)
    return x, cond, ids, mask, t


class TestOps:
    def test_rope_tables_identical(self):
        for n, d in ((48, 16), (437, 128), (512, 64)):
            for ours, ref in zip(trope.rope_tables(n, d), jrope.rope_tables(n, d)):
                assert np.array_equal(ours, ref)

    def test_apply_rope(self):
        rng = np.random.default_rng(2)
        x = rng.standard_normal((2, 3, 48, 16)).astype(np.float32)
        cos, sin = jrope.rope_tables(48, 16)
        ref = jrope.apply_rope(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin))
        out = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(cos), torch.from_numpy(sin))
        _close(out, ref, atol=1e-6)

    @pytest.mark.parametrize("with_mask", [True, False])
    def test_reference_attention(self, with_mask):
        rng = np.random.default_rng(3)
        q, k, v = (rng.standard_normal((2, 3, 40, 16)).astype(np.float32) for _ in range(3))
        mask = np.arange(40)[None, :] < np.array([25, 40])[:, None]
        jm = jnp.asarray(mask) if with_mask else None
        tm = torch.from_numpy(mask) if with_mask else None
        ref = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm)
        out = torch_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), tm)
        _close(out, ref, atol=1e-5)

    def test_mel_frontend(self):
        rng = np.random.default_rng(4)
        wave = (0.3 * rng.standard_normal((2, 40 * 256))).astype(np.float32)
        ref = jstft.MelFrontend()(jnp.asarray(wave))
        out = tstft.MelFrontend()(torch.from_numpy(wave))
        assert out.shape == (2, 40, 100)
        _close(out, ref)

    @pytest.mark.parametrize("k", [7, 31])
    def test_depthwise_conv_same_padding(self, k):
        rng = np.random.default_rng(5)
        x = rng.standard_normal((2, 40, 12)).astype(np.float32)
        w = rng.standard_normal((k, 1, 12)).astype(np.float32)
        b = rng.standard_normal((12,)).astype(np.float32)
        ref = jvoc._dwconv({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x))
        out = tdit.dwconv(torch.from_numpy(x), torch.from_numpy(w.transpose(2, 1, 0).copy()),
                          torch.from_numpy(b))
        _close(out, ref, atol=1e-5)


class TestDiT:
    def test_text_embed(self, models):
        params, jcfg, _, dit, _ = models
        _, _, ids, _, _ = _seq_inputs()
        ref = jdit.dit_text_embed(params["dit"], jcfg, jnp.asarray(ids))
        with torch.no_grad():
            out = dit.text_embed(torch.from_numpy(ids))
        _close(out, ref)

    def test_time_modulations(self, models):
        params, jcfg, _, dit, _ = models
        t = np.linspace(0.0, 1.0, 7, dtype=np.float32)
        mods, fmod = jdit.dit_time_modulations(params["dit"], jcfg, jnp.asarray(t))
        with torch.no_grad():
            tmods, tfmod = dit.time_modulations(torch.from_numpy(t))
        _close(tmods, mods)
        _close(tfmod, fmod)

    @pytest.mark.parametrize("hoisted", [False, True])
    def test_forward_embedded(self, models, hoisted):
        params, jcfg, _, dit, _ = models
        x, cond, ids, mask, t = _seq_inputs()
        temb = jdit.dit_text_embed(params["dit"], jcfg, jnp.asarray(ids))
        jmod = tmod = None
        if hoisted:  # the sampler's form: one t for every row, B' = 1
            t = np.full_like(t, 0.3)
            mods, fmod = jdit.dit_time_modulations(params["dit"], jcfg, jnp.asarray(t[:1]))
            jmod = (jnp.moveaxis(mods, 0, 1), fmod)
            tmod = (torch.from_numpy(np.array(jmod[0])), torch.from_numpy(np.array(fmod)))
        ref = jdit.dit_forward_embedded(
            params["dit"], jcfg, jnp.asarray(x), jnp.asarray(cond), temb,
            jnp.asarray(t), jnp.asarray(mask), time_mod=jmod,
        )
        with torch.no_grad():
            out = dit.forward_embedded(
                torch.from_numpy(x), torch.from_numpy(cond),
                torch.from_numpy(np.array(temb)), torch.from_numpy(t),
                torch.from_numpy(mask), time_mod=tmod,
            )
        assert np.abs(np.asarray(ref)).max() > 0.1  # the solve is not trivial
        _close(out, ref)
        assert (out[0, 37:] == 0).all()  # masked frames are exactly zero


class TestVocoder:
    def test_vocoder_forward(self, models):
        params, _, vcfg, _, voc = models
        mel = np.random.default_rng(6).standard_normal((2, 24, 16)).astype(np.float32)
        ref = jvoc.vocoder_forward(params["vocoder"], vcfg, jnp.asarray(mel))
        with torch.no_grad():
            out = voc(torch.from_numpy(mel))
        assert out.shape == (2, 24 * 64)
        _close(out, ref)

    def test_istft_overlap_add(self):
        rng = np.random.default_rng(7)
        re, im = (rng.standard_normal((2, 20, 129)).astype(np.float32) for _ in range(2))
        ref = jvoc.istft_overlap_add(jnp.asarray(re), jnp.asarray(im), 256, 64)
        out = tvoc.istft_overlap_add(torch.from_numpy(re), torch.from_numpy(im), 256, 64)
        _close(out, ref, atol=1e-5)
        with pytest.raises(ValueError):
            tvoc.istft_overlap_add(torch.from_numpy(re), torch.from_numpy(im), 256, 96)


def test_bf16_dtype_policy(models):
    """Matmul leaves (ada and final_ada included) take the compute dtype; the
    rest stay float32, as the JAX engine places them."""
    params = models[0]
    dit_state, voc_state = from_jax_tree(params, torch.bfloat16)
    bf16 = {k for k, v in {**dit_state, **{f"voc.{k}": v for k, v in voc_state.items()}}.items()
            if v.dtype == torch.bfloat16}
    assert "blocks.0.qkv.weight" in bf16 and "blocks.1.ada.bias" in bf16
    assert {"final_ada.weight", "input_proj.weight", "conv_pos_dw.weight",
            "conv_pos_pw.weight", "text_blocks.0.pw1.weight", "voc.blocks.0.pw2.weight"} <= bf16
    for f32 in ("text_table.weight", "time_mlp1.weight", "final_proj.weight",
                "text_blocks.0.dwconv.weight", "voc.embed.weight", "voc.head.weight",
                "voc.blocks.0.gamma", "voc.blocks.0.dwconv.weight"):
        assert f32 not in bf16


def test_qkv_column_order_kept(models):
    """nn.Linear's [out, in] weight keeps the packed q ‖ k ‖ v output order."""
    params = models[0]
    dit_state, _ = from_jax_tree(params, torch.float32)
    w = params["dit"]["blocks"]["qkv"]["w"][1]  # [in, 3d]
    assert np.array_equal(dit_state["blocks.1.qkv.weight"].numpy(), w.T)
