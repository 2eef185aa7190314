"""The sampler caches of the PyTorch port against the JAX package.

The CFG cache (``uncond_interval``) and the deep-block cache
(``deep_cache_interval`` / ``deep_cache_blocks``) are approximations of the
exact solve, so both packages must make the *same* approximation: with
opened AdaLN gates and one shared ``x0`` the port's cached sampler must
match JAX's, float32 max-abs ≤ 1e-4 (both sides true float32 on the CPU).
JAX pads the eval count to whole segments with dt = 0 steps; the port's
eager loop has none, which these comparisons (7 evals, intervals 2 and 3)
also hold. The zero-gate bit-exact test of
``tests/test_sampler_deep_cache.py`` is carried over.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_config
from test_torch_slice import _batch, _open_gates, port_config

import vietvoice_tts_tpu_torch as vt
from vietvoice_tts_tpu.models import dit as jdit
from vietvoice_tts_tpu.models import sampler as jsampler
from vietvoice_tts_tpu.runtime.engine_core import EngineCore as JaxEngineCore
from vietvoice_tts_tpu_torch.models import dit as tdit
from vietvoice_tts_tpu_torch.models.params import dit_state
from vietvoice_tts_tpu_torch.models.sampler import SamplerConfig, flow_matching_sample
from vietvoice_tts_tpu_torch.runtime import serialization as tser
from vietvoice_tts_tpu_torch.runtime.engine_core import EngineCore as TorchEngineCore

ATOL = 1e-4
# 2 heads × 32: the port's split-heads route (and JAX's XLA route).
DIMS = dict(dim=64, depth=4, heads=2, ff_mult=2, n_mels=16, text_dim=32,
            text_conv_layers=1, vocab_size=32)
JCFG = jdit.DiTConfig(**DIMS, compute_dtype=jnp.float32)


def _params(seed=0, live_blocks=None):
    """JAX-layout params with the AdaLN gates opened on ``live_blocks``
    (None = all blocks, plus the final modulation)."""
    params = jdit.init_dit_params(seed, JCFG)
    rng = np.random.default_rng(seed + 100)
    ada = params["blocks"]["ada"]
    w = rng.normal(0.0, 0.05, ada["w"].shape).astype(np.float32)
    b = rng.normal(0.0, 0.05, ada["b"].shape).astype(np.float32)
    if live_blocks is not None:
        keep = np.zeros(DIMS["depth"], bool)
        keep[list(live_blocks)] = True
        w[~keep] = 0.0
        b[~keep] = 0.0
    ada["w"], ada["b"] = w, b
    return params


def _port_dit(params):
    dit = tdit.DiT(tdit.DiTConfig(**DIMS, compute_dtype=torch.float32))
    dit.load_state_dict(dit_state(params, torch.float32), assign=True)
    return dit.eval()


def _inputs(b=2, n=64, seed=0):
    rng = np.random.default_rng(seed)
    cond = rng.standard_normal((b, n, DIMS["n_mels"])).astype(np.float32) * 0.1
    text = np.full((b, n), 3, np.int32)
    text[:, n // 2:] = -1
    mask = np.ones((b, n), bool)
    mask[1, n - 8:] = False
    x0 = rng.standard_normal((b, n, DIMS["n_mels"])).astype(np.float32)
    return cond, text, mask, x0


def _sample_port(dit, scfg, inputs):
    cond, text, mask, x0 = (torch.from_numpy(a) for a in inputs)
    with torch.no_grad():
        return flow_matching_sample(dit, scfg, cond, text.long(), mask, [0, 1], x0=x0).numpy()


def _sample_jax(params, cache, inputs, nfe_step=8):
    cond, text, mask, x0 = inputs
    scfg = jsampler.SamplerConfig(nfe_step=nfe_step, cfg_strength=2.0, **cache)
    return np.asarray(jsampler.flow_matching_sample(
        params, JCFG, scfg, jax.random.PRNGKey(0), jnp.asarray(cond), jnp.asarray(text),
        jnp.asarray(mask), jnp.arange(cond.shape[0], dtype=jnp.uint32), x0=jnp.asarray(x0),
    ))


@pytest.mark.parametrize("cache", [
    {"uncond_interval": 2},
    {"uncond_interval": 3},
    {"deep_cache_interval": 2, "deep_cache_blocks": 2},
    {"deep_cache_interval": 3, "deep_cache_blocks": 1},
])
def test_cached_sampler_matches_jax(cache):
    """Gates opened: each cache is an approximation, and the port makes the
    one JAX makes (7 evals, so intervals 2 and 3 both end mid-segment)."""
    params = _params()
    inputs = _inputs()
    ref = _sample_jax(params, cache, inputs)
    exact = _sample_jax(params, {}, inputs)
    dit = _port_dit(params)
    out = _sample_port(dit, SamplerConfig(nfe_step=8, **cache), inputs)
    assert np.abs(ref - exact).max() > 10 * ATOL  # the cache is not a no-op
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        _sample_port(dit, SamplerConfig(nfe_step=8), inputs), exact, atol=ATOL, rtol=0
    )


def test_deep_cache_exact_when_deep_blocks_are_identity():
    """Gates open only on the first j blocks: the deep trunk contributes
    exactly zero, so every interval reproduces the exact solve bit for bit
    (7 evals, r in 2, 3, 4: the last segment is cut short each time)."""
    j = 2
    dit = _port_dit(_params(live_blocks=range(j)))
    inputs = _inputs()
    base = SamplerConfig(nfe_step=8)
    ref = _sample_port(dit, base, inputs)
    for r in (2, 3, 4):
        scfg = dataclasses.replace(base, deep_cache_interval=r, deep_cache_blocks=j)
        np.testing.assert_array_equal(_sample_port(dit, scfg, inputs), ref, err_msg=f"r={r}")


def test_deep_cache_interval_two_is_close_but_not_identical():
    dit = _port_dit(_params())
    inputs = _inputs()
    ref = _sample_port(dit, SamplerConfig(nfe_step=8), inputs)
    out = _sample_port(
        dit, SamplerConfig(nfe_step=8, deep_cache_interval=2, deep_cache_blocks=2), inputs
    )
    assert np.isfinite(out).all() and out.shape == ref.shape
    assert not np.array_equal(out, ref)
    assert np.abs(out).max() < 10 * max(np.abs(ref).max(), 1.0)


def test_interval_one_is_the_exact_path():
    dit = _port_dit(_params())
    inputs = _inputs()
    ref = _sample_port(dit, SamplerConfig(nfe_step=6), inputs)
    out = _sample_port(
        dit, SamplerConfig(nfe_step=6, uncond_interval=1, deep_cache_interval=1,
                           deep_cache_blocks=2), inputs
    )
    np.testing.assert_array_equal(out, ref)


def test_cfg_cache_runs_cond_only_evals_at_batch_b(monkeypatch):
    """k = 3 over 7 evals: doubled, cond, cond, doubled, cond, cond, doubled;
    cond-only evals get batch-B inputs and the batch-1 hoisted modulations."""
    dit = _port_dit(_params())
    seen = []
    forward = dit.forward_embedded

    def spy(x, cond, text_emb, t, mask, time_mod=None, **kw):
        seen.append((x.shape[0], cond.shape[0], text_emb.shape[0], t.shape[0],
                     mask.shape[0], time_mod[0].shape[1], time_mod[1].shape[0]))
        return forward(x, cond, text_emb, t, mask, time_mod=time_mod, **kw)

    monkeypatch.setattr(dit, "forward_embedded", spy)
    _sample_port(dit, SamplerConfig(nfe_step=8, uncond_interval=3), _inputs())
    assert [s[0] for s in seen] == [4, 2, 2, 4, 2, 2, 4]
    assert all(len(set(s[:5])) == 1 and s[5:] == (1, 1) for s in seen)


def test_deep_cache_schedule(monkeypatch):
    """r = 2 over 7 evals: record, reuse, record, reuse, ..., record; all at
    the CFG-doubled batch."""
    dit = _port_dit(_params())
    seen = []
    forward = dit.forward_embedded

    def spy(*args, **kw):
        seen.append((args[0].shape[0], kw.get("shallow_blocks"),
                     kw.get("deep_state") is not None, kw.get("return_deep_state", False)))
        return forward(*args, **kw)

    monkeypatch.setattr(dit, "forward_embedded", spy)
    _sample_port(dit, SamplerConfig(nfe_step=8, deep_cache_interval=2, deep_cache_blocks=3),
                 _inputs())
    record, reuse = (4, 3, False, True), (4, 3, True, False)
    assert seen == [record, reuse, record, reuse, record, reuse, record]


def test_mutually_exclusive_caches():
    dit = _port_dit(_params())
    scfg = SamplerConfig(nfe_step=8, uncond_interval=2, deep_cache_interval=2,
                         deep_cache_blocks=2)
    with pytest.raises(ValueError, match="mutually exclusive"):
        _sample_port(dit, scfg, _inputs())
    with pytest.raises(ValueError, match="mutually exclusive"):
        vt.ModelConfig(device="cpu", nfe_uncond_interval=2, nfe_deep_cache_interval=2)
    with pytest.raises(ValueError, match="nfe_deep_cache_blocks"):
        vt.ModelConfig(device="cpu", dit_depth=4, nfe_deep_cache_interval=2,
                       nfe_deep_cache_blocks=9)
    assert vt.ModelConfig(device="cpu", dit_depth=2).nfe_deep_cache_interval == 1


# -- The DiT's deep-state arguments -------------------------------------------------


def _forward_inputs(b=2, n=40, seed=4):
    rng = np.random.default_rng(seed)
    x, cond = (rng.standard_normal((b, n, DIMS["n_mels"])).astype(np.float32) for _ in range(2))
    temb = rng.standard_normal((b, n, DIMS["text_dim"])).astype(np.float32)
    mask = np.arange(n)[None, :] < np.array([n - 9, n])[:, None]
    t = np.array([0.4, 0.4], np.float32)
    return x, cond, temb, t, mask


def test_dit_deep_state_matches_jax():
    """return_deep_state gives the exact output plus h_L − h_j; deep_state
    replays it on another input. Both against JAX, gates opened."""
    params = _params(seed=1)
    dit = _port_dit(params)
    args = _forward_inputs()
    jargs = tuple(jnp.asarray(a) for a in args)
    targs = tuple(torch.from_numpy(a) for a in args)
    ref_out, ref_state = jdit.dit_forward_embedded(
        params, JCFG, *jargs, shallow_blocks=2, return_deep_state=True)
    with torch.no_grad():
        out, state = dit.forward_embedded(*targs, shallow_blocks=2, return_deep_state=True)
        exact = dit.forward_embedded(*targs)
    assert torch.equal(out, exact)  # the record eval is the exact forward
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=ATOL, rtol=0)
    np.testing.assert_allclose(state.numpy(), np.asarray(ref_state), atol=ATOL, rtol=0)
    assert np.abs(np.asarray(ref_state)).max() > 1e-2

    args2 = _forward_inputs(seed=5)
    ref2 = jdit.dit_forward_embedded(
        params, JCFG, *(jnp.asarray(a) for a in args2), shallow_blocks=2, deep_state=ref_state)
    with torch.no_grad():
        out2 = dit.forward_embedded(*(torch.from_numpy(a) for a in args2),
                                    shallow_blocks=2, deep_state=state)
    np.testing.assert_allclose(out2.numpy(), np.asarray(ref2), atol=ATOL, rtol=0)
    for j in (0, DIMS["depth"]):
        with pytest.raises(ValueError, match="shallow_blocks"):
            dit.forward_embedded(*targs, shallow_blocks=j)


# -- Through EngineCore ------------------------------------------------------------


@pytest.mark.parametrize("cache", [
    {"nfe_uncond_interval": 2},
    {"nfe_deep_cache_interval": 2, "nfe_deep_cache_blocks": 1},
])
def test_engine_core_cached_latent_matches_jax(tiny_pack_dir, cache):
    """The whole chunk solve with a cache on, both cores on one pack with
    opened gates and one shared x0 (tolerance of test_torch_slice's exact
    solve: 1e-3 on a latent of several units)."""
    from pathlib import Path

    pack = Path(tiny_pack_dir) / "vietvoice-tpu-v1"
    params = _open_gates(tser.load_params(pack / "params.msgpack"))
    vocab = len((pack / "vocab.txt").read_text().splitlines())
    jcore = JaxEngineCore(
        tiny_config(model_cache_dir=tiny_pack_dir, transfer_dtype="float32", **cache),
        params, vocab,
    )
    tcore = TorchEngineCore(port_config(model_cache_dir=tiny_pack_dir, **cache), params, vocab)
    for key, value in cache.items():
        field = key.removeprefix("nfe_")
        assert getattr(tcore.sampler_cfg, field) == value
    wave, ref_len, ids, total_len, x0 = _batch()
    ref = jcore.mel_latent_batch(wave, ref_len, ids, total_len, x0=x0)
    out = tcore.mel_latent_batch(wave, ref_len, ids, total_len, x0=x0)
    assert np.abs(ref).max() > 1.0
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=0)


def test_api_serves_with_each_cache(tiny_pack_dir):
    for cache in ({"nfe_uncond_interval": 2},
                  {"nfe_deep_cache_interval": 2, "nfe_deep_cache_blocks": 1}):
        with vt.TTSApi(port_config(model_cache_dir=tiny_pack_dir, **cache)) as api:
            wave, _ = api.synthesize("Xin chào")
            assert wave.dtype == np.int16 and len(wave) > 0
