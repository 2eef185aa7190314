"""The port's trainer (``vietvoice_tts_tpu_torch/training/train.py``) against
the JAX package's, on the CPU at tiny dims.

Both sides start from the same numpy parameter tree. ``jax.random`` cannot
be reproduced in torch, so each test rebuilds the port's ``Draws`` from the
JAX key with the ``jax.random.split(key, 5)`` calls of
``vietvoice_tts_tpu/training/train.py:71-100``. Gradient checks open the
AdaLN gates (random ``ada``/``final_ada``): with the zero-init gates every
block is an identity and attention gets no gradient.

Tolerances, float32 on both sides: loss 1e-6 relative; each gradient leaf
1e-5 × its max-abs, and exactly zero where JAX's is; the schedule and the
clip 1e-6 relative; three AdamW updates on identical gradients 1e-6 × each
leaf's max-abs; five train steps' losses 1e-5 relative. bfloat16 compute
(f32 master weights) against JAX's bfloat16 loss: BF16_LOSS_RTOL.
"""

import dataclasses
import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vietvoice_tts_tpu.models import dit as jdit
from vietvoice_tts_tpu.training import train as jtrain
from vietvoice_tts_tpu_torch.models import dit as tdit
from vietvoice_tts_tpu_torch.models.params import dit_state, to_jax_tree
from vietvoice_tts_tpu_torch.models.sampler import SamplerConfig, flow_matching_sample
from vietvoice_tts_tpu_torch.training import train as ttrain

DIMS = dict(dim=64, depth=2, heads=4, ff_mult=2, n_mels=16, text_dim=32,
            text_conv_layers=1, vocab_size=32)
JCFG = jdit.DiTConfig(**DIMS, compute_dtype=jnp.float32, use_pallas=False)
TCFG = tdit.DiTConfig(**DIMS)  # the trainer sets compute dtype and route
DTYPES = ("float32", "bfloat16")
# |port − JAX| / JAX of the bf16 loss, opened gates: measured 1.1e-4 to
# 3.2e-4 over keys 0-5 on the CPU (both sides round the same matmuls to
# bf16, summing in other orders, and the port keeps f32 softmax weights);
# the bound is about six times that.
BF16_LOSS_RTOL = 2e-3


def _train_cfgs(**kw):
    """The same TrainConfig in both packages."""
    return jtrain.TrainConfig(**kw), ttrain.TrainConfig(**kw)


JTRAIN, TTRAIN = _train_cfgs(warmup_steps=2)


def _batch(b=2, n=64):
    """tests/test_training.py's batch (the second row half valid), with the
    text padded by −1 past each row's length."""
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((b, n, DIMS["n_mels"])).astype(np.float32)
    text = np.full((b, n), 3, np.int32)
    text[:, n // 2:] = -1
    lengths = np.array([n, n // 2], np.int32)[:b]
    return mel, text, lengths


def _tree(open_gates=False, seed=0):
    tree = jdit.init_dit_params(seed, JCFG)
    if open_gates:
        rng = np.random.default_rng(seed + 100)
        for gates in (tree["blocks"]["ada"], tree["final_ada"]):
            for k in gates:
                gates[k] = rng.normal(0.0, 0.05, gates[k].shape).astype(np.float32)
    return tree


def draws_from_key(key, b, n, m, cfg) -> ttrain.Draws:
    """The JAX loss's draws, in its split order (k_t, k_x0, k_span, k_frac,
    k_drop), as the port's Draws."""
    k_t, k_x0, k_span, k_frac, k_drop = jax.random.split(key, 5)
    arrays = (
        jax.random.uniform(k_t, (b,), jnp.float32),
        jax.random.normal(k_x0, (b, n, m), jnp.float32),
        jax.random.uniform(k_frac, (b,), jnp.float32, cfg.min_span_frac, cfg.max_span_frac),
        jax.random.uniform(k_span, (b,), jnp.float32),
        jax.random.bernoulli(k_drop, cfg.cfg_dropout, (b,)),
    )
    return ttrain.Draws(*(torch.from_numpy(np.array(a)) for a in arrays))


def _port(tree, compute_dtype="float32", **kw):
    cfg = dataclasses.replace(TTRAIN, compute_dtype=compute_dtype, **kw)
    dit, opt = ttrain.init_train_state(tree, TCFG, cfg, "cpu")
    return dit, opt, cfg


def _port_loss(dit, batch, draws):
    mel, text, lengths = ttrain.as_tensors(*batch, "cpu")
    return ttrain.flow_matching_loss(dit, mel, text, lengths, draws)


def _grads(dit) -> dict:
    return to_jax_tree({n: p.grad for n, p in dit.named_parameters()})


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _assert_leaves_close(ours, ref, rel, zeros_exact=True):
    """Each leaf within rel × its max-abs; JAX's exact zeros exactly zero."""
    ref_leaves = dict((jax.tree_util.keystr(p), np.asarray(v)) for p, v in _leaves(ref))
    our_leaves = dict((jax.tree_util.keystr(p), np.asarray(v)) for p, v in _leaves(ours))
    assert our_leaves.keys() == ref_leaves.keys()
    for name, r in ref_leaves.items():
        o = our_leaves[name]
        assert o.shape == r.shape, name
        scale = float(np.abs(r).max())
        if zeros_exact and scale == 0.0:
            assert not np.any(o), f"{name}: JAX gives exactly 0, the port {np.abs(o).max()}"
            continue
        err = float(np.abs(o - r).max())
        assert err <= rel * scale, f"{name}: {err:.3e} > {rel} × {scale:.3e}"


@pytest.fixture(scope="module")
def jax_step():
    """One compiled JAX train step (f32, JTRAIN) for every test that needs it."""
    return jax.jit(jtrain.make_train_step(JCFG, JTRAIN))


# The JAX loss, compiled once per (DiTConfig, TrainConfig).
jax_loss = jax.jit(jtrain.flow_matching_loss, static_argnums=(1, 6))


def _jax_time_embedding_on_torch_freqs(p, t):
    """The JAX DiT's ``_time_embedding`` (``models/dit.py:221-230``) with
    its frequencies exp(−ln(10⁴)·i/128) taken from torch's ``exp``. XLA's
    float32 ``exp`` on the CPU is one ulp off torch's at 14 of the 128
    (off the correctly rounded value at 15, torch at 3), and the ×1000 time
    scale makes that 1.3e-5 of time_embed.mlp1's gradient: a difference of
    the two libraries' ``exp``, not of the trainer."""
    half = tdit.TIME_FREQ_DIM // 2
    freqs = jnp.asarray(torch.exp(
        -math.log(10000.0) * torch.arange(half, dtype=torch.float32) / half).numpy())
    args = t.astype(jnp.float32)[:, None] * freqs[None, :] * 1000.0
    feats = jnp.concatenate([jnp.cos(args), jnp.sin(args)], axis=-1)
    h = jax.nn.silu(feats @ p["mlp1"]["w"] + p["mlp1"]["b"])
    return h @ p["mlp2"]["w"] + p["mlp2"]["b"]


# -- Loss, its inputs and its gradients -------------------------------------


class TestLossParity:
    @pytest.mark.parametrize("seed", [0, 1, 7])
    def test_loss_matches_jax(self, seed):
        tree, batch = _tree(open_gates=True), _batch()
        key = jax.random.PRNGKey(seed)
        ref = float(jax_loss(tree, JCFG, key, *map(jnp.asarray, batch), JTRAIN))
        dit, _, _ = _port(tree)
        got = _port_loss(dit, batch, draws_from_key(key, 2, 64, 16, TTRAIN)).item()
        assert abs(got - ref) <= 1e-6 * abs(ref), (got, ref)

    @pytest.mark.parametrize("dropout", [0.0, 0.5, 1.0])
    def test_masks_and_cond_match_jax(self, monkeypatch, dropout):
        """What the loss hands the DiT — x_t, cond, text ids, t, mask — is
        what the JAX loss hands ``dit_forward``; spans cover short rows."""
        seen = {}

        def recording_forward(params, cfg, x, cond, text_ids, t, mask):
            seen.update(x=x, cond=cond, text_ids=text_ids, t=t, mask=mask)
            return jnp.zeros_like(x)

        monkeypatch.setattr(jtrain, "dit_forward", recording_forward)
        jcfg, tcfg = _train_cfgs(cfg_dropout=dropout, min_span_frac=0.3)
        mel, text, _ = _batch(b=4)
        lengths = np.array([64, 32, 5, 1], np.int32)
        key = jax.random.PRNGKey(3)
        jtrain.flow_matching_loss({}, JCFG, key, jnp.asarray(mel), jnp.asarray(text),
                                  jnp.asarray(lengths), jcfg)
        draws = draws_from_key(key, 4, 64, 16, tcfg)
        f = ttrain.flow_inputs(*ttrain.as_tensors(mel, text, lengths, "cpu"), draws)
        np.testing.assert_array_equal(f.cond.numpy(), np.asarray(seen["cond"]))
        np.testing.assert_array_equal(f.text_ids.numpy(), np.asarray(seen["text_ids"]))
        np.testing.assert_array_equal(f.valid.numpy(), np.asarray(seen["mask"]))
        np.testing.assert_array_equal(draws.t.numpy(), np.asarray(seen["t"]))
        np.testing.assert_allclose(f.xt.numpy(), np.asarray(seen["x"]), rtol=0, atol=1e-6)
        # The scored span lies inside the valid frames and is never empty
        # on a row longer than one frame at these fractions.
        assert not np.any(f.infill.numpy() & ~f.valid.numpy())
        assert f.infill.numpy()[:3].any(axis=1).all()

    def test_gradients_match_jax(self, monkeypatch):
        """With the time frequencies shared (see
        ``_jax_time_embedding_on_torch_freqs``); the JAX gradient is traced
        here, after the patch."""
        monkeypatch.setattr(jdit, "_time_embedding", _jax_time_embedding_on_torch_freqs)
        tree, batch = _tree(open_gates=True), _batch()
        key = jax.random.PRNGKey(4)
        jax_grad = jax.jit(jax.grad(jtrain.flow_matching_loss), static_argnums=(1, 6))
        ref = jax_grad(tree, JCFG, key, *map(jnp.asarray, batch), JTRAIN)
        dit, _, _ = _port(tree)
        _port_loss(dit, batch, draws_from_key(key, 2, 64, 16, TTRAIN)).backward()
        grads = _grads(dit)
        # Attention is in the checked path: its weights get gradient.
        assert np.abs(grads["blocks"]["qkv"]["w"]).max() > 0
        _assert_leaves_close(grads, jax.tree.map(np.asarray, ref), 1e-5)

    def test_bf16_loss_against_jax_bf16(self):
        tree, batch = _tree(open_gates=True), _batch()
        jcfg = dataclasses.replace(JCFG, compute_dtype=jnp.bfloat16)
        dit, _, _ = _port(tree, compute_dtype="bfloat16")
        for seed in (0, 1, 2):
            key = jax.random.PRNGKey(seed)
            ref = float(jax_loss(tree, jcfg, key, *map(jnp.asarray, batch), JTRAIN))
            got = _port_loss(dit, batch, draws_from_key(key, 2, 64, 16, TTRAIN)).item()
            assert abs(got - ref) <= BF16_LOSS_RTOL * abs(ref), (seed, got, ref)


# -- Optimizer: schedule, clip, AdamW ------------------------------------------


class TestOptimizer:
    @pytest.mark.parametrize("lr,warmup", [(1e-4, 1000), (5e-3, 10), (1e-2, 0)])
    def test_schedule_matches_optax(self, lr, warmup):
        cfg = ttrain.TrainConfig(learning_rate=lr, warmup_steps=warmup)
        sched = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, 1_000_000, lr * 0.1)
        counts = sorted({0, 1, max(warmup - 1, 0), warmup, warmup + 1, 500_000, 10**6, 2 * 10**6})
        for c in counts:
            ref, got = float(sched(c)), ttrain.learning_rate(c, cfg)
            assert abs(got - ref) <= 1e-6 * abs(ref) + 1e-12, (c, got, ref)
        if warmup:
            assert ttrain.learning_rate(0, cfg) == 0.0  # the first update moves nothing

    @pytest.mark.parametrize("scale", [1e-3, 0.5, 3.0, 40.0])
    def test_clip_matches_optax(self, scale):
        """Both sides of max_norm; never the + 1e-6 of clip_grad_norm_."""
        rng = np.random.default_rng(int(scale * 10))
        tree = {k: (rng.standard_normal(s) * scale).astype(np.float32)
                for k, s in (("a", (7, 5)), ("b", (11,)), ("c", (3, 2, 4)))}
        ref, _ = optax.clip_by_global_norm(1.0).update(tree, optax.EmptyState())
        grads = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
        norm = ttrain.clip_by_global_norm(list(grads.values()), 1.0)
        assert abs(norm.item() - float(optax.global_norm(tree))) <= 1e-6 * norm.item()
        for k in tree:
            np.testing.assert_allclose(grads[k].numpy(), np.asarray(ref[k]), rtol=1e-6, atol=0)
        if norm.item() < 1.0:
            for k in tree:
                np.testing.assert_array_equal(grads[k].numpy(), tree[k])

    def test_adamw_updates_match_optax(self):
        """Three updates on identical gradients (one clipped, one not, one
        tiny): parameters and both moments against the optax chain."""
        jcfg, tcfg = _train_cfgs(learning_rate=1e-2, warmup_steps=0, weight_decay=0.01)
        tree = _tree(open_gates=True)
        rng = np.random.default_rng(11)
        grads = [jax.tree.map(lambda x: (rng.standard_normal(x.shape) * s).astype(np.float32), tree)
                 for s in (0.5, 1e-3, 1e-6)]
        optimizer = jtrain.make_optimizer(jcfg)
        params, state = tree, optimizer.init(tree)
        update = jax.jit(optimizer.update)
        dit, opt = ttrain.init_train_state(tree, TCFG, tcfg, "cpu")
        by_name = dict(dit.named_parameters())
        for g in grads:
            updates, state = update(g, state, params)
            params = optax.apply_updates(params, updates)
            for name, t in dit_state(g, torch.float32).items():
                by_name[name].grad = t
            ttrain.apply_update(opt, tcfg)
        adam = state[1][0]
        mu = to_jax_tree({n: opt.state[p]["exp_avg"] for n, p in by_name.items()})
        nu = to_jax_tree({n: opt.state[p]["exp_avg_sq"] for n, p in by_name.items()})
        assert ttrain.update_count(opt) == int(adam.count) == 3
        _assert_leaves_close(to_jax_tree(dit), jax.tree.map(np.asarray, params), 1e-6, False)
        _assert_leaves_close(mu, jax.tree.map(np.asarray, adam.mu), 1e-6, False)
        _assert_leaves_close(nu, jax.tree.map(np.asarray, adam.nu), 1e-6, False)

    def test_one_parameter_group_holds_every_leaf(self):
        dit, opt, _ = _port(_tree())
        assert len(opt.param_groups) == 1
        assert opt.param_groups[0]["weight_decay"] == TTRAIN.weight_decay
        assert {id(p) for p in opt.param_groups[0]["params"]} == {id(p) for p in dit.parameters()}

    def test_train_state_is_built_on_the_card_by_default(self):
        """As ``ModelConfig.device``: a caller who names no device gets the
        card, and without one an error rather than a CPU run."""
        default = inspect.signature(ttrain.init_train_state).parameters["device"].default
        assert default == "cuda"
        if not torch.cuda.is_available():
            with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
                ttrain.init_train_state(_tree(), TCFG, TTRAIN)


# -- Whole steps ---------------------------------------------------------------


class TestSteps:
    def test_five_f32_steps_match_jax(self, jax_step):
        tree, batch = _tree(), _batch()
        params, state = tree, jtrain.init_train_state(tree, JTRAIN)
        dit, opt, cfg = _port(tree)
        step = ttrain.make_train_step(TCFG, cfg)
        tensors = ttrain.as_tensors(*batch, "cpu")
        ref, got = [], []
        for i in range(5):
            key = jax.random.PRNGKey(i)
            params, state, loss = jax_step(params, state, key, *map(jnp.asarray, batch))
            ref.append(float(loss))
            got.append(step(dit, opt, draws_from_key(key, 2, 64, 16, cfg), *tensors).item())
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0)
        assert ttrain.update_count(opt) == 5

    def test_step_refuses_a_dit_built_otherwise(self):
        dit, opt, cfg = _port(_tree())
        step = ttrain.make_train_step(TCFG, dataclasses.replace(cfg, compute_dtype="bfloat16"))
        draws = ttrain.draw(torch.Generator().manual_seed(0), 2, 64, 16, cfg)
        with pytest.raises(ValueError, match="built with"):
            step(dit, opt, draws, *ttrain.as_tensors(*_batch(), "cpu"))

    def test_trainer_builds_the_dit_without_kernels(self):
        dit, _, _ = _port(_tree(), compute_dtype="bfloat16")
        assert dit.cfg.use_kernels is False and dit.cfg.compute_dtype == torch.bfloat16
        assert all(p.dtype == torch.float32 and p.requires_grad for p in dit.parameters())

    def test_kernel_wrappers_stay_differentiable_on_cpu(self):
        """On CPU tensors both kernel wrappers run their plain versions,
        which autograd differentiates, and launch nothing."""
        from vietvoice_tts_tpu_torch.ops.kernels import flash_attention as fa
        from vietvoice_tts_tpu_torch.ops.kernels import fused_rope_attention as fra
        from vietvoice_tts_tpu_torch.ops.rope import rope_tables

        before = fra.launches, fa.launches
        rng = np.random.default_rng(5)
        qkv = torch.from_numpy(rng.standard_normal((1, 16, 3 * 2 * 64)).astype(np.float32))
        qkv.requires_grad_(True)
        cos, sin = (torch.from_numpy(t) for t in rope_tables(16, 64))
        fra.fused_qkv_rope_attention(qkv, cos, sin, None, 2).sum().backward()
        q = qkv.detach()[..., :128].reshape(1, 16, 2, 64).transpose(1, 2).requires_grad_(True)
        fa.flash_attention(q, q, q, None).sum().backward()
        assert qkv.grad.abs().max() > 0 and q.grad.abs().max() > 0
        assert (fra.launches, fa.launches) == before

    def test_draw_is_seeded_and_shaped(self):
        a = ttrain.draw(torch.Generator().manual_seed(3), 4, 16, 8, TTRAIN)
        b = ttrain.draw(torch.Generator().manual_seed(3), 4, 16, 8, TTRAIN)
        for f in dataclasses.fields(a):
            assert torch.equal(getattr(a, f.name), getattr(b, f.name))
        assert a.x0.shape == (4, 16, 8) and a.drop.dtype == torch.bool
        assert ((a.frac >= TTRAIN.min_span_frac) & (a.frac < TTRAIN.max_span_frac)).all()


# -- tests/test_training.py carried over to the port, in both dtypes ----------


def _steps(dit, opt, cfg, batch, seeds):
    step = ttrain.make_train_step(TCFG, cfg)
    tensors = ttrain.as_tensors(*batch, "cpu")
    b, n, _ = batch[0].shape
    return [
        step(dit, opt, ttrain.draw(torch.Generator().manual_seed(s), b, n, 16, cfg), *tensors).item()
        for s in seeds
    ]


@pytest.mark.parametrize("dtype", DTYPES)
class TestCarriedOver:
    def test_finite_positive(self, dtype):
        dit, _, cfg = _port(_tree(), dtype)
        loss = _port_loss(dit, _batch(), ttrain.draw(torch.Generator().manual_seed(0), 2, 64, 16, cfg))
        assert np.isfinite(loss.item()) and loss.item() > 0

    def test_gradients_flow(self, dtype):
        """Zero gates at init: the block internals get exactly zero gradient
        (in JAX too); the path into and out of the trunk and the gate
        projections do not."""
        dit, _, cfg = _port(_tree(), dtype)
        _port_loss(dit, _batch(), ttrain.draw(torch.Generator().manual_seed(0), 2, 64, 16, cfg)).backward()
        g = _grads(dit)
        for leaf in (g["final_proj"]["w"], g["input_proj"]["w"], g["text_embed"]["table"],
                     g["blocks"]["ada"]["w"]):
            assert np.abs(leaf).max() > 0
        for key in ("qkv", "attn_out", "ff1", "ff2"):
            assert not np.any(g["blocks"][key]["w"]), key

    def test_gradients_reach_qkv_after_gates_open(self, dtype):
        dit, opt, cfg = _port(_tree(), dtype)
        _steps(dit, opt, cfg, _batch(), range(3))
        opt.zero_grad()
        _port_loss(dit, _batch(), ttrain.draw(torch.Generator().manual_seed(9), 2, 64, 16, cfg)).backward()
        assert np.abs(_grads(dit)["blocks"]["qkv"]["w"]).max() > 0

    def test_draws_change_loss(self, dtype):
        dit, _, cfg = _port(_tree(), dtype)
        l1, l2 = (_port_loss(dit, _batch(), ttrain.draw(torch.Generator().manual_seed(s), 2, 64, 16,
                                                         cfg)).item() for s in (1, 2))
        assert l1 != l2

    def test_loss_decreases_on_repeated_batch(self, dtype):
        dit, opt, cfg = _port(_tree(), dtype)
        losses = _steps(dit, opt, cfg, _batch(), [0] * 12)
        assert losses[-1] < losses[0]

    def test_params_updated(self, dtype):
        dit, opt, cfg = _port(_tree(), dtype)
        before = dit.final_proj.weight.detach().clone()
        _steps(dit, opt, cfg, _batch(), range(3))
        assert not torch.equal(before, dit.final_proj.weight)
        assert all(p.dtype == torch.float32 for p in dit.parameters())
        assert all(s["exp_avg"].dtype == s["exp_avg_sq"].dtype == torch.float32
                   for s in opt.state.values())


# -- Convergence: overfit one batch, then sample it back -----------------------

ODIMS = dict(dim=32, depth=1, heads=2, ff_mult=2, n_mels=8, text_dim=16,
             text_conv_layers=1, vocab_size=16)


def _overfit(steps, compute_dtype):
    """tests/test_training.py::TestConvergence._overfit on the port:
    cfg_dropout 0, fresh draws every step."""
    cfg = ttrain.TrainConfig(learning_rate=5e-3, warmup_steps=10, cfg_dropout=0.0,
                             weight_decay=0.0, compute_dtype=compute_dtype)
    dcfg = tdit.DiTConfig(**ODIMS)
    tree = tdit.init_dit_params(0, dcfg)
    dit, opt = ttrain.init_train_state(tree, dcfg, cfg, "cpu")
    step = ttrain.make_train_step(dcfg, cfg)
    rng = np.random.default_rng(7)
    b, n = 4, 16
    mel = rng.standard_normal((b, n, ODIMS["n_mels"])).astype(np.float32)
    text = rng.integers(0, ODIMS["vocab_size"], (b, n)).astype(np.int32)
    lengths = np.full((b,), n, np.int32)
    tensors = ttrain.as_tensors(mel, text, lengths, "cpu")
    gen = torch.Generator().manual_seed(0)
    losses = [step(dit, opt, ttrain.draw(gen, b, n, ODIMS["n_mels"], cfg), *tensors).item()
              for _ in range(steps)]
    return dit, opt, tree, losses, tensors


@pytest.fixture(scope="module")
def overfit_f32():
    return _overfit(400, "float32")


@pytest.mark.parametrize("dtype,steps,bound", [("float32", 400, 0.1), ("bfloat16", 200, 0.2)])
def test_overfit_one_batch_collapses_loss(overfit_f32, dtype, steps, bound):
    dit, opt, _, losses, _ = overfit_f32 if dtype == "float32" else _overfit(steps, dtype)
    final = float(np.mean(losses[-20:]))  # smooths the per-step draws
    assert np.isfinite(final) and final < bound * losses[0], (losses[0], final)
    assert all(p.dtype == torch.float32 for p in dit.parameters())
    assert all(s["exp_avg"].dtype == torch.float32 for s in opt.state.values())


def test_trained_params_reconstruct_mel_through_sampler(overfit_f32):
    """The port's sampler from the trained weights rebuilds the memorised
    second half far better than from the untrained ones (cfg_strength 0:
    no unconditional branch was trained)."""
    trained, _, tree, _, (mel, text, _) = overfit_f32
    untrained = tdit.DiT(tdit.DiTConfig(**ODIMS, compute_dtype=torch.float32))
    untrained.load_state_dict(dit_state(tree, torch.float32), assign=True)
    b, n, m = mel.shape
    is_ref = torch.arange(n)[None, :] < n // 2
    cond = torch.where(is_ref[..., None], mel, torch.zeros(()))
    mask = torch.ones((b, n), dtype=torch.bool)
    x0 = torch.from_numpy(np.random.default_rng(0).standard_normal((b, n, m)).astype(np.float32))
    scfg = SamplerConfig(nfe_step=32, cfg_strength=0.0)

    def mae(dit):
        with torch.no_grad():
            out = flow_matching_sample(dit.eval(), scfg, cond, text, mask, range(b), x0=x0)
        return (out[:, n // 2:] - mel[:, n // 2:]).abs().mean().item()

    mae_trained, mae_untrained = mae(trained), mae(untrained)
    trained.train()
    assert mae_trained < 0.5 * mae_untrained, (mae_trained, mae_untrained)


# -- models/params.py: to_jax_tree ---------------------------------------------


class TestParamsRoundTrip:
    def test_to_jax_tree_inverts_dit_state_in_f32(self):
        tree = _tree(open_gates=True)
        dit, _, _ = _port(tree)
        back = to_jax_tree(dit)
        assert jax.tree.structure(back) == jax.tree.structure(tree)
        for (path, a), (_, b) in zip(_leaves(back), _leaves(tree)):
            assert a.dtype == np.float32 and a.shape == b.shape, path
            np.testing.assert_array_equal(a, b)
        state = dit_state(back, torch.float32)
        for name, t in dit.state_dict().items():
            assert torch.equal(state[name], t), name

    def test_round_trip_in_bf16_after_the_serving_cast(self):
        tree = _tree(open_gates=True)
        dit = tdit.DiT(dataclasses.replace(TCFG, compute_dtype=torch.bfloat16))
        dit.load_state_dict(dit_state(tree, torch.bfloat16), assign=True)
        again = dit_state(to_jax_tree(dit), torch.bfloat16)
        for name, t in dit.state_dict().items():
            assert again[name].dtype == t.dtype and torch.equal(again[name], t), name

    def test_parameters_are_exactly_the_jax_tree(self):
        """No extra bias and no trained buffer: the global norm, and with it
        the clip, sees the same elements in both packages."""
        tree = _tree()
        dit, _, _ = _port(tree)
        n_jax = sum(np.asarray(leaf).size for leaf in jax.tree.leaves(tree))
        assert sum(p.numel() for p in dit.parameters()) == n_jax
        assert len(list(dit.parameters())) == len(dit.state_dict())
        assert list(dit.buffers()) == []
