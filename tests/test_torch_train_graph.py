"""The port's train step as a captured graph (``training/train.py:TrainStep``),
the counterpart of ``jax.jit(make_train_step(...), donate_argnums=(0, 1))``.

A CUDA graph exists only on the card (``chip_smoke.py`` phase 9 (e) and
``tests/test_torch_cuda.py`` hold replays against eager steps there, bit for
bit). Here the graph path is driven through :class:`FakeGraph`, as
``tests/test_torch_graphs.py`` drives the chunk programs' cache: its eager
run runs the step's body, its capture records the body and runs nothing (a
capture executes no kernel), and a replay runs the recorded body again with
the host's update count and schedule out of reach. At ``tiny_config``'s
widths (DiT 64 × 2, 4 heads, 100 mels), float32, AdaLN gates opened, two
keys (batch × frames 2 × 32 and 1 × 48), ``warmup_steps=2`` so that the
learning rate changes every step:

- k graph steps over the two keys make k updates and equal k eager steps
  exactly: losses, parameters and both Adam moments;
- one capture per key, a replay for every other step, ``.grad`` None after
  a graph step, and the CPU itself stays eager;
- the scalars the body sees are ``learning_rate(count)`` and optax's
  float32 bias corrections at every step;
- a resume from a checkpoint the eager step wrote, continued with graph
  steps, equals an uninterrupted eager run;
- a capture that fails raises, and a step bound to one model and
  optimizer refuses another, or a state loaded after its first capture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vietvoice_tts_tpu_torch.models.dit import DiTConfig, init_dit_params
from vietvoice_tts_tpu_torch.runtime.graphs import GraphCache
from vietvoice_tts_tpu_torch.training import train as ttrain
from vietvoice_tts_tpu_torch.training.checkpoint import CheckpointManager

DCFG = DiTConfig(dim=64, depth=2, heads=4, ff_mult=2, n_mels=100, text_dim=32,
                 text_conv_layers=1, vocab_size=32)
TCFG = ttrain.TrainConfig(learning_rate=1e-3, warmup_steps=2)
KEYS = ((2, 32), (1, 48))
ORDER = (0, 0, 1, 0, 1, 1, 0)  # which key each step takes: 7 steps, 2 keys


def _host_count_unreachable():
    """The host's update count and schedule raise while inside: a body that
    read them would bake one step's values into a real capture."""
    mp = pytest.MonkeyPatch()

    def refuse(*_a, **_k):
        raise AssertionError("the captured body read the update count on the host")

    for name in ("learning_rate", "update_count"):
        mp.setattr(ttrain, name, refuse)
    mp.setattr(ttrain.AdamW, "begin_update", refuse)
    return mp


class FakeGraph:
    """A CUDA graph's stand-in on the CPU (see the module docstring)."""

    @staticmethod
    def shared(device):
        return None

    def __init__(self, shared):
        self.fn = self.out = None

    def warm(self, fn):
        return fn()

    def capture(self, fn):
        self.fn = fn
        self.out = torch.empty((), dtype=torch.float32)
        return self.out

    def replay(self):
        mp = _host_count_unreachable()
        try:
            self.out.copy_(self.fn())
        finally:
            mp.undo()


class FailingCapture(FakeGraph):
    def capture(self, fn):
        raise RuntimeError("operation not permitted when stream is capturing")


def _tree():
    tree = init_dit_params(np.random.default_rng(0), DCFG)
    rng = np.random.default_rng(1)
    for gates in (tree["blocks"]["ada"], tree["final_ada"]):
        for k in gates:
            gates[k] = rng.normal(0.0, 0.05, gates[k].shape).astype(np.float32)
    return tree


def _batch(b, n, seed):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((b, n, DCFG.n_mels)).astype(np.float32)
    ids = np.full((b, n), -1, np.int32)
    ids[:, : n // 2] = rng.integers(0, DCFG.vocab_size, (b, n // 2))
    lengths = np.array([n, n - 7][:b], np.int32)
    return ttrain.as_tensors(mel, ids, lengths, "cpu")


BATCHES = [_batch(b, n, seed=i) for i, (b, n) in enumerate(KEYS)]


def _draws(i):
    b, n = KEYS[ORDER[i]]
    return ttrain.draw(torch.Generator().manual_seed(100 + i), b, n, DCFG.n_mels, TCFG)


def _run(steps, graph_cls=None, state=None, seen=None):
    """Steps ``steps`` of ORDER on a fresh state (or ``state``), through the
    graph path with ``graph_cls`` or eagerly; returns (dit, opt, step,
    losses). ``seen`` collects the scalars each update's body was given."""
    dit, opt = state or ttrain.init_train_state(_tree(), DCFG, TCFG, "cpu")
    step = ttrain.make_train_step(DCFG, TCFG)
    if graph_cls is not None:
        step.graphs = GraphCache("cpu", graph_cls=graph_cls)
    if seen is not None:
        apply = opt.apply
        opt.apply = lambda scalars: (seen.append(scalars.tolist()), apply(scalars))[1]
    losses = [step(dit, opt, _draws(i), *BATCHES[ORDER[i]]).item() for i in steps]
    return dit, opt, step, losses


def _state_tensors(dit, opt):
    params = list(dit.parameters())
    return params + [opt.state[p][k] for p in params for k in ("exp_avg", "exp_avg_sq")]


RESUME_AT = 3


@pytest.fixture(scope="module")
def eager(tmp_path_factory):
    """The eager run, with a checkpoint at step RESUME_AT on the way."""
    dit, opt, step, first = _run(range(RESUME_AT))
    ckpt = CheckpointManager(tmp_path_factory.mktemp("ckpt"))
    ckpt.save(RESUME_AT, dit, opt, force=True)
    *_, rest = _run(range(RESUME_AT, len(ORDER)), state=(dit, opt))
    return dit, opt, step, first + rest, ckpt


@pytest.fixture(scope="module")
def graphed():
    seen = []
    return (*_run(range(len(ORDER)), FakeGraph, seen=seen), seen)


def test_k_graph_steps_equal_k_eager_steps(eager, graphed):
    dit_e, opt_e, step_e, losses_e, _ = eager
    dit_g, opt_g, _, losses_g, _ = graphed
    assert step_e.graphs is None  # the CPU stays eager
    assert losses_g == losses_e and len(set(losses_e)) == len(ORDER)
    assert ttrain.update_count(opt_g) == ttrain.update_count(opt_e) == len(ORDER)
    assert all(int(opt_g.state[p]["step"]) == len(ORDER) for p in dit_g.parameters())
    for got, want in zip(_state_tensors(dit_g, opt_g), _state_tensors(dit_e, opt_e), strict=True):
        assert torch.equal(got, want)
    before = ttrain.init_train_state(_tree(), DCFG, TCFG, "cpu")[0]
    assert not torch.equal(before.final_proj.weight, dit_g.final_proj.weight)


def test_one_capture_per_key_and_a_replay_for_every_other_step(graphed):
    dit, _, step, _, _ = graphed
    graphs = step.graphs
    assert graphs.captures == len(KEYS) and graphs.replays == len(ORDER) - len(KEYS)
    assert {k[:2] for k in graphs.entries} == set(KEYS)
    assert all(k[2:] == ("float32", False, False) for k in graphs.entries)
    assert all(p.grad is None for p in dit.parameters())


def test_body_sees_the_schedule_and_optax_float32_corrections(graphed):
    """[lr, 1 − b1ᵗ, 1 − b2ᵗ] at update t = count + 1: the schedule at the
    count, and optax's ``1 - decay**count`` on an int32 count, float32."""
    *_, seen = graphed
    assert len(seen) == len(ORDER)
    for count, scalars in enumerate(seen):
        t = jnp.int32(count + 1)
        want = [np.float32(ttrain.learning_rate(count, TCFG))] + [
            float(jax.jit(lambda c, b=b: 1 - b**c)(t)) for b in ttrain.ADAM_BETAS]
        assert scalars == want, count
    # The rate rises through the warm-up (0, lr/2, lr); the corrections move
    # at every step.
    assert len({s[0] for s in seen[:3]}) == 3 and len({tuple(s) for s in seen}) == len(ORDER)


def test_resume_from_an_eager_checkpoint_then_graph_steps(eager):
    *state_e, losses_e, ckpt = eager
    model_state, opt_state, step = ckpt.restore()
    assert step == RESUME_AT
    dit, opt = ttrain.init_train_state(_tree(), DCFG, TCFG, "cpu")
    dit.load_state_dict(model_state)
    opt.load_state_dict(opt_state)
    dit, opt, graphed, rest = _run(range(RESUME_AT, len(ORDER)), FakeGraph, state=(dit, opt))
    assert graphed.graphs.captures == len(KEYS)
    assert rest == losses_e[RESUME_AT:]
    assert ttrain.update_count(opt) == len(ORDER)
    for got, want in zip(_state_tensors(dit, opt), _state_tensors(*state_e[:2]), strict=True):
        assert torch.equal(got, want)


def test_a_failed_capture_raises():
    with pytest.raises(RuntimeError, match="capturing"):
        _run(range(1), FailingCapture)


def test_graphs_are_bound_to_one_model_optimizer_and_state():
    dit, opt, step, _ = _run(range(1), FakeGraph)
    other_dit, other_opt = ttrain.init_train_state(_tree(), DCFG, TCFG, "cpu")
    for args in ((other_dit, opt), (dit, other_opt)):
        with pytest.raises(ValueError, match="captured for another"):
            step(*args, _draws(1), *BATCHES[ORDER[1]])
    opt.load_state_dict(opt.state_dict())
    with pytest.raises(ValueError, match="load a checkpoint before"):
        step(dit, opt, _draws(1), *BATCHES[ORDER[1]])

