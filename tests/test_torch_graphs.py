"""The captured chunk programs of the PyTorch port (``runtime/graphs.py``,
``EngineCore._run``), the counterpart of the JAX core's per-shape jit cache.

On the CPU the programs run eagerly, as they do under a mesh; a CUDA graph
exists only on the card (``chip_smoke.py`` holds each replay against its
eager run there). Here:

- the program bodies, run directly, against the chunk program as the core
  ran it before graphs (the noise drawn inside the sampler from the rows'
  seeds): **array-equal** int16 PCM on both routes and equal latents with
  and without ``x0``, in float32 on the CPU, with the AdaLN gates opened;
- the cache's bookkeeping, driven through :class:`FakeGraph`, which re-runs
  the captured callable into the same static output: one capture per key,
  a new key for every setting a capture bakes in, no aliasing between two
  calls of one shape, launch counters that move only at replay, a failed
  capture that raises and leaves nothing behind;
- JAX's plain cross-fade (``AudioProcessor.concatenate_with_crossfade``)
  against the port's copy, array-equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_slice import _open_gates, port_config

import vietvoice_tts_tpu_torch as vt
from vietvoice_tts_tpu.pipeline import audio as jaudio
from vietvoice_tts_tpu_torch.models import sampler as tsampler
from vietvoice_tts_tpu_torch.models.sampler import flow_matching_sample
from vietvoice_tts_tpu_torch.ops.kernels import add_launches, launch_counts
from vietvoice_tts_tpu_torch.pipeline import audio as taudio
from vietvoice_tts_tpu_torch.runtime.engine_core import EngineCore, captures_graphs
from vietvoice_tts_tpu_torch.runtime.graphs import GraphCache
from vietvoice_tts_tpu_torch.runtime.session import ModelSessionManager

N = 128


class FakeGraph:
    """A CUDA graph's stand-in on the CPU: the capture runs the program and
    keeps its output as the static output; a replay runs it again into that
    same buffer, with the kernels' counters held still (a replay calls no
    wrapper)."""

    @staticmethod
    def shared(device):
        return None

    def __init__(self, shared):
        self.fn = self.out = None

    def warm(self, fn):
        fn()

    def capture(self, fn):
        self.fn = fn
        self.out = fn()
        return self.out

    def replay(self):
        counts = launch_counts()
        self.out.copy_(self.fn())
        add_launches({k: counts[k] - v for k, v in launch_counts().items()})


@pytest.fixture(scope="module")
def pack(tiny_pack_dir):
    cfg = port_config(model_cache_dir=tiny_pack_dir)
    mgr = ModelSessionManager(cfg)
    mgr.load_models()
    return cfg, _open_gates(mgr.params), mgr.vocab_size


@pytest.fixture(scope="module")
def core(pack):
    return EngineCore(*pack)


@pytest.fixture
def graphed(pack):
    core = EngineCore(*pack)
    core.graphs = GraphCache(core.device, graph_cls=FakeGraph)
    return core


def _batch(core, b=2, seed=3, ref_frames=(16, 24)):
    hop = core.config.hop_length
    rng = np.random.default_rng(seed)
    wave = np.zeros((b, N * hop), np.float32)
    for i in range(b):
        wave[i, : ref_frames[i % 2] * hop] = rng.uniform(-0.4, 0.4, ref_frames[i % 2] * hop)
    ref_len = np.array([ref_frames[i % 2] for i in range(b)], np.int32)
    total = np.array([N - 8 - 4 * i for i in range(b)], np.int32)
    ids = np.full((b, N), -1, np.int32)
    ids[:, :60] = rng.integers(0, core.vocab_size, (b, 60))
    return wave, ref_len, ids, total, np.arange(b, dtype=np.uint32) + 5


@torch.inference_mode()
def _before_graphs(core, wave, ref_len, ids, total, seeds, mel=None, x0=None):
    """(PCM, masked latent) of the chunk program as the core ran it before
    its programs took the noise as an input."""
    if mel is None:
        mel = core.frontend(torch.as_tensor(wave))
    idx = torch.arange(mel.shape[1])
    ref_t, ids_t, tot_t = (torch.as_tensor(np.asarray(a, np.int64)) for a in (ref_len, ids, total))
    is_ref, mask = idx[None] < ref_t[:, None], idx[None] < tot_t[:, None]
    cond = torch.where(is_ref[..., None], mel, torch.zeros(()))
    latent = flow_matching_sample(
        core.dit, core.sampler_cfg, cond, ids_t, mask, seeds.tolist(),
        random_seed=core.config.random_seed,
        x0=None if x0 is None else torch.as_tensor(x0),
    )
    pcm = core._finish_waveform(mel, is_ref, mask, latent)
    return pcm.numpy(), torch.where(mask[..., None], latent, 0.0).numpy()


def _inputs(core, wave, ref_len, ids, total, seeds, x0=None):
    ints = [torch.as_tensor(np.asarray(a, np.int64)) for a in (ref_len, ids, total)]
    noise = core._noise(seeds, N) if x0 is None else torch.as_tensor(x0)
    return ints, noise


# -- The program bodies ----------------------------------------------------------


@pytest.mark.parametrize("route", ["pcm", "pcm_cond"])
def test_program_body_equals_the_eager_chunk(core, route):
    wave, ref_len, ids, total, seeds = _batch(core)
    ints, x0 = _inputs(core, wave, ref_len, ids, total, seeds)
    with torch.inference_mode():
        if route == "pcm":
            got = core._waveform_program(torch.as_tensor(wave), *ints, x0)
            mel = None
        else:
            mel = core._cached_mel(wave, ref_len)
            assert mel is not None  # both references fit the cache window
            got = core._cond_program(mel, *ints, x0)
    want, _ = _before_graphs(core, wave, ref_len, ids, total, seeds, mel=mel)
    assert got.dtype == torch.int16 and np.any(want)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(core.synthesize_batch(wave, ref_len, ids, total, seed=seeds), want)


@pytest.mark.parametrize("with_x0", [False, True])
def test_latent_program_equals_mel_latent_batch(core, with_x0):
    wave, ref_len, ids, total, seeds = _batch(core, seed=4)
    x0 = (np.random.default_rng(9).standard_normal((2, N, core.config.n_mels))
          .astype(np.float32) if with_x0 else None)
    ints, noise = _inputs(core, wave, ref_len, ids, total, seeds, x0)
    with torch.inference_mode():
        got = core._latent_program(torch.as_tensor(wave), *ints, noise).numpy()
    _, want = _before_graphs(core, wave, ref_len, ids, total, seeds, x0=x0)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        core.mel_latent_batch(wave, ref_len, ids, total, seed=seeds, x0=x0), want)


# -- The cache -------------------------------------------------------------------


def test_one_capture_per_key_and_replays_equal_eager(core, graphed):
    wave, ref_len, ids, total, seeds = _batch(core)
    long_ref = ref_len.copy()
    long_ref[0] = N - 2  # too long for the cache window: the waveform route
    for args in ((wave, ref_len, ids, total), (wave, long_ref, ids, total)):
        want = core.synthesize_batch(*args, seed=seeds)
        for _ in range(2):
            np.testing.assert_array_equal(graphed.synthesize_batch(*args, seed=seeds), want)
    latent = core.mel_latent_batch(wave, ref_len, ids, total, seed=seeds)
    np.testing.assert_array_equal(
        graphed.mel_latent_batch(wave, ref_len, ids, total, seed=seeds), latent)
    routes = [key[0] for key in graphed.graphs.entries]
    assert routes == ["pcm_cond", "pcm", "latent"]
    assert (graphed.graph_captures, graphed.graph_replays) == (3, 5)
    assert (core.graph_captures, core.graph_replays) == (0, 0)


def test_two_calls_of_one_shape_do_not_alias(core, graphed):
    a = _batch(core, seed=3)
    b = _batch(core, seed=8)
    fetch_a = graphed.synthesize_batch_async(*a[:4], seed=a[4])
    fetch_b = graphed.synthesize_batch_async(*b[:4], seed=b[4])
    assert graphed.graph_captures == 1 and graphed.graph_replays == 2
    want_a = core.synthesize_batch(*a[:4], seed=a[4])
    want_b = core.synthesize_batch(*b[:4], seed=b[4])
    assert not np.array_equal(want_a, want_b)
    np.testing.assert_array_equal(fetch_b(), want_b)
    np.testing.assert_array_equal(fetch_a(), want_a)


def test_every_setting_a_capture_bakes_in_is_in_the_key(graphed):
    """Flipping ``use_kernels`` or the compute dtype on a core, or the TF32
    flags, must not replay a graph captured under the other setting."""
    inputs = [torch.zeros((2, N), dtype=torch.int64)] * 3 + [torch.ones((2, N, 4))]

    def program(*x):
        tsampler._time_grid_on(graphed.sampler_cfg, graphed.device)  # as a solve does
        return x[-1] * 2

    def run():
        with torch.inference_mode():
            graphed._run("pcm", program, *inputs)

    run()
    run()
    assert graphed.graph_captures == 1
    for change in (dict(use_kernels=True), dict(compute_dtype=torch.bfloat16)):
        graphed.dit.cfg = dataclasses.replace(graphed.dit.cfg, **change)
        run()
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = not saved
    try:
        run()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    run()  # back to the last setting: a replay
    assert (graphed.graph_captures, graphed.graph_replays) == (4, 6)


def _counting_program(x):
    """Stands in for a chunk program: "launches" three kernels."""
    from vietvoice_tts_tpu_torch.ops.kernels import fused_rope_attention as fra

    fra.launches += 3
    return x + 1


def test_launch_counters_move_only_at_replay():
    cache = GraphCache("cpu", graph_cls=FakeGraph)
    before = launch_counts()
    out = cache.run("k", _counting_program, [torch.zeros(4)])
    # The eager run and the capture counted 6 in the wrapper; taken back.
    assert launch_counts()["fused_rope_attention"] == before["fused_rope_attention"] + 3
    assert cache.entries["k"].launches == {"fused_rope_attention": 3}
    out2 = cache.run("k", _counting_program, [torch.ones(4)])
    assert out2 is out and torch.equal(out, torch.full((4,), 2.0))
    assert launch_counts()["fused_rope_attention"] == before["fused_rope_attention"] + 6
    assert launch_counts()["flash_attention"] == before["flash_attention"]


def test_a_replay_adds_the_adaln_launches_of_its_forwards(graphed, monkeypatch):
    """``launch_counts()`` carries the AdaLN kernel's module. With
    ``use_kernels`` each DiT forward of a chunk program calls the kernel's
    wrapper 1 + 2·depth times (a stand-in here, which counts a launch and
    runs the plain version): the capture takes those counts back and every
    replay adds one solve's, evals · (1 + 2·depth), whatever the batch."""
    from vietvoice_tts_tpu_torch.models import dit as tdit
    from vietvoice_tts_tpu_torch.ops.kernels import adaln_norm as an

    assert set(launch_counts()) == {"fused_rope_attention", "flash_attention", "adaln_norm"}

    def counted(*args, **kw):
        an.launches += 1
        return an.adaln_norm_reference(*args, **kw)

    monkeypatch.setattr(tdit, "adaln_norm", counted)
    graphed.dit.cfg = dataclasses.replace(graphed.dit.cfg, use_kernels=True)
    per_solve = (graphed.sampler_cfg.nfe_step - 1) * (1 + 2 * graphed.dit.cfg.depth)
    for b in (2, 2, 1):
        wave, ref_len, ids, total, seeds = _batch(graphed, b=b)
        before = launch_counts()
        graphed.synthesize_batch(wave, ref_len, ids, total, seed=seeds)
        after = launch_counts()
        assert {k: after[k] - before[k] for k in after} == {
            "fused_rope_attention": 0, "flash_attention": 0, "adaln_norm": per_solve}
    assert (graphed.graph_captures, graphed.graph_replays) == (2, 3)


def test_a_failed_capture_raises_and_leaves_nothing(graphed, monkeypatch):
    """The capture checks that the eager run made the solve's time grid:
    a warm run that made nothing fails the capture, which raises to the
    caller (no eager fallback), stores no graph and leaves the counters."""
    monkeypatch.setattr(FakeGraph, "warm", lambda self, fn: None)
    monkeypatch.setattr(tsampler, "_TIME_GRIDS", {})
    before = launch_counts()
    wave, ref_len, ids, total, seeds = _batch(graphed)
    with pytest.raises(RuntimeError, match="time grid"):
        graphed.synthesize_batch(wave, ref_len, ids, total, seed=seeds)
    assert graphed.graphs.entries == {} and graphed.graph_captures == 0
    assert launch_counts() == before


def test_graphs_run_on_the_card_alone(core):
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert captures_graphs(cuda, None)
    assert not captures_graphs(cuda, object())  # under a mesh: eager
    assert not captures_graphs(cpu, None)
    assert core.graphs is None


def test_shapes_that_do_not_fit_a_graph_raise():
    cache = GraphCache("cpu", graph_cls=FakeGraph)
    cache.run("k", lambda x: x + 1, [torch.zeros(4)])
    with pytest.raises(ValueError, match="does not fit"):
        cache.run("k", lambda x: x + 1, [torch.zeros(5)])


# -- The plain cross-fade ---------------------------------------------------------


@pytest.mark.parametrize("fade", [0.0, 0.01, 0.1])
@pytest.mark.parametrize("lengths", [(24000, 30000, 26000), (5000, 300, 7000), (24000,), ()])
def test_linear_crossfade_matches_jax(lengths, fade):
    rng = np.random.default_rng(len(lengths))
    waves = [(rng.uniform(-0.6, 0.6, n) * 32767).astype(np.int16) for n in lengths]
    ours = taudio.AudioProcessor.concatenate_with_crossfade(waves, fade, 24000)
    theirs = jaudio.AudioProcessor.concatenate_with_crossfade(waves, fade, 24000)
    assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
    np.testing.assert_array_equal(ours, theirs)
