"""``parallel/`` of the PyTorch port and the mesh branches that use it,
against the JAX package, on the CPU.

Carried over from ``tests/test_parallel.py`` (the mesh, the spec tree, the
sharded forward, Ulysses and the ring, their rejections, the
sequence-parallel sampler and engine core), plus the qkv split, the DP and
TP engine cores, ``TTSApi`` on a mesh, the DP and TP train steps (the
distributed loss and the clip), ``train(mesh=)`` with checkpoints, and the
command lines' mesh flags. Ranks are ``torch.multiprocessing`` spawn
children on gloo (``tests/torch_parallel_proc.py``, which imports no JAX);
this process computes the JAX side and hands numpy over. Each group of
checks that shares a launch reads one module fixture.

Tolerances, float32: sharded forwards 1e-5 max-abs against the unsharded
JAX forward; attention 2e-5 (``test_parallel.py``'s); the samplers 2e-4
(``test_parallel.py:270,282``); engine PCM ±1 of 32767 against the port's
single-device core, and the mel latent 1e-3 against JAX's from one shared
noise (``test_torch_slice.py``'s); train steps: loss 1e-5 relative, each
parameter leaf 1e-4 of its max-abs (``test_torch_training.py``'s).
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_config
from test_torch_slice import _open_gates, port_config
from test_torch_training import JCFG, _assert_leaves_close, _tree, draws_from_key
from torch_parallel_proc import engines, layers, run_ranks, training

import vietvoice_tts_tpu_torch as vt
from vietvoice_tts_tpu.models import dit as jdit
from vietvoice_tts_tpu.models import sampler as jsampler
from vietvoice_tts_tpu.models import vocoder as jvoc
from vietvoice_tts_tpu.ops.attention import attention as jattention
from vietvoice_tts_tpu.ops.rope import apply_rope as japply_rope
from vietvoice_tts_tpu.ops.rope import rope_tables
from vietvoice_tts_tpu.runtime.engine_core import EngineCore as JaxEngineCore
from vietvoice_tts_tpu.training import train as jtrain
from vietvoice_tts_tpu_torch import cli
from vietvoice_tts_tpu_torch.models import dit as tdit
from vietvoice_tts_tpu_torch.models.params import to_jax_tree
from vietvoice_tts_tpu_torch.parallel import comm
from vietvoice_tts_tpu_torch.parallel.mesh import (
    initialize_distributed,
    launch_mesh,
    make_mesh,
    mesh_axis_sizes,
)
from vietvoice_tts_tpu_torch.parallel.sharding import (
    P,
    param_pspecs,
    shard_batch,
    shard_tree,
    unshard_tree,
)
from vietvoice_tts_tpu_torch.runtime.engine_core import EngineCore
from vietvoice_tts_tpu_torch.training import __main__ as tmain
from vietvoice_tts_tpu_torch.training.checkpoint import CheckpointManager

DIT_DIMS = dict(dim=128, depth=2, heads=8, ff_mult=2, n_mels=16, text_dim=64,
                text_conv_layers=1, vocab_size=32)
DIT6_DIMS = {**DIT_DIMS, "dim": 96, "heads": 6}
VOC_DIMS = dict(dim=64, intermediate_dim=128, num_layers=1, n_mels=16, n_fft=256, hop_length=64)
JDIT = jdit.DiTConfig(**DIT_DIMS, compute_dtype=jnp.float32, use_pallas=False)
JDIT6 = jdit.DiTConfig(**DIT6_DIMS, compute_dtype=jnp.float32, use_pallas=False)
JVOC = jvoc.VocoderConfig(**VOC_DIMS)
PCM_TOLERANCE = 1  # int16 steps


def _open(tree, seed=5):
    """The DiT tree with random AdaLN gates (zero gates make every block
    the identity, and attention would not count)."""
    return _open_gates({"dit": tree, "vocoder": {}}, seed)["dit"]


def _params():
    return {"dit": _open(jdit.init_dit_params(0, JDIT)), "vocoder": jvoc.init_vocoder_params(1, JVOC)}


def _dit_inputs(b=4, n=64):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, n, 16)).astype(np.float32)
    cond = (0.1 * rng.standard_normal((b, n, 16))).astype(np.float32)
    text = np.full((b, n), 3, np.int32)
    text[:, n // 2:] = -1
    t = np.linspace(0.1, 0.9, b).astype(np.float32)
    mask = np.ones((b, n), bool)
    mask[1, n - 8:] = False
    mask[3, n // 2:] = False
    return x, cond, text, t, mask


def _qkv(h, mask_from, seed, b=2, n=64, d=16):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, n, h, d)).astype(np.float32) for _ in range(3))
    mask = np.ones((b, n), bool)
    mask[1, mask_from:] = False
    cos, sin = rope_tables(n, d)
    return q, k, v, cos, sin, mask


def _jax_attention(q, k, v, cos, sin, mask):
    qb, kb, vb = (jnp.moveaxis(jnp.asarray(a), 1, 2) for a in (q, k, v))
    out = jattention(japply_rope(qb, cos, sin), japply_rope(kb, cos, sin), vb,
                     jnp.asarray(mask), use_pallas=False)
    return np.moveaxis(np.asarray(out), 1, 2)


def _sampler_inputs(b=2, n=64):
    rng = np.random.default_rng(0)
    cond = (rng.standard_normal((b, n, 16)) * 0.1).astype(np.float32)
    text = np.full((b, n), 3, np.int32)
    text[:, n // 2:] = -1
    mask = np.ones((b, n), bool)
    mask[1, n - 8:] = False
    x0 = rng.standard_normal((b, n, 16)).astype(np.float32)
    return cond, text, mask, x0


def _jax_sample(cfg, tree, inputs):
    cond, text, mask, x0 = inputs
    return np.asarray(jsampler.flow_matching_sample(
        tree, cfg, jsampler.SamplerConfig(nfe_step=4), jax.random.PRNGKey(0),
        jnp.asarray(cond), jnp.asarray(text), jnp.asarray(mask),
        jnp.arange(2, dtype=jnp.uint32), x0=jnp.asarray(x0),
    ))


# -- One launch of four ranks: mesh, layers, sequence parallelism --------------------


@pytest.fixture(scope="module")
def layer_run(tmp_path_factory):
    params = _params()
    dit6 = _open(jdit.init_dit_params(1, JDIT6), seed=6)
    data = dict(
        dit_dims=DIT_DIMS, dit_dims6=DIT6_DIMS, voc_dims=VOC_DIMS, params=params, dit6=dit6,
        dit_inputs=_dit_inputs(),
        voc_mel=np.random.default_rng(2).standard_normal((4, 32, 16)).astype(np.float32),
        ulysses=_qkv(8, 32, seed=0), ring=_qkv(6, 40, seed=3),
        sampler_inputs=_sampler_inputs(),
    )
    results, _ = run_ranks(layers, 4, tmp_path_factory.mktemp("layers"), data)
    return data, results


class TestMesh:
    def test_shape(self, layer_run):
        _, results = layer_run
        assert all(r["axes"] == (2, 2) for r in results)

    def test_bad_model_axis(self, layer_run):
        _, results = layer_run
        assert all(r.get("bad_model_axis") for r in results)
        with pytest.raises(ValueError, match="does not divide"):
            make_mesh(model=3)  # one process: world size 1

    def test_default_data_axis(self, layer_run):
        _, results = layer_run
        assert all(r["default_axes"] == (2, 2) for r in results)
        assert mesh_axis_sizes(make_mesh()) == (1, 1)

    def test_ranks_are_data_major_with_the_model_axis_innermost(self, layer_run):
        """rank = d·model + m; a data group holds the ranks of one model
        index, a model group those of one data index."""
        _, results = layer_run
        for rank, r in enumerate(results):
            d, m = divmod(rank, 2)
            assert r["coords"] == (d, m)
            assert r["data_members"] == 2**m + 2 ** (2 + m)
            assert r["model_members"] == 2 ** (2 * d) + 2 ** (2 * d + 1)

    def test_a_mesh_needs_its_ranks(self, monkeypatch):
        """In one process, without a launcher: a mesh of more than one rank
        raises, naming torchrun; initialize_distributed does nothing."""
        monkeypatch.delenv("WORLD_SIZE", raising=False)
        initialize_distributed()
        assert not torch.distributed.is_initialized()
        with pytest.raises(ValueError, match="torchrun"):
            make_mesh(data=2)
        with pytest.raises(ValueError, match="torchrun"):
            launch_mesh(1, 2)
        assert launch_mesh(1, 1) is None

    @pytest.mark.parametrize("cards,local,want", [
        (2, "2", "cpu:gloo,cuda:nccl"),  # a card per rank: NCCL, and gloo for host tensors
        (1, "2", "gloo"),  # ranks share a card: NCCL refuses two ranks on one device
        (0, "2", "gloo"),  # the CPU
    ])
    def test_backend_takes_host_tensors_where_nccl_runs(self, monkeypatch, cards, local, want):
        """On a host with a card per rank the group is ``cpu:gloo,cuda:nccl``,
        so the checkpoint's all-gather of host arrays (``gather_tree``) has a
        backend; torchrun's rank is put on its own card first."""
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local)
        monkeypatch.setenv("WORLD_SIZE", local)
        monkeypatch.setenv("LOCAL_RANK", "1")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
        monkeypatch.setattr(torch.distributed, "is_nccl_available", lambda: True)
        calls = []
        monkeypatch.setattr(torch.cuda, "set_device", lambda i: calls.append(("device", i)))
        monkeypatch.setattr(torch.distributed, "init_process_group",
                            lambda backend: calls.append(("backend", backend)))
        initialize_distributed()
        device = [("device", 1)] if "nccl" in want else []
        assert calls == device + [("backend", want)]


class TestShardings:
    def test_pspec_tree_matches_params(self):
        params = {"dit": jdit.init_dit_params(0, JDIT), "vocoder": jvoc.init_vocoder_params(1, JVOC)}
        specs = param_pspecs(tdit.DiTConfig(**DIT_DIMS), None)
        jax.tree.map(lambda a, b: None, params, specs,
                     is_leaf=lambda x: isinstance(x, P) or not isinstance(x, (dict, list)))

    def test_qkv_split_gives_each_rank_its_heads(self):
        """Rank r holds heads [r·H/tp, (r+1)·H/tp) of q, of k and of v,
        packed q_r ‖ k_r ‖ v_r — not a contiguous slice of q ‖ k ‖ v."""
        tree = jdit.init_dit_params(0, JDIT)
        specs = param_pspecs(tdit.DiTConfig(**DIT_DIMS), None)["dit"]
        w, b = tree["blocks"]["qkv"]["w"], tree["blocks"]["qkv"]["b"]
        d, hd = JDIT.dim, JDIT.head_dim
        for tp in (2, 4):
            for r in range(tp):
                shard = shard_tree(tree, specs, r, tp)["blocks"]["qkv"]
                heads = slice(r * d // tp, (r + 1) * d // tp)
                want_w = np.concatenate([w[..., j * d:(j + 1) * d][..., heads] for j in range(3)], -1)
                want_b = np.concatenate([b[..., j * d:(j + 1) * d][..., heads] for j in range(3)], -1)
                np.testing.assert_array_equal(shard["w"], want_w)
                np.testing.assert_array_equal(shard["b"], want_b)
                assert shard["w"].shape[-1] == 3 * (JDIT.heads // tp) * hd

    def test_shards_join_to_the_whole_tree(self):
        params = _params()
        specs = param_pspecs(tdit.DiTConfig(**DIT_DIMS), None)
        shards = [shard_tree(params, specs, r, 4) for r in range(4)]
        assert shards[1]["dit"]["blocks"]["ff2"]["w"].shape == (2, 64, 128)
        assert shards[1]["vocoder"]["head"]["w"].shape == params["vocoder"]["head"]["w"].shape
        jax.tree.map(np.testing.assert_array_equal, unshard_tree(shards, specs), params)

    def test_shard_batch_takes_the_ranks_rows(self):
        mesh = dataclasses.replace(make_mesh(), data=2, rank=1)
        a = np.arange(8).reshape(4, 2)
        (rows,) = shard_batch(mesh, a)
        np.testing.assert_array_equal(rows, a[2:])
        with pytest.raises(ValueError):
            shard_batch(mesh, a[:3])

    def test_collectives_of_a_one_rank_axis_return_their_input(self):
        x = torch.arange(6.0).reshape(2, 3)
        for out in (comm.all_reduce(x, None), comm.all_gather(x, None),
                    comm.all_to_all(x, None, 0, 1), comm.ring_shift([x], None)[0]):
            assert out is x

    def test_tp_forward_matches_jax(self, layer_run):
        data, results = layer_run
        p = data["params"]
        ref = np.asarray(jdit.dit_forward(p["dit"], JDIT, *data["dit_inputs"]))
        voc = np.asarray(jvoc.vocoder_forward(p["vocoder"], JVOC, jnp.asarray(data["voc_mel"])))
        assert np.abs(ref).max() > 1.0
        for r in results:
            np.testing.assert_allclose(r["dit_tp"], ref, atol=1e-5, rtol=0)
            np.testing.assert_allclose(r["voc_tp"], voc, atol=1e-5, rtol=0)

    def test_dp_tp_forward_matches_jax(self, layer_run):
        data, results = layer_run
        p = data["params"]
        ref = np.asarray(jdit.dit_forward(p["dit"], JDIT, *data["dit_inputs"]))
        voc = np.asarray(jvoc.vocoder_forward(p["vocoder"], JVOC, jnp.asarray(data["voc_mel"])))
        for r in results:
            np.testing.assert_allclose(r["dit_dp_tp"], ref, atol=1e-5, rtol=0)
            np.testing.assert_allclose(r["voc_dp_tp"], voc, atol=1e-5, rtol=0)


class TestSequenceParallel:
    @pytest.mark.parametrize("sp", [2, 4])
    def test_ulysses_matches_single_device(self, layer_run, sp):
        data, results = layer_run
        ref = _jax_attention(*data["ulysses"])
        out = results[0][f"ulysses_sp{sp}"]
        # Rows past the valid length are undefined; compare the valid region.
        np.testing.assert_allclose(out[0], ref[0], atol=2e-5)
        np.testing.assert_allclose(out[1, :32], ref[1, :32], atol=2e-5)

    def test_ring_matches_single_device(self, layer_run):
        data, results = layer_run
        ref = _jax_attention(*data["ring"])
        out = results[0]["ring_sp4"]
        np.testing.assert_allclose(out[0], ref[0], atol=2e-5)
        np.testing.assert_allclose(out[1, :40], ref[1, :40], atol=2e-5)

    def test_rejects_indivisible_heads(self, layer_run):
        _, results = layer_run
        assert "heads 6 not divisible" in results[0]["ulysses_rejects_heads"]

    def test_rejects_indivisible_frames(self, layer_run):
        _, results = layer_run
        assert "frames 18 not divisible" in results[0]["ring_rejects_frames"]

    def test_ulysses_sampler_matches_unsharded(self, layer_run):
        """heads (8) divide the axis (4) → Ulysses, inside the DiT."""
        data, results = layer_run
        ref = _jax_sample(JDIT, data["params"]["dit"], data["sampler_inputs"])
        np.testing.assert_allclose(results[0]["sampler_ulysses"], ref, atol=2e-4)

    def test_ring_sampler_matches_unsharded(self, layer_run):
        """heads (6) do not divide the axis (4) → the ring."""
        data, results = layer_run
        ref = _jax_sample(JDIT6, data["dit6"], data["sampler_inputs"])
        np.testing.assert_allclose(results[0]["sampler_ring"], ref, atol=2e-4)


# -- One launch of four ranks: engine cores and TTSApi -------------------------------


def _engine_batch():
    hop = 256
    rng = np.random.default_rng(0)
    wave = rng.uniform(-0.3, 0.3, (2, 128 * hop)).astype(np.float32)
    ref_len = np.array([16, 16], np.int32)
    ids = np.full((2, 128), 4, np.int32)
    total = np.array([100, 112], np.int32)
    return wave, ref_len, ids, total, np.arange(2, dtype=np.uint32)


@pytest.fixture(scope="module")
def engine_run(tiny_pack_dir, tmp_path_factory):
    from vietvoice_tts_tpu_torch.runtime import serialization as tser

    pack = Path(tiny_pack_dir) / "vietvoice-tpu-v1"
    params = _open_gates(tser.load_params(pack / "params.msgpack"))
    vocab = len((pack / "vocab.txt").read_text().splitlines())
    cfg = port_config(model_cache_dir=tiny_pack_dir)
    x0 = np.random.default_rng(1).standard_normal((2, 128, 100)).astype(np.float32)
    text = "Xin chào. Hôm nay trời đẹp, chúng ta cùng nhau đi dạo ở công viên nhé."
    data = dict(config=cfg.to_dict(), params=params, vocab=vocab, batch=_engine_batch(),
                x0=x0, text=text)
    results, _ = run_ranks(engines, 4, tmp_path_factory.mktemp("engines"), data)
    solo = EngineCore(cfg, params, vocab)
    return data, results, solo, cfg


class TestEngineCore:
    @pytest.mark.parametrize("mode", ["sp", "dp_tp", "dp"])
    def test_pcm_matches_single_device(self, engine_run, mode):
        """Sequence parallel (2 × 2, Ulysses), DP × TP (2 × 2) and DP (4 × 1;
        two rows padded to four): every rank gets the whole batch's PCM."""
        data, results, solo, _ = engine_run
        ref = solo.synthesize_batch(*data["batch"])
        assert np.abs(ref).max() > 100
        for r in results:
            assert r[mode].shape == ref.shape and r[mode].dtype == np.int16
            assert np.abs(r[mode].astype(np.int32) - ref.astype(np.int32)).max() <= PCM_TOLERANCE

    @pytest.mark.parametrize("mode", ["sp", "dp_tp", "dp"])
    def test_mel_latent_matches_jax(self, engine_run, tiny_pack_dir, mode):
        """The same modes' mel latent from one injected noise against the
        single-device JAX engine's."""
        data, results, _, _ = engine_run
        jcore = JaxEngineCore(
            tiny_config(model_cache_dir=tiny_pack_dir, transfer_dtype="float32"),
            data["params"], data["vocab"],
        )
        wave, ref_len, ids, total, seed = data["batch"]
        ref = jcore.mel_latent_batch(wave, ref_len, ids, total, seed=seed, x0=data["x0"])
        for r in results:
            np.testing.assert_allclose(r[mode + "_latent"], ref, atol=1e-3, rtol=0)

    def test_cond_cache_is_off_under_a_mesh(self, engine_run):
        _, results, solo, _ = engine_run
        assert solo._cond_eligible(np.array([8]), 128)
        assert all(r[m + "_cache_off"] for r in results for m in ("sp", "dp_tp", "dp"))

    def test_api_on_a_mesh_pads_batches_to_the_data_axis(self, engine_run):
        """TTSApi(config, mesh=) on DP 4: the chunks' batches are padded to
        four rows, and the audio is the single-device API's."""
        data, results, _, cfg = engine_run
        api = vt.TTSApi(cfg)
        ref, _ = api.synthesize(data["text"])
        api.cleanup()
        for r in results:
            assert r["api"].shape == ref.shape
            assert np.abs(r["api"].astype(np.int32) - ref.astype(np.int32)).max() <= PCM_TOLERANCE


# -- One launch of two ranks: the DP and TP train steps, train(mesh=) --------------


TRAIN_KW = dict(warmup_steps=1, learning_rate=1e-3, max_grad_norm=0.1)


def _train_tree():
    """Opened gates and random biases. With the zero-init biases, Adam's
    first real update of a bias is ±lr wherever its gradient is, and where
    the clipped gradient is near Adam's eps that update swings with the
    gradient's last bits (the single-device port and JAX then differ by
    1.8e-4 of the leaf's max on qkv.b, measured): the comparison would
    test eps, not the mesh. With random biases it is 4.2e-5 on one device."""
    rng = np.random.default_rng(11)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: rng.normal(0.0, 0.05, x.shape).astype(np.float32)
        if jax.tree_util.keystr(path).endswith("['b']") else x,
        _tree(open_gates=True),
    )


def _train_batch(n=64):
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((4, n, 16)).astype(np.float32)
    text = np.full((4, n), 3, np.int32)
    lengths = np.array([n, n // 2, 48, 20], np.int32)
    for row, length in enumerate(lengths):
        text[row, length:] = -1
    return mel, text, lengths


@pytest.fixture(scope="module")
def train_run(tiny_pack_dir, tmp_path_factory):
    import shutil

    jcfg = jtrain.TrainConfig(**TRAIN_KW)
    tree, batch = _train_tree(), _train_batch()
    key = jax.random.PRNGKey(3)
    draws = draws_from_key(key, 4, 64, 16, jcfg)
    # Two JAX steps on the same batch and draws (the first at learning rate 0).
    step = jax.jit(jtrain.make_train_step(JCFG, jcfg))
    params, state = tree, jtrain.init_train_state(tree, jcfg)
    losses = []
    for _ in range(2):
        params, state, loss = step(params, state, key, *map(jnp.asarray, batch))
        losses.append(float(loss))
    work = tmp_path_factory.mktemp("train")
    pack_copy = work / "models"
    shutil.copytree(tiny_pack_dir, pack_copy)
    dims = {k: v for k, v in dataclasses.asdict(JCFG).items()
            if k in ("dim", "depth", "heads", "ff_mult", "n_mels", "text_dim",
                     "text_conv_layers", "vocab_size")}
    data = dict(
        train_cfg=TRAIN_KW, dit_dims=dims, tree=tree, batch=batch,
        draws=[d.numpy() for d in dataclasses.astuple(draws)],
        config=port_config(model_cache_dir=str(pack_copy)).to_dict(),
        ckpt_dir=str(work / "ckpt"),
    )
    results, _ = run_ranks(training, 2, work / "ranks", data, timeout=60)
    return losses, jax.tree.map(np.asarray, params), results, work


class TestTraining:
    @pytest.mark.parametrize("mode", ["dp", "tp"])
    def test_step_matches_jax(self, train_run, mode):
        """Two steps (the clip binds at max_grad_norm 0.1; rows with 64, 32,
        48 and 20 frames, so the two data ranks score different numbers of
        frames) against the single-device JAX step."""
        losses, ref, results, _ = train_run
        for r in results:
            np.testing.assert_allclose(r[mode + "_loss"], losses[1], rtol=1e-5, atol=0)
            _assert_leaves_close(r[mode + "_params"], ref, 1e-4)

    def test_tp_rank_holds_its_shard(self, train_run):
        _, _, results, _ = train_run
        assert all(r["tp_sharded_shape"] == (3 * 64 // 2, 64) for r in results)

    def test_train_on_a_mesh_checkpoints_the_whole_model(self, train_run):
        """train(mesh=TP 2): rank 0 writes whole-model checkpoints and the
        export; a checkpoint loads into an unsharded DiT on one device."""
        _, _, results, work = train_run
        assert results[0]["train_losses"] == results[1]["train_losses"]
        assert len(results[0]["train_losses"]) == 2
        assert np.isfinite(results[0]["train_losses"]).all()
        ckpt = CheckpointManager(work / "ckpt")
        assert ckpt.all_steps() == [1, 2]
        model_state, opt_state, step = ckpt.restore()
        assert step == 2
        cfg = port_config(model_cache_dir=str(work / "models"))
        dit = tdit.DiT(tdit.DiTConfig(dim=cfg.dit_dim, depth=cfg.dit_depth, heads=cfg.dit_heads,
                                      n_mels=cfg.n_mels, text_dim=cfg.text_dim,
                                      text_conv_layers=cfg.text_conv_layers,
                                      vocab_size=model_state["text_table.weight"].shape[0] - 1))
        dit.load_state_dict(model_state)
        assert opt_state["state"][3]["exp_avg"].shape == dict(dit.named_parameters())[
            list(dict(dit.named_parameters()))[3]].shape
        from vietvoice_tts_tpu_torch.runtime.serialization import load_params

        exported = load_params(work / "models" / "vietvoice-tpu-v1" / "params.msgpack")["dit"]
        jax.tree.map(np.testing.assert_array_equal, exported, to_jax_tree(dit))


# -- The command lines ------------------------------------------------------------------


class TestCommandLines:
    def test_cli_mesh_outside_torchrun_exits_1(self, monkeypatch, capsys, tmp_path):
        monkeypatch.delenv("WORLD_SIZE", raising=False)
        out = tmp_path / "o.wav"
        monkeypatch.setattr(sys, "argv", ["vv", "Xin chào.", str(out), "--device", "cpu",
                                          "--mesh-model", "2"])
        with pytest.raises(SystemExit) as exc:
            cli.main()
        assert exc.value.code == 1
        assert "torchrun" in capsys.readouterr().err
        assert not out.exists()

    def test_training_mesh_outside_torchrun_exits_1(self, monkeypatch, capsys, tmp_path):
        monkeypatch.delenv("WORLD_SIZE", raising=False)
        monkeypatch.setattr(sys, "argv", ["vv", "--device", "cpu", "--mesh-data", "2",
                                          "--checkpoint-dir", str(tmp_path / "c"),
                                          "--model-cache-dir", str(tmp_path / "m")])
        with pytest.raises(SystemExit) as exc:
            tmain.main()
        assert exc.value.code == 1
        assert "torchrun" in capsys.readouterr().err
        assert not (tmp_path / "m").exists()
