"""Rank bodies for the port's multi-process tests, and their launcher.

``tests/test_torch_parallel.py`` and ``tests/test_torch_multihost.py`` start
these functions as ``torch.multiprocessing`` spawn children, one per rank,
joined in a gloo process group through a ``file://`` rendezvous in the
test's temporary directory (no TCP port is shared between test workers).
This module imports only ``torch``, numpy and the port, never JAX: the
reference side is computed by the test process and handed over as numpy.
Each rank pickles what it returns to ``<dir>/rank<r>.pkl`` (or its
traceback to ``rank<r>.err``); the launcher joins every child with a
timeout and kills them all on expiry, so a hang fails one test.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from vietvoice_tts_tpu_torch.config import ModelConfig
from vietvoice_tts_tpu_torch.models.dit import DiT, DiTConfig
from vietvoice_tts_tpu_torch.models.params import dit_state, to_jax_tree, vocoder_state
from vietvoice_tts_tpu_torch.models.sampler import SamplerConfig, flow_matching_sample
from vietvoice_tts_tpu_torch.models.vocoder import Vocoder, VocoderConfig
from vietvoice_tts_tpu_torch.parallel import comm
from vietvoice_tts_tpu_torch.parallel.mesh import make_mesh, mesh_axis_sizes
from vietvoice_tts_tpu_torch.parallel.sequence import ring_attention, ulysses_attention
from vietvoice_tts_tpu_torch.parallel.sharding import (
    param_pspecs,
    shard_batch,
    shard_params,
    shard_tree,
)

JOIN_TIMEOUT = 60.0  # seconds a multi-process test may take to join


def _entry(fn, rank, world, workdir, args, backend):
    torch.set_num_threads(1)
    out = Path(workdir)
    try:
        if "nccl" in backend:
            torch.cuda.set_device(rank)
        dist.init_process_group(
            backend, init_method=f"file://{out / 'rendezvous'}", rank=rank, world_size=world
        )
        result = fn(rank, world, *args)
        (out / f"rank{rank}.pkl").write_bytes(pickle.dumps(result))
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, workdir, *args, timeout: float = JOIN_TIMEOUT, check=True,
              backend: str = "gloo"):
    """Run ``fn(rank, world, *args)`` on ``world`` spawned ranks; returns
    (results by rank, or None where a rank wrote none; exit codes). Under a
    backend with NCCL, rank r runs on card r."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [
        ctx.Process(target=_entry, args=(fn, r, world, str(workdir), args, backend),
                    daemon=True)
        for r in range(world)
    ]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(5)
    codes = [p.exitcode for p in procs]
    results = []
    for r in range(world):
        f = workdir / f"rank{r}.pkl"
        results.append(pickle.loads(f.read_bytes()) if f.exists() else None)
    if check:
        errors = "\n".join(
            (workdir / f"rank{r}.err").read_text()
            for r in range(world)
            if (workdir / f"rank{r}.err").exists()
        )
        assert not hung, f"ranks {hung} still running after {timeout} s\n{errors}"
        assert codes == [0] * world, f"exit codes {codes}\n{errors}"
    return results, codes


# -- Models from numpy trees -----------------------------------------------------


def build_dit(tree: dict, cfg: DiTConfig) -> DiT:
    with torch.device("meta"):
        dit = DiT(cfg)
    dit.load_state_dict(dit_state(tree, cfg.compute_dtype), assign=True)
    return dit.eval().requires_grad_(False)


def build_vocoder(tree: dict, cfg: VocoderConfig) -> Vocoder:
    with torch.device("meta"):
        voc = Vocoder(cfg)
    voc.load_state_dict(vocoder_state(tree, cfg.compute_dtype), assign=True)
    return voc.eval().requires_grad_(False)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -- Layers: mesh, tensor parallelism, sequence parallelism -----------------------


def layers(rank, world, d):
    """World 4. Mesh layout checks; the DiT and vocoder at TP 2 (whole
    batch) and DP 2 × TP 2 (rows split); Ulysses at sp 2 and 4, the ring at
    sp 4, their rejections; the sequence-parallel sampler."""
    out = {}
    mesh = make_mesh(data=2, model=2)
    out["axes"] = mesh_axis_sizes(mesh)
    out["coords"] = (mesh.data_index, mesh.model_index)
    # Which ranks share each group: sum 2^rank over it.
    bit = torch.tensor([float(2**rank)])
    out["data_members"] = int(comm.all_reduce(bit, mesh.data_group).item())
    out["model_members"] = int(comm.all_reduce(bit, mesh.model_group).item())
    out["default_axes"] = mesh_axis_sizes(make_mesh(model=2))
    try:
        make_mesh(model=3)
    except ValueError:
        out["bad_model_axis"] = True

    dit_cfg = DiTConfig(**d["dit_dims"], compute_dtype=torch.float32)
    voc_cfg = VocoderConfig(**d["voc_dims"])
    shard = shard_params(d["params"], mesh, dit_cfg, voc_cfg)
    dit = build_dit(shard["dit"], dataclasses.replace(dit_cfg, model_group=mesh.model_group))
    voc = build_vocoder(shard["vocoder"], dataclasses.replace(voc_cfg, model_group=mesh.model_group))
    inputs = [_t(a) for a in d["dit_inputs"]]
    mel = _t(d["voc_mel"])
    out["dit_tp"] = dit(*inputs).numpy()
    out["voc_tp"] = voc(mel).numpy()
    rows = shard_batch(mesh, *inputs)
    out["dit_dp_tp"] = comm.all_gather(dit(*rows), mesh.data_group).numpy()
    (mel_rows,) = shard_batch(mesh, mel)
    out["voc_dp_tp"] = comm.all_gather(voc(mel_rows), mesh.data_group).numpy()

    # Attention over the frame axis: this rank's frames in, its frames out.
    def sp(fn, group, q, k, v, cos, sin, mask):
        n, r, size = q.shape[1], comm.rank(group), comm.size(group)
        lo, hi = r * n // size, (r + 1) * n // size
        local = [_t(x)[:, lo:hi] for x in (q, k, v)]
        o = fn(*local, _t(cos), _t(sin), _t(mask), group)
        return comm.all_gather(o, group, dim=1).numpy()

    line = make_mesh(data=1, model=4)
    out["ulysses_sp2"] = sp(ulysses_attention, mesh.model_group, *d["ulysses"])
    out["ulysses_sp4"] = sp(ulysses_attention, line.model_group, *d["ulysses"])
    out["ring_sp4"] = sp(ring_attention, line.model_group, *d["ring"])
    q6 = torch.zeros((1, 4, 6, 8))  # 6 heads do not split over 4
    cos16, sin16 = torch.zeros((16, 8)), torch.zeros((16, 8))
    for name, fn, args in (
        ("ulysses_rejects_heads", ulysses_attention, (q6, q6, q6, cos16, sin16)),
        ("ring_rejects_frames", ring_attention,  # 18 frames do not split over 4
         (q6[:, :4], q6[:, :4], q6[:, :4], torch.zeros((18, 8)), torch.zeros((18, 8)))),
    ):
        try:
            fn(*args, torch.ones((1, args[3].shape[0]), dtype=torch.bool), line.model_group)
        except ValueError as e:
            out[name] = str(e)

    # The sequence-parallel sampler (Ulysses: 8 heads; the ring: 6 heads).
    scfg = SamplerConfig(nfe_step=4)
    for name, dims, tree in (("sampler_ulysses", d["dit_dims"], d["params"]["dit"]),
                             ("sampler_ring", d["dit_dims6"], d["dit6"])):
        cfg = DiTConfig(**dims, compute_dtype=torch.float32, seq_group=line.model_group)
        cond, text, mask, x0 = (_t(a) for a in d["sampler_inputs"])
        with torch.no_grad():
            out[name] = flow_matching_sample(
                build_dit(tree, cfg), scfg, cond, text.long(), mask, [0, 1], x0=x0
            ).numpy()
    return out


# -- Engine cores on the tiny pack -------------------------------------------------


def engines(rank, world, d):
    """World 4. ``EngineCore`` (opened gates) under sequence parallelism
    (2 × 2, Ulysses), DP × TP (2 × 2) and DP (4 × 1); ``TTSApi`` on DP 4."""
    from vietvoice_tts_tpu_torch.client import TTSApi
    from vietvoice_tts_tpu_torch.runtime.engine_core import EngineCore

    out = {}
    square, line = make_mesh(2, 2), make_mesh(4, 1)
    wave, ref_len, ids, total, seed = d["batch"]
    for name, mesh, extra in (
        ("sp", square, dict(sequence_parallel=True)),
        ("dp_tp", square, {}),
        ("dp", line, {}),
    ):
        cfg = ModelConfig(**{**d["config"], **extra})
        core = EngineCore(cfg, d["params"], d["vocab"], mesh=mesh)
        out[name] = core.synthesize_batch(wave, ref_len, ids, total, seed=seed)
        out[name + "_latent"] = core.mel_latent_batch(
            wave, ref_len, ids, total, seed=seed, x0=d["x0"]
        )
        out[name + "_cache_off"] = core._cond_eligible(np.array([8]), 128) is False
    api = TTSApi(ModelConfig(**d["config"]), mesh=line)
    out["api"], _ = api.synthesize(d["text"])
    api.cleanup()
    return out


# -- Training --------------------------------------------------------------------


def training(rank, world, d):
    """World 2. Two train steps on DP 2 and two on TP 2 from the same tree,
    batch and draws; then ``train(mesh=...)`` on TP 2 with checkpoints. On
    ``d["device"]`` (the CPU by default)."""
    from vietvoice_tts_tpu_torch.training import train as ttrain
    from vietvoice_tts_tpu_torch.training.checkpoint import whole_state
    from vietvoice_tts_tpu_torch.training.loop import TrainRunConfig, train

    out = {}
    tcfg = ttrain.TrainConfig(**d["train_cfg"])
    dims = d["dit_dims"]
    device = d.get("device", "cpu")
    batch = [_t(a).to(device) for a in d["batch"]]
    draws = ttrain.Draws(*(_t(a) for a in d["draws"])).to(device)
    for name, mesh in (("dp", make_mesh(2, 1)), ("tp", make_mesh(1, 2))):
        cfg = DiTConfig(**dims, model_group=mesh.model_group)
        tree = d["tree"]
        if mesh.model_group is not None:
            tree = shard_tree(tree, param_pspecs(cfg, None)["dit"], mesh.model_index, mesh.model)
        dit, opt = ttrain.init_train_state(tree, cfg, tcfg, device)
        step = ttrain.make_train_step(cfg, tcfg, mesh)
        for _ in range(2):  # the first update is at learning rate 0 (warm-up)
            out[name + "_loss"] = step(dit, opt, draws, *batch).item()
        model_state, opt_state = whole_state(dit, opt, mesh.model_group)
        out[name + "_params"] = to_jax_tree(model_state)
        if name == "tp":
            out["tp_sharded_shape"] = tuple(dit.blocks[0].qkv.weight.shape)

    mesh = make_mesh(1, 2)
    run = TrainRunConfig(steps=2, batch_size=2, checkpoint_dir=d["ckpt_dir"],
                         checkpoint_every=1, export_to_pack=True)
    summary = train(ModelConfig(**d["config"]), ttrain.TrainConfig(), run, mesh=mesh)
    out["train_losses"] = summary["losses"]
    return out


# -- The lockstep serving loop ------------------------------------------------------


def serving(rank, world, d):
    """World 2, TP 2 on the tiny pack. Rank 0 submits jobs to a
    ``MultiHostServingLoop``; both ranks record a hash of every real batch's
    PCM. ``clean``: rank 0's ``stop()`` stops the cluster. ``crash``: rank 0
    dies without stopping, and rank 1's loop must fail-stop."""
    from vietvoice_tts_tpu_torch.runtime.engine_core import EngineCore
    from vietvoice_tts_tpu_torch.serving.batcher import ChunkJob
    from vietvoice_tts_tpu_torch.serving.multihost import MultiHostServingLoop

    mode, bucket = d["mode"], d["bucket"]
    cfg = ModelConfig(**d["config"])
    core = EngineCore(cfg, d["params"], d["vocab"], mesh=make_mesh(1, 2))
    record: list = []
    real = core.synthesize_batch_async

    def recording(wave, ref_len, text_ids, total_len, seed=0):
        fetch = real(wave, ref_len, text_ids, total_len, seed=seed)
        is_real = bool((np.asarray(ref_len) > 0).any())

        def fetch_and_record():
            pcm = fetch()
            if is_real:
                record.append(hashlib.sha1(pcm.tobytes()).hexdigest())
            return pcm

        return fetch_and_record

    core.synthesize_batch_async = recording
    loop = MultiHostServingLoop(core, max_wait_ms=50.0)
    loop.start()
    out = {"hashes": None}
    deadline = time.monotonic() + 40.0
    if rank == 0:
        futures = [loop.submit(ChunkJob(**job)) for job in d["jobs"]]
        out["waves"] = [f.result(timeout=40.0) for f in futures]
        while time.monotonic() < deadline and not record:
            time.sleep(0.05)
        out["hashes"] = list(record)
        if mode == "crash":
            (Path(d["dir"]) / "rank0.pkl").write_bytes(pickle.dumps(out))
            time.sleep(2.0)  # the worker records its copy of the batch
            os._exit(1)  # no stop, no group teardown
        loop.stop(timeout=30.0)
        return out
    while time.monotonic() < deadline and loop._running:
        time.sleep(0.1)
    loop._thread.join(timeout=10.0)
    out["stopped"] = not loop._running and not loop._thread.is_alive()
    out["hashes"] = list(record)
    if mode == "crash":
        # The group is broken: skip its teardown, which would wait for rank 0.
        (Path(d["dir"]) / "rank1.pkl").write_bytes(pickle.dumps(out))
        sys.stdout.flush()
        os._exit(0)
    return out
