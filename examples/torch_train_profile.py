"""Where a train step of the PyTorch port's trainer spends its time, on the card.

    python examples/torch_train_profile.py [compute_dtype] [batch] [frames] [--graph]

Builds the default full-width DiT (1024 × 22, 8 heads × 128) from seeded
random weights with float32 master weights, exactly as
``vietvoice_tts_tpu_torch.training`` does, and trains it on one random batch
(default: bfloat16 compute, batch 8, 256 frames, 187 of them valid as in the
seeded pack's 2 s clips). The steps run eagerly (the step's ``graphs`` set
to None), as before the trainer captured them. After three warm-up steps it
prints, in ms:

- the step's wall time as the training loop sees it (the host reads the
  loss, which waits for the device), median of 10 steps;
- each phase alone — forward, backward, clip, AdamW — with a synchronise
  after each (so a phase's time is the longer of its host and device work);
- from ``torch.profiler`` over 3 steps: device kernel time and kernel count
  per step, the device's idle share of the wall time, and the ten kernels
  that take the most device time.

With ``--graph`` it compares the step as the trainer runs it on the card, a
replay of a CUDA graph captured for its shape (``TrainStep``), with the
eager step, from one initial state each: the capture (its wall, nodes by
type, the pool), then 10 rounds that take one step of each in
alternating order, printing for each mode the median wall (for the graph
also the replay's device span by CUDA events queued around it, so wall −
span is host time with the device idle, and how long its launch holds the
host) and, from ``torch.profiler`` over 3 steps, the device kernel time,
its idle share, the host's launch calls and the top kernels.

Each line names the card and its power limit. Nothing is written to disk.
"""

import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from vietvoice_tts_tpu_torch.models.dit import DiTConfig, init_dit_params  # noqa: E402
from vietvoice_tts_tpu_torch.pipeline.text import VALID_CHARS  # noqa: E402
from vietvoice_tts_tpu_torch.training import train as ttrain  # noqa: E402

graph_mode = "--graph" in sys.argv[1:]
args = [a for a in sys.argv[1:] if a != "--graph"]
dtype = args[0] if len(args) > 0 else "bfloat16"
batch = int(args[1]) if len(args) > 1 else 8
frames = int(args[2]) if len(args) > 2 else 256
if not torch.cuda.is_available():
    sys.exit("needs a CUDA card")
smi = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True, text=True,
                     check=True).stdout.strip()
torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

dev = torch.device("cuda")
dcfg = DiTConfig(vocab_size=len(VALID_CHARS))
tcfg = ttrain.TrainConfig(compute_dtype=dtype, warmup_steps=2)
tree = init_dit_params(0, dcfg)
dit, opt = ttrain.init_train_state(tree, dcfg, tcfg, dev)
n_params = sum(p.numel() for p in dit.parameters())
rng = np.random.default_rng(0)
valid = min(frames, 187)
mel = rng.normal(-4.0, 2.0, (batch, frames, dcfg.n_mels)).astype(np.float32)
ids = np.full((batch, frames), -1, np.int32)
ids[:, :50] = rng.integers(0, dcfg.vocab_size, (batch, 50))
tensors = ttrain.as_tensors(mel, ids, np.full((batch,), valid, np.int32), dev)
gen = torch.Generator().manual_seed(0)
step = ttrain.make_train_step(dcfg, tcfg)
step.graphs = None


def one_step(state=None) -> float:
    draws = ttrain.draw(gen, batch, frames, dcfg.n_mels, tcfg).to(dev)
    model, optimizer, fn = state or (dit, opt, step)
    return fn(model, optimizer, draws, *tensors).item()


def traced(fn, steps: int, wall_ms: float, top: int) -> None:
    """Device kernels of ``steps`` calls of ``fn`` from torch.profiler, and
    the device's idle share of a step of ``wall_ms``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        prof_wall = (time.perf_counter() - t0) * 1e3 / steps
    # Device-side events that are kernels: not the ranges that user
    # annotations (such as the optimizer's ``Optimizer.step#…``) also put on
    # the device.
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False) and "#" not in e.key]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    launches = sum(e.count for e in kernels) / steps
    # The host's launch calls, as the runtime saw them: one graph launch a
    # replay, one kernel launch (or memset) per eager kernel.
    host = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CPU]
    calls = {k: sum(e.count for e in host if k in e.key) / steps
             for k in ("LaunchKernel", "GraphLaunch", "Memset")}
    if device_ms == 0:
        print(f"profiler: no device time recorded [{smi}]")
        return
    print(f"profiler, {steps} steps: device kernels {device_ms:.1f} ms in {launches:.0f} "
          f"launches a step: the device idles {100 * (1 - device_ms / wall_ms):.0f}% of the "
          f"{wall_ms:.1f} ms step (wall {prof_wall:.1f} ms a step with the profiler on); host "
          f"calls a step: {', '.join(f'{k} {v:.0f}' for k, v in calls.items())} [{smi}]")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3 / steps:8.2f} ms {e.count // steps:6d}× "
              f"{e.key[:110]}")


if graph_mode:
    graphed = ttrain.make_train_step(dcfg, tcfg)
    g_dit, g_opt = ttrain.init_train_state(tree, dcfg, tcfg, dev)
    states = {"graph": (g_dit, g_opt, graphed), "eager": (dit, opt, step)}
    before = torch.cuda.memory_reserved()
    one_step(states["graph"])  # the capture; its eager run is this step
    entry = next(iter(graphed.graphs.entries.values()))
    pool = graphed.graphs.pool_bytes()
    # The replay's own span on the device: events queued just before and just
    # after it, so wall − span is the step's host time around the replay.
    replay, replay_spans, replay_host = entry.graph.replay, [], []

    def timed_replay():
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        events[0].record()
        t0 = time.perf_counter()
        replay()
        replay_host.append((time.perf_counter() - t0) * 1e3)
        events[1].record()
        replay_spans.append(events)

    entry.graph.replay = timed_replay
    print(f"graph of ({batch}, {frames}, {dtype}): capture {entry.capture_s:.2f} s wall (its "
          f"eager run included), nodes by type {entry.graph.node_types} (rewritten as "
          f"kernels: {entry.graph.rewritten}); pool "
          f"{pool[0] / 2**30:.2f} GiB reserved, {pool[1] / 2**30:.3f} GiB allocated; device "
          f"memory reserved +{(torch.cuda.memory_reserved() - before) / 2**30:.2f} GiB (the "
          f"Adam state included) [{smi}]", flush=True)
    for _ in range(3):
        for state in states.values():
            one_step(state)
    walls = {m: [] for m in states}
    replay_spans.clear()
    replay_host.clear()
    for rnd in range(10):
        for mode in (("graph", "eager") if rnd % 2 == 0 else ("eager", "graph")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one_step(states[mode])
            walls[mode].append((time.perf_counter() - t0) * 1e3)
    span = statistics.median(a.elapsed_time(b) for a, b in replay_spans)
    tokens = batch * frames
    for mode in states:
        wall = statistics.median(walls[mode])
        print(f"{mode}: step {wall:.1f} ms (median of 10 interleaved: "
              f"{' '.join(f'{w:.1f}' for w in walls[mode])}), {tokens / wall * 1e3:.0f} "
              f"tokens/s, 6·P·tokens / step {6 * n_params * tokens / wall / 1e9:.1f} TFLOP/s"
              + (f"; the replay spans {span:.1f} ms on the device (CUDA events around "
                 f"it, median of {len(replay_spans)}) and its launch holds the host "
                 f"{statistics.median(replay_host):.1f} ms" if mode == "graph" else "")
              + f" [{smi}]", flush=True)
        traced(lambda m=mode: one_step(states[m]), 3, wall, 10)
    ratio = statistics.median(walls["eager"]) / statistics.median(walls["graph"])
    print(f"eager / graph: {ratio:.2f} [{smi}]")
    sys.exit(0)


for _ in range(3):
    one_step()
walls = []
for _ in range(10):
    t0 = time.perf_counter()
    one_step()
    walls.append((time.perf_counter() - t0) * 1e3)
wall = statistics.median(walls)
tokens = batch * frames
print(f"{dtype}, batch {batch} × {frames} frames, P = {n_params:,}: step {wall:.1f} ms "
      f"(median of 10: {' '.join(f'{w:.1f}' for w in walls)}), {tokens / wall * 1e3:.0f} "
      f"tokens/s, 6·P·tokens / step {6 * n_params * tokens / wall / 1e9:.1f} TFLOP/s "
      f"[{smi}]", flush=True)


def timed(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


phases = {"draw + copy": [], "forward": [], "backward": [], "clip": [], "adamw": []}
for _ in range(5):
    box = {}
    phases["draw + copy"].append(timed(lambda: box.update(
        d=ttrain.draw(gen, batch, frames, dcfg.n_mels, tcfg).to(dev))))
    opt.zero_grad(set_to_none=True)
    phases["forward"].append(timed(lambda: box.update(
        loss=ttrain.flow_matching_loss(dit, *tensors, box["d"]))))
    phases["backward"].append(timed(lambda: box["loss"].backward()))
    params = [p for p in dit.parameters()]
    phases["clip"].append(timed(lambda: ttrain.clip_by_global_norm(
        [p.grad for p in params], tcfg.max_grad_norm)))
    phases["adamw"].append(timed(opt.step))
print("phases alone, median of 5 (ms): " + ", ".join(
    f"{k} {statistics.median(v):.1f}" for k, v in phases.items()) + f" [{smi}]", flush=True)

traced(one_step, 3, wall, 10)
