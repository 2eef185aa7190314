"""Where the bench's pipelined batch-32 loop spends its time, on the card.

    VIETVOICE_TPU_CACHE=<pack dir> python examples/torch_bench_trace.py [trace dir]

First a probe: with ~0.5 s of work queued on the device, how long does a
new pinned host buffer (``torch.empty(..., pin_memory=True)`` of a size the
caching host allocator does not hold) take to hand back, against the same
with the device idle? If it waits for the queue to drain, every dispatch
that needs a new pinned buffer serializes on the batch before it.

Then it loads the default model (``ModelConfig()``: 8 heads × 128, 22
layers, bf16) from the pack, runs what the bench runs before its batch-32
config (``bench_batched`` of ``vietvoice_tts_tpu_torch.bench`` at batch 8 ×
1024 and 64 × 512), then the batch-32 × 512 config under
``utils.profiling.trace`` (CPU and CUDA activities), with the pinned
allocator's counters (``torch.cuda.host_memory_stats``) read before and
after, and reads the Chrome trace it writes (default
``build/bench_trace/trace.json``) over the pipelined loop, the
``bench_batched_pipelined`` range (four batches, up to three in flight):

- the device's busy and idle share of the loop's wall, the kernels that
  take the most of its time, and each idle gap above 1 ms with the longest
  host CUDA runtime calls that overlap it;
- every pinned host allocation (``cudaHostAlloc``): when, how long, how much
  device work was queued when it began, and whether it returned only after
  that work was done — the mark of an allocation that waited for the device
  to drain, which would make the "pipelined" loop a serial one.

Each line names the card and its power limit.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from vietvoice_tts_tpu_torch import TTSApi  # noqa: E402
from vietvoice_tts_tpu_torch.bench import bench_batched  # noqa: E402
from vietvoice_tts_tpu_torch.utils.profiling import trace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
out_dir = Path(sys.argv[1]) if len(sys.argv) > 1 else ROOT / "build" / "bench_trace"
if not torch.cuda.is_available():
    sys.exit("needs a CUDA card")
smi = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True, text=True,
                     check=True).stdout.strip()


def new_pinned_buffer_ms(queued_cycles: int, n_bytes: int) -> tuple:
    """(ms until a new pinned buffer of n_bytes is handed back, ms until the
    device is also done) with ``queued_cycles`` of device sleep queued."""
    torch.cuda.synchronize()
    if queued_cycles:
        torch.cuda._sleep(queued_cycles)
    t0 = time.perf_counter()
    torch.empty(n_bytes, dtype=torch.uint8, pin_memory=True)
    alloc = time.perf_counter() - t0
    torch.cuda.synchronize()
    return alloc * 1e3, (time.perf_counter() - t0) * 1e3


new_pinned_buffer_ms(0, 1 << 20)  # the context and the allocator exist
for label, cycles, n_bytes in (("device idle", 0, 96 << 20),
                               ("~0.5 s queued", 10**9, 200 << 20)):
    alloc_ms, done_ms = new_pinned_buffer_ms(cycles, n_bytes)
    print(f"probe, {label}: a new {n_bytes >> 20} MiB pinned buffer in {alloc_ms:.1f} ms; "
          f"the device done after {done_ms:.1f} ms [{smi}]", flush=True)

api = TTSApi()
core = api.engine.engine_core
hop, sr = core.config.hop_length, core.config.sample_rate
for batch, frames, ref in ((8, 1024, 250), (64, 512, 125)):
    print(f"before: {bench_batched(core, hop, sr, batch, frames, ref, 'before')} [{smi}]",
          flush=True)


def pinned_counters() -> dict:
    stats = getattr(torch.cuda, "host_memory_stats", dict)()
    return {k: stats.get(k, 0) for k in ("num_host_alloc", "host_alloc_time.total")}


before = pinned_counters()
t0 = time.perf_counter()
with trace(str(out_dir)):
    traced = bench_batched(core, hop, sr, 32, 512, 125, "traced")
after = pinned_counters()
print(f"traced: {traced} ({time.perf_counter() - t0:.1f} s with the profiler and its "
      f"export) [{smi}]", flush=True)
print(f"pinned allocator over the traced config: {after['num_host_alloc'] - before['num_host_alloc']} "
      f"new blocks, {(after['host_alloc_time.total'] - before['host_alloc_time.total']) / 1e3:.1f} "
      f"ms in CUDA's allocation calls", flush=True)
api.cleanup()

events = [e for e in json.loads((out_dir / "trace.json").read_text())["traceEvents"]
          if e.get("ph") == "X"]
loop = next(e for e in events if e.get("name") == "bench_batched_pipelined"
            and e.get("cat") == "user_annotation")
t_start, t_end = loop["ts"], loop["ts"] + loop["dur"]
device = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
runtime = [e for e in events if e.get("cat") == "cuda_runtime"]

busy, gaps, edge = 0.0, [], t_start
for s, e in device:
    s, e = max(s, t_start), min(e, t_end)
    if e <= edge:
        continue
    if s > edge:
        gaps.append((edge, s))
    busy += e - max(s, edge)
    edge = e
if edge < t_end:
    gaps.append((edge, t_end))
wall = t_end - t_start
kernels = [e for e in events if e.get("cat") == "kernel" and t_start <= e["ts"] < t_end]
print(f"loop: {wall / 1e3:.1f} ms wall for 4 batches; device busy {busy / 1e3:.1f} ms "
      f"({100 * busy / wall:.1f}%), idle {100 * (1 - busy / wall):.1f}%; {len(kernels)} kernels, "
      f"{sum(e['dur'] for e in kernels) / 1e3:.1f} ms of kernel time [{smi}]", flush=True)
by_name: dict = {}
for e in kernels:
    total, count = by_name.get(e["name"], (0.0, 0))
    by_name[e["name"]] = (total + e["dur"], count + 1)
for name, (total, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
    print(f"  {total / 1e3:9.1f} ms {count:6d}× {name[:100]}")
for s, e in gaps:
    if e - s < 1e3:
        continue
    overlap = sorted((r for r in runtime if r["ts"] < e and r["ts"] + r["dur"] > s),
                     key=lambda r: -r["dur"])[:3]
    calls = ", ".join(f"{r['name']} {r['dur'] / 1e3:.2f} ms" for r in overlap) or "none"
    print(f"  device idle {(e - s) / 1e3:.2f} ms from +{(s - t_start) / 1e3:.1f} ms; "
          f"host runtime calls over it: {calls}")

# The device work queued at a moment: the latest end of a kernel whose launch
# (the runtime call with its correlation id) came before that moment.
kernel_end = {e["args"]["correlation"]: e["ts"] + e["dur"] for e in events
              if e.get("cat") == "kernel" and "correlation" in e.get("args", {})}
launches = sorted((r["ts"], kernel_end[r["args"]["correlation"]]) for r in runtime
                  if r.get("args", {}).get("correlation") in kernel_end)
allocs = [r for r in runtime if "HostAlloc" in r["name"] or "MallocHost" in r["name"]]
print(f"pinned host allocations in the trace: {len(allocs)}, "
      f"{sum(1 for r in allocs if t_start <= r['ts'] < t_end)} in the loop", flush=True)
for r in allocs:
    begin, end = r["ts"], r["ts"] + r["dur"]
    queued_end = max((k_end for ts, k_end in launches if ts < begin), default=begin)
    print(f"  {r['name']} at +{(begin - t_start) / 1e3:.1f} ms: {r['dur'] / 1e3:.2f} ms; "
          f"device work queued at its start {max(queued_end - begin, 0) / 1e3:.1f} ms; "
          f"returned {(end - queued_end) / 1e3:+.1f} ms after that work ended "
          f"({'waited for the device' if queued_end > begin and end >= queued_end else 'did not wait'})")
