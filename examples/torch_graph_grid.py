"""The serving grid's CUDA graphs on the card: what ``warmup`` captures and
what it costs.

    VIETVOICE_TPU_CACHE=<pack dir> python examples/torch_graph_grid.py [out.json]

Loads the default model (``ModelConfig()``: 8 heads × 128, 22 layers, bf16)
from the pack (a seeded one is made there if none lies there), then runs
``TTSEngine.warmup()`` over the whole serving grid: every batch size the
micro-batcher dispatches (``config.batch_grid()``) at every frame bucket,
and the waveform route at batch 1, one captured graph each
(``runtime/graphs.py``). It prints the device memory reserved and allocated
before and after (the graphs share one pool), the warm-up's wall, and per
graph its capture wall (an eager run and the capture), its nodes by type
(kernel, memset, memcpy, event, host, other), the memset and memcpy nodes
the rewrite turned into kernels, and the median over three
replays of its device ms (CUDA events) and of the host's ms to launch it.
Each line names the card and its power limit; the whole table is written as
JSON (default ``build/graph_grid.json``).
"""

import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from vietvoice_tts_tpu_torch import TTSApi  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
out = Path(sys.argv[1]) if len(sys.argv) > 1 else ROOT / "build" / "graph_grid.json"
if not torch.cuda.is_available():
    sys.exit("needs a CUDA card")
smi = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True, text=True,
                     check=True).stdout.strip()

api = TTSApi()
engine = api.engine
core = engine.engine_core
gc.collect()
torch.cuda.empty_cache()
torch.cuda.synchronize()
before = torch.cuda.memory_reserved(), torch.cuda.memory_allocated()
t0 = time.perf_counter()
engine.warmup()
torch.cuda.synchronize()
wall = time.perf_counter() - t0
after = torch.cuda.memory_reserved(), torch.cuda.memory_allocated()
print(f"warmup of {len(core.graphs.entries)} graphs (batches {engine.config.batch_grid()} × "
      f"{len(engine.config.frame_buckets)} buckets, + the waveform route at batch 1): "
      f"{wall:.1f} s; device memory reserved {before[0] / 2**30:.2f} → "
      f"{after[0] / 2**30:.2f} GiB, allocated {before[1] / 2**30:.2f} → "
      f"{after[1] / 2**30:.2f} GiB [{smi}]", flush=True)

rows = []
for key, entry in core.graphs.entries.items():
    route, b, n = key[:3]
    device_ms, host_ms = [], []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        t0 = time.perf_counter()
        entry.graph.replay()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        device_ms.append(start.elapsed_time(end))
    row = {"route": route, "batch": b, "frames": n, "capture_s": round(entry.capture_s, 3),
           "nodes": entry.graph.node_types, "rewritten": entry.graph.rewritten,
           "replay_device_ms": round(statistics.median(device_ms), 3),
           "replay_host_ms": round(statistics.median(host_ms), 3)}
    rows.append(row)
    print(json.dumps(row), flush=True)
out.parent.mkdir(parents=True, exist_ok=True)
out.write_text(json.dumps({"card": smi, "warmup_s": wall, "reserved_bytes": after[0] - before[0],
                           "allocated_bytes": after[1] - before[1], "graphs": rows}, indent=1))
worst = max(rows, key=lambda r: r["replay_host_ms"])
print(f"{len(rows)} graphs; capture {sum(r['capture_s'] for r in rows):.1f} s in all, replay "
      f"device {sum(r['replay_device_ms'] for r in rows) / 1e3:.1f} s in all; memset nodes "
      f"left {sum(r['nodes']['memset'] for r in rows)}, rewritten "
      f"{sum(r['rewritten']['memset'] for r in rows)}; memcpy nodes rewritten "
      f"{sum(r['rewritten']['memcpy'] for r in rows)}, left "
      f"{sum(r['nodes']['memcpy'] for r in rows)}; longest launch {worst['replay_host_ms']} ms "
      f"(B={worst['batch']} N={worst['frames']}) [{smi}]")
api.cleanup()
