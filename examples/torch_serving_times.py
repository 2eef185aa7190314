"""Time the PyTorch port's serving requests on one checkout, on the card.

    python examples/torch_serving_times.py <checkout> <label> [model_cache_dir]

Imports ``vietvoice_tts_tpu_torch`` from ``<checkout>`` (so two checkouts can
be compared in one session on one card: run it once per checkout, in the
order A B B A), loads the default full-width model (a seeded pack is made
under ``model_cache_dir`` when none lies there) and prints one line of wall
times in ms: a short sentence six times, a long text (three chunks in one
batch) three times, and the long text streamed four times (all pieces, and
the first piece). The host queues every kernel of a request, so these times
move with the machine's CPU as much as with the card: compare two checkouts
only within one session.
"""

import sys
import time

tree, label = sys.argv[1], sys.argv[2]
cache_dir = sys.argv[3] if len(sys.argv) > 3 else "build/serving_times/models"
sys.path.insert(0, tree)

import torch  # noqa: E402

from vietvoice_tts_tpu_torch import ModelConfig, TTSApi  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
SHORT = "Xin chào, hôm nay trời rất đẹp."
LONG = " ".join(["Nguoi dan thanh pho thuc day som de chuan bi cho mot ngay lam viec moi."] * 16)

api = TTSApi(ModelConfig(device="cuda", model_cache_dir=cache_dir))
api.synthesize(SHORT)  # load, first use of the libraries, kernel build


def timed(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


shorts = [timed(lambda: api.synthesize(SHORT)) for _ in range(6)]
longs = [timed(lambda: api.synthesize(LONG)) for _ in range(3)]
streams, firsts = [], []
for _ in range(4):
    t0, first = time.perf_counter(), None
    for _piece in api.synthesize_streaming(LONG):
        if first is None:
            first = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    streams.append((time.perf_counter() - t0) * 1e3)
    firsts.append(first)


def fmt(xs) -> str:
    return " ".join(f"{x:.1f}" for x in xs)


print(f"{label}: short {fmt(shorts)} | long {fmt(longs)} | stream all {fmt(streams)} "
      f"| first {fmt(firsts)}", flush=True)
