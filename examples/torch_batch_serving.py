"""Concurrent synthesis through the PyTorch port's micro-batcher: many
requests share padded batches on the card transparently.

    python examples/torch_batch_serving.py
"""

import threading

from vietvoice_tts_tpu_torch import ModelConfig, TTSApi

api = TTSApi(ModelConfig(device="cuda", max_batch_size=8))
api.engine.enable_micro_batching(max_wait_ms=10)

texts = [f"Đây là yêu cầu số {i} trong lô." for i in range(16)]
results = {}


def worker(i: int) -> None:
    wave, t = api.synthesize(texts[i])
    results[i] = (len(wave) / 24000.0, t)


threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(texts))]
for t in threads:
    t.start()
for t in threads:
    t.join()

stats = api.engine.batcher.stats
print(f"{len(results)} utterances, mean device batch {stats.mean_batch_size:.1f}")
for i, (dur, t) in sorted(results.items()):
    print(f"  #{i}: {dur:.2f}s audio in {t:.2f}s")
