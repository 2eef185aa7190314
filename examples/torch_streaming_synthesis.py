"""Streaming synthesis with the PyTorch port: play audio while later chunks
are still computing on the card.

For long texts, ``synthesize_streaming`` yields int16 pieces as each chunk
finishes — time-to-first-audio is ONE chunk's latency.
``first_chunk_duration`` caps the head chunk so playback starts sooner, at
the cost of one extra cross-fade boundary.

    python examples/torch_streaming_synthesis.py
"""

import time

import numpy as np

from vietvoice_tts_tpu_torch import ModelConfig, TTSApi
from vietvoice_tts_tpu_torch.utils.wavio import write_wav

LONG_TEXT = (
    "Trong một ngôi làng nhỏ ven sông, có một người thợ mộc già sống cùng "
    "đứa cháu nhỏ của mình. Mỗi buổi sáng, ông thức dậy từ rất sớm, pha "
    "một ấm trà nóng, rồi bắt đầu công việc với những thanh gỗ thơm mùi "
    "nhựa mới. Tiếng bào gỗ đều đặn vang lên như một bản nhạc quen thuộc "
    "của cả xóm. Người ta nói rằng bàn tay ông có thể biến những khúc gỗ "
    "xù xì thành những món đồ tinh xảo nhất vùng."
)

api = TTSApi(ModelConfig(device="cuda"))
t0 = time.perf_counter()
pieces = []
for i, piece in enumerate(api.synthesize_streaming(LONG_TEXT, first_chunk_duration=4.0)):
    dt = time.perf_counter() - t0
    print(f"piece {i}: {len(piece) / 24000:.2f}s of audio after {dt * 1e3:.0f} ms")
    pieces.append(piece)  # a real player would start playback here

write_wav(np.concatenate(pieces), "output/streamed.wav", 24000)
print("Done → output/streamed.wav")
