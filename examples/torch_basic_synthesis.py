"""Basic synthesis with the PyTorch port: default voice → WAV file, on the card.

    python examples/torch_basic_synthesis.py

Without a CUDA card, ``ModelConfig(device="cpu")`` runs it on the CPU.
"""

from vietvoice_tts_tpu_torch import ModelConfig, TTSApi

api = TTSApi(ModelConfig(device="cuda"))
generation_time = api.synthesize_to_file(
    "Xin chào! Đây là hệ thống tổng hợp giọng nói tiếng Việt chạy trên GPU.",
    "output/basic.wav",
)
print(f"Done in {generation_time:.2f}s → output/basic.wav")
