"""Voice selection from the bundled catalog + voice cloning from user audio,
with the PyTorch port on the card.

    python examples/torch_voice_selection.py
"""

from vietvoice_tts_tpu_torch import ModelConfig, TTSApi
from vietvoice_tts_tpu_torch.reference_samples import filter_samples, load_reference_samples

api = TTSApi(ModelConfig(device="cuda"))

# Pick a catalog voice by tags.
api.synthesize_to_file(
    "Bản tin thời sự buổi tối.",
    "output/male_southern.wav",
    gender="male",
    area="southern",
    emotion="serious",
)

# Browse the catalog programmatically.
samples = load_reference_samples()
happy = filter_samples(samples, emotion="happy")
print(f"{len(happy)} happy voices available")

# Clone a voice from your own clip (transcript required).
api.synthesize_to_file(
    "Giọng nói này được nhân bản từ đoạn âm thanh tham khảo.",
    "output/cloned.wav",
    reference_audio="output/male_southern.wav",
    reference_text="Bản tin thời sự buổi tối.",
)
