"""Weight-pack and voice-catalog session management.

Port of ``vietvoice_tts_tpu/runtime/session.py``. The pack directory has the
same layout in both packages:

    <model_cache_dir>/<model_name>/
        params.msgpack       flax-format msgpack {'dit': ..., 'vocoder': ...}
        model_meta.json      architecture dims the pack was built with
        vocab.txt            one character per line
        audio_metadata.json  voice catalog (file_name/gender/group/area/emotion/text)
        audios/*.wav         reference voice clips

When the pack doesn't exist it is materialized from the configured seed with
the same RNG draws as the JAX package, so both packages build the same pack
from one seed.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..config import (
    MODEL_AREA,
    MODEL_EMOTION,
    MODEL_GENDER,
    MODEL_GROUP,
    ModelConfig,
)
from ..utils.logging import get_logger
from ..utils.wavio import write_wav

log = get_logger("session")

_VI_SENTENCES = [
    "Xin chào, đây là giọng nói tham khảo của hệ thống.",
    "Hôm nay trời đẹp, chúng ta cùng nhau đọc một câu chuyện.",
    "Tin tức buổi sáng được cập nhật liên tục trong ngày.",
    "Cảm ơn bạn đã lắng nghe bản tin của chúng tôi.",
    "Mỗi cuốn sách là một người bạn đồng hành đáng quý.",
    "Chúc bạn một ngày làm việc hiệu quả và vui vẻ.",
]


def default_vocab_chars() -> list[str]:
    """Character set shipped with the default pack."""
    from ..pipeline.text import VALID_CHARS

    return list(VALID_CHARS)


def _synth_reference_clip(rng: np.ndarray, sample_rate: int, seconds: float = 2.0, f0: float = 150.0) -> np.ndarray:
    """Deterministic harmonic-series 'voice' clip for the offline catalog."""
    t = np.arange(int(seconds * sample_rate)) / sample_rate
    sig = np.zeros_like(t)
    for h, amp in enumerate([1.0, 0.6, 0.35, 0.2, 0.1], start=1):
        vib = 1.0 + 0.01 * np.sin(2 * np.pi * 5.0 * t + h)
        sig += amp * np.sin(2 * np.pi * f0 * h * vib * t)
    # Amplitude envelope with syllable-like modulation.
    env = 0.5 * (1 + np.sin(2 * np.pi * 3.0 * t - np.pi / 2)) * 0.8 + 0.2
    sig = sig * env + 0.01 * rng
    sig = sig / np.abs(sig).max() * 0.8
    return sig.astype(np.float32)


def config_from_pack(pack_dir, **overrides) -> ModelConfig:
    """Build a ModelConfig whose architecture dims match a weight pack's
    ``model_meta.json``."""
    pack = Path(pack_dir)
    meta = json.loads((pack / "model_meta.json").read_text())
    fields = dict(
        model_cache_dir=str(pack.parent),
        model_name=pack.name,
        vocab_size=meta.get("vocab_size", 256),
        n_mels=meta.get("n_mels", 100),
        n_fft=meta.get("n_fft", 1024),
        hop_length=meta.get("hop_length", 256),
        sample_rate=meta.get("sample_rate", 24000),
    )
    dit = meta.get("dit", {})
    for src, dst in (
        ("dim", "dit_dim"), ("depth", "dit_depth"), ("heads", "dit_heads"),
        ("ff_mult", "dit_ff_mult"), ("text_dim", "text_dim"),
        ("text_conv_layers", "text_conv_layers"),
    ):
        if src in dit:
            fields[dst] = dit[src]
    voc = meta.get("vocoder", {})
    for src, dst in (
        ("dim", "vocoder_dim"), ("intermediate_dim", "vocoder_intermediate_dim"),
        ("num_layers", "vocoder_num_layers"),
    ):
        if src in voc:
            fields[dst] = voc[src]
    fields.update(overrides)
    return ModelConfig(**fields)


class ModelSessionManager:
    """Loads (or materializes) the weight pack; owns vocab path, voice
    catalog, and reference-sample selection."""

    def __init__(self, config: ModelConfig):
        self.config = config
        self.params = None  # {'dit': pytree, 'vocoder': pytree}, numpy leaves
        self.sample_metadata: list[dict] = []
        self.vocab_path: Optional[str] = None
        self.vocab_size: int = 0
        self.is_synthetic: bool = False

    # -- Pack creation -------------------------------------------------------

    def _materialize_pack(self, pack: Path) -> None:
        from ..models.dit import DiTConfig, init_dit_params
        from ..models.vocoder import VocoderConfig, init_vocoder_params
        from .serialization import save_params

        log.info("Materializing weight pack at %s (seed=%d)", pack, self.config.random_seed)
        pack.mkdir(parents=True, exist_ok=True)

        chars = default_vocab_chars()
        (pack / "vocab.txt").write_text("\n".join(chars) + "\n", encoding="utf-8")

        cfg = self.config
        dit_cfg = DiTConfig(
            dim=cfg.dit_dim,
            depth=cfg.dit_depth,
            heads=cfg.dit_heads,
            ff_mult=cfg.dit_ff_mult,
            n_mels=cfg.n_mels,
            text_dim=cfg.text_dim,
            text_conv_layers=cfg.text_conv_layers,
            vocab_size=len(chars),
        )
        voc_cfg = VocoderConfig(
            dim=cfg.vocoder_dim,
            intermediate_dim=cfg.vocoder_intermediate_dim,
            num_layers=cfg.vocoder_num_layers,
            n_mels=cfg.n_mels,
            n_fft=cfg.n_fft,
            hop_length=cfg.hop_length,
        )
        rng = np.random.default_rng(cfg.random_seed)
        params = {
            "dit": init_dit_params(rng, dit_cfg),
            "vocoder": init_vocoder_params(rng, voc_cfg),
        }
        save_params(pack / "params.msgpack", params)
        meta = {
            "vocab_size": len(chars),
            "dit": {
                "dim": dit_cfg.dim,
                "depth": dit_cfg.depth,
                "heads": dit_cfg.heads,
                "ff_mult": dit_cfg.ff_mult,
                "text_dim": dit_cfg.text_dim,
                "text_conv_layers": dit_cfg.text_conv_layers,
            },
            "vocoder": {
                "dim": voc_cfg.dim,
                "intermediate_dim": voc_cfg.intermediate_dim,
                "num_layers": voc_cfg.num_layers,
            },
            "n_mels": cfg.n_mels,
            "n_fft": cfg.n_fft,
            "hop_length": cfg.hop_length,
            "sample_rate": cfg.sample_rate,
            "seed": cfg.random_seed,
            # Seeded-random pack: runs the full pipeline offline but produces
            # noise, not speech.
            "synthetic": True,
        }
        (pack / "model_meta.json").write_text(json.dumps(meta, indent=2))

        # Voice catalog: one clip per (gender, area, emotion); groups cycle.
        audios = pack / "audios"
        audios.mkdir(exist_ok=True)
        catalog = []
        rng = np.random.default_rng(cfg.random_seed)
        idx = 0
        for gender in MODEL_GENDER:
            for area in MODEL_AREA:
                for emotion in MODEL_EMOTION:
                    group = MODEL_GROUP[idx % len(MODEL_GROUP)]
                    f0 = (120.0 if gender == "male" else 210.0) + 8.0 * (idx % 5)
                    noise = rng.standard_normal(int(2.0 * cfg.sample_rate))
                    clip = _synth_reference_clip(noise, cfg.sample_rate, f0=f0)
                    fname = f"{gender}_{area}_{emotion}_{idx:03d}.wav"
                    write_wav(clip, audios / fname, cfg.sample_rate)
                    catalog.append(
                        {
                            "file_name": fname,
                            "gender": gender,
                            "group": group,
                            "area": area,
                            "emotion": emotion,
                            "text": _VI_SENTENCES[idx % len(_VI_SENTENCES)],
                        }
                    )
                    idx += 1
        (pack / "audio_metadata.json").write_text(
            json.dumps(catalog, ensure_ascii=False, indent=1)
        )

    # -- Loading -------------------------------------------------------------

    def load_models(self) -> None:
        """Load (materializing if needed) params, vocab, and catalog."""
        from .serialization import load_params

        pack = Path(self.config.model_path)
        if not (pack / "params.msgpack").exists():
            if not self.config.allow_synthetic_pack:
                raise RuntimeError(
                    f"No weight pack at {pack} and allow_synthetic_pack=False: "
                    "refusing to materialize random weights. Point "
                    "model_cache_dir at a converted pack."
                )
            self._materialize_pack(pack)
        meta = json.loads((pack / "model_meta.json").read_text())
        # Only converted packs carry converted_from; its absence means the
        # pack was materialized from a seed.
        self.is_synthetic = bool(meta.get("synthetic", "converted_from" not in meta))
        if self.is_synthetic:
            if not self.config.allow_synthetic_pack:
                raise RuntimeError(
                    f"Weight pack at {pack} is marked synthetic (seeded-random "
                    "weights) and allow_synthetic_pack=False: refusing to "
                    "serve noise as speech."
                )
            log.warning(
                "Weight pack %s is SYNTHETIC (seeded-random weights): output "
                "is noise, not speech.",
                pack,
            )
        self.vocab_size = meta["vocab_size"]
        self.params = load_params(pack / "params.msgpack")
        self.vocab_path = str(pack / "vocab.txt")
        self.sample_metadata = json.loads((pack / "audio_metadata.json").read_text())
        self.model_meta = meta
        log.info(
            "Loaded weight pack %s (vocab=%d, %d voice samples)",
            pack,
            self.vocab_size,
            len(self.sample_metadata),
        )

    # -- Sample selection (reference core/model.py:137-214) ------------------

    def select_sample(
        self,
        gender: Optional[str] = None,
        group: Optional[str] = None,
        area: Optional[str] = None,
        emotion: Optional[str] = None,
        sample_iteration: Optional[int] = None,
        reference_audio: Optional[str] = None,
        reference_text: Optional[str] = None,
    ) -> Tuple[str | bytes, str]:
        """Resolve (reference_audio, reference_text) from explicit args or the
        catalog, with config defaults and first-sample fallback. Only
        *explicitly passed* voice filters conflict with reference audio."""
        explicit_filters = [
            name
            for name, value in (
                ("gender", gender),
                ("group", group),
                ("area", area),
                ("emotion", emotion),
            )
            if value is not None
        ]
        gender = gender or self.config.gender
        group = group or self.config.group
        area = area or self.config.area
        emotion = emotion or self.config.emotion

        filters = {}
        for name, value, allowed in (
            ("gender", gender, MODEL_GENDER),
            ("group", group, MODEL_GROUP),
            ("area", area, MODEL_AREA),
            ("emotion", emotion, MODEL_EMOTION),
        ):
            if value is not None:
                if value not in allowed:
                    raise ValueError(
                        f"Invalid {name}: {value}. Must be one of {allowed}"
                    )
                filters[name] = value

        if reference_audio is not None:
            if reference_text is None:
                raise ValueError("Reference text is required when using reference audio")
            if not Path(reference_audio).exists():
                raise FileNotFoundError(
                    f"Reference audio file not found: {reference_audio}"
                )
            if explicit_filters:
                raise ValueError(
                    f"Cannot use reference audio and text with options: {explicit_filters}"
                )
            log.info("Using user reference audio: %s", reference_audio)
            return reference_audio, reference_text

        matching = [
            (s, i)
            for i, s in enumerate(self.sample_metadata)
            if all(s[k] == v for k, v in filters.items())
        ]
        if not matching:
            sample, sample_idx = self.sample_metadata[0], 0
        elif sample_iteration is not None:
            if sample_iteration >= len(matching):
                raise ValueError(
                    f"sample_iteration {sample_iteration} is out of range. "
                    f"Only {len(matching)} samples available for the given filters."
                )
            sample, sample_idx = matching[sample_iteration]
        else:
            sample, sample_idx = matching[0]

        log.info(
            "Selected sample #%d: gender=%s group=%s area=%s emotion=%s",
            sample_idx,
            sample["gender"],
            sample["group"],
            sample["area"],
            sample["emotion"],
        )
        audio_path = Path(self.config.model_path) / "audios" / sample["file_name"]
        return str(audio_path), sample["text"]

    def cleanup(self) -> None:
        """Release the host copy of the weights (the pack on disk stays)."""
        self.params = None
