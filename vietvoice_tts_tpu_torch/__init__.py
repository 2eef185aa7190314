"""VietVoice TTS on PyTorch and CUDA — the port of ``vietvoice_tts_tpu``.

Same entry points and module names as the JAX package, with hand-written
CUDA kernels in place of its Pallas kernels. Imports ``torch``, never
``jax``.
"""

from .config import (
    MODEL_AREA,
    MODEL_EMOTION,
    MODEL_GENDER,
    MODEL_GROUP,
    ModelConfig,
    TTSConfig,
)
from .client import TTSApi
from .deterministic import freeze_all_seeds, setup_deterministic_tts
from .pipeline.engine import TTSEngine

__version__ = "0.1.0"

__all__ = [
    "ModelConfig",
    "TTSConfig",
    "TTSEngine",
    "TTSApi",
    "freeze_all_seeds",
    "setup_deterministic_tts",
    "MODEL_GENDER",
    "MODEL_GROUP",
    "MODEL_AREA",
    "MODEL_EMOTION",
]
