"""``python -m vietvoice_tts_tpu_torch`` entry point."""

from .cli import main
from .deterministic import freeze_all_seeds

if __name__ == "__main__":
    freeze_all_seeds()
    main()
