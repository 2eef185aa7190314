"""Training: flow-matching objective, optimizer step, checkpointing.

Port of ``vietvoice_tts_tpu/training/``: conditional flow matching with
span-masked infilling (the F5-TTS recipe) on one device, in PyTorch, with
the optimizer (AdamW on optax's schedule and clip) and the checkpoints
(``torch.save``) written here, so neither optax nor orbax is needed.
"""

from .train import Draws, TrainConfig, draw, flow_matching_loss, init_train_state, make_train_step

__all__ = [
    "Draws",
    "TrainConfig",
    "draw",
    "flow_matching_loss",
    "init_train_state",
    "make_train_step",
]
