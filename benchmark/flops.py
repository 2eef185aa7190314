"""Operations and bytes, counted from shapes: the model's flops for the
step's share of the peak, and the attention kernel's bound. The backbone's
counts are its architecture module's (``benchmark/archs/``); the peaks,
the vocoder's count and a row's whole count are here.

The peaks are NVIDIA's data sheet for one H100 SXM (dense, without
sparsity): 989 TFLOP/s in bfloat16 on the tensor cores and 3.35 TB/s of
HBM. A share is stated against them with the card's power limit beside it.
"""

from __future__ import annotations

from . import spec

PEAK_FLOPS = {"bfloat16": 989e12}
PEAK_HBM_BYTES_PER_S = 3.35e12
VOC_KERNEL = 7


def _arch(model: dict):
    return spec.architecture(model["architecture"])


def dit_eval_flops(model: dict, valid: int) -> float:
    """One backbone evaluation of one row with ``valid`` frames (its
    architecture's ``eval_flops``)."""
    return _arch(model).eval_flops(model, valid)


def text_embed_flops(model: dict, valid: int) -> float:
    """The text embedding of one row (its architecture's ``embed_flops``)."""
    return _arch(model).embed_flops(model, valid)


def vocoder_flops(model: dict, frames: int) -> float:
    v, m = model["vocoder"], model["audio"]["n_mels"]
    n_fft = model["audio"]["n_fft"]
    n_freqs = n_fft // 2 + 1
    per_frame = (2 * VOC_KERNEL * m * v["dim"]
                 + v["num_layers"] * (2 * VOC_KERNEL * v["dim"]
                                      + 2 * 2 * v["dim"] * v["intermediate_dim"])
                 + 2 * v["dim"] * 2 * n_freqs
                 + 2 * 2 * n_freqs * n_fft)  # the inverse DFT
    return per_frame * frames


def row_flops(model: dict, valid: int) -> float:
    """What one chunk row of ``valid`` frames needs end to end: the text
    embedding and every backbone evaluation of the CFG-doubled solve (two rows
    at each of nfe_step - 1 steps), then the vocoder."""
    steps = model["sampler"]["nfe_step"] - 1
    return (2 * text_embed_flops(model, valid) + 2 * steps * dit_eval_flops(model, valid)
            + vocoder_flops(model, valid))


def attention_bound_s(model: dict, valid_lengths, bucket: int, dtype_bytes: int = 2) -> float:
    """The least time of one attention call over a batch whose rows have
    these valid lengths (frames): max(flops over the peak, bytes over HBM's
    rate), by the architecture's ``attention_bound_s``."""
    return _arch(model).attention_bound_s(model, valid_lengths, bucket, dtype_bytes)


def attention_calls_per_batch(model: dict) -> int:
    """Attention calls of one dispatched batch (the architecture's count)."""
    return _arch(model).attention_calls_per_batch(model)
