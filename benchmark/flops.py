"""Operations and bytes, counted from shapes: the model's flops for the
step's share of the peak, and the attention kernel's bound.

The peaks are NVIDIA's data sheet for one H100 SXM (dense, without
sparsity): 989 TFLOP/s in bfloat16 on the tensor cores and 3.35 TB/s of
HBM. A share is stated against them with the card's power limit beside it.
"""

from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12}
PEAK_HBM_BYTES_PER_S = 3.35e12
TIME_FREQ_DIM = 256
CONV_POS_KERNEL = 31
TEXT_CONV_KERNEL = 7
VOC_KERNEL = 7


def dit_eval_flops(model: dict, valid: int) -> float:
    """One DiT evaluation of one row with ``valid`` frames: the dense
    products of every frame and attention over the valid keys."""
    d, depth = model["dit"]["dim"], model["dit"]["depth"]
    ff, td, m = model["dit"]["ff_mult"], model["dit"]["text_dim"], model["audio"]["n_mels"]
    per_frame = (2 * (2 * m + td) * d  # input projection
                 + 2 * CONV_POS_KERNEL * d + 2 * d * d  # position conv
                 + depth * 2 * d * d * (3 + 1 + 2 * ff)  # qkv, out, feed-forward
                 + 2 * d * m)  # output projection
    attention = depth * 4 * valid * valid * d  # QK^T and PV
    return per_frame * valid + attention


def text_embed_flops(model: dict, valid: int) -> float:
    td, layers = model["dit"]["text_dim"], model["dit"]["conv_layers"]
    return valid * layers * (2 * TEXT_CONV_KERNEL * td + 2 * 2 * (2 * td * td))


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
    embedding and every DiT evaluation of the CFG-doubled solve (two rows
    at each of nfe_step - 1 steps), then the vocoder."""
    steps = model["sampler"]["nfe_step"] - 1
    return (2 * text_embed_flops(model, valid) + 2 * steps * dit_eval_flops(model, valid)
            + vocoder_flops(model, valid))


def attention_bound_s(model: dict, valid_lengths, bucket: int, dtype_bytes: int = 2) -> float:
    """The least time of one attention call over a batch whose rows have
    these valid lengths (frames): max(flops on valid queries and keys over
    the peak, bytes read and written once over HBM's rate). Reads packed
    q, k, v of the valid frames, the rope tables and the mask; writes the
    output of the valid frames."""
    d = model["dit"]["dim"]
    hd = d // model["dit"]["heads"]
    flops = sum(4 * n * n * d for n in valid_lengths)
    rows = sum(valid_lengths)
    bytes_moved = (rows * 4 * d * dtype_bytes + 2 * bucket * hd * dtype_bytes
                   + len(valid_lengths) * bucket)
    peak = PEAK_FLOPS[model["compute_dtype"]]
    return max(flops / peak, bytes_moved / PEAK_HBM_BYTES_PER_S)


def attention_calls_per_batch(model: dict) -> int:
    """Attention calls of one dispatched batch: every block at every step."""
    return model["dit"]["depth"] * (model["sampler"]["nfe_step"] - 1)
