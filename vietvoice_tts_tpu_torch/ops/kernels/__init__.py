"""Hand-written CUDA kernels (sources in ``csrc/``): their build step,
wrappers and plain PyTorch versions."""

import torch

# Head widths the attention kernels take: multiples of 8 (rows of 16 bytes in
# bfloat16) up to MAX_HEAD_DIM, whose Q rows still fit in shared memory
# (csrc/attention_strided.cuh).
MAX_HEAD_DIM = 1024


def refuse_autograd(kernel: str, *inputs: torch.Tensor) -> None:
    """Raise if autograd would record this call: the kernels have no
    backward (neither had the TPU kernels they port), and a result written
    through ``ctypes`` carries no ``grad_fn``, so a caller that
    differentiates through it would silently lose that gradient. Training
    runs the plain versions (``DiTConfig(use_kernels=False)``)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise RuntimeError(
            f"{kernel}: the CUDA kernel has no backward; call it under "
            "torch.no_grad() / torch.inference_mode(), or build the model with "
            "use_kernels=False to differentiate through the plain version"
        )


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 as the kernels round it (nearest, ties
    away from zero, on the bit pattern: add 0x1000, clear the low 13 bits);
    inf and nan pass through. A plain emulation for tests and
    ``chip_smoke.py``: the main path never calls it."""
    bits = x.float().contiguous().view(torch.int32)
    special = (bits & 0x7F800000) == 0x7F800000
    return torch.where(special, bits, (bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo): hi = TF32(x), lo = TF32(x − hi), the two parts the float32
    ("tf32x3") kernels split every operand into: |x − hi| ≤ 2⁻¹¹|x| and
    |x − hi − lo| ≤ 2⁻²²|x| for finite x."""
    hi = round_tf32(x)
    return hi, round_tf32(x.float() - hi)


def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the kernels' tensor cores take it in float32: both
    operands split, lo·hi + hi·lo + hi·hi, the small terms first, float32
    sums. Each TF32 product is exact in float32, so only the order of the
    sums differs from the card's."""
    a_hi, a_lo = tf32_split(a)
    b_hi, b_lo = tf32_split(b)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


# The modules whose wrappers count their launches (``<module>.launches``).
KERNELS = ("fused_rope_attention", "flash_attention")


def launch_counts() -> dict[str, int]:
    """Each kernel's ``launches`` counter, by module name."""
    import importlib

    return {k: importlib.import_module(f"{__name__}.{k}").launches for k in KERNELS}


def add_launches(counts: dict[str, int]) -> None:
    """Add ``counts`` (negative to take back) to the kernels' counters. A
    captured CUDA graph launches its kernels without calling the wrappers:
    ``runtime/graphs.py`` takes a capture's counts back and adds them again at
    every replay."""
    import importlib

    for k, n in counts.items():
        importlib.import_module(f"{__name__}.{k}").launches += n
