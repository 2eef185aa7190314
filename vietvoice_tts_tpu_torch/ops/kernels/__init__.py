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
