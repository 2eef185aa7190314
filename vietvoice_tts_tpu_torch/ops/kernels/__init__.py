"""Hand-written CUDA kernels (sources in ``csrc/``): their build step,
wrappers and plain PyTorch versions."""

import torch


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
