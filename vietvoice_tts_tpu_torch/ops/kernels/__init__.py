"""Hand-written CUDA kernels (sources in ``csrc/``): their build step,
wrappers and plain PyTorch versions."""
