"""Compute ops: mel front-end, RoPE, reference attention, CUDA kernels."""
