"""Deterministic initialization (port of ``vietvoice_tts_tpu/deterministic.py``).

Synthesis is already reproducible by construction: every row's sampling
noise comes from its own ``torch.Generator`` seeded from
``(config.random_seed, row seed)`` (``models/sampler.py:row_noise``), so no
global RNG state reaches the audio. :func:`freeze_all_seeds` freezes the
host-side and torch global RNGs for tests and data preparation;
:func:`setup_deterministic_tts` also asks PyTorch for deterministic
algorithms and pins the cuBLAS workspace, which cuBLAS needs for
run-to-run reproducible matmuls on CUDA.

Nothing here runs when the package is imported: call what you need.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch

from .config import DETERMINISTIC_SEED


def freeze_all_seeds(seed: int = DETERMINISTIC_SEED) -> None:
    """Seed ``random``, ``numpy.random`` and torch's CPU and CUDA generators."""
    random.seed(seed)
    np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    torch.manual_seed(seed)  # the CPU generator and every CUDA device's


def setup_deterministic_tts(seed: int = DETERMINISTIC_SEED) -> None:
    """Full deterministic setup: frozen seeds, deterministic algorithms, and
    the cuBLAS workspace pin.

    Call it before the first CUDA matmul: cuBLAS reads
    ``CUBLAS_WORKSPACE_CONFIG`` when its handle is created. From then on an
    operation without a deterministic implementation raises; the serving
    path has none."""
    freeze_all_seeds(seed)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.benchmark = False
