"""Native (C++) host-side runtime components, bound via ctypes.

A copy of ``vietvoice_tts_tpu/native/``. The reference's native layer is ONNX
Runtime itself (SURVEY §2); here the device compute is PyTorch and the CUDA
kernels, and this package covers a *host* hot path around it: the cross-fade
concatenation of a long text's chunks (``pipeline/audio.py``). The shared
library is built with ``g++`` at first use (``build.py``); without ``g++``
the numpy path serves.
"""
