"""Mel-spectrogram front-end as matmuls (port of ``vietvoice_tts_tpu/ops/stft.py``).

Vocos-style parameters (F5-TTS family): reflect-padded centred frames, a
periodic-Hann-windowed real DFT as two matmuls against precomputed cos/sin
bases, power-1 magnitude, an HTK mel filterbank without norm, and natural-log
compression clamped at 1e-5. All float32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def hz_to_mel_htk(f: np.ndarray | float) -> np.ndarray:
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def mel_to_hz_htk(m: np.ndarray | float) -> np.ndarray:
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


def mel_filterbank(
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: float | None = None,
) -> np.ndarray:
    """Triangular HTK-scale mel filterbank [n_freqs, n_mels], no norm."""
    fmax = fmax or sample_rate / 2.0
    n_freqs = n_fft // 2 + 1
    freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    mel_pts = np.linspace(hz_to_mel_htk(fmin), hz_to_mel_htk(fmax), n_mels + 2)
    hz_pts = mel_to_hz_htk(mel_pts)
    fb = np.zeros((n_freqs, n_mels), dtype=np.float32)
    for m in range(n_mels):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - freqs) / max(hi - ctr, 1e-10)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb


def _dft_bases(n_fft: int, win_length: int) -> tuple[np.ndarray, np.ndarray]:
    """Window-folded real-DFT cos/sin bases [win_length, n_fft//2+1]."""
    n_freqs = n_fft // 2 + 1
    window = np.hanning(win_length + 1)[:-1].astype(np.float64)  # periodic Hann
    t = np.arange(win_length)[:, None]  # [win, 1]
    k = np.arange(n_freqs)[None, :]  # [1, n_freqs]
    ang = 2.0 * np.pi * t * k / n_fft
    cos_b = (np.cos(ang) * window[:, None]).astype(np.float32)
    sin_b = (-np.sin(ang) * window[:, None]).astype(np.float32)
    return cos_b, sin_b


class MelFrontend(nn.Module):
    """Log-mel extraction: waveform [B, T] → mel [B, frames, n_mels].

    ``T`` must equal ``frames * hop_length`` (callers pad the waveform to the
    frame bucket). Centred frames use reflect padding of ``n_fft // 2``.
    """

    def __init__(
        self,
        sample_rate: int = 24000,
        n_fft: int = 1024,
        win_length: int = 1024,
        hop_length: int = 256,
        n_mels: int = 100,
    ):
        super().__init__()
        self.sample_rate = sample_rate
        self.n_fft = n_fft
        self.win_length = win_length
        self.hop_length = hop_length
        self.n_mels = n_mels
        cos_b, sin_b = _dft_bases(n_fft, win_length)
        self.register_buffer("cos_basis", torch.from_numpy(cos_b))
        self.register_buffer("sin_basis", torch.from_numpy(sin_b))
        self.register_buffer(
            "mel_fb", torch.from_numpy(mel_filterbank(sample_rate, n_fft, n_mels))
        )

    def forward(self, waveform: torch.Tensor) -> torch.Tensor:
        """waveform [B, T] float32 in [-1, 1] → log-mel [B, T//hop, n_mels]."""
        n_frames = waveform.shape[1] // self.hop_length
        pad = self.n_fft // 2
        x = F.pad(waveform.float()[:, None], (pad, pad), mode="reflect")[:, 0]
        frames = x.unfold(1, self.win_length, self.hop_length)[:, :n_frames]
        re = frames @ self.cos_basis
        im = frames @ self.sin_basis
        mag = torch.sqrt(re * re + im * im + 1e-12)
        mel = mag @ self.mel_fb
        return torch.log(torch.clamp(mel, min=1e-5))
