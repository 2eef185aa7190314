"""Plain float32 model: mel front end, flow-matching sampler and Vocos
vocoder, written from the equations with plain ``torch`` ops. The backbone
whose velocity the sampler integrates is the configuration's architecture
(``benchmark/archs/<architecture>.py``), through its ``prepare`` and
``velocity``.

It reads the weights as the benchmark makes them (``benchmark/weights.py``):
a nested dict in the pack's layout, dense weights ``[in, out]`` used as
``x @ w``, depthwise conv weights ``[k, 1, C]``, dense conv weights
``[k, in, out]``, block weights stacked on a leading depth axis. It imports
nothing of the program under test.

``precision`` selects how every matrix product's operands are rounded
before a float32 product:

- ``"float32"``: not at all (the reference; callers turn TF32 off);
- ``"bfloat16"``: to bfloat16 (an estimate of a bfloat16 program);
- ``"fp8"``: to float8 e4m3 with one scale a tensor (amax / 448), the
  precision below bfloat16: the control that a check has to fail.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import spec

LN_EPS = 1e-6
LOG_MAG_CLIP = 10.0
PRECISIONS = ("float32", "bfloat16", "fp8")
FP8_MAX = 448.0


def round_operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` (float32) rounded as a matrix product's operand in ``precision``."""
    if precision == "float32":
        return x
    if precision == "bfloat16":
        return x.to(torch.bfloat16).float()
    if precision == "fp8":
        scale = x.detach().abs().amax().clamp(min=1e-12) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")


class Ops:
    """The products of one precision."""

    def __init__(self, precision: str = "float32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
        self.precision = precision

    def r(self, x: torch.Tensor) -> torch.Tensor:
        return round_operand(x, self.precision)

    def dense(self, x: torch.Tensor, p: dict) -> torch.Tensor:
        return self.r(x) @ self.r(p["w"]) + p["b"]

    def f32_dense(self, x: torch.Tensor, p: dict) -> torch.Tensor:
        """A product that the serving program keeps in float32."""
        return x @ p["w"] + p["b"]


def layernorm(x: torch.Tensor, eps: float = LN_EPS) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps)


def depthwise_same(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Depthwise 1-D conv of x [B, N, C] with w [k, 1, C]: zero padding
    (k-1)//2 before and the rest after, then the bias."""
    w = p["w"][:, 0, :]  # [k, C]
    k = w.shape[0]
    lo = (k - 1) // 2
    xp = F.pad(x, (0, 0, lo, k - 1 - lo))
    n = x.shape[1]
    out = torch.zeros_like(x)
    for j in range(k):
        out = out + xp[:, j : j + n] * w[j]
    return out + p["b"]


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x**3)))


# ---------------------------------------------------------------------------
# Mel front end (Vocos-style: centred reflect-padded frames, periodic Hann,
# power-1 magnitude, HTK mel filterbank without norm, natural log at 1e-5)
# ---------------------------------------------------------------------------


def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int) -> np.ndarray:
    """Triangular HTK mel filterbank [n_freqs, n_mels] over 0 .. sr/2."""
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)

    n_freqs = n_fft // 2 + 1
    freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sample_rate / 2.0), n_mels + 2))
    fb = np.zeros((n_freqs, n_mels), np.float64)
    for m in range(n_mels):
        lo, ctr, hi = pts[m], pts[m + 1], pts[m + 2]
        up = (freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - freqs) / max(hi - ctr, 1e-10)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb.astype(np.float32)


def hann_periodic(n: int) -> np.ndarray:
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float64)


def log_mel(wave: torch.Tensor, audio: dict) -> torch.Tensor:
    """wave [B, T] float32 (T = frames · hop) → log-mel [B, frames, n_mels]."""
    n_fft, hop, win_len = audio["n_fft"], audio["hop_length"], audio["win_length"]
    n_frames = wave.shape[1] // hop
    pad = n_fft // 2
    x = F.pad(wave[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(1, win_len, hop)[:, :n_frames]  # [B, F, win]
    n_freqs = n_fft // 2 + 1
    t = np.arange(win_len)[:, None]
    k = np.arange(n_freqs)[None, :]
    ang = 2.0 * np.pi * t * k / n_fft
    window = hann_periodic(win_len)[:, None]
    dev = wave.device
    cos_b = torch.from_numpy((np.cos(ang) * window).astype(np.float32)).to(dev)
    sin_b = torch.from_numpy((-np.sin(ang) * window).astype(np.float32)).to(dev)
    re, im = frames @ cos_b, frames @ sin_b
    mag = torch.sqrt(re * re + im * im + 1e-12)
    fb = torch.from_numpy(mel_filterbank(audio["sample_rate"], n_fft, audio["n_mels"])).to(dev)
    return torch.log(torch.clamp(mag @ fb, min=1e-5))


# ---------------------------------------------------------------------------
# Flow-matching sampler: Euler steps on the sway grid, CFG-doubled rows
# ---------------------------------------------------------------------------


def sway_grid(nfe_step: int, sway: float) -> torch.Tensor:
    t = torch.linspace(0.0, 1.0, nfe_step, dtype=torch.float32)
    return t + sway * (torch.cos(math.pi / 2.0 * t) - 1.0 + t) if sway else t


def sample(ops: Ops, p: dict, model: dict, cond, ids, mask, x0) -> torch.Tensor:
    """Euler solve of the CFG-doubled flow from x0 [B, N, n_mels] (cond rows,
    then rows with zero conditioning and no text) → latent [B, N, n_mels].
    The velocity is the configuration's backbone's, whose weights ``p`` are
    the tree's ``"dit"``."""
    arch = spec.architecture(model["architecture"])
    s = model["sampler"]
    t = sway_grid(s["nfe_step"], s["sway_sampling_coef"])
    dts = torch.diff(t).tolist()
    t_starts = t[:-1].to(cond.device)
    b = cond.shape[0]
    cond2 = torch.cat([cond, torch.zeros_like(cond)])
    mask2 = torch.cat([mask, mask])
    state = arch.prepare(ops, p, model, cond2, torch.cat([ids, torch.full_like(ids, -1)]),
                         t_starts)
    x = x0
    for i, dt in enumerate(dts):
        v2 = arch.velocity(ops, p, model, state, torch.cat([x, x]), mask2, i)
        v_c, v_u = v2[:b], v2[b:]
        x = x + dt * (v_c + s["cfg_strength"] * (v_c - v_u))
    return x


# ---------------------------------------------------------------------------
# Vocos vocoder: ConvNeXt trunk, then an iSTFT head
# ---------------------------------------------------------------------------


def affine_layernorm(x, scale, bias):
    return layernorm(x) * scale + bias


def istft(real: torch.Tensor, imag: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Centred inverse STFT with a periodic Hann window, normalised by the
    overlapped squared window: [B, N, n_freqs] → [B, N·hop]."""
    b, n, n_freqs = real.shape
    k = np.arange(n_freqs)[:, None]
    t = np.arange(n_fft)[None, :]
    ang = 2.0 * np.pi * k * t / n_fft
    w = np.full((n_freqs, 1), 2.0)
    w[0] = w[-1] = 1.0
    dev = real.device
    cos_b = torch.from_numpy((w * np.cos(ang) / n_fft).astype(np.float32)).to(dev)
    sin_b = torch.from_numpy((-w * np.sin(ang) / n_fft).astype(np.float32)).to(dev)
    win = hann_periodic(n_fft)
    frames = (real @ cos_b + imag @ sin_b) * torch.from_numpy(win.astype(np.float32)).to(dev)
    total = (n - 1) * hop + n_fft
    out = F.fold(frames.transpose(1, 2), (1, total), (1, n_fft), stride=(1, hop))[:, 0, 0]
    env = np.zeros(total)
    for i in range(n):
        env[i * hop : i * hop + n_fft] += win**2
    env = torch.from_numpy(np.maximum(env, 1e-8).astype(np.float32)).to(dev)
    pad = n_fft // 2
    return (out / env)[:, pad : pad + n * hop]


def vocode(ops: Ops, p: dict, mel: torch.Tensor, audio: dict) -> torch.Tensor:
    """Log-mel [B, N, n_mels] → waveform [B, N·hop] float32."""
    w = p["embed"]["w"]  # [k, n_mels, dim]
    k = w.shape[0]
    lo = (k - 1) // 2
    xp = F.pad(mel, (0, 0, lo, k - 1 - lo))
    n = mel.shape[1]
    x = sum(xp[:, j : j + n] @ w[j] for j in range(k)) + p["embed"]["b"]
    x = affine_layernorm(x, p["norm_in_scale"], p["norm_in_bias"])
    blocks = p["blocks"]
    for i in range(blocks["gamma"].shape[0]):
        h = depthwise_same(x, {"w": blocks["dwconv"]["w"][i], "b": blocks["dwconv"]["b"][i]})
        h = affine_layernorm(h, blocks["norm_scale"][i], blocks["norm_bias"][i])
        h = gelu_tanh(ops.dense(h, {"w": blocks["pw1"]["w"][i], "b": blocks["pw1"]["b"][i]}))
        h = ops.dense(h, {"w": blocks["pw2"]["w"][i], "b": blocks["pw2"]["b"][i]})
        x = x + blocks["gamma"][i] * h
    x = affine_layernorm(x, p["norm_out_scale"], p["norm_out_bias"])
    h = ops.f32_dense(x, p["head"])
    log_mag, phase = h.chunk(2, dim=-1)
    mag = torch.exp(torch.clamp(log_mag, -LOG_MAG_CLIP, LOG_MAG_CLIP))
    return istft(mag * torch.cos(phase), mag * torch.sin(phase),
                 audio["n_fft"], audio["hop_length"])


# ---------------------------------------------------------------------------
# One padded chunk batch, as the serving path runs it
# ---------------------------------------------------------------------------


def row_noise(random_seed: int, row_seeds, n: int, m: int, device) -> torch.Tensor:
    """[B, n, m] standard-normal noise, row i from a generator seeded with
    a hash of (random_seed, row_seeds[i]), drawn on ``device``."""
    rows = []
    for s in row_seeds:
        g = torch.Generator(device=device)
        seed = np.random.SeedSequence([int(random_seed), int(s)]).generate_state(1)[0]
        g.manual_seed(int(seed))
        rows.append(torch.randn((n, m), generator=g, device=device))
    return torch.stack(rows)


@torch.no_grad()
def chunk_pcm(ops: Ops, weights: dict, model: dict, wave, ref_len, ids, total_len, row_seeds):
    """Padded chunk rows → int16 PCM [B, N·hop] (before the reference prefix
    and the padding are cut off). ``wave`` [B, N·hop] float32, ``ref_len``
    and ``total_len`` [B] frames, ``ids`` [B, N] (-1 padded), all on one
    device."""
    audio = model["audio"]
    mel = log_mel(wave, audio)
    n = mel.shape[1]
    frame = torch.arange(n, device=wave.device)
    is_ref = frame[None] < ref_len[:, None]
    mask = frame[None] < total_len[:, None]
    zero = torch.zeros((), device=wave.device)
    cond = torch.where(is_ref[..., None], mel, zero)
    x0 = row_noise(model["random_seed"], row_seeds, n, audio["n_mels"], wave.device)
    latent = sample(ops, weights["dit"], model, cond, ids, mask, x0)
    latent = torch.where(is_ref[..., None], mel, latent)
    latent = torch.where(mask[..., None], latent, zero)
    wav = vocode(ops, weights["vocoder"], latent, audio)
    return (torch.clamp(wav, -1.0, 1.0) * 32767.0).to(torch.int16)
