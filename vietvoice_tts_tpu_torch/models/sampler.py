"""Flow-matching ODE sampler, exact path (port of ``vietvoice_tts_tpu/models/sampler.py:95-155``).

- Sway-warped time grid (F5 recipe): t ← t + s·(cos(πt/2) − 1 + t).
- CFG as a doubled batch: cond and uncond rows (zero conditioning, text ids
  −1) run as one [2B] forward per step.
- Text embedding and the AdaLN modulations of every step are computed once,
  before the step loop.
- Per-row seeded noise: row i's initial noise comes from its own
  ``torch.Generator`` seeded from ``(random_seed, row_seeds[i])``, so a
  row's output does not depend on what it is batched with. The values differ
  from ``jax.random``'s; parity tests inject the same ``x0`` into both.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .dit import DiT


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    nfe_step: int = 32
    cfg_strength: float = 2.0
    sway_sampling_coef: float = -1.0
    # The JAX package's sampler caches; only the exact path (1, 1) is ported.
    uncond_interval: int = 1
    deep_cache_interval: int = 1


def sway_time_grid(cfg: SamplerConfig) -> torch.Tensor:
    """Monotone [0, 1] grid of nfe_step points (nfe_step−1 intervals),
    sway-warped, float32 on the CPU."""
    t = torch.linspace(0.0, 1.0, cfg.nfe_step, dtype=torch.float32)
    s = cfg.sway_sampling_coef
    if s:
        t = t + s * (torch.cos(math.pi / 2.0 * t) - 1.0 + t)
    return t


def row_noise(
    random_seed: int, row_seeds, n: int, m: int, device: torch.device
) -> torch.Tensor:
    """[B, n, m] float32 standard-normal noise, one generator per row, each
    seeded with a hash of ``(random_seed, row_seed)`` (32 bits: the CPU
    generator reads no more)."""
    rows = []
    for s in row_seeds:
        g = torch.Generator(device=device)
        seed = np.random.SeedSequence([int(random_seed), int(s)]).generate_state(1)[0]
        g.manual_seed(int(seed))
        rows.append(torch.randn((n, m), generator=g, device=device))
    return torch.stack(rows)


def flow_matching_sample(
    dit: DiT,
    cfg: SamplerConfig,
    cond: torch.Tensor,  # [B, N, n_mels] reference-mel conditioning
    text_ids: torch.Tensor,  # [B, N] int, -1 padded
    mask: torch.Tensor,  # [B, N] bool
    row_seeds,  # [B] per-utterance seeds (ints)
    random_seed: int = 0,
    x0: torch.Tensor | None = None,  # [B, N, n_mels] external initial noise
) -> torch.Tensor:
    """Integrate the learned velocity field from noise to the mel latent.

    Returns [B, N, n_mels] float32."""
    if cfg.uncond_interval != 1 or cfg.deep_cache_interval != 1:
        raise ValueError(
            "only the exact sampler (uncond_interval = deep_cache_interval = 1) "
            "is ported"
        )
    b, n, m = cond.shape
    if x0 is not None:
        x = x0.float()
    else:
        x = row_noise(random_seed, row_seeds, n, m, cond.device)

    cond2 = torch.cat([cond, torch.zeros_like(cond)], dim=0)
    mask2 = torch.cat([mask, mask], dim=0)
    text2 = torch.cat([text_ids, torch.full_like(text_ids, -1)], dim=0)
    text_emb2 = dit.text_embed(text2)

    t_grid = sway_time_grid(cfg)
    dts = torch.diff(t_grid).tolist()
    # Copied to the device once: a blocking host-to-device copy inside the
    # loop would wait for the previous step to finish on the device, and the
    # host could not queue the next step's kernels ahead of it.
    t_starts = t_grid[:-1].to(cond.device)
    mods_all, fmod_all = dit.time_modulations(t_starts)

    for i, dt in enumerate(dts):
        x2 = torch.cat([x, x], dim=0)
        tb = t_starts[i].expand(2 * b)
        v2 = dit.forward_embedded(
            x2, cond2, text_emb2, tb, mask2,
            time_mod=(mods_all[i][:, None], fmod_all[i][None]),
        )
        v_cond, v_uncond = v2[:b], v2[b:]
        x = x + dt * (v_cond + cfg.cfg_strength * (v_cond - v_uncond))
    return x
