"""Flow-matching ODE sampler (port of ``vietvoice_tts_tpu/models/sampler.py``).

- Sway-warped time grid (F5 recipe): t ← t + s·(cos(πt/2) − 1 + t).
- CFG as a doubled batch: cond and uncond rows (zero conditioning, text ids
  −1) run as one [2B] forward per step.
- Text embedding and the AdaLN modulations of every step are computed once,
  before the step loop.
- Two opt-in caches, mutually exclusive (``SamplerConfig``): the CFG cache
  refreshes the unconditional velocity every k-th eval and runs the evals
  in between cond-only at batch B; the deep-block cache runs the full depth
  every r-th eval and only the first j blocks in between. The JAX sampler
  pads the eval count to whole segments with dt = 0 identity steps because
  ``lax.scan`` needs equal segments; this eager loop just stops at the last
  real eval, which gives the same x.
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
    # CFG cache: refresh the unconditional velocity only every k-th eval;
    # between refreshes the cond-only forward runs at batch B instead of the
    # CFG-doubled 2B and reuses the cached uncond velocity. 1 = exact.
    uncond_interval: int = 1
    # Deep-block cache: every r-th eval runs all DiT blocks and records the
    # deep trunk's residual contribution (h_L − h_j); the r−1 evals in
    # between run only the first ``deep_cache_blocks`` blocks and reuse it.
    # 1 = exact. Mutually exclusive with uncond_interval > 1.
    deep_cache_interval: int = 1
    deep_cache_blocks: int = 7


def sway_time_grid(cfg: SamplerConfig) -> torch.Tensor:
    """Monotone [0, 1] grid of nfe_step points (nfe_step−1 intervals),
    sway-warped, float32 on the CPU."""
    t = torch.linspace(0.0, 1.0, cfg.nfe_step, dtype=torch.float32)
    s = cfg.sway_sampling_coef
    if s:
        t = t + s * (torch.cos(math.pi / 2.0 * t) - 1.0 + t)
    return t


# (SamplerConfig, device) → _time_grid_on's result. Never evicted: a CUDA
# graph captured over a solve reads the start times by address.
_TIME_GRIDS: dict = {}


def _time_grid_on(cfg: SamplerConfig, device: torch.device):
    """(step sizes as Python floats, step start times on ``device``).

    Cached: a host-to-device copy from pageable memory first waits for the
    device to drain its stream, so a copy per solve (let alone per step)
    would keep the host from queueing a solve behind a running one, and
    inside a CUDA graph's capture it is an error."""
    key = (cfg, _device_key(device))
    hit = _TIME_GRIDS.get(key)
    if hit is None:
        t_grid = sway_time_grid(cfg)
        with torch.inference_mode(False):
            hit = torch.diff(t_grid).tolist(), t_grid[:-1].to(device)
        _TIME_GRIDS[key] = hit
    return hit


def time_grid_cached(cfg: SamplerConfig, device) -> bool:
    """Whether the solve's time grid already lies on ``device``: a capture
    must find it there (``runtime/engine_core.py``)."""
    return (cfg, _device_key(device)) in _TIME_GRIDS


def _device_key(device) -> torch.device:
    """``device`` with its index: ``cuda`` and ``cuda:0`` are one card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


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
    k = max(1, cfg.uncond_interval)
    r = max(1, cfg.deep_cache_interval)
    if k > 1 and r > 1:
        raise ValueError(
            "uncond_interval and deep_cache_interval are mutually exclusive: "
            "enable at most one cache"
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

    dts, t_starts = _time_grid_on(cfg, cond.device)
    mods_all, fmod_all = dit.time_modulations(t_starts)

    deep_kw = {"shallow_blocks": cfg.deep_cache_blocks} if r > 1 else {}
    v_uncond = deep = None
    for i, dt in enumerate(dts):
        time_mod = (mods_all[i][:, None], fmod_all[i][None])
        if i % k:
            # CFG cache: cond-only at batch B against the cached v_uncond.
            v_cond = dit.forward_embedded(
                x, cond, text_emb2[:b], t_starts[i].expand(b), mask, time_mod=time_mod
            )
        else:
            args = (torch.cat([x, x], dim=0), cond2, text_emb2,
                    t_starts[i].expand(2 * b), mask2)
            if i % r:
                # Deep cache: the shallow blocks plus the segment's record.
                v2 = dit.forward_embedded(*args, time_mod=time_mod, deep_state=deep, **deep_kw)
            elif r > 1:
                v2, deep = dit.forward_embedded(
                    *args, time_mod=time_mod, return_deep_state=True, **deep_kw
                )
            else:
                v2 = dit.forward_embedded(*args, time_mod=time_mod)
            v_cond, v_uncond = v2[:b], v2[b:]
        x = x + dt * (v_cond + cfg.cfg_strength * (v_cond - v_uncond))
    return x
