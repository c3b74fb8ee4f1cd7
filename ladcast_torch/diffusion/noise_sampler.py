"""Training-time noise-level (sigma index) sampler.

The port of ``ladcast_tpu/diffusion/noise_sampler.py``: log-normal sigmas
with (P_mean, P_std) annealed linearly over the training steps, each
snapped to the nearest entry of the training sigma schedule.
"""

from __future__ import annotations

import torch

from ladcast_torch.config import EDMSchedulerConfig, NoiseSamplerConfig
from ladcast_torch.diffusion import edm


def indices_from_normals(rnd: torch.Tensor, cur_step: int,
                         ns_cfg: NoiseSamplerConfig,
                         sched_cfg: EDMSchedulerConfig) -> torch.Tensor:
    """Snap standard-normal draws ``rnd`` (B,) to training sigma indices
    (int64, on rnd's device)."""
    step = float(min(cur_step, ns_cfg.num_max_steps - 1))
    frac = step / max(ns_cfg.num_max_steps - 1, 1)
    p_mean = ns_cfg.P_mean_start + frac * (ns_cfg.P_mean_end - ns_cfg.P_mean_start)
    p_std = ns_cfg.P_std_start + frac * (ns_cfg.P_std_end - ns_cfg.P_std_start)
    sigma = torch.exp(rnd.float() * p_std + p_mean)
    sigmas = edm.train_sigmas(sched_cfg, device=rnd.device)
    return (sigmas[None, :] - sigma[:, None]).abs().argmin(dim=1)


def sample_sigma_indices(generator: torch.Generator, batch_size: int,
                         cur_step: int, ns_cfg: NoiseSamplerConfig,
                         sched_cfg: EDMSchedulerConfig) -> torch.Tensor:
    """(B,) indices into the training sigma schedule, from ``batch_size``
    normal draws of ``generator`` on its device."""
    rnd = torch.randn(batch_size, generator=generator,
                      device=generator.device)
    return indices_from_normals(rnd, cur_step, ns_cfg, sched_cfg)
