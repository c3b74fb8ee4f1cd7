"""The deterministic Heun EDM sampler.

:func:`edm_heun_sample` is the exact path of the JAX package's sampler
(``s_churn=0``, ``correction_skip_period=0``): N-1 Heun steps, each an
Euler move plus a 2nd-order correction, then a final Euler step -- 2N-1
denoiser calls. The trajectory runs in the given dtype (fp32 by default).
Sigmas stay device tensors, so the loop never waits on the device.
"""

from __future__ import annotations

from typing import Callable

import torch

from ladcast_torch.config import EDMSchedulerConfig
from ladcast_torch.diffusion import edm

DenoisedFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def edm_heun_sample(
    cfg: EDMSchedulerConfig,
    denoised_fn: DenoisedFn,
    noise: torch.Tensor,
    num_inference_steps: int,
    *,
    s_churn: float = 0.0,
    correction_skip_period: int = 0,
    dtype=torch.float32,
) -> torch.Tensor:
    """Heun (2nd order) EDM sampling from unit Gaussian ``noise``:
    x0 = noise * sigma[0]; ``denoised_fn(x, sigma)`` is D(x; sigma)."""
    if s_churn != 0.0:
        raise NotImplementedError("churned Heun sampling is not ported")
    if correction_skip_period > 1:
        raise NotImplementedError("correction skipping is not ported")
    sigmas = edm.inference_sigmas(cfg, num_inference_steps, dtype=dtype,
                                  device=noise.device)
    x = noise.to(dtype) * sigmas[0]
    for i in range(num_inference_steps - 1):
        t_cur, t_next = sigmas[i], sigmas[i + 1]
        d1 = (x - denoised_fn(x, t_cur)) / t_cur
        x_eul = x + (t_next - t_cur) * d1
        d2 = (x_eul - denoised_fn(x_eul, t_next)) / t_next
        x = x + (t_next - t_cur) * (0.5 * d1 + 0.5 * d2)
    # final step: Euler only
    t_cur, t_next = sigmas[-2], sigmas[-1]
    d1 = (x - denoised_fn(x, t_cur)) / t_cur
    x = x + (t_next - t_cur) * d1
    return x.float()
