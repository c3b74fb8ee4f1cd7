"""Denoising samplers (the port of ``ladcast_tpu/diffusion/samplers.py``).

  - :func:`edm_heun_sample`: the 2nd-order Heun EDM sampler, deterministic
    or churned, 2N-1 denoiser calls: N-1 Heun steps (an Euler move plus a
    correction) and a final Euler step. ``correction_skip_period`` drops
    some correction calls.
  - :func:`dpm_multistep_sample`: the DPM-Solver++(2M) multistep update of
    diffusers' ``EDMDPMSolverMultistepScheduler`` (solver order 2,
    midpoint, final sigma zero), N denoiser calls.

Both take ``denoised_fn(x, sigma) -> D(x; sigma)``, which applies the EDM
preconditioning around the raw network. The trajectory runs in the given
dtype (fp32 by default). Sigmas stay device tensors, so the loops never
wait on the device. Where the JAX samplers are ``lax.scan`` loops these are
Python loops, and their data-dependent selects are host branches.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ladcast_torch.config import EDMSchedulerConfig
from ladcast_torch.diffusion import edm

DenoisedFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def make_denoised_fn(cfg: EDMSchedulerConfig, net_fn: Callable) -> DenoisedFn:
    """Wrap a raw network ``net_fn(x_in, c_noise) -> F`` with the EDM pre-
    and post-conditioning, so that it evaluates the denoiser D(x; sigma)."""

    def denoised(x, sigma):
        x_in = edm.precondition_inputs(cfg, x, sigma)
        c_noise = edm.precondition_noise(sigma)
        f = net_fn(x_in, c_noise)
        return edm.precondition_outputs(cfg, x, f.to(x.dtype), sigma)

    return denoised


def edm_heun_sample(
    cfg: EDMSchedulerConfig,
    denoised_fn: DenoisedFn,
    noise: torch.Tensor,
    num_inference_steps: int,
    *,
    s_churn: float = 0.0,
    s_min: float = 0.0,
    s_max: float = float("inf"),
    s_noise: float = 0.0,
    churn_generator: Optional[torch.Generator] = None,
    churn_noise: Optional[torch.Tensor] = None,
    dtype=torch.float32,
    correction_skip_period: int = 0,
    correction_skip_warmup: int = 2,
) -> torch.Tensor:
    """Heun (2nd order) EDM sampling from unit Gaussian ``noise``:
    x0 = noise * sigma[0].

    With ``s_churn > 0`` each step first raises the noise level of sigmas
    within [s_min, s_max] by gamma = min(s_churn / N, sqrt(2) - 1) with
    fresh noise scaled by ``s_noise``: drawn from ``churn_generator`` (the
    place of the JAX ``churn_key``), or taken from ``churn_noise``
    (N, *noise.shape), the hook that lets a test drive two samplers with
    the same draws.

    ``correction_skip_period`` > 1 (0 and 1 are the exact path) is an
    approximate acceleration: within ``warmup <= i < N-2`` only every
    ``period``-th step evaluates the correction call D(x_eul, t_next);
    a skipped step extrapolates it as ``E_i + (C_j - E_j)`` from the last
    fully evaluated step j.
    """
    n = num_inference_steps
    sigmas = edm.inference_sigmas(cfg, n, dtype=dtype, device=noise.device)
    x = noise.to(dtype) * sigmas[0]

    stochastic = s_churn > 0.0
    if stochastic:
        if churn_noise is not None:
            if tuple(churn_noise.shape) != (n, *x.shape):
                raise ValueError(f"churn_noise {tuple(churn_noise.shape)}, "
                                 f"expected {(n, *x.shape)}")
            churn_noise = churn_noise.to(dtype)
        elif churn_generator is None:
            raise ValueError("churn_generator (or churn_noise) required "
                             "when s_churn > 0")
        gamma_base = min(s_churn / n, 2.0 ** 0.5 - 1.0)

    def churn(x_cur, t_cur, i):
        """(x_hat, t_hat): the step's raised noise level."""
        if not stochastic:
            return x_cur, t_cur
        in_range = (t_cur >= s_min) & (t_cur <= s_max)
        gamma = torch.where(in_range, gamma_base, 0.0).to(dtype)
        t_hat = t_cur + gamma * t_cur
        eps = (churn_noise[i] if churn_noise is not None else
               torch.randn(x_cur.shape, generator=churn_generator,
                           dtype=x_cur.dtype, device=x_cur.device))
        return x_cur + torch.sqrt(t_hat**2 - t_cur**2) * s_noise * eps, t_hat

    p = correction_skip_period if correction_skip_period > 1 else 0
    n_heun = max(n - 1, 0)
    delta = torch.zeros_like(x)
    for i in range(n_heun):
        t_next = sigmas[i + 1]
        x_hat, t_hat = churn(x, sigmas[i], i)
        e = denoised_fn(x_hat, t_hat)
        d1 = (x_hat - e) / t_hat
        x_eul = x_hat + (t_next - t_hat) * d1
        skip = (p > 0 and correction_skip_warmup <= i < n_heun - 1
                and (i - correction_skip_warmup) % p != 0)
        if skip:
            c = e + delta
        else:
            c = denoised_fn(x_eul, t_next)
            if p > 0:
                delta = c - e
        d2 = (x_eul - c) / t_next
        x = x_hat + (t_next - t_hat) * (0.5 * d1 + 0.5 * d2)
    # final step: Euler only
    t_next = sigmas[n]
    x, t_cur = churn(x, sigmas[n - 1], n - 1)
    d1 = (x - denoised_fn(x, t_cur)) / t_cur
    x = x + (t_next - t_cur) * d1
    return x.float()


def dpm_multistep_sample(
    cfg: EDMSchedulerConfig,
    denoised_fn: DenoisedFn,
    noise: torch.Tensor,
    num_inference_steps: int,
    *,
    dtype=torch.float32,
    init_scale: Optional[float] = None,
) -> torch.Tensor:
    """DPM-Solver++ 2M sampling. The first and the last step use the
    1st-order update (the scheduler's ``lower_order_nums`` warm-up and its
    ``lower_order_final`` rule), the steps between the 2M midpoint update.

    ``init_scale`` multiplies the unit Gaussian ``noise`` to form x0: by
    default sigma_max, the right start for a flow whose first step assumes
    sigma = sigmas[0]; 1.0 reproduces the reference's "pipeline" sampler,
    which starts from unscaled noise.
    """
    if not (cfg.solver_order == 2 and cfg.solver_type == "midpoint"):
        raise ValueError("dpm_multistep_sample needs solver_order 2 and "
                         "solver_type 'midpoint'")
    n = num_inference_steps
    sigmas = edm.inference_sigmas(cfg, n, dtype=dtype, device=noise.device)
    x = noise.to(dtype) * (sigmas[0] if init_scale is None else init_scale)
    m_prev = torch.zeros_like(x)
    for i in range(n):
        s_cur, s_next = sigmas[i], sigmas[i + 1]
        s_prev = sigmas[max(i - 1, 0)]
        m0 = denoised_fn(x, s_cur)
        last = i == n - 1  # sigma_next = 0: lambda_t = inf
        ratio = torch.zeros_like(s_cur) if last else s_next / s_cur
        lam_s0, lam_s1 = -torch.log(s_cur), -torch.log(s_prev)
        h = torch.full_like(s_cur, float("inf")) if last else \
            -torch.log(s_next) - lam_s0
        em1 = -torch.ones_like(s_cur) if last else torch.exp(-h) - 1.0
        x_new = ratio * x - em1 * m0
        if 0 < i < n - 1:
            r0 = (lam_s0 - lam_s1) / h
            x_new = x_new - 0.5 * em1 * ((m0 - m_prev) / r0)
        x, m_prev = x_new, m0
    return x.float()
