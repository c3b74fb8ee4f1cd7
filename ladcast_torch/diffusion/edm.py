"""EDM (Karras et al. 2022) preconditioning and sigma schedules on tensors.

  Karras sigmas     sigma_i = (smax^(1/rho) + ramp*(smin^(1/rho) - smax^(1/rho)))^rho
  c_in              1 / sqrt(sigma^2 + sigma_data^2)
  c_noise           ln(sigma) / 4
  output            c_skip*x + c_out*F(x), c_skip = sigma_data^2/(sigma^2+sigma_data^2),
                    c_out = sigma*sigma_data/sqrt(sigma^2+sigma_data^2)
"""

from __future__ import annotations

import torch

from ladcast_torch.config import EDMSchedulerConfig


def karras_sigmas(cfg: EDMSchedulerConfig, num_steps: int,
                  dtype=torch.float32, device=None) -> torch.Tensor:
    """Descending Karras sigma ramp of length ``num_steps``."""
    ramp = torch.linspace(0.0, 1.0, num_steps, dtype=dtype, device=device)
    min_inv_rho = cfg.sigma_min ** (1.0 / cfg.rho)
    max_inv_rho = cfg.sigma_max ** (1.0 / cfg.rho)
    return (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** cfg.rho


def inference_sigmas(cfg: EDMSchedulerConfig, num_inference_steps: int,
                     dtype=torch.float32, device=None) -> torch.Tensor:
    """N Karras sigmas and a trailing zero (``final_sigmas_type='zero'``)."""
    s = karras_sigmas(cfg, num_inference_steps, dtype=dtype, device=device)
    return torch.cat([s, s.new_zeros(1)])


def precondition_noise(sigma):
    return 0.25 * torch.log(sigma)


def precondition_inputs(cfg: EDMSchedulerConfig, sample, sigma):
    return sample * (1.0 / torch.sqrt(sigma**2 + cfg.sigma_data**2))


def precondition_outputs(cfg: EDMSchedulerConfig, sample, model_output, sigma):
    sd2 = cfg.sigma_data**2
    denom = sigma**2 + sd2
    c_skip = sd2 / denom
    if cfg.prediction_type == "epsilon":
        c_out = sigma * cfg.sigma_data / torch.sqrt(denom)
    elif cfg.prediction_type == "v_prediction":
        c_out = -sigma * cfg.sigma_data / torch.sqrt(denom)
    else:
        raise ValueError(f"Unsupported prediction_type {cfg.prediction_type}")
    return c_skip * sample + c_out * model_output
