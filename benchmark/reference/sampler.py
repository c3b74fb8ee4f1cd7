"""The plain reference of the EDM Heun sampler (Karras et al. 2022,
algorithm 1 without churn) and of the latent and field normalisations,
which read the shipped statistics files with numpy."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Tuple

import numpy as np
import torch

SIGMA_MIN, SIGMA_MAX, SIGMA_DATA, RHO = 0.002, 80.0, 0.5, 7.0
LATENT_TARGET_STD = 0.5

# the 84-channel stack: 6 atmospheric variables x 13 levels, then 6 surface
ATM = ("geopotential", "specific_humidity", "temperature", "u_component_of_wind",
       "v_component_of_wind", "vertical_velocity")
SURFACE = ("10m_u_component_of_wind", "10m_v_component_of_wind", "2m_temperature",
           "mean_sea_level_pressure", "sea_surface_temperature", "total_precipitation_6hr")
LEVELS = ("50", "100", "150", "200", "250", "300", "400", "500", "600", "700",
          "850", "925", "1000")


def karras_sigmas(n: int, device=None) -> torch.Tensor:
    """n descending Karras sigmas, then a zero."""
    ramp = torch.linspace(0.0, 1.0, n, device=device)
    lo, hi = SIGMA_MIN ** (1 / RHO), SIGMA_MAX ** (1 / RHO)
    return torch.cat([(hi + ramp * (lo - hi)) ** RHO, torch.zeros(1, device=device)])


def denoiser(net: Callable, x, sigma, cond, yp):
    """D(x; sigma) = c_skip x + c_out F(c_in x, ln(sigma) / 4)."""
    s2 = sigma ** 2 + SIGMA_DATA ** 2
    f = net(x / torch.sqrt(s2), (torch.log(sigma) / 4).expand(x.shape[0]), cond, yp)
    return SIGMA_DATA ** 2 / s2 * x + sigma * SIGMA_DATA / torch.sqrt(s2) * f


def heun(net: Callable, noise, cond, yp, steps: int) -> torch.Tensor:
    """N - 1 Heun steps and a final Euler step: 2N - 1 network calls."""
    s = karras_sigmas(steps, noise.device)
    x = noise * s[0]
    for i in range(steps - 1):
        d1 = (x - denoiser(net, x, s[i], cond, yp)) / s[i]
        x_eul = x + (s[i + 1] - s[i]) * d1
        d2 = (x_eul - denoiser(net, x_eul, s[i + 1], cond, yp)) / s[i + 1]
        x = x + (s[i + 1] - s[i]) * (0.5 * d1 + 0.5 * d2)
    d = (x - denoiser(net, x, s[steps - 1], cond, yp)) / s[steps - 1]
    return x - s[steps - 1] * d


def static_dir() -> Path:
    """The shipped statistics and static fields, read as raw files."""
    return Path(__file__).resolve().parents[2] / "ladcast_torch" / "static"


def latent_stats() -> Tuple[np.ndarray, np.ndarray]:
    d = json.loads((static_dir() / "ERA5_latent_normal_1979_2017_lat84.json").read_text())
    return np.asarray(d["mean"], np.float32), np.asarray(d["std"], np.float32)


def field_stats() -> Tuple[np.ndarray, np.ndarray]:
    """Per-channel mean and std of the 84-channel stack."""
    d = json.loads((static_dir() / "ERA5_normal_1979_2017.json").read_text())
    mean, std = [], []
    for v in ATM:
        mean += [d[v]["mean"][lv] for lv in LEVELS]
        std += [d[v]["std"][lv] for lv in LEVELS]
    for v in SURFACE:
        mean.append(d[v]["mean"])
        std.append(d[v]["std"])
    return np.asarray(mean, np.float32), np.asarray(std, np.float32)


def static_fields() -> np.ndarray:
    """(120, 240, 5): land-sea mask and the four orography fields, the
    south-pole row dropped, each z-scored with the unbiased std."""
    lsm = np.load(static_dir() / "240x121_land_sea_mask.npy")
    oro = np.load(static_dir() / "240x121_orography.npy")
    s = np.concatenate([lsm[None], oro], 0).astype(np.float64)[:, 1:, :]
    s = (s - s.mean(axis=(1, 2), keepdims=True)) / s.std(axis=(1, 2), ddof=1, keepdims=True)
    return np.transpose(s, (1, 2, 0)).astype(np.float32)
