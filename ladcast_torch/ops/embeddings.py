"""Scalar-conditioning embeddings: the EDM timestep sinusoid (diffusers
``Timesteps(256, flip_sin_to_cos=True, downscale_freq_shift=0)``) and the
year-progress sin/cos embedding, which takes a float progress in [0, 1).
"""

from __future__ import annotations

import math

import torch


def timestep_embedding(
    timesteps: torch.Tensor,
    embedding_dim: int,
    *,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
    max_period: float = 10000.0,
    scale: float = 1.0,
) -> torch.Tensor:
    """(B,) -> (B, embedding_dim) fp32 sinusoidal embedding."""
    half = embedding_dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    freqs = torch.exp(exponent / (half - downscale_freq_shift))
    args = scale * timesteps.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    return emb


def year_sincos_embedding(
    year_progress: torch.Tensor,
    embedding_dim: int = 256,
    max_period: float = 10000.0,
    freq_scale: float = 1.0,
) -> torch.Tensor:
    """(B,) year progress -> (B, D) sin/cos superposition with
    exponentially decaying magnitudes."""
    half = embedding_dim // 2
    ar = torch.arange(half, dtype=torch.float32, device=year_progress.device)
    freqs = (ar + 1) * freq_scale
    mag = torch.exp(-math.log(max_period) * ar / half)
    args = 2.0 * math.pi * year_progress.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args) * mag, torch.cos(args) * mag], dim=-1)
