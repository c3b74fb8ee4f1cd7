"""Rotary position embeddings with grid-valued (physical-coordinate) axes.

Numpy table functions (the port's own copy of the JAX package's) and the
interleaved-pair rotation: pairs (x[2i], x[2i+1]) rotate together, so
rot[2i] = -x[2i+1] and rot[2i+1] = x[2i]. This is diffusers
``apply_rotary_emb(use_real=True, use_real_unbind_dim=-1)``, not the
half-split layout.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


def rotary_tables_1d(dim: int, pos: np.ndarray, theta: float) -> Tuple[np.ndarray, np.ndarray]:
    """cos/sin tables, (len(pos), dim), each frequency repeated twice."""
    if dim % 2:
        raise ValueError(f"rotary dim {dim} must be even")
    pos = np.asarray(pos, dtype=np.float32)
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32)[: dim // 2] / dim))
    angles = np.outer(pos, freqs)
    cos = np.repeat(np.cos(angles), 2, axis=1).astype(np.float32)
    sin = np.repeat(np.sin(angles), 2, axis=1).astype(np.float32)
    return cos, sin


def multi_axis_rotary_tables(
    rope_dims: Sequence[int],
    axis_coords: Sequence[np.ndarray],
    theta: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-axis tables over the C-order meshgrid of ``axis_coords`` (t,
    then lat, then lon), concatenated along the feature dim."""
    if len(rope_dims) != len(axis_coords):
        raise ValueError("one rope dim per axis")
    grids = np.meshgrid(*[np.asarray(c, dtype=np.float32) for c in axis_coords],
                        indexing="ij")
    parts = [rotary_tables_1d(dim, grid.reshape(-1), theta)
             for dim, grid in zip(rope_dims, grids)]
    return (np.concatenate([c for c, _ in parts], axis=1),
            np.concatenate([s for _, s in parts], axis=1))


def rotate_pairs(x: torch.Tensor) -> torch.Tensor:
    """rot[2i] = -x[2i+1], rot[2i+1] = x[2i]."""
    x2 = x.unflatten(-1, (-1, 2))
    return torch.stack([-x2[..., 1], x2[..., 0]], dim=-1).flatten(-2)


def apply_rotary_emb(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, D); cos/sin: (S, D). Computed in fp32, cast back."""
    xf = x.float()
    return (xf * cos + rotate_pairs(xf) * sin).to(x.dtype)


def ladcast_axis_coords(
    num_frames: int,
    height: int,
    width: int,
    lat_start: float,
    lat_end: float,
    lon_start: float,
    lon_end: float,
    *,
    conditioning: bool,
) -> List[np.ndarray]:
    """Axis coordinates of the DiT RoPE grids: prediction frames get
    temporal coords 1..T, conditioning frames -T_in+1..0; spatial coords
    are linspaces over the (radian) start/end positions."""
    if conditioning:
        t = np.arange(-num_frames + 1, 1, dtype=np.float32)
    else:
        t = np.arange(1, num_frames + 1, dtype=np.float32)
    lat = np.linspace(lat_start, lat_end, height, dtype=np.float32)
    lon = np.linspace(lon_start, lon_end, width, dtype=np.float32)
    return [t, lat, lon]
