"""Bundled static assets of the port (copies of the JAX package's files
under ``static/``): the per-variable ERA5 normalization statistics, the
84-vector latent statistics, and the land-sea mask and orography fields
that condition the DCAE."""

from __future__ import annotations

import functools
import json
from pathlib import Path
from typing import Tuple

import numpy as np

from ladcast_torch import channels as ch

_STATIC_DIR = Path(__file__).resolve().parent / "static"


@functools.lru_cache(maxsize=None)
def _load_json(name: str) -> dict:
    return json.loads((_STATIC_DIR / name).read_text())


@functools.lru_cache(maxsize=None)
def latent_mean_std() -> Tuple[np.ndarray, np.ndarray]:
    """84-vector latent mean and std, float32."""
    d = _load_json("ERA5_latent_normal_1979_2017_lat84.json")
    return (np.asarray(d["mean"], dtype=np.float32),
            np.asarray(d["std"], dtype=np.float32))


@functools.lru_cache(maxsize=None)
def era5_mean_std() -> Tuple[np.ndarray, np.ndarray]:
    """Per-channel mean and std of the 84-channel dynamic stack, float32.
    Level-keyed statistics expand in their JSON order, as in the
    reference."""
    d = _load_json("ERA5_normal_1979_2017.json")
    means, stds = [], []
    for var in ch.ATM_VARIABLES + ch.SURFACE_VARIABLES:
        p = d[var]
        if isinstance(p["mean"], dict):
            means.extend(p["mean"][level] for level in p["mean"])
            stds.extend(p["std"][level] for level in p["mean"])
        else:
            means.append(p["mean"])
            stds.append(p["std"])
    return (np.asarray(means, dtype=np.float32),
            np.asarray(stds, dtype=np.float32))


def _raw_static_stack() -> np.ndarray:
    """The (5, 120, 240) land-sea mask and orography, south-pole row
    cropped, unnormalized."""
    lsm = np.load(_STATIC_DIR / "240x121_land_sea_mask.npy")
    oro = np.load(_STATIC_DIR / "240x121_orography.npy")
    return np.concatenate([lsm[None], oro], axis=0).astype(np.float32)[:, 1:, :]


def static_mean_std() -> Tuple[np.ndarray, np.ndarray]:
    """Per-field mean and (ddof=1) std of the 5 static channels over the
    cropped grid: the z-scoring of :func:`static_conditioning_tensor`, which
    unnormalizes the DCAE's static reconstruction metrics."""
    stack = _raw_static_stack()
    return stack.mean(axis=(1, 2)), stack.std(axis=(1, 2), ddof=1)


def static_conditioning_tensor(layout: str = "CHW") -> np.ndarray:
    """The (5, 120, 240) [or HWC] static conditioning stack: land-sea mask
    and 4 orography fields, south-pole row cropped, each z-scored over the
    cropped grid with the unbiased (ddof=1) std, as torch.std computes it
    in the reference."""
    stack = _raw_static_stack()
    mean = stack.mean(axis=(1, 2), keepdims=True)
    std = stack.std(axis=(1, 2), keepdims=True, ddof=1)
    stack = (stack - mean) / std
    if layout == "HWC":
        return np.transpose(stack, (1, 2, 0))
    if layout != "CHW":
        raise ValueError(f"layout {layout!r}: expected 'CHW' or 'HWC'")
    return stack
