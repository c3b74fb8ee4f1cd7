"""Latitude and cell-area weights (the port of
``ladcast_tpu/metrics/weights.py``; WeatherBench2's formulas)."""

from __future__ import annotations

import numpy as np


def cos_lat_weights(lat_deg) -> np.ndarray:
    """cos(lat) normalized to mean 1."""
    w = np.cos(np.deg2rad(np.asarray(lat_deg, dtype=np.float64)))
    return w / w.mean()


def cell_area_weights(lat_deg) -> np.ndarray:
    """Spherical cell-area weights normalized to mean 1: cell bounds at the
    latitude midpoints and the poles, weight sin(upper) - sin(lower)."""
    lat = np.deg2rad(np.asarray(lat_deg, dtype=np.float64))
    mid = (lat[:-1] + lat[1:]) / 2
    bounds = np.concatenate([[-np.pi / 2], mid, [np.pi / 2]])
    area = np.sin(bounds[1:]) - np.sin(bounds[:-1])
    return area / area.mean()


def grid_lat_weights(kind: str = "cos", grid_lat: int = 120) -> np.ndarray:
    """Weights of the cropped 1.5-degree grid's rows (lat -88.5 .. 90)."""
    lat = np.linspace(-88.5, 90.0, grid_lat)
    if kind == "cos":
        return cos_lat_weights(lat)
    if kind == "area":
        return cell_area_weights(lat)
    raise ValueError(f"kind {kind!r}: expected 'cos' or 'area'")


def latent_lat_weights() -> np.ndarray:
    """cos-lat weights of the 15 latent rows' centre latitudes."""
    return cos_lat_weights(np.linspace(-83.25, 84.75, 15))
