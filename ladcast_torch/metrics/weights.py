"""Latitude weighting (the port of ``ladcast_tpu/metrics/weights.py``'s
``cos_lat_weights``)."""

from __future__ import annotations

import numpy as np


def cos_lat_weights(lat_deg) -> np.ndarray:
    """cos(lat) normalized to mean 1."""
    w = np.cos(np.deg2rad(np.asarray(lat_deg, dtype=np.float64)))
    return w / w.mean()
