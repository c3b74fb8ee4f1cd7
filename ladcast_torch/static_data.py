"""Bundled static assets of the port: the 84-vector latent normalization
statistics (``static/ERA5_latent_normal_1979_2017_lat84.json``, a copy of
the JAX package's)."""

from __future__ import annotations

import functools
import json
from pathlib import Path
from typing import Tuple

import numpy as np

_STATIC_DIR = Path(__file__).resolve().parent / "static"


@functools.lru_cache(maxsize=None)
def latent_mean_std() -> Tuple[np.ndarray, np.ndarray]:
    """84-vector latent mean and std, float32."""
    d = json.loads((_STATIC_DIR / "ERA5_latent_normal_1979_2017_lat84.json").read_text())
    return (np.asarray(d["mean"], dtype=np.float32),
            np.asarray(d["std"], dtype=np.float32))
