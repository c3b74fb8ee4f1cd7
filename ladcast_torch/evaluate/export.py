"""Export of decoded forecasts as arrays with JSON coordinate metadata
(the xarray-free part of ``ladcast_tpu/evaluate/export.py``; its xarray and
zarr functions are not ported)."""

from __future__ import annotations

import json

import numpy as np

from ladcast_torch import channels as ch


def grid_coords(num_steps: int, step_size_hour: int = 6):
    """Coordinates of a decoded bundle. It holds the forecast only: frame i
    is valid at init + (i+1)*step (prediction_timedelta 0 is the analysis
    frame, which decode paths never include)."""
    return {
        "prediction_timedelta_hours": [step_size_hour * (i + 1)
                                       for i in range(num_steps)],
        "level": list(ch.PRESSURE_LEVELS),
        "latitude": np.arange(ch.LAT_START_DEG, ch.LAT_END_DEG + 1e-6,
                              ch.INTERVAL_DEG).tolist(),
        "longitude": np.arange(ch.LON_START_DEG, ch.LON_END_DEG + 1e-6,
                               ch.INTERVAL_DEG).tolist(),
    }


def decoded_to_npz(decoded: np.ndarray, init_ts_int: int, path: str,
                   step_size_hour: int = 6) -> None:
    """Write (ens, T, lat, lon, 84) physical fields as ``fields`` beside
    ``meta``, the JSON of the coordinates, the init time and the variable
    and channel names."""
    meta = grid_coords(decoded.shape[1], step_size_hour)
    meta["init_time"] = init_ts_int
    meta["variables"] = list(ch.ATM_VARIABLES) + list(ch.SURFACE_VARIABLES)
    meta["channel_names"] = ch.channel_names()
    np.savez_compressed(path, fields=decoded.astype(np.float32),
                        meta=json.dumps(meta))
