"""Export of decoded forecasts (the port of
``ladcast_tpu/evaluate/export.py``): the 84-channel stack unpacked into
named variables, as an xarray Dataset with (idx, time,
prediction_timedelta, [level,] latitude, longitude) coordinates appended to
a zarr store (xarray, pandas and zarr are optional and imported inside those
functions), or as arrays with JSON coordinate metadata (numpy only)."""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

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


def pack_variables(decoded: np.ndarray, atm_names: Sequence[str],
                   sur_names: Sequence[str], num_levels: int,
                   extract_variables: Optional[Sequence[str]] = None):
    """The channel stack (..., C) unpacked into per-variable arrays: each
    atmospheric variable's ``num_levels`` consecutive channels at
    ``var_idx * num_levels``, then one channel per surface variable. Returns
    ``{var: (ens, T, num_levels, lat, lon)}`` for atmospheric and ``{var:
    (ens, T, lat, lon)}`` for surface variables of an (ens, T, lat, lon, C)
    input: the reference's (prediction_timedelta, level) axis order."""
    atm_names, sur_names = list(atm_names), list(sur_names)
    names = (list(extract_variables) if extract_variables is not None
             else atm_names + sur_names)
    base = len(atm_names) * num_levels
    out = {}
    for var in names:
        if var in atm_names:
            start = atm_names.index(var) * num_levels
            out[var] = np.moveaxis(decoded[..., start:start + num_levels], -1, 2)
        else:
            out[var] = decoded[..., base + sur_names.index(var)]
    return out


def decoded_to_dataset(decoded: np.ndarray, init_ts_int: int,
                       step_size_hour: int = 6,
                       extract_variables: Optional[Sequence[str]] = None):
    """A decoded ensemble (ens, T, lat, lon, 84), physical fields, as an
    ``xr.Dataset`` of float32 variables (requires xarray and pandas)."""
    import pandas as pd
    import xarray as xr

    E, T = decoded.shape[:2]
    co = grid_coords(T, step_size_hour)
    coords = {
        "idx": np.arange(E),
        "time": [pd.to_datetime(str(init_ts_int), format="%Y%m%d%H")],
        "prediction_timedelta": [pd.Timedelta(hours=h)
                                 for h in co["prediction_timedelta_hours"]],
        "level": co["level"],
        "latitude": co["latitude"],
        "longitude": co["longitude"],
    }
    ds = xr.Dataset(coords=coords)
    packed = pack_variables(decoded, ch.ATM_VARIABLES, ch.SURFACE_VARIABLES,
                            ch.NUM_LEVELS, extract_variables)
    for var, arr in packed.items():
        dims = (("idx", "time", "prediction_timedelta", "level", "latitude",
                 "longitude") if var in ch.ATM_VARIABLES else
                ("idx", "time", "prediction_timedelta", "latitude", "longitude"))
        ds[var] = xr.DataArray(arr[:, None].astype(np.float32), dims=dims)
    return ds


def append_to_zarr(ds, path: str, append_dim: str = "time") -> None:
    """Write ``ds`` as a new zarr store at ``path``, or append it along
    ``append_dim`` where the store exists."""
    if os.path.exists(path):
        ds.to_zarr(path, mode="a", append_dim=append_dim)
    else:
        ds.to_zarr(path, mode="w")


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
