"""Normalization transforms for fields and latents (the port of
``ladcast_tpu/data/transforms.py``), channels last: tensors or arrays are
(..., H, W, C) and mean/std are per-channel (C,) vectors. ``target_std``
rescales normalized data to the EDM sigma_data (latents use 0.5)."""

from __future__ import annotations

import torch


def normalize(x, mean, std, target_std: float = 1.0):
    """(x - mean) / std * target_std over the trailing channel axis."""
    return (x - mean) / std * target_std


def inverse_normalize(x, mean, std, target_std: float = 1.0):
    return (x / target_std) * std + mean


def mask_sst_nans(x: torch.Tensor, sst_channel: int, fill_value: float = -2.0):
    """Replace NaNs in the SST channel with -2 (out of distribution for
    normalized SST). Returns (masked copy of x, nan_mask), nan_mask True
    where a NaN was."""
    sst = x[..., sst_channel]
    nan_mask = torch.isnan(sst)
    x = x.clone()
    x[..., sst_channel] = torch.where(nan_mask, fill_value, sst)
    return x, nan_mask


def crop_south_pole(x, lat_axis: int = -3):
    """Drop the first latitude row (-90 deg; latitude ascends from -90) of
    a (..., lat, lon, C) array: the 121-row ERA5 grid becomes the model's
    120 rows."""
    idx = [slice(None)] * x.ndim
    idx[lat_axis] = slice(1, None)
    return x[tuple(idx)]


def periodic_roll(x: torch.Tensor, shift_lat: int, shift_lon: int,
                  lat_axis: int = -3, lon_axis: int = -2) -> torch.Tensor:
    """The periodic re-anchoring augmentation: roll the grid so that
    (shift_lat, shift_lon) becomes its top-left corner."""
    return torch.roll(x, shifts=(-shift_lat, -shift_lon),
                      dims=(lat_axis, lon_axis))
