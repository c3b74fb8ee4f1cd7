"""Probabilistic forecast scores (the port of
``ladcast_tpu/metrics/scores.py``; WeatherBench2's definitions) as plain
functions on tensors, computed on the tensors' device.

NaN handling: truth NaNs exist only in SST over land; the ``nan_safe``
variants take ``torch.nanmean`` over the trailing (lat, lon) axes, which
equals the plain mean for NaN-free channels.
"""

from __future__ import annotations

from typing import Optional

import torch


def _mean(nan_safe: bool):
    return torch.nanmean if nan_safe else torch.mean


def pointwise_crps_skill(forecast: torch.Tensor, truth: torch.Tensor,
                         ensemble_axis: int = 0) -> torch.Tensor:
    """mean_i |truth - forecast_i| over the members."""
    return (truth - forecast).abs().mean(dim=ensemble_axis)


def pointwise_crps_spread(forecast: torch.Tensor,
                          ensemble_axis: int = 0) -> torch.Tensor:
    """The sorted-members spread estimator, 1-based ranks i:
    2 / (M (M - 1)) * sum_i (2 i - M - 1) * sorted_i."""
    m = forecast.shape[ensemble_axis]
    if m < 2:
        return torch.zeros_like(forecast.select(ensemble_axis, 0))
    srt = torch.sort(forecast, dim=ensemble_axis).values
    w = 2.0 * torch.arange(1, m + 1, dtype=forecast.dtype,
                           device=forecast.device) - m - 1
    shape = [1] * forecast.dim()
    shape[ensemble_axis] = m
    weighted = (srt * w.reshape(shape)).sum(dim=ensemble_axis)
    return 2.0 * weighted / (m * (m - 1))


def crps(forecast: torch.Tensor, truth: torch.Tensor,
         ensemble_axis: int = 0) -> torch.Tensor:
    """Fair CRPS: skill - spread / 2."""
    return (pointwise_crps_skill(forecast, truth, ensemble_axis)
            - 0.5 * pointwise_crps_spread(forecast, ensemble_axis))


def acc(forecast: torch.Tensor, truth: torch.Tensor, climate: torch.Tensor,
        lat_weight: Optional[torch.Tensor] = None,
        nan_safe: bool = False) -> torch.Tensor:
    """Anomaly correlation coefficient over the trailing (lat, lon) axes."""
    mean = _mean(nan_safe)
    fa = forecast - climate
    ta = truth - climate
    lw = 1.0 if lat_weight is None else lat_weight
    num = mean(fa * ta * lw, dim=(-2, -1))
    den = torch.sqrt(mean(fa ** 2 * lw, dim=(-2, -1))
                     * mean(ta ** 2 * lw, dim=(-2, -1)))
    return num / den


def lat_weighted_mse(pred: torch.Tensor, truth: torch.Tensor,
                     lat_weight: torch.Tensor,
                     nan_safe: bool = False) -> torch.Tensor:
    """Latitude-weighted MSE over the trailing (lat, lon) axes; lat_weight
    broadcasts with (..., lat, lon)."""
    return _mean(nan_safe)(lat_weight * (pred - truth) ** 2, dim=(-2, -1))


def lat_weighted_rmse(pred: torch.Tensor, truth: torch.Tensor,
                      lat_weight: torch.Tensor,
                      nan_safe: bool = False) -> torch.Tensor:
    return torch.sqrt(lat_weighted_mse(pred, truth, lat_weight, nan_safe))


def ensemble_spread(forecast: torch.Tensor, lat_weight: torch.Tensor,
                    ensemble_axis: int = 0,
                    nan_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Lat-weighted ensemble spread: sqrt of the domain-mean unbiased
    (ddof = 1) member variance over the trailing (lat, lon) axes. A
    calibrated M-member ensemble has RMSE ~= spread * sqrt((M + 1) / M).
    ``nan_mask`` (..., lat, lon) is True where a point counts."""
    var = forecast.var(dim=ensemble_axis, correction=1)
    if nan_mask is not None:
        var = torch.where(nan_mask, var, torch.nan)
    return torch.sqrt(torch.nanmean(lat_weight * var, dim=(-2, -1)))


def rank_histogram(forecast: torch.Tensor, truth: torch.Tensor,
                   lat_weight: torch.Tensor,
                   ensemble_axis: int = 0) -> torch.Tensor:
    """Lat-weighted rank histogram over the trailing (lat, lon) axes:
    (..., M + 1) frequencies, bin r the weighted share of points where
    exactly r members lie below the truth (ties break low). Non-finite
    truth (SST over land) has zero weight."""
    m = forecast.shape[ensemble_axis]
    ranks = (forecast < truth.unsqueeze(ensemble_axis)).sum(dim=ensemble_axis)
    valid = torch.isfinite(truth)
    w = torch.broadcast_to(lat_weight * valid, ranks.shape)
    onehot = (ranks[..., None] == torch.arange(m + 1, device=ranks.device)
              ).to(torch.float32)
    hist = (onehot * w[..., None]).sum(dim=(-3, -2))
    return hist / torch.clamp(hist.sum(dim=-1, keepdim=True), min=1e-12)


def zonal_power_spectrum(x: torch.Tensor,
                         lat_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Zonal power spectrum, averaged over latitude (weighted when
    ``lat_weight`` is given): x (..., lat, lon) -> (..., lon // 2 + 1),
    normalized so that sum_k P_k == mean_lon x**2 per row (factor 2 for
    every k but 0 and, for even lon, the Nyquist one)."""
    n = x.shape[-1]
    p = (torch.fft.rfft(x.float(), dim=-1) / n).abs() ** 2
    mult = torch.full((p.shape[-1],), 2.0, device=x.device)
    mult[0] = 1.0
    if n % 2 == 0:
        mult[-1] = 1.0
    p = p * mult
    if lat_weight is not None:
        lw = (lat_weight / lat_weight.sum()).reshape(-1, 1)
        return (p * lw).sum(dim=-2)
    return p.mean(dim=-2)
