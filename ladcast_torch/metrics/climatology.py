"""Day-of-year / hour climatologies for ACC scoring (the port of
``ladcast_tpu/metrics/climatology.py``; numpy). A climatology is an array
(366, n_hours, ...) indexed [day of year - 1, hour bin]."""

from __future__ import annotations

from datetime import timedelta
from typing import Iterable, Sequence, Tuple

import numpy as np

from ladcast_torch.data import time_utils


def climatology_to_timeseries(
    clim: np.ndarray,
    hour_values: Sequence[int],
    start_ts_int: int,
    lead_time_hours: int,
    interval_hours: int = 6,
    exclude_start: bool = True,
) -> np.ndarray:
    """The climatology at the forecast's valid times, start (+ interval)
    .. start + lead every ``interval_hours``, stacked."""
    hour_values = list(hour_values)
    start = time_utils.int_to_datetime(start_ts_int)
    n = lead_time_hours // interval_hours + 1
    times = [start + timedelta(hours=interval_hours * i) for i in range(n)]
    if exclude_start:
        times = times[1:]
    return np.stack([clim[t.timetuple().tm_yday - 1, hour_values.index(t.hour)]
                     for t in times])


def accumulate_climatology(
    chunks: Iterable[Tuple[np.ndarray, Sequence[int]]],
    hour_values: Sequence[int] = (0, 6, 12, 18),
) -> Tuple[np.ndarray, int]:
    """The day-of-year / hour-binned mean of the samples in ``chunks``,
    pairs of (N, ...) samples and their N YYYYMMDDHH ``ts_ints``, summed in
    fp64 one chunk at a time; returns (clim float32, samples binned).
    Empty bins are 0. The sums are divided in place, so the peak memory is
    the fp64 sums and the float32 result (8 + 4 bytes a value)."""
    hour_values = list(hour_values)
    acc, cnt = None, np.zeros((366, len(hour_values)), np.int64)
    for fields, ts_ints in chunks:
        if acc is None:
            acc = np.zeros((366, len(hour_values)) + fields.shape[1:], np.float64)
        for x, ts in zip(fields, ts_ints):
            dt = time_utils.int_to_datetime(int(ts))
            doy, h = dt.timetuple().tm_yday, hour_values.index(dt.hour)
            acc[doy - 1, h] += x
            cnt[doy - 1, h] += 1
    acc /= np.maximum(cnt, 1).reshape(366, len(hour_values), *([1] * (acc.ndim - 2)))
    return acc.astype(np.float32), int(cnt.sum())


def compute_climatology(
    fields: np.ndarray,
    ts_ints: Sequence[int],
    hour_values: Sequence[int] = (0, 6, 12, 18),
) -> np.ndarray:
    """The day-of-year / hour-binned mean of samples (N, ...) at the
    YYYYMMDDHH ``ts_ints``, float32; empty bins are 0."""
    return accumulate_climatology([(fields, ts_ints)], hour_values)[0]
