"""Host-side timestamp helpers (the part of
``ladcast_tpu/data/time_utils.py`` that the port's dataset and CLIs
need). Timestamps are YYYYMMDDHH ints; plain datetime and numpy."""

from __future__ import annotations

import calendar
from datetime import datetime, timedelta
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np


def timestamp_str_to_int(ts: str) -> int:
    """'YYYY-MM-DDThh' (the name of a monthly tar's member) -> YYYYMMDDHH."""
    return int(ts.replace("-", "").replace("T", "").replace(" ", "")
               .replace(":", "")[:10])


def int_to_datetime(ts_int: int) -> datetime:
    s = str(int(ts_int))
    return datetime(int(s[0:4]), int(s[4:6]), int(s[6:8]), int(s[8:10]))


def datetime_to_int(dt: datetime) -> int:
    return int(dt.strftime("%Y%m%d%H"))


def add_hours_int(ts_int: int, hours: int) -> int:
    return datetime_to_int(int_to_datetime(ts_int) + timedelta(hours=hours))


def year_progress(dt: datetime) -> float:
    """Fraction of the year elapsed."""
    start = datetime(dt.year, 1, 1)
    end = datetime(dt.year + 1, 1, 1)
    return (dt - start).total_seconds() / (end - start).total_seconds()


def timestamps_to_year_progress(ts_ints: Iterable[int]) -> np.ndarray:
    """(B,) YYYYMMDDHH ints -> (B,) float32 year progress."""
    return np.asarray([year_progress(int_to_datetime(t)) for t in ts_ints],
                      dtype=np.float32)


def rollout_year_progress(init_ts_int: int, num_repetitions: int,
                          hours_per_repetition: int) -> np.ndarray:
    """Year progress of each AR repetition of a rollout: the sampler's
    timestamp advances by ``hours_per_repetition`` per repetition from the
    init time. (num_repetitions,) float32."""
    t0 = int_to_datetime(init_ts_int)
    return np.asarray(
        [year_progress(t0 + timedelta(hours=i * hours_per_repetition))
         for i in range(num_repetitions)], dtype=np.float32)


def _sample_month_days(year: int, month: int,
                       num_samples_per_month: int) -> np.ndarray:
    """The reference's per-month day selection: linspace over
    [1, last_day) (endpoint excluded), rounded, first day forced to 1."""
    _, last_day = calendar.monthrange(year, month)
    days = np.linspace(1, last_day, num_samples_per_month, endpoint=False)
    days = np.round(days).astype(int)
    days[0] = 1
    return days


def filter_eval_timestamps(years: Sequence[int], num_samples_per_month: int,
                           hours: Sequence[int] = (0, 12)) -> List[int]:
    """Evenly spaced evaluation init times: per month,
    ``num_samples_per_month`` days at 00z and 12z. Sorted YYYYMMDDHH ints."""
    out: List[int] = []
    for year in years:
        for month in range(1, 13):
            for day in _sample_month_days(year, month, num_samples_per_month):
                for hour in hours:
                    out.append(datetime_to_int(datetime(year, month, int(day), hour)))
    return sorted(out)


def date_str_to_int(s: str) -> int:
    """'YYYY-MM-DD[Thh]' -> YYYYMMDDHH int; a date alone gets hour 00."""
    digits = "".join(c for c in s if c.isdigit())
    if len(digits) == 8:
        digits += "00"
    if len(digits) != 10:
        raise ValueError(f"expected YYYY-MM-DD[Thh], got {s!r}")
    return int(digits)


def date_bounds(start_date: Optional[str], end_date: Optional[str],
                lead_hours: int = 0) -> Tuple[int, int]:
    """(lo, hi) YYYYMMDDHH bounds from optional date strings; ``hi`` is
    moved back by ``lead_hours`` so that a forecast started at ``hi`` still
    verifies inside the range. A missing bound is wide open."""
    lo = date_str_to_int(start_date) if start_date else 0
    hi = (add_hours_int(date_str_to_int(end_date), -lead_hours)
          if end_date else 9_999_999_999)
    return lo, hi


def filter_eval_timestamps_range(start: int, end: int,
                                 num_samples_per_month: int,
                                 hours: Sequence[int] = (0, 12)) -> List[int]:
    """Date-range form of :func:`filter_eval_timestamps`: for every month
    that meets [start, end], its sampled days at 00z / 12z, keeping the
    timestamps <= end. As in the reference, sampled days before ``start``
    in the first month are kept: it clips against the range's end only."""
    sd, ed = int_to_datetime(start), int_to_datetime(end)
    if sd > ed:
        raise ValueError(f"start {start} is after end {end}")
    out: List[int] = []
    year, month = sd.year, sd.month
    while (year, month) <= (ed.year, ed.month):
        for day in _sample_month_days(year, month, num_samples_per_month):
            for hour in hours:
                ts = datetime_to_int(datetime(year, month, int(day), hour))
                if ts <= end:
                    out.append(ts)
        year, month = (year + 1, 1) if month == 12 else (year, month + 1)
    return sorted(out)


# The reference dataset's named splits, as year ranges; a year ("2018")
# selects that year alone.
SPLIT_YEARS = {"train": (1979, 2017), "validation": (2018, 2018),
               "test": (2022, 2022), "full": (1979, 2022)}


def split_year_range(split: str) -> Tuple[int, int]:
    """(first year, last year) of a named split; a year ("2018") selects
    that year alone."""
    if split in SPLIT_YEARS:
        return SPLIT_YEARS[split]
    year = int(split)
    if not 1979 <= year <= 2100:
        raise ValueError(f"split {split!r}: a name of {sorted(SPLIT_YEARS)} "
                         f"or a year")
    return (year, year)


def split_timestamps(timestamps: Sequence[int], split: str) -> np.ndarray:
    """The YYYYMMDDHH ints of ``timestamps`` inside a split's years."""
    ts = np.asarray(timestamps, np.int64)
    start, end = split_year_range(split)
    years = ts // 10**6
    return ts[(years >= start) & (years <= end)]
