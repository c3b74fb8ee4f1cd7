"""Host-side timestamp helpers (the part of
``ladcast_tpu/data/time_utils.py`` the AR dataset needs). Timestamps are
YYYYMMDDHH ints."""

from __future__ import annotations

from datetime import datetime, timedelta


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
