"""Monthly-tar ERA5 archives (the port of ``ladcast_tpu/data/era5_tar.py``).

The archive is a directory of ``YYYY_MM.tar`` files whose members are
hourly ``YYYY-MM-DDTHH.npy`` arrays, channels first: (85, 121, 240)
float32, 78 atmospheric and 7 surface channels with surface pressure last,
latitude ascending from the south pole. :class:`TarFieldSource` serves
frames as the port's field sources do (``frames_at``), with the pole row
cropped and surface pressure dropped, channels last: (120, 240, 84).
Host code only: tarfile, numpy, and the C++ reader of
``data/native_reader.py``.

  * :func:`split_tar_files`, :func:`available_timestamps` -- the named
    splits over the archive (``time_utils.SPLIT_YEARS``);
  * :func:`read_tar_range` -- frames of an hourly range, as stored;
  * :class:`TarFieldSource` -- ``frames_at`` over a tar directory;
  * :func:`preprocess_batch` -- normalise and mask SST NaNs;
  * :func:`write_tar_archive` -- write frames of any field source as
    monthly tars in this layout.
"""

from __future__ import annotations

import io
import logging
import os
import tarfile
from datetime import datetime, timedelta
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ladcast_torch.data import time_utils
from ladcast_torch.data.time_utils import split_timestamps, split_year_range

__all__ = ["split_year_range", "split_tar_files", "split_timestamps",
           "available_timestamps", "read_tar_range", "TarFieldSource",
           "preprocess_batch", "write_tar_archive"]

_log = logging.getLogger(__name__)


def _member_name(dt: datetime) -> str:
    return dt.strftime("%Y-%m-%dT%H") + ".npy"


def _tar_name(dt: datetime) -> str:
    return f"{dt.year}_{dt.month:02d}.tar"


def split_tar_files(tar_dir: str, split: str) -> list:
    """The existing monthly tars of a split's years, in (year, month)
    order; missing months are skipped."""
    start, end = split_year_range(split)
    files = []
    for year in range(start, end + 1):
        for month in range(1, 13):
            p = os.path.join(tar_dir, f"{year}_{month:02d}.tar")
            if os.path.exists(p):
                files.append(p)
    return files


def available_timestamps(tar_dir: str, split: str = "full") -> np.ndarray:
    """Every member timestamp in a split's tars, in archive order."""
    out = []
    for path in split_tar_files(tar_dir, split):
        with tarfile.open(path, "r") as t:
            out.extend(time_utils.timestamp_str_to_int(m.name[:-len(".npy")])
                       for m in t.getmembers() if m.name.endswith(".npy"))
    return np.asarray(out, np.int64)


def read_tar_range(tar_dir: str, start_ts: int, end_ts: int,
                   dh: int = 1) -> Tuple[np.ndarray, list]:
    """The frames from ``start_ts`` to ``end_ts`` (YYYYMMDDHH, inclusive)
    every ``dh`` hours, as stored (channels first). Returns (array (N,
    ...), their YYYYMMDDHH ints)."""
    start = time_utils.int_to_datetime(start_ts)
    end = time_utils.int_to_datetime(end_ts)
    dts = []
    cur = start
    while cur <= end:
        dts.append(cur)
        cur += timedelta(hours=dh)
    frames = []
    open_tars: Dict[str, tarfile.TarFile] = {}
    try:
        for dt in dts:
            tname = _tar_name(dt)
            if tname not in open_tars:
                open_tars[tname] = tarfile.open(os.path.join(tar_dir, tname), "r")
            member = open_tars[tname].extractfile(_member_name(dt))
            frames.append(np.load(io.BytesIO(member.read())))
    finally:
        for t in open_tars.values():
            t.close()
    return np.stack(frames), [time_utils.datetime_to_int(d) for d in dts]


class TarFieldSource:
    """``frames_at`` over a directory of monthly tars: (N, lat, lon, C)
    float32, the pole row cropped and the last channel (surface pressure)
    dropped unless asked otherwise.

    ``native="auto"`` (the default) reads members through the C++ pread
    pool (``native_reader.TarNpyMemberSource``), indexing each archive on
    first touch; an archive it cannot serve (mixed member sizes or
    strides, no g++) is read with tarfile instead, with a log line that
    names it. ``native=True`` raises there; ``native=False`` reads every
    archive with tarfile."""

    def __init__(self, tar_dir: str, crop_south_pole: bool = True,
                 drop_last_channel: bool = True, native="auto"):
        self.tar_dir = tar_dir
        self.crop_south_pole = crop_south_pole
        self.drop_last_channel = drop_last_channel
        self._native_mode = native if native in ("auto", True) else False
        self._cache: Dict[str, tarfile.TarFile] = {}
        # per archive: its native source, or None where tarfile serves it
        self._native_srcs: Dict[str, object] = {}

    def _native_for(self, tname: str):
        if not self._native_mode:
            return None
        if tname not in self._native_srcs:
            from ladcast_torch.data.native_reader import TarNpyMemberSource

            src = None
            try:
                src = TarNpyMemberSource([os.path.join(self.tar_dir, tname)])
            except (OSError, ValueError, RuntimeError) as e:
                if self._native_mode is True:
                    raise
                _log.warning("native tar reader disabled for %s (%s); "
                             "using tarfile fallback for this archive", tname, e)
            self._native_srcs[tname] = src
        return self._native_srcs[tname]

    def _post(self, raw: np.ndarray) -> np.ndarray:
        """(N, C, lat, lon) members -> (N, lat, lon, C) frames."""
        if self.drop_last_channel:
            raw = raw[:, :-1]
        if self.crop_south_pole:
            raw = raw[:, :, 1:, :]
        return np.moveaxis(raw, 1, -1)

    def frames_at(self, ts_ints: Sequence[int]) -> np.ndarray:
        dts = [time_utils.int_to_datetime(int(ts)) for ts in ts_ints]
        by_tar: Dict[str, list] = {}
        for pos, dt in enumerate(dts):
            by_tar.setdefault(_tar_name(dt), []).append(pos)
        out = None
        for tname, positions in by_tar.items():
            src = self._native_for(tname)
            if src is not None:
                try:
                    idx = [src.index_by_name[_member_name(dts[p])]
                           for p in positions]
                except KeyError as e:
                    raise KeyError(f"timestamp not in archive: {e}") from e
                raw = src.frames(np.asarray(idx, np.int64))
            else:
                if tname not in self._cache:
                    self._cache[tname] = tarfile.open(
                        os.path.join(self.tar_dir, tname), "r")
                raw = np.stack([
                    np.load(io.BytesIO(self._cache[tname].extractfile(
                        _member_name(dts[p])).read())) for p in positions])
            frames = self._post(raw)
            if out is None:
                out = np.empty((len(dts), *frames.shape[1:]), np.float32)
            out[positions] = frames
        return np.zeros((0,), np.float32) if out is None else out

    def close(self):
        for t in self._cache.values():
            t.close()
        self._cache.clear()
        for src in self._native_srcs.values():
            if src is not None:
                src.close()
        self._native_srcs.clear()


def preprocess_batch(batch: np.ndarray, mean: np.ndarray, std: np.ndarray,
                     sst_channel: Optional[int] = None,
                     mask_value: float = -2.0):
    """Normalise (B, lat, lon, C) raw fields; with ``sst_channel``, NaNs
    become ``mask_value``. Returns (batch, NaN mask of the SST channel or
    None)."""
    batch = (batch - mean) / std
    if sst_channel is None:
        return batch, None
    nan_mask = np.isnan(batch[..., sst_channel])
    batch = np.where(np.isnan(batch), mask_value, batch)
    return batch.astype(np.float32), nan_mask


def write_tar_archive(source, timestamps: Sequence[int], tar_dir: str) -> None:
    """Append the frames of ``source`` (``frames_at`` -> (lat, lon, C)) at
    ``timestamps`` to monthly tars in ``tar_dir``, stored channels first as
    float32 ``.npy`` members, the archive's layout."""
    os.makedirs(tar_dir, exist_ok=True)
    writers: Dict[str, tarfile.TarFile] = {}
    try:
        for ts in timestamps:
            dt = time_utils.int_to_datetime(int(ts))
            tname = _tar_name(dt)
            if tname not in writers:
                writers[tname] = tarfile.open(os.path.join(tar_dir, tname), "a")
            frame = source.frames_at([ts])[0]
            buf = io.BytesIO()
            np.save(buf, np.moveaxis(frame, -1, 0).astype(np.float32))
            info = tarfile.TarInfo(_member_name(dt))
            info.size = buf.tell()
            buf.seek(0)
            writers[tname].addfile(info, buf)
    finally:
        for t in writers.values():
            t.close()
