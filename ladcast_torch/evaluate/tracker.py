"""Tropical-cyclone tracking on gridded forecasts (the port of
``ladcast_tpu/evaluate/tracker.py``; host-side numpy).

The reference's algorithm (evaluate/track.py:150-334):
  * start from a rounded-to-grid first-fix position;
  * every 6h search an outer box (inner + 2*NEIGHBOR_DEG) around the last
    fix for local minima of mean sea-level pressure, where "local
    minimum" means the point equals the minimum of its inner-box
    neighborhood; candidates on the outer-box edge are dropped; the
    candidate closest to the previous fix wins;
  * shrink the inner box through ``inner_box_sizes`` until a minimum that
    MOVES the fix is found;
  * if the storm sits over land (land-sea mask >= 0.5) or no MSLP minimum
    is found, fall back to the 700 hPa geopotential minimum (only when
    ``enforce_msl`` is False).

This port is pure numpy over dense (lat, lon) grids with coordinate
vectors -- no xarray dependency -- so it works on decoded forecast
tensors directly. Track-data loaders for IBTrACS CSV and HURDAT are
provided for observation comparison.
"""

from __future__ import annotations

from dataclasses import dataclass
from datetime import datetime, timedelta
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

GRID_RES = 1.5
NEIGHBOR_DEG = 1.5


def round_to_grid(val: float, resolution: float = GRID_RES) -> float:
    return float(np.round(val / resolution) * resolution)


@dataclass
class GriddedField:
    """A 2-D field with coordinate vectors (ascending latitude)."""

    values: np.ndarray        # (lat, lon)
    latitude: np.ndarray      # (lat,)
    longitude: np.ndarray     # (lon,) in [0, 360)

    def box_mask(self, lat_lo, lat_hi, lon_s, lon_e):
        mlat = (self.latitude >= min(lat_lo, lat_hi)) & \
               (self.latitude <= max(lat_lo, lat_hi))
        if lon_s <= lon_e:
            mlon = (self.longitude >= lon_s) & (self.longitude <= lon_e)
        else:  # wrap across 0/360
            mlon = (self.longitude >= lon_s) | (self.longitude <= lon_e)
        return mlat, mlon

    def nearest(self, lat, lon) -> float:
        i = int(np.argmin(np.abs(self.latitude - lat)))
        j = int(np.argmin(np.abs((self.longitude - lon + 180) % 360 - 180)))
        return float(self.values[i, j])


def find_local_minimum(
    field: GriddedField,
    center: Tuple[float, float],
    inner_deg: float,
) -> Optional[Tuple[float, float, float]]:
    """Local minimum search (track.py:168-230): outer box of candidates,
    inner-box neighborhood minima, edge candidates dropped, closest to
    center returned."""
    lat0, lon0 = center
    outer = inner_deg + NEIGHBOR_DEG * 2
    half_o, half_i = outer / 2, inner_deg / 2
    lat_lo, lat_hi = lat0 - half_o, lat0 + half_o
    lon_s, lon_e = (lon0 - half_o) % 360, (lon0 + half_o) % 360

    mlat, mlon = field.box_mask(lat_lo, lat_hi, lon_s, lon_e)
    cand_lats = field.latitude[mlat]
    cand_lons = field.longitude[mlon]
    if cand_lats.size == 0 or cand_lons.size == 0:
        return None

    raw = []
    for la in cand_lats:
        for lo in cand_lons:
            v = field.nearest(la, lo)
            nlat, nlon = field.box_mask(la - half_i, la + half_i,
                                        (lo - half_i) % 360,
                                        (lo + half_i) % 360)
            neigh = field.values[np.ix_(nlat, nlon)]
            if neigh.size and v == float(neigh.min()):
                raw.append((float(la), float(lo), v))

    finals = [
        (la, lo, v) for la, lo, v in raw
        if not (abs(la - lat_lo) < 1e-6 or abs(la - lat_hi) < 1e-6
                or abs((lo - lon_s) % 360) < 1e-6
                or abs((lo - lon_e) % 360) < 1e-6)
    ]
    if not finals:
        return None
    return min(finals, key=lambda t: (t[0] - lat0) ** 2
               + ((t[1] - lon0 + 180) % 360 - 180) ** 2)


def track_first_n_steps(
    t0: datetime,
    raw_lat0: float,
    raw_lon0: float,
    mslp_at: Callable[[datetime], GriddedField],
    *,
    n_steps: int = 3,
    inner_box_sizes: Sequence[float] = (7, 4, 1),
    enforce_msl: bool = True,
    land_mask: Optional[GriddedField] = None,
    geopotential700_at: Optional[Callable[[datetime], GriddedField]] = None,
    step_hours: int = 6,
) -> List[Tuple[datetime, float, float]]:
    """Track a storm for n_steps 6-hourly fixes (track.py:234-334).

    ``mslp_at(t)`` / ``geopotential700_at(t)`` return the relevant field at
    time t (works for both analysis series and forecast lead times).
    """
    lat0, lon0 = round_to_grid(raw_lat0), round_to_grid(raw_lon0)
    track = [(t0, lat0, lon0)]
    current = (lat0, lon0)

    for step in range(1, n_steps + 1):
        prev = current
        t_next = t0 + timedelta(hours=step_hours * step)
        over_land = 0.0
        if not enforce_msl and land_mask is not None:
            over_land = land_mask.nearest(*current)

        moved = False
        if over_land < 0.5:
            mslp = mslp_at(t_next)
            for inner in inner_box_sizes:
                res = find_local_minimum(mslp, current, inner)
                if res and (prev[0] != res[0] or prev[1] != res[1]):
                    current = (res[0], res[1])
                    moved = True
                    break

        if not moved and not enforce_msl and geopotential700_at is not None:
            g700 = geopotential700_at(t_next)
            for inner in inner_box_sizes:
                res = find_local_minimum(g700, current, inner)
                if res and (prev[0] != res[0] or prev[1] != res[1]):
                    current = (res[0], res[1])
                    moved = True
                    break

        track.append((t_next, *current))
    return track


def load_ibtracs_csv(path: str, storm_id: str):
    """IBTrACS CSV -> list of (datetime, lat, lon[0..360)) for one storm
    (track.py:110-147 semantics, stdlib csv instead of pandas)."""
    import csv

    out = []
    with open(path) as f:
        reader = csv.reader(f)
        header = next(reader)
        idx = {name: i for i, name in enumerate(header)}
        next(reader, None)  # units row
        for row in reader:
            if row[idx["SID"]] != storm_id:
                continue
            try:
                t = datetime.strptime(row[idx["ISO_TIME"]],
                                      "%Y-%m-%d %H:%M:%S")
                la = float(row[idx["LAT"]])
                lo = float(row[idx["LON"]]) % 360
            except (ValueError, KeyError):
                continue
            out.append((t, la, lo))
    if not out:
        raise ValueError(f"storm {storm_id!r} not found in {path}")
    return out


def load_hurdat(path: str, storm_id: str):
    """HURDAT2 text -> list of (datetime, lat, lon[0..360))
    (track.py:84-107 semantics)."""
    out = []
    with open(path) as f:
        lines = f.readlines()
    i = 0
    while i < len(lines):
        header = [h.strip() for h in lines[i].split(",")]
        sid, n = header[0], int(header[2])
        if sid == storm_id:
            for j in range(i + 1, i + 1 + n):
                p = [x.strip() for x in lines[j].split(",")]
                t = datetime.strptime(p[0] + p[1], "%Y%m%d%H%M")
                la = float(p[4][:-1]) * (-1 if p[4].endswith("S") else 1)
                lo = float(p[5][:-1]) * (-1 if p[5].endswith("W") else 1)
                out.append((t, la, lo % 360))
            return out
        i += 1 + n
    raise ValueError(f"storm {storm_id!r} not found in {path}")


def load_kml_tracks(path: str, valid_models: Optional[Sequence[str]] = None,
                    n_steps: Optional[int] = None, interval: int = 1):
    """Parse model cyclone tracks from a KML file (the reference fetches
    these from a URL, track.py:338-386; zero-egress images read a local
    file). Returns {model_name: [(datetime, lat, lon), ...]}.

    Expects the common multi-model track KML layout: one Folder per model,
    Placemarks with a when/TimeStamp and coordinates "lon,lat[,alt]".
    """
    import re
    import xml.etree.ElementTree as ET

    tree = ET.parse(path)
    ns = {"k": re.sub(r"\{(.*)\}.*", r"\1", tree.getroot().tag)}
    out = {}
    for folder in tree.getroot().iter(f"{{{ns['k']}}}Folder"):
        name_el = folder.find(f"{{{ns['k']}}}name")
        model = name_el.text.strip() if name_el is not None else "unknown"
        if valid_models and model not in valid_models:
            continue
        pts = []
        for pm in folder.iter(f"{{{ns['k']}}}Placemark"):
            when = pm.find(f".//{{{ns['k']}}}when")
            coord = pm.find(f".//{{{ns['k']}}}coordinates")
            if when is None or coord is None:
                continue
            t = datetime.fromisoformat(when.text.strip().replace("Z", ""))
            lon, lat = [float(v) for v in coord.text.strip().split(",")[:2]]
            pts.append((t, lat, lon % 360))
        pts = sorted(pts)[::interval]
        if n_steps is not None:
            pts = pts[: n_steps + 1]
        if pts:
            out[model] = pts
    return out


def track_error_km(track_a, track_b) -> np.ndarray:
    """Great-circle distance (km) between two tracks at matching times."""
    bmap = {t: (la, lo) for t, la, lo in track_b}
    errs = []
    for t, la, lo in track_a:
        if t not in bmap:
            continue
        lb, ob = bmap[t]
        errs.append(_haversine_km(la, lo, lb, ob))
    return np.asarray(errs)


def _haversine_km(lat1, lon1, lat2, lon2, radius_km: float = 6371.0):
    p1, p2 = np.deg2rad(lat1), np.deg2rad(lat2)
    dp = p2 - p1
    dl = np.deg2rad(lon2 - lon1)
    a = np.sin(dp / 2) ** 2 + np.cos(p1) * np.cos(p2) * np.sin(dl / 2) ** 2
    return 2 * radius_km * np.arcsin(np.sqrt(a))
