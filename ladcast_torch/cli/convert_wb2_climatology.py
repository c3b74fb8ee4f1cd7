"""Convert a WeatherBench2-style climatology zarr to the scorer's .npz (the
port of ``ladcast_tpu/cli/convert_wb2_climatology.py``).

    python -m ladcast_torch.cli.convert_wb2_climatology --input clim.zarr \\
        --output clim.npz [--hours 0,6,12,18] [--allow_partial_doy]

The public climatology that actually exists is the WB2 product (a zarr
with ``dayofyear``/``hour`` dims and one variable per field, atmospheric
variables carrying a ``level`` dim -- the layout the reference consumes
via ``climatology_to_timeseries``, evaluate/utils.py:152-201). The
scorer here (``cli/evaluate_ens.py --climatology``) instead wants a
single packed array ``clim`` of shape (366, 4, lat, lon, C) indexed as
``clim[dayofyear-1, hour//6]`` with channels in the canonical 84-channel
order (``channels.channel_names()``). This CLI is the on-ramp between
the two:

  * variables are gathered in the canonical order (6 atm vars x 13
    levels, level-minor, then 6 surface vars);
  * dims are transposed to (dayofyear, hour, lat, lon) regardless of
    the zarr's on-disk order;
  * latitude is reoriented south->north and a -90 pole row is cropped
    (the repo's grid is -88.5..90, ``channels.py``);
  * the four synoptic hours 0/6/12/18 are selected (the scorer's
    ``hour//6`` indexing assumes exactly these bins).

``wb2_climatology_to_arrays`` is pure and duck-typed (needs only
``ds[name].dims`` / ``.values``), so it is testable without
xarray; the CLI wraps it with ``xarray.open_zarr``.

Output format matches ``cli/compute_climatology.py`` exactly -- the two
tools feed ``--climatology`` interchangeably.
"""

from __future__ import annotations

import argparse
from typing import Sequence, Tuple

import numpy as np

from ladcast_torch import channels as ch

DEFAULT_HOURS = (0, 6, 12, 18)


def _dim_name(dims: Sequence[str], candidates: Sequence[str],
              what: str) -> str:
    for c in candidates:
        if c in dims:
            return c
    raise ValueError(f"no {what} dim among {tuple(dims)} "
                     f"(expected one of {tuple(candidates)})")


def wb2_climatology_to_arrays(
        ds, hours: Sequence[int] = DEFAULT_HOURS,
        allow_partial_doy: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pack a WB2-layout climatology dataset into (clim, hours).

    ``ds`` must support ``ds[name]`` returning an object with ``.dims``
    (tuple of str) and ``.values`` (ndarray) -- xarray Datasets do; the
    tests use a minimal fake. Returns ``clim`` of shape
    (n_dayofyear, len(hours), lat, lon, 84) float32 and the hour array.

    ``allow_partial_doy`` accepts a climatology covering only the first
    N days of the year (the scorer indexes ``clim[tm_yday-1]``, so a
    partial product can still score forecasts whose valid times stay
    inside the covered range -- useful for single-month evaluations and
    the acceptance-script smoke test). The Feb-29 leap-day insertion is
    skipped for partial products that end before day 59.
    """
    hours = tuple(int(h) for h in hours)
    hr = np.asarray(ds["hour"].values).astype(np.int64)
    missing_h = [h for h in hours if h not in hr]
    if missing_h:
        raise ValueError(f"hours {missing_h} not in climatology "
                         f"(has {hr.tolist()})")
    hidx = np.asarray([int(np.where(hr == h)[0][0]) for h in hours])
    doy = np.asarray(ds["dayofyear"].values).astype(np.int64)
    if len(doy) not in (365, 366) and not allow_partial_doy:
        raise ValueError(f"dayofyear has length {len(doy)}, expected "
                         "365/366 (WB2 layout); pass --allow_partial_doy "
                         "for a deliberate partial-year product")
    partial = allow_partial_doy and len(doy) not in (365, 366)
    if partial and not np.array_equal(doy, np.arange(1, len(doy) + 1)):
        # checked BEFORE the (expensive) 84-channel extraction: the
        # scorer indexes clim[tm_yday-1], so a partial product must be
        # anchored at Jan 1 and contiguous, or every lookup lands on the
        # wrong row (a June-only subset would pack day 152 at row 0)
        raise ValueError(
            "partial climatology must cover days 1..N contiguously "
            f"(dayofyear starts at {doy[0]}); the scorer indexes "
            "clim[tm_yday-1]")

    probe = ds[ch.ATM_VARIABLES[0]]
    lat_name = _dim_name(probe.dims, ("latitude", "lat"), "latitude")
    lon_name = _dim_name(probe.dims, ("longitude", "lon"), "longitude")
    lev_name = _dim_name(probe.dims, ("level", "pressure_level"), "level")
    lat = np.asarray(ds[lat_name].values, np.float64)
    levels = np.asarray(ds[lev_name].values).astype(np.int64)
    flip_lat = lat[0] > lat[-1]          # reorient to south->north
    lat_asc = lat[::-1] if flip_lat else lat
    crop_pole = bool(np.isclose(lat_asc[0], -90.0))

    def extract(var: str, level: int | None) -> np.ndarray:
        da = ds[var]
        dims = list(da.dims)
        want = ["dayofyear", "hour"] + \
            ([lev_name] if level is not None else []) + [lat_name, lon_name]
        miss = [w for w in want if w not in dims]
        if miss:
            raise ValueError(f"variable {var!r} lacks dims {miss} "
                             f"(has {tuple(dims)})")
        v = np.asarray(da.values).transpose([dims.index(w) for w in want])
        if level is not None:
            li = np.where(levels == level)[0]
            if li.size == 0:
                raise ValueError(f"{var}: level {level} not in "
                                 f"{levels.tolist()}")
            v = v[:, :, int(li[0])]
        v = v[:, hidx]                    # (doy, n_hours, lat, lon)
        if flip_lat:
            v = v[:, :, ::-1]
        if crop_pole:
            v = v[:, :, 1:]
        return v

    cols = []
    for var in ch.ATM_VARIABLES:
        for level in ch.PRESSURE_LEVELS:
            cols.append(extract(var, level))
    for var in ch.SURFACE_VARIABLES:
        cols.append(extract(var, None))
    clim = np.stack(cols, axis=-1).astype(np.float32)
    if partial:
        # no Feb-29 handling (leap-year valid times past Feb would
        # misindex by one day -- documented limit); contiguity was
        # validated up front, before extraction
        return clim, np.asarray(hours, np.int64)
    if len(doy) == 365:
        # WB2 proper carries 366 rows; a 365-day product must grow a
        # Feb 29 bin AT index 59 (copy of Feb 28) -- the scorer indexes
        # clim[tm_yday-1], and in leap years every day from Mar 1 on has
        # tm_yday one higher than in the 365-day layout, so appending at
        # the end would misalign Mar..Dec by one day in leap years.
        clim = np.concatenate([clim[:59], clim[58:59], clim[59:]], axis=0)
    return clim, np.asarray(hours, np.int64)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="WB2 climatology zarr -> scorer clim.npz "
                    "(interchangeable with cli/compute_climatology.py)")
    ap.add_argument("--input", required=True,
                    help="WB2-style climatology zarr store")
    ap.add_argument("--output", required=True, help="output .npz path")
    ap.add_argument("--hours", default="0,6,12,18",
                    help="UTC hours to keep (the scorer's hour//6 "
                         "indexing assumes 0,6,12,18)")
    ap.add_argument("--allow_partial_doy", action="store_true",
                    help="accept a climatology covering only the first "
                         "N days of the year (partial-year evaluation)")
    args = ap.parse_args(argv)

    try:
        import xarray as xr
    except ImportError as e:
        raise SystemExit("xarray is required to open a zarr climatology; "
                         f"not available: {e}")
    ds = xr.open_zarr(args.input)
    hours = [int(h) for h in args.hours.split(",")]
    clim, hrs = wb2_climatology_to_arrays(ds, hours,
                                          args.allow_partial_doy)
    np.savez(args.output, clim=clim, hours=hrs)
    print(f"wrote {args.output}: clim {clim.shape}, hours {hrs.tolist()}")


if __name__ == "__main__":
    main()
