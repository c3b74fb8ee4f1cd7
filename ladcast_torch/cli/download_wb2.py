"""Download the WeatherBench2 ERA5 subset used by LaDCast (the port of
``ladcast_tpu/cli/download_wb2.py``).

    python -m ladcast_torch.cli.download_wb2 --output era5.zarr \\
        [--start 1979-01-01] [--end 2022-12-31]

Equivalent of the reference dataloader/download.py:1-50: open the public
WB2 1.5-degree ERA5 zarr on GCS, select the 6 atmospheric + 7 surface +
13 static variables from 1979 onward (~3 TB), and write a local zarr.

Requires xarray + gcsfs + network access (not available in air-gapped
images; the CLI degrades with a clear message).
"""

from __future__ import annotations

import argparse

from ladcast_torch import channels as ch

WB2_ERA5_URL = (
    "gs://weatherbench2/datasets/era5/"
    "1959-2023_01_10-1h-240x121_equiangular_with_poles_conservative.zarr")

SURFACE_VARS = list(ch.SURFACE_VARIABLES) + ["surface_pressure"]
STATIC_VARS = [
    "land_sea_mask",
    "standard_deviation_of_orography",
    "angle_of_sub_gridscale_orography",
    "anisotropy_of_sub_gridscale_orography",
    "slope_of_sub_gridscale_orography",
    "geopotential_at_surface",
    "high_vegetation_cover",
    "lake_cover",
    "low_vegetation_cover",
    "soil_type",
    "standard_deviation_of_filtered_subgrid_orography",
    "type_of_high_vegetation",
    "type_of_low_vegetation",
]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--output", required=True, help="local zarr path")
    ap.add_argument("--source", default=WB2_ERA5_URL)
    ap.add_argument("--start", default="1979-01-01")
    ap.add_argument("--end", default=None)
    args = ap.parse_args(argv)

    try:
        import xarray as xr
    except ImportError as e:
        raise SystemExit(
            "downloading requires xarray+gcsfs (pip install xarray gcsfs "
            "zarr); this image is air-gapped -- run on a machine with GCS "
            f"access. ({e})")

    ds = xr.open_zarr(args.source, chunks=None)
    variables = list(ch.ATM_VARIABLES) + SURFACE_VARS + STATIC_VARS
    ds = ds[[v for v in variables if v in ds]]
    ds = ds.sel(time=slice(args.start, args.end))
    print(f"selected {len(ds.data_vars)} variables, "
          f"{ds.sizes.get('time', 0)} timesteps -> {args.output}")
    ds.to_zarr(args.output, mode="w")


if __name__ == "__main__":
    main()
