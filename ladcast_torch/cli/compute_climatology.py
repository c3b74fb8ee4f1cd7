"""Day-of-year / hour-binned climatology for ACC scoring (the port of
``ladcast_tpu/cli/compute_climatology.py``; numpy on the host).

    python -m ladcast_torch.cli.compute_climatology --data era5.npz \\
        --output clim.npz [--start_year Y] [--end_year Y] [--hours 0,6,12,18]

Writes ``clim.npz`` with ``clim`` (366, n_hours, lat, lon, C), the mean of
the frames in each (day of year, hour) bin accumulated in fp64 one batch at
a time (empty bins 0; ``metrics.climatology.accumulate_climatology``), and
``hours``: what ``cli.evaluate_ens --climatology`` reads. The field source
is an ``.npz`` bundle or a directory of monthly tars. At the 120 x 240 x 84 grid with four hours, ``clim``
holds 3.54e9 values: a 14.2 GB file, and 42.5 GB of host memory at the
peak (the fp64 sums and the float32 result).
"""

from __future__ import annotations

import argparse

import numpy as np

from ladcast_torch.data import time_utils
from ladcast_torch.metrics.climatology import accumulate_climatology


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", required=True,
                    help="ERA5 .npz bundle or directory of monthly tars")
    ap.add_argument("--output", required=True, help="output .npz path")
    ap.add_argument("--start_year", type=int, default=None)
    ap.add_argument("--end_year", type=int, default=None)
    ap.add_argument("--hours", default="0,6,12,18",
                    help="comma-separated UTC hours to bin")
    ap.add_argument("--batch", type=int, default=64,
                    help="frames read per source call")
    args = ap.parse_args(argv)

    from ladcast_torch.cli.pred_rollout import open_field_source

    src, ts_all = open_field_source(args.data)
    hours = [int(h) for h in args.hours.split(",")]
    keep = []
    for t in np.asarray(ts_all, np.int64):
        dt = time_utils.int_to_datetime(int(t))
        if args.start_year is not None and dt.year < args.start_year:
            continue
        if args.end_year is not None and dt.year > args.end_year:
            continue
        if dt.hour in hours:
            keep.append(int(t))
    if not keep:
        raise SystemExit("no timestamps in the requested range/hours")

    def chunks():
        for s in range(0, len(keep), args.batch):
            chunk = keep[s:s + args.batch]
            yield np.asarray(src.frames_at(chunk), np.float64), chunk
            print(f"accumulated {min(s + args.batch, len(keep))}/{len(keep)}",
                  flush=True)

    clim, n_binned = accumulate_climatology(chunks(), hours)
    np.savez(args.output, clim=clim, hours=np.asarray(hours, np.int64))
    print(f"wrote {args.output}: clim {clim.shape}, "
          f"{n_binned} frames binned")


if __name__ == "__main__":
    main()
