"""Per-variable (per-level for the atmospheric ones) mean and std of an
ERA5 archive over a year range, as JSON (the port of
``ladcast_tpu/cli/compute_stats.py``; numpy on the host).

    python -m ladcast_torch.cli.compute_stats --data era5.npz \\
        --output stats.json [--start_year 1979] [--end_year 2017]

One pass in fp64 (sums and sums of squares, NaNs skipped), in the layout of
the bundled ``ERA5_normal_1979_2017.json``. The source is an ``.npz``
bundle or a directory of monthly tars (``cli.pred_rollout.open_field_source``).
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ladcast_torch import channels as ch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", required=True,
                    help="ERA5 .npz bundle or directory of monthly tars")
    ap.add_argument("--output", required=True)
    ap.add_argument("--start_year", type=int, default=1979)
    ap.add_argument("--end_year", type=int, default=2017)
    ap.add_argument("--batch_size", type=int, default=64)
    args = ap.parse_args(argv)

    from ladcast_torch.cli.pred_rollout import open_field_source

    src, stamps = open_field_source(args.data)
    ts_all = [int(t) for t in stamps
              if args.start_year <= t // 1_000_000 <= args.end_year]

    n = np.zeros(ch.NUM_DYNAMIC_CHANNELS, np.float64)
    s1 = np.zeros(ch.NUM_DYNAMIC_CHANNELS, np.float64)
    s2 = np.zeros(ch.NUM_DYNAMIC_CHANNELS, np.float64)
    for i in range(0, len(ts_all), args.batch_size):
        raw = src.frames_at(ts_all[i:i + args.batch_size]).astype(np.float64)
        flat = raw.reshape(-1, raw.shape[-1])
        n += (~np.isnan(flat)).sum(0)
        s1 += np.nansum(flat, 0)
        s2 += np.nansum(flat ** 2, 0)
        print(f"accumulated {min(i + args.batch_size, len(ts_all))}"
              f"/{len(ts_all)}", flush=True)
    mean = s1 / n
    std = np.sqrt(np.maximum(s2 / n - mean ** 2, 0.0))

    out = {}
    k = 0
    for var in ch.ATM_VARIABLES:
        out[var] = {
            "mean": {str(p): mean[k + j] for j, p in enumerate(ch.PRESSURE_LEVELS)},
            "std": {str(p): std[k + j] for j, p in enumerate(ch.PRESSURE_LEVELS)}}
        k += ch.NUM_LEVELS
    for var in ch.SURFACE_VARIABLES:
        out[var] = {"mean": mean[k], "std": std[k]}
        k += 1
    with open(args.output, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
