"""Cyclone tracking CLI (the port of ``ladcast_tpu/cli/track.py``; host-side
numpy).

    python -m ladcast_torch.cli.track --forecast fields_<ts>.npz \\
        --lat0 15.0 --lon0 285.0 --output_csv tracks.csv \\
        [--n_steps 12] [--ibtracs ibtracs.csv --storm_id SID] \\
        [--plot map.png] [--plot_errors errors.png]

Tracks a storm's mean-sea-level-pressure minimum through every member of a
decoded forecast (the ``fields_<ts>.npz`` of ``cli.pred_rollout --decode``)
from a first fix, and writes one CSV row per (member, fix); with an
IBTrACS CSV and a storm id, the great-circle error of each fix in km.
``--plot`` draws the tracks with their ensemble mean (and the observed
track) on a map, ``--plot_errors`` the error growth of each member (with
the observed track only); both need matplotlib, which is checked before the
forecast is read.
"""

from __future__ import annotations

import argparse
import csv
import json

import numpy as np

from ladcast_torch import channels as ch
from ladcast_torch.data import time_utils
from ladcast_torch.evaluate import tracker


def _grid():
    lat = np.arange(ch.LAT_START_DEG, ch.LAT_END_DEG + 1e-6, ch.INTERVAL_DEG)
    lon = np.arange(ch.LON_START_DEG, ch.LON_END_DEG + 1e-6, ch.INTERVAL_DEG)
    return lat, lon


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--forecast", required=True,
                    help="fields_<ts>.npz of cli.pred_rollout --decode")
    ap.add_argument("--lat0", type=float, required=True,
                    help="first-fix latitude (deg)")
    ap.add_argument("--lon0", type=float, required=True,
                    help="first-fix longitude (deg, 0..360)")
    ap.add_argument("--n_steps", type=int, default=12)
    ap.add_argument("--output_csv", required=True)
    ap.add_argument("--ibtracs", default=None,
                    help="optional IBTrACS CSV for track-error columns")
    ap.add_argument("--storm_id", default=None)
    ap.add_argument("--plot", default=None,
                    help="write a track-comparison map PNG")
    ap.add_argument("--plot_errors", default=None,
                    help="write a track-error-growth PNG (needs --ibtracs)")
    return ap


def run(args: argparse.Namespace) -> dict:
    """Track every member of ``args.forecast``; returns {member name: [(time,
    lat, lon), ...]}."""
    if args.plot or args.plot_errors:
        from ladcast_torch.utils.visualization import require_matplotlib

        require_matplotlib("--plot" if args.plot else "--plot_errors")
    with np.load(args.forecast, allow_pickle=True) as d:
        fields = d["fields"]  # (E, T, lat, lon, 84)
        meta = json.loads(str(d["meta"]))
    init_ts = int(meta["init_time"])
    tds = meta["prediction_timedelta_hours"]  # frame i valid at init + tds[i]
    step_h = tds[1] - tds[0] if len(tds) > 1 else tds[0]
    lat, lon = _grid()
    mslp_c = ch.channel_index("mean_sea_level_pressure")
    t0 = time_utils.int_to_datetime(init_ts)

    tracks = {}
    for m in range(fields.shape[0]):
        def mslp_at(t, member=m):
            hours = (t - t0).total_seconds() / 3600
            li = int(round((hours - tds[0]) / step_h))
            li = max(0, min(li, fields.shape[1] - 1))
            return tracker.GriddedField(fields[member, li, :, :, mslp_c], lat, lon)

        tracks[f"member_{m}"] = tracker.track_first_n_steps(
            t0, args.lat0, args.lon0, mslp_at,
            n_steps=min(args.n_steps, fields.shape[1]), step_hours=step_h)

    obs = None
    if args.ibtracs and args.storm_id:
        obs = tracker.load_ibtracs_csv(args.ibtracs, args.storm_id)
    with open(args.output_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["member", "time", "lat", "lon"]
                   + (["error_km"] if obs is not None else []))
        for name, track in tracks.items():
            errs = tracker.track_error_km(track, obs) if obs else None
            for i, (t, la, lo) in enumerate(track):
                row = [name, t.isoformat(), la, lo]
                if errs is not None and i < len(errs):
                    row.append(round(float(errs[i]), 1))
                w.writerow(row)
    print(f"wrote {args.output_csv} ({len(tracks)} member tracks)")

    if args.plot or args.plot_errors:
        from ladcast_torch.utils import visualization as viz

        if args.plot:
            viz.plot_tracks(
                obs_track=obs, ens_tracks=tracks,
                ens_mean_track=viz.ensemble_mean_track(tracks),
                title=f"{args.storm_id or 'storm'} track comparison",
                out_path=args.plot)
            print(f"wrote {args.plot}")
        if args.plot_errors and obs is not None:
            errs = {name: tracker.track_error_km(track, obs)
                    for name, track in tracks.items()}
            viz.plot_track_errors(errs, step_hours=step_h,
                                  out_path=args.plot_errors)
            print(f"wrote {args.plot_errors}")
    return tracks


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
