"""Compare scorer output against the reference's published 2018 RMSE
curves (BASELINE.md); the port of ``ladcast_tpu/cli/compare_baseline.py``
(numpy only).

The reference publishes only a figure (assets/2018_rmse.png, embedded at
its README.md:29); BASELINE.md digitizes the LaDCast ens-mean values at
day 1/5/10 with ~±10%% read-off error. This CLI loads
``ens_mean_mse.npy`` from an ``evaluate_ens`` output dir, compares each
digitized (variable, day) point, and emits a pass/fail JSON: a point
passes when our RMSE <= baseline * (1 + tolerance). ``--plot`` draws
per-variable RMSE-vs-lead-time curves with the baseline points overlaid.

Usage:
  python -m ladcast_torch.cli.compare_baseline --scores <dir> \
      [--tolerance 0.15] [--plot curves.png] [--output verdict.json]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ladcast_torch import channels as ch

# BASELINE.md "Published curves, digitized" table: (variable, level) ->
# {day: approx ens-mean lat-weighted RMSE}. Digitized from
# assets/2018_rmse.png; ±~10% read-off error is inherent.
BASELINE_RMSE = {
    ("geopotential", 500): {1: 45.0, 5: 390.0, 10: 690.0},
    ("geopotential", 850): {1: 65.0, 5: 280.0, 10: 480.0},
    ("temperature", 500): {1: 0.75, 5: 1.85, 10: 2.8},
    ("temperature", 850): {1: 0.97, 5: 1.9, 10: 3.0},
    ("u_component_of_wind", 500): {1: 2.4, 5: 5.3, 10: 7.4},
    ("u_component_of_wind", 850): {1: 1.7, 5: 3.9, 10: 5.0},
    ("specific_humidity", 500): {1: 3.5e-4, 5: 6.2e-4, 10: 7.5e-4},
    ("specific_humidity", 850): {1: 1.0e-3, 5: 1.45e-3, 10: 1.68e-3},
    ("mean_sea_level_pressure", None): {1: 95.0, 5: 380.0, 10: 600.0},
    ("10m_u_component_of_wind", None): {1: 1.05, 5: 2.45, 10: 3.4},
    ("10m_v_component_of_wind", None): {1: 1.05, 5: 2.5, 10: 3.5},
    ("2m_temperature", None): {1: 1.0, 5: 1.7, 10: 2.25},
}


def compare(scores_dir: str, tolerance: float = 0.15,
            step_size_hour: int = 6) -> dict:
    mse = np.load(os.path.join(scores_dir, "ens_mean_mse.npy"))
    if mse.shape[0] == 0:
        raise SystemExit(f"no scored init times in {scores_dir}")
    rmse = np.sqrt(mse.mean(axis=0))  # (C, T)
    T = rmse.shape[1]

    verdicts, num_pass, num_total = {}, 0, 0
    for (var, level), days in BASELINE_RMSE.items():
        ci = ch.channel_index(var, level)
        name = f"{var}@{level}" if level else var
        verdicts[name] = {}
        for day, base in days.items():
            t = day * 24 // step_size_hour - 1
            if t >= T:
                verdicts[name][f"day{day}"] = {"baseline": base,
                                               "ours": None,
                                               "status": "not_scored"}
                continue
            ours = float(rmse[ci, t])
            ok = ours <= base * (1.0 + tolerance)
            verdicts[name][f"day{day}"] = {
                "baseline": base, "ours": round(ours, 6),
                "ratio": round(ours / base, 3),
                "status": "pass" if ok else "FAIL"}
            num_pass += ok
            num_total += 1
    return {
        "tolerance": tolerance,
        "note": "baseline values digitized from assets/2018_rmse.png "
                "(±~10% read-off error, BASELINE.md); pass = ours <= "
                "baseline * (1 + tolerance)",
        "num_pass": num_pass, "num_scored": num_total,
        "all_pass": bool(num_total > 0 and num_pass == num_total),
        "verdicts": verdicts,
    }


def plot(scores_dir: str, out_png: str, step_size_hour: int = 6) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    mse = np.load(os.path.join(scores_dir, "ens_mean_mse.npy"))
    rmse = np.sqrt(mse.mean(axis=0))
    T = rmse.shape[1]
    leads = (np.arange(T) + 1) * step_size_hour / 24.0

    items = list(BASELINE_RMSE.items())
    ncols = 4
    nrows = -(-len(items) // ncols)
    fig, axes = plt.subplots(nrows, ncols, figsize=(4 * ncols, 3 * nrows))
    for ax, ((var, level), days) in zip(np.ravel(axes), items):
        ci = ch.channel_index(var, level)
        ax.plot(leads, rmse[ci], label="this repo", color="tab:blue")
        bx = [d for d in days if d * 24 // step_size_hour - 1 < T]
        ax.scatter([float(d) for d in bx],
                   [days[d] for d in bx], color="tab:red", zorder=3,
                   label="BASELINE.md (digitized)")
        ax.set_title(f"{var}@{level}" if level else var, fontsize=9)
        ax.set_xlabel("lead time (days)")
        ax.grid(alpha=0.3)
    np.ravel(axes)[0].legend(fontsize=7)
    for ax in np.ravel(axes)[len(items):]:
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scores", required=True,
                    help="evaluate_ens output dir (ens_mean_mse.npy)")
    ap.add_argument("--tolerance", type=float, default=0.15,
                    help="relative margin above the digitized baseline "
                         "that still passes (digitizing error is ±~10%%)")
    ap.add_argument("--step_size_hour", type=int, default=6)
    ap.add_argument("--plot", default=None, help="write curve-vs-baseline "
                                                 "panel png")
    ap.add_argument("--output", default=None, help="write verdict json")
    args = ap.parse_args(argv)

    result = compare(args.scores, args.tolerance, args.step_size_hour)
    if args.plot:
        plot(args.scores, args.plot, args.step_size_hour)
        result["plot"] = args.plot
    if args.output:
        with open(args.output, "w") as f:
            json.dump(result, f, indent=2)
    print(json.dumps(result))
    if not result["all_pass"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
