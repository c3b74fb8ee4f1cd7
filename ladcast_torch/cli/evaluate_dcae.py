"""DCAE reconstruction evaluation CLI (the port of
``ladcast_tpu/cli/evaluate_dcae.py``).

    python -m ladcast_torch.cli.evaluate_dcae --data era5.npz \\
        --dcae_params <dir> --output_csv recon.csv [--device cpu]

Encodes and decodes each frame (normalized, SST NaNs at -2) on the device
(CUDA unless ``--device cpu`` is given) in the dtype of the loaded
parameters, and writes a CSV: per channel the physical lat-weighted RMSE
(mean over batches), then the lat-weighted relative L2 of the
reconstruction (``lat_weighted_rel_l2``). SST over land is masked in both.
"""

from __future__ import annotations

import argparse
import csv
import os

import numpy as np
import torch

from ladcast_torch import channels as ch, resolve_device, static_data
from ladcast_torch.config import DCAEConfig
from ladcast_torch.data import transforms
from ladcast_torch.metrics.losses import lp_loss
from ladcast_torch.metrics.weights import grid_lat_weights
from ladcast_torch.models import hub


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", required=True,
                    help="ERA5 .npz bundle or directory of monthly tars")
    ap.add_argument("--dcae_params", required=True)
    ap.add_argument("--output_csv", required=True)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--max_samples", type=int, default=None)
    ap.add_argument("--split", default=None,
                    help="keep only a split's years (train, validation, test, "
                         "full or a year, e.g. 2018)")
    ap.add_argument("--device", default="cuda")
    return ap


def run(args: argparse.Namespace) -> np.ndarray:
    """Write the CSV of ``args`` (:func:`build_parser`); returns the
    per-channel RMSE."""
    device = resolve_device(args.device)
    from ladcast_torch.cli.pred_rollout import _load_any_params, open_field_source

    params, cfg = _load_any_params(args.dcae_params, "dcae", DCAEConfig())
    dtype = next(v.dtype for v in params.values() if v.is_floating_point())
    dcae = hub.build_model("dcae", cfg, params, device, dtype)
    del params
    statics = torch.from_numpy(
        static_data.static_conditioning_tensor(layout="HWC")).to(device)
    fm, fs = (torch.from_numpy(a).to(device) for a in static_data.era5_mean_std())
    lat_w = torch.as_tensor(grid_lat_weights("cos"), dtype=torch.float32,
                            device=device)

    @torch.inference_mode()
    def recon_metrics(raw):
        x = transforms.normalize(raw, fm, fs)
        nan_mask = torch.isnan(x[..., ch.SST_CHANNEL_INDEX])
        x = torch.where(torch.isnan(x), -2.0, x)
        y = dcae(x.to(dtype), statics.to(dtype)).float()  # statics stripped
        m = nan_mask[..., None] & (
            torch.arange(x.shape[-1], device=device) == ch.SST_CHANNEL_INDEX)
        y = torch.where(m, -2.0, y)
        x = torch.where(m, -2.0, x)
        B, H, W, C = x.shape
        lw = lat_w.reshape(1, H, 1, 1)
        rel = lp_loss(y, x, lw.expand(B, H, 1, 1))
        err_phys = (y - x) * fs  # the z-scoring's scale undone
        rmse = torch.sqrt(torch.mean(lw * err_phys ** 2, dim=(0, 1, 2)))
        return rel, rmse

    src, ts_all = open_field_source(args.data, split=args.split)
    ts_all = list(ts_all)
    if args.max_samples:
        ts_all = ts_all[: args.max_samples]
    rels, rmses = [], []
    for s in range(0, len(ts_all), args.batch_size):
        raw = src.frames_at(ts_all[s:s + args.batch_size])
        rel, rmse = recon_metrics(torch.from_numpy(
            np.asarray(raw, np.float32)).to(device))
        rels.append(float(rel))
        rmses.append(rmse.cpu().numpy())
        print(f"evaluated {min(s + args.batch_size, len(ts_all))}"
              f"/{len(ts_all)}", flush=True)

    rmse_mean = np.mean(np.stack(rmses), axis=0)
    os.makedirs(os.path.dirname(os.path.abspath(args.output_csv)), exist_ok=True)
    with open(args.output_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["channel", "lat_weighted_rmse"])
        for name, v in zip(ch.channel_names(), rmse_mean):
            w.writerow([name, float(v)])
        w.writerow(["lat_weighted_rel_l2", float(np.mean(rels))])
    print(f"wrote {args.output_csv}")
    return rmse_mean


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
