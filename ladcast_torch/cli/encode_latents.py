"""Encode an ERA5 archive through a trained DCAE into a latent dataset
(the port of ``ladcast_tpu/cli/encode_latents.py``).

    python -m ladcast_torch.cli.encode_latents --data era5.npz \\
        --dcae_params <hub dir> --output latents.npz \\
        [--start_date Y-M-D] [--end_date Y-M-D] [--device cpu]

Each snapshot is normalized, its SST NaNs set to -2, and encoded with the
static conditioning, ``--batch_size`` frames per call, on the device (CUDA
unless ``--device cpu`` is given) in ``--compute_dtype`` (bf16 by default:
no gradient is taken, so the convs read their packed weights). Writes an
``.npz`` with ``latents`` (time, 15, 30, 84) float32 in physical latent
scale and ``timestamps``: what ``cli.train_ar --latents`` reads.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ladcast_torch import resolve_device, static_data
from ladcast_torch.config import DCAEConfig
from ladcast_torch.data import time_utils, transforms
from ladcast_torch.models import hub


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", required=True,
                    help="ERA5 .npz bundle or directory of monthly tars")
    ap.add_argument("--dcae_params", required=True)
    ap.add_argument("--output", required=True, help=".npz path")
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--start_date", default=None,
                    help="YYYY-MM-DD[Thh]: encode only timestamps >= this")
    ap.add_argument("--end_date", default=None,
                    help="YYYY-MM-DD[Thh]: encode only timestamps <= this")
    ap.add_argument("--compute_dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--device", default="cuda")
    return ap


def run(args: argparse.Namespace) -> dict:
    """Encode what ``args`` (:func:`build_parser`) selects; returns
    {"latents", "timestamps", "encode_s"} (seconds of the encode calls,
    each ending in a synchronise)."""
    if not args.output.endswith(".npz"):
        raise NotImplementedError(
            f"--output {args.output}: only .npz outputs are ported; zarr "
            f"waits for ROADMAP.md Queue 1 item M13 (part c, xarray)")
    device = resolve_device(args.device)
    from ladcast_torch.cli.pred_rollout import _load_any_params, open_field_source

    # the source and the range first, so that usage errors fail before the
    # checkpoint load
    src, timestamps = open_field_source(args.data)
    timestamps = np.asarray(timestamps, np.int64)
    if args.start_date or args.end_date:
        lo, hi = time_utils.date_bounds(args.start_date, args.end_date)
        timestamps = timestamps[(timestamps >= lo) & (timestamps <= hi)]
        if len(timestamps) == 0:
            raise SystemExit(f"no timestamps in range [{lo}, {hi}]: the source "
                             f"covers none of --start_date/--end_date")
    n = len(timestamps)
    if n == 0:
        raise SystemExit("source contains no timestamps to encode")

    params, cfg = _load_any_params(args.dcae_params, "dcae", DCAEConfig())
    cdt = getattr(torch, args.compute_dtype)
    dcae = hub.build_model("dcae", cfg, params, device, cdt)
    del params
    static = torch.from_numpy(
        static_data.static_conditioning_tensor(layout="HWC")).to(device, cdt)
    fm, fs = static_data.era5_mean_std()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    lats, encode_s = [], 0.0
    for s in range(0, n, args.batch_size):
        raw = src.frames_at(timestamps[s:s + args.batch_size])
        x = torch.from_numpy(np.asarray(raw, np.float32)).to(device)
        sync()
        t0 = time.perf_counter()
        with torch.inference_mode():
            x = transforms.normalize(x, torch.from_numpy(fm).to(device),
                                     torch.from_numpy(fs).to(device))
            x = torch.where(torch.isnan(x), -2.0, x)
            z = dcae.encode(x.to(cdt), static).float()
        sync()
        encode_s += time.perf_counter() - t0
        lats.append(z.cpu().numpy())
        print(f"encoded {min(s + args.batch_size, n)}/{n}", flush=True)
    latents = np.concatenate(lats)  # (time, 15, 30, 84)
    np.savez(args.output, latents=latents, timestamps=timestamps)
    print(f"wrote {args.output}: {latents.shape}")
    return {"latents": latents, "timestamps": timestamps, "encode_s": encode_s}


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
