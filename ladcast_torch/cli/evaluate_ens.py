"""Ensemble scoring CLI (the port of ``ladcast_tpu/cli/evaluate_ens.py``):
lat-weighted ensemble-mean RMSE, CRPS and ACC per (channel, lead time).

    python -m ladcast_torch.cli.evaluate_ens --latent_dir out \\
        --truth era5.npz --climatology clim.npz --dcae_params <hub dir> \\
        --output_dir scores [--diagnostics] [--device cpu]

Reads the per-init-time ``latent_<ts>.npy`` files of ``cli.pred_rollout``
((ens, C, T+1, h, w), physical latent scale), decodes the members on the
device (CUDA unless ``--device cpu`` is given) in the dtype of the loaded
DCAE parameters, scores every lead time against the truth and a
day-of-year / hour climatology, and writes per metric and rank
``<key>.rank<r>.npy`` and, on rank 0 after a barrier, the merged
``<key>.npy`` (init times, C, T, ...; rank 0's init times first), then
``summary.json``. Over N ranks (``torchrun --nproc_per_node N``) the init
times are strided over the ranks; with ``--shard_ensemble`` every rank
decodes its share of each init time's members instead, and rank 0 gathers
them and scores. SST (channel 82) takes nan-aware means over the ocean
(truth NaNs over land).

Truth: an ``.npz`` bundle (``fields`` (time, lat, lon, 84) raw,
``timestamps``) or a directory of monthly tars (``data.era5_tar``). Climatology: ``clim.npz`` of ``cli.compute_climatology``.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import time

import numpy as np
import torch

from ladcast_torch import channels as ch, resolve_device, static_data
from ladcast_torch.config import DCAEConfig
from ladcast_torch.data import time_utils, transforms
from ladcast_torch.metrics import scores
from ladcast_torch.metrics.weights import grid_lat_weights
from ladcast_torch.models import hub
from ladcast_torch.parallel import dist
from ladcast_torch.parallel.mesh import pad_to_multiple

METRIC_KEYS = ("ens_mean_mse", "crps", "acc")
DIAGNOSTIC_KEYS = ("spread", "rank_hist", "spectrum_fc", "spectrum_truth")


@contextlib.contextmanager
def _exact_fp32_convs():
    """cuDNN's convolutions without TF32 for the block: the fp32 scorer
    keeps fp32 products (the matmuls keep them by torch's default)."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def make_score_fn(dcae, lat_w: torch.Tensor, field_stats=None,
                  diagnostics: bool = False, shard_ensemble: bool = False):
    """The per-init-time scorer of a DCAE module (on its device, in its
    dtype): score(latents, truth, climate, stats=None) -> {key: (C, T, ...)}.

    ``latents`` (E, T, h, w, C) are in physical latent scale (the files'
    scale); ``truth`` and ``climate`` (T, H, W, C) in physical units. One
    lead time at a time: its E members are decoded at once, unnormalized
    with ``field_stats`` (default: the ERA5 statistics) and every metric
    is reduced on the device, so only (E, H, W, C) of decoded fields is
    live at a time. ``stats``, when given, gets the seconds spent decoding
    (``decode_s``) and scoring (``score_s``), each ending in a synchronise.

    ``shard_ensemble``: each rank of the process group decodes ceil(E /
    ranks) of a lead's members (the member axis padded, the extras
    discarded) and rank 0 gathers them and scores, since CRPS and the
    spread need every member; the other ranks' ``score`` returns None.
    """
    param = next(dcae.parameters())
    dev, dtype = param.device, param.dtype
    fm, fs = (torch.as_tensor(a, dtype=torch.float32, device=dev)
              for a in (field_stats or static_data.era5_mean_std()))
    lw = lat_w.to(dev, torch.float32).reshape(-1, 1)
    lwv = lw.reshape(-1)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    def per_lead(z, tr_t, cl_t):
        # z (E, h, w, C); tr_t, cl_t (H, W, C)
        E = z.shape[0]
        if shard_ensemble:
            n = dist.process_count()
            per = pad_to_multiple(E, n) // n
            z = torch.cat([z, z.new_zeros(per * n - E, *z.shape[1:])])
            z = z[dist.process_index() * per:(dist.process_index() + 1) * per]
        dec = dcae.decode(z.to(dtype)).float()
        dec = transforms.inverse_normalize(dec, fm, fs, 1.0)
        if shard_ensemble:
            dec = dist.gather_to_rank0(dec)
            if dec is None:
                return None, None, None
            dec = dec[:E]
        return dec, tr_t.movedim(-1, 0), cl_t.movedim(-1, 0)

    def metrics(dec, tr, cl):
        fc = dec.movedim(-1, 0)  # (C, E, H, W)
        ens_mean = fc.mean(dim=1)
        out = {"ens_mean_mse": scores.lat_weighted_mse(ens_mean, tr, lw,
                                                       nan_safe=True),
               "crps": torch.nanmean(scores.crps(fc, tr[:, None], 1) * lw,
                                     dim=(-2, -1)),
               "acc": scores.acc(ens_mean, tr, cl, lw, nan_safe=True)}
        if diagnostics:
            # truth NaNs (SST over land) weigh nothing in the spread and the
            # rank histogram and are zero-filled for the spectrum
            out["spread"] = scores.ensemble_spread(
                fc, lw, ensemble_axis=1, nan_mask=torch.isfinite(tr))
            out["rank_hist"] = scores.rank_histogram(fc, tr, lw, ensemble_axis=1)
            out["spectrum_fc"] = scores.zonal_power_spectrum(ens_mean, lwv)
            out["spectrum_truth"] = scores.zonal_power_spectrum(
                torch.nan_to_num(tr), lwv)
        return out

    @torch.inference_mode()
    def score(latents, truth, climate, stats=None):
        # lead-major, so that each lead's members are one contiguous batch
        z = torch.as_tensor(latents, dtype=torch.float32).to(dev)
        z = z.transpose(0, 1).contiguous()  # (T, E, h, w, C)
        truth = torch.as_tensor(truth, dtype=torch.float32).to(dev)
        climate = torch.as_tensor(climate, dtype=torch.float32).to(dev)
        per = []
        t_dec = t_score = 0.0
        with _exact_fp32_convs():
            for t in range(z.shape[0]):
                t0 = sync() if stats is not None else 0.0
                dec, tr, cl = per_lead(z[t], truth[t], climate[t])
                t1 = sync() if stats is not None else 0.0
                if dec is not None:
                    per.append(metrics(dec, tr, cl))
                del dec
                if stats is not None:
                    t2 = sync()
                    t_dec, t_score = t_dec + t1 - t0, t_score + t2 - t1
        if stats is not None:
            stats.update(decode_s=t_dec, score_s=t_score)
        if not per:  # a rank that decoded for rank 0
            return None
        # each metric (C, ...) per lead -> (C, T, ...)
        return {k: torch.stack([m[k] for m in per], dim=1) for k in per[0]}

    return score


def merge_rank_shards(output_dir, keys, n_ranks):
    """Concatenate the non-empty ``<key>.rank<r>.npy`` shards of every rank
    into ``<key>.npy``; returns the merged arrays."""
    merged = {}
    for k in keys:
        parts = [np.load(os.path.join(output_dir, f"{k}.rank{r}.npy"))
                 for r in range(n_ranks)]
        parts = [p for p in parts if p.shape[0] > 0]
        merged[k] = (np.concatenate(parts) if parts
                     else np.zeros((0, 1, 1), np.float32))
        np.save(os.path.join(output_dir, f"{k}.npy"), merged[k])
    return merged


def init_time_from_filename(path):
    """The YYYYMMDDHH init time of a ``latent_{ts}.npy`` file."""
    return int(os.path.basename(path).split("_")[-1].split(".")[0])


def derive_lead_budget(files, crop_init, step_size_hour,
                       total_lead_time_hour=None):
    """The lead hours ``--end_date`` reserves: the given total, else what
    the files hold ((E, C, T[+1], h, w), the t=0 frame dropped unless
    ``crop_init`` is off; only the header is read)."""
    if total_lead_time_hour is not None or not files:
        return total_lead_time_hour
    shape = np.load(files[0], mmap_mode="r").shape
    n_lead = shape[2] - 1 if crop_init else shape[2]
    return n_lead * step_size_hour


def filter_latent_files(files, start_date=None, end_date=None,
                        total_lead_time_hour=None):
    """The files whose init time lies in [start, end - lead], so that the
    whole forecast's truth exists before ``end_date``."""
    if not (start_date or end_date):
        return files
    lo, hi = time_utils.date_bounds(start_date, end_date,
                                    total_lead_time_hour or 0)
    return [f for f in files if lo <= init_time_from_filename(f) <= hi]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--latent_dir", required=True)
    ap.add_argument("--truth", required=True,
                    help="ERA5 .npz bundle or directory of monthly tars")
    ap.add_argument("--climatology", default=None,
                    help=".npz with key 'clim' (366, 4, lat, lon, C): day of "
                         "year - 1, hour // 6 (cli.compute_climatology)")
    ap.add_argument("--allow_truth_mean_climatology", action="store_true",
                    help="without --climatology, take the time mean of the "
                         "truth window as the climatology (ACC then only "
                         "indicative)")
    ap.add_argument("--dcae_params", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--step_size_hour", type=int, default=6)
    ap.add_argument("--start_date", default=None,
                    help="YYYY-MM-DD[Thh]: score only init times >= this")
    ap.add_argument("--end_date", default=None,
                    help="YYYY-MM-DD[Thh]: score only init times whose whole "
                         "forecast fits before this")
    ap.add_argument("--total_lead_time_hour", type=int, default=None,
                    help="score only the first total / step lead frames")
    ap.add_argument("--no_crop_init", dest="crop_init", action="store_false",
                    default=True,
                    help="score every frame: for files without the t=0 frame")
    ap.add_argument("--force_ens_size", type=int, default=None,
                    help="score only the first N members")
    ap.add_argument("--diagnostics", action="store_true",
                    help="also spread and spread/skill, rank histograms and "
                         "zonal power spectra of ens-mean and truth")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shard_ensemble", action="store_true",
                    help="split each init time's member decode over the "
                         "ranks, rather than the init times")
    # a flag of the JAX CLI whose module is not ported yet
    ap.add_argument("--plot_diagnostics", default=None, metavar="PNG")
    return ap


_NOT_PORTED = [
    (lambda a: a.plot_diagnostics,
     "--plot_diagnostics: utils/visualization.py waits for ROADMAP.md "
     "Queue 1 item M13 (part c, visualization)"),
]


def _headline_summary(merged, step_size_hour, diagnostics):
    """Per headline variable, ens-mean RMSE and CRPS (with --diagnostics
    spread and spread/skill) at day 1 / 5 / 10, or at the last lead."""
    mse = merged["ens_mean_mse"].mean(0)
    crps = merged["crps"].mean(0)
    T = mse.shape[1]
    leads = {f"day{d}": d * 24 // step_size_hour - 1 for d in (1, 5, 10)
             if d * 24 // step_size_hour - 1 < T}
    if not leads:
        leads["final"] = T - 1
    headline = [("geopotential", 500), ("geopotential", 850),
                ("temperature", 500), ("temperature", 850),
                ("u_component_of_wind", 500), ("u_component_of_wind", 850),
                ("specific_humidity", 500), ("specific_humidity", 850),
                ("mean_sea_level_pressure", None), ("2m_temperature", None)]
    spread = merged["spread"].mean(0) if diagnostics else None
    # the fair finite-ensemble factor: calibrated iff RMSE == spread * it
    fair = (np.sqrt(merged["rank_hist"].shape[-1]
                    / (merged["rank_hist"].shape[-1] - 1.0))
            if diagnostics and merged["rank_hist"].ndim == 4 else 1.0)
    summary = {}
    for var, level in headline:
        ci = ch.channel_index(var, level)
        name = f"{var}@{level}" if level else var
        summary[name] = {k: {"rmse": round(float(np.sqrt(mse[ci, t])), 4),
                             "crps": round(float(crps[ci, t]), 4)}
                         for k, t in leads.items()}
        if spread is not None:
            for k, t in leads.items():
                rmse_v = float(np.sqrt(mse[ci, t]))
                summary[name][k]["spread"] = round(float(spread[ci, t]), 4)
                summary[name][k]["ssr"] = round(
                    float(spread[ci, t]) * fair / max(rmse_v, 1e-12), 4)
    return summary


def run(args: argparse.Namespace) -> dict:
    """Score the files of ``args`` (:func:`build_parser`). Returns
    {"summary", "num_init_times", "records"}: the records are the printed
    lines, one per init time, with its decode and score seconds."""
    if args.climatology is None and not args.allow_truth_mean_climatology:
        raise SystemExit("--climatology is required for ACC (or pass "
                         "--allow_truth_mean_climatology for an indicative "
                         "truth-window-mean substitute)")
    for unsupported, msg in _NOT_PORTED:
        if unsupported(args):
            raise NotImplementedError(msg)
    dist.initialize(device=args.device)
    device = dist.local_device(resolve_device(args.device))
    rank = dist.process_index()
    from ladcast_torch.cli.pred_rollout import _load_any_params, open_field_source

    truth_src, _ = open_field_source(args.truth)
    params, dcae_cfg = _load_any_params(args.dcae_params, "dcae", DCAEConfig())
    # the loaded parameters' dtype (fp32 checkpoints decode in fp32)
    dtype = next(v.dtype for v in params.values() if v.is_floating_point())
    dcae = hub.build_model("dcae", dcae_cfg, params, device, dtype)
    del params
    clim = np.load(args.climatology)["clim"] if args.climatology else None

    files = sorted(glob.glob(os.path.join(args.latent_dir, "latent_*.npy")))
    lead_budget = (derive_lead_budget(files, args.crop_init, args.step_size_hour,
                                      args.total_lead_time_hour)
                   if args.end_date else args.total_lead_time_hour)
    files = filter_latent_files(files, args.start_date, args.end_date,
                                lead_budget)
    if not args.shard_ensemble:
        files = dist.shard_list(files)
    lat_w = torch.as_tensor(grid_lat_weights("cos"), dtype=torch.float32)
    score_fn = make_score_fn(dcae, lat_w, diagnostics=args.diagnostics,
                             shard_ensemble=args.shard_ensemble)
    scored, records = [], []
    for f in files:
        t0 = time.perf_counter()
        ts = init_time_from_filename(f)
        arr = np.load(f)  # (E, C, T+1, h, w), physical latent scale
        if args.force_ens_size is not None:
            arr = arr[: args.force_ens_size]
        lat = np.moveaxis(arr, 1, -1)
        if args.crop_init:
            lat = lat[:, 1:]  # drop t=0: (E, T, h, w, C)
        if args.total_lead_time_hour is not None:
            lat = lat[:, : args.total_lead_time_hour // args.step_size_hour]
        lead_ts = [time_utils.add_hours_int(ts, args.step_size_hour * (i + 1))
                   for i in range(lat.shape[1])]
        try:
            truth = truth_src.frames_at(lead_ts)  # (T, H, W, C) physical
        except (KeyError, ValueError) as e:
            records.append({"init_time": ts, "skipped": str(e)[:120]})
            print(json.dumps(records[-1]), flush=True)
            continue
        if clim is not None:
            days = [time_utils.int_to_datetime(t) for t in lead_ts]
            cl = np.stack([clim[d.timetuple().tm_yday - 1, d.hour // 6]
                           for d in days])
        else:
            cl = np.broadcast_to(np.nanmean(truth, axis=0, keepdims=True),
                                 truth.shape).copy()
        stats = {}
        m = score_fn(np.ascontiguousarray(lat, np.float32),
                     np.asarray(truth, np.float32), np.asarray(cl, np.float32),
                     stats)
        if m is not None:
            scored.append({k: v.cpu().numpy() for k, v in m.items()})
        records.append({"init_time": ts, "scored": m is not None, **stats,
                        "seconds": time.perf_counter() - t0})
        print(json.dumps(records[-1]), flush=True)

    # every rank writes its shard files; after the barrier rank 0 merges
    # them (processes may skip different numbers of init times)
    os.makedirs(args.output_dir, exist_ok=True)
    keys = list(METRIC_KEYS) + (list(DIAGNOSTIC_KEYS) if args.diagnostics else [])
    for k in keys:
        stacked = (np.stack([m[k] for m in scored]) if scored
                   else np.zeros((0, 1, 1), np.float32))  # (N, C, T, ...)
        np.save(os.path.join(args.output_dir, f"{k}.rank{rank}.npy"), stacked)
    dist.barrier("scorer-shards-written")
    if rank != 0:
        return {"summary": None, "num_init_times": None, "records": records}
    merged = merge_rank_shards(args.output_dir, keys, dist.process_count())
    if merged["crps"].shape[0] == 0:
        raise SystemExit("no init time was scored: check --latent_dir and "
                         "--truth")
    summary = _headline_summary(merged, args.step_size_hour, args.diagnostics)
    with open(os.path.join(args.output_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps({"num_init_times": int(merged["crps"].shape[0]),
                      "saved": args.output_dir, "summary": summary}))
    return {"summary": summary, "num_init_times": int(merged["crps"].shape[0]),
            "records": records}


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
