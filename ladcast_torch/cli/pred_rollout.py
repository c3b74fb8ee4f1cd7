"""Ensemble-forecast generation CLI (the port of
``ladcast_tpu/cli/pred_rollout.py``).

    python -m ladcast_torch.cli.pred_rollout --data era5.npz \\
        --dit_params <hub dir> --dcae_params <hub dir> --output_dir out \\
        [--sampler edm|dpm] [--decode] [--device cpu]

Builds the evaluation init-time list (N samples per month at 00z / 12z, of
``--year`` or of a date range), loads the DiT and the DCAE, runs the
ensemble rollout per init time on CUDA unless ``--device cpu`` is given
and writes per init time ``latent_<ts>.npy``, (ens, C, T+1, h, w)
in the reference layout (channels first, physical latent scale, t=0 = the
encoded analysis), and with ``--decode`` ``fields_<ts>.npz``, the decoded
fields in physical units with their coordinates.

ERA5 input: an ``.npz`` bundle with ``fields`` (time, lat, lon, 84), raw,
and ``timestamps`` (YYYYMMDDHH ints), a directory of monthly tars
(``YYYY_MM.tar`` of hourly (85, 121, 240) ``.npy`` members,
``data.era5_tar``), or an ERA5 zarr in the reference layout (xarray). ``--int8_matmuls`` runs the DiT's transformer-block
matmuls as dynamic w8a8 int8 products (``ops.quant``): an opt-in
approximation of the exact forecast.

Over N ranks (``torchrun --nproc_per_node N``, one process per card): the
init times are strided over the ranks and each rank writes its own init
times' files, which equal a one-process run's (the per-init seed); with
``--shard_ensemble`` every rank works on every init time, each on its
ceil(E / N) members (``rollout.pipeline``), and rank 0 writes the files.

:func:`main` parses the arguments; :func:`run` forecasts from parsed
arguments and returns one record per init time.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch
from torch.profiler import record_function

from ladcast_torch import channels as ch, resolve_device, static_data
from ladcast_torch.config import (
    DCAEConfig,
    EDMSchedulerConfig,
    RolloutConfig,
    ladcast_1p6b_config,
    ladcast_375m_config,
)
from ladcast_torch.data import time_utils, transforms
from ladcast_torch.evaluate.export import decoded_to_npz
from ladcast_torch.models import hub
from ladcast_torch.parallel import dist
from ladcast_torch.rollout.engine import stream_seed
from ladcast_torch.rollout.pipeline import ForecastPipeline


class NpzFieldSource:
    """(time, lat, lon, 84) raw fields + YYYYMMDDHH ints."""

    def __init__(self, path: str):
        d = np.load(path)
        self.fields = d["fields"]
        self.timestamps = list(d["timestamps"].astype(np.int64))

    def frames_at(self, ts_ints):
        idx = [self.timestamps.index(int(t)) for t in ts_ints]
        return self.fields[idx]


class ZarrFieldSource:
    """The reference's ERA5 zarr (requires xarray and pandas), the south
    pole row cropped at read."""

    def __init__(self, path: str):
        import pandas as pd
        import xarray as xr

        ds = xr.open_zarr(path)
        self.ds = ds.sel(latitude=slice(ch.LAT_START_DEG, ch.LAT_END_DEG))
        self._pd = pd

    def frames_at(self, ts_ints):
        """(T, lat, lon, 84) float32 raw fields at the YYYYMMDDHH ints: one
        batched selection per call, which reads each chunk once (a
        selection per time and variable would make T x 12 round trips to
        the store)."""
        times = np.asarray([np.datetime64(time_utils.int_to_datetime(int(t)))
                            for t in ts_ints])
        sel = self.ds.sel(time=times)
        stack = []
        for var in ch.ATM_VARIABLES:
            stack.append(sel[var].sel(level=list(ch.PRESSURE_LEVELS)).transpose(
                "time", "level", "latitude", "longitude").values)
        for var in ch.SURFACE_VARIABLES:
            stack.append(sel[var].transpose(
                "time", "latitude", "longitude").values[:, None])
        return np.moveaxis(np.concatenate(stack, 1), 1, -1).astype(np.float32)


def _is_zarr(path: str) -> bool:
    """Whether :func:`open_field_source` reads ``path`` as a zarr store:
    anything that is neither an ``.npz`` nor a directory of tars (a
    directory named ``*.zarr`` or holding zarr metadata is a store)."""
    if path.endswith(".npz"):
        return False
    if os.path.isdir(path):
        return path.rstrip("/").endswith(".zarr") or any(
            os.path.exists(os.path.join(path, f))
            for f in (".zgroup", ".zmetadata", "zarr.json"))
    return True


def open_field_source(path: str, split: str = None):
    """(source, timestamps int64) of an ERA5 field source: an ``.npz``
    bundle, a directory of monthly tars (``data.era5_tar``; its timestamps
    in archive order), or a zarr store (:class:`ZarrFieldSource`).
    ``split`` keeps a named split's years (train 1979-2017, validation
    2018, test 2022, full, or a year)."""
    if _is_zarr(path):
        src = ZarrFieldSource(path)
        ts = np.asarray([int(t.strftime("%Y%m%d%H")) for t in
                         src._pd.to_datetime(src.ds.time.values)], np.int64)
    elif os.path.isdir(path):
        from ladcast_torch.data import era5_tar

        return (era5_tar.TarFieldSource(path),
                era5_tar.available_timestamps(path, split or "full"))
    else:
        src = NpzFieldSource(path)
        ts = np.asarray(src.timestamps, np.int64)
    if split:
        ts = time_utils.split_timestamps(ts, split)
    return src, ts


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", required=True,
                    help="ERA5 .npz bundle, directory of monthly tars or "
                         "zarr store")
    ap.add_argument("--dit_params", required=True,
                    help="a diffusers model or training-checkpoint directory "
                         "(config taken from its config.json), a "
                         ".safetensors file, or a checkpoint directory of "
                         "ladcast_torch.cli.train_ar")
    ap.add_argument("--dcae_params", required=True)
    ap.add_argument("--dit_subfolder", default=None,
                    help="subfolder inside --dit_params (e.g. ar_model "
                         "rather than the preferred ar_model_ema)")
    ap.add_argument("--dcae_subfolder", default=None)
    ap.add_argument("--model", default="375M", choices=["375M", "1.6B"],
                    help="DiT config when --dit_params is not a diffusers "
                         "directory (ignored otherwise)")
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--year", type=int, default=2018)
    ap.add_argument("--start_date", default=None,
                    help="YYYY-MM-DD[Thh]: evaluate a date range instead of "
                         "--year; per-month sampling still applies")
    ap.add_argument("--end_date", default=None,
                    help="YYYY-MM-DD[Thh] range end (inclusive); requires "
                         "--start_date")
    ap.add_argument("--num_samples_per_month", type=int, default=10)
    ap.add_argument("--ensemble_size", type=int, default=20)
    ap.add_argument("--num_inference_steps", type=int, default=20)
    ap.add_argument("--return_seq_len", type=int, default=4)
    ap.add_argument("--input_seq_len", type=int, default=1)
    ap.add_argument("--total_lead_time_hour", type=int, default=240)
    ap.add_argument("--step_size_hour", type=int, default=6)
    ap.add_argument("--noise_level", type=float, default=0.0)
    ap.add_argument("--sampler", default="edm", choices=["edm", "dpm"])
    ap.add_argument("--correction_skip_period", type=int, default=0,
                    help="approximate acceleration: evaluate only every N-th "
                         "Heun correction, extrapolate the rest (0 = exact)")
    ap.add_argument("--host_step", action="store_true",
                    help="drive the AR loop repetition by repetition "
                         "(the same trajectory)")
    ap.add_argument("--save_as_latent", action="store_true", default=True)
    ap.add_argument("--decode", dest="save_as_latent", action="store_false")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--int8_matmuls", action="store_true",
                    help="approximate: dynamic w8a8 int8 matmuls in the DiT's "
                         "transformer blocks (ops/quant.py); validate skill "
                         "before production use")
    ap.add_argument("--shard_ensemble", action="store_true",
                    help="split each init time's members over the ranks, "
                         "rather than the init times")
    return ap


def _trainer_checkpoint_params(path: str, kind: str, cfg):
    """The weights of the newest step in a checkpoint directory of
    ``ladcast_torch.cli.train_ar`` (the DiT) or ``cli.train_dcae`` (the
    DCAE): the EMA average where the run kept one (what the reference
    evaluates), else the raw parameters."""
    from ladcast_torch.models.dcae import AutoencoderDC
    from ladcast_torch.models.ladcast_dit import LaDCastTransformer3D
    from ladcast_torch.train import checkpoint as ckpt

    state = ckpt.make_manager(path, max_to_keep=0).restore(map_location="cpu")
    if state.get("ema") is None:
        return state["params"]
    with torch.device("meta"):
        model = LaDCastTransformer3D(cfg) if kind == "dit" else AutoencoderDC(cfg)
        names = [n for n, _ in model.named_parameters()]
    ema = state["ema"]["params"]
    if len(ema) != len(names):
        raise ValueError(f"{path}: {len(ema)} EMA tensors for a model of "
                         f"{len(names)} parameters (--model?)")
    return dict(zip(names, ema))


def _load_any_params(path: str, kind: str, cfg, subfolder: str = None):
    """(state dict, config) from any supported checkpoint layout:

    - a bare ``.safetensors`` file (reference state dict), with the
      caller's ``cfg``;
    - a diffusers model directory (hub layout, training checkpoints with
      ``ar_model`` / ``ar_model_ema`` subfolders included, single or
      index-sharded safetensors): the config comes from its
      ``config.json`` and the caller's ``cfg`` is ignored;
    - a checkpoint directory of ``ladcast_torch.cli.train_ar`` (the DiT)
      or ``cli.train_dcae`` (the DCAE) (``step_*.pt`` files), with the
      caller's ``cfg``.
    """
    if path.endswith(".safetensors"):
        from ladcast_torch.models.safetensors_io import load_file

        return load_file(path), cfg
    if hub.is_hub_dir(path):
        loaded = hub.load_pretrained(path, subfolder, expect_kind=kind)
        return loaded.params, loaded.config
    if os.path.isdir(path):
        return _trainer_checkpoint_params(path, kind, cfg), cfg
    raise FileNotFoundError(
        f"{path}: neither a .safetensors file, a diffusers model directory "
        f"nor a trainer checkpoint directory")


def run(args: argparse.Namespace, compute_dtype: str = "bfloat16") -> list:
    """Forecast every init time of ``args`` (:func:`build_parser`) that the
    data holds. Returns the printed records: per init time its seconds by
    stage, or why it was skipped."""
    if (args.start_date is None) != (args.end_date is None):
        raise ValueError("--start_date and --end_date must be given together")
    if _is_zarr(args.data):  # fail on a missing xarray before the loads
        import xarray  # noqa: F401
    dist.initialize(device=args.device)
    device = dist.local_device(resolve_device(args.device))
    rank0 = dist.process_index() == 0

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    rcfg = RolloutConfig(
        ensemble_size=args.ensemble_size,
        num_inference_steps=args.num_inference_steps,
        return_seq_len=args.return_seq_len,
        input_seq_len=args.input_seq_len,
        total_lead_time_hour=args.total_lead_time_hour,
        step_size_hour=args.step_size_hour,
        noise_level=args.noise_level,
        sampler_type=args.sampler,
        correction_skip_period=args.correction_skip_period)
    dit_cfg = (ladcast_375m_config() if args.model == "375M"
               else ladcast_1p6b_config())
    # the stages carry profiler labels, which a device trace
    # (utils.profiling.device_trace) shows beside the host's ops
    t0 = time.perf_counter()
    with record_function("pred_rollout.load"):
        dit_params, dit_cfg = _load_any_params(
            args.dit_params, "dit", dit_cfg, args.dit_subfolder)
        dcae_params, dcae_cfg = _load_any_params(
            args.dcae_params, "dcae", DCAEConfig(), args.dcae_subfolder)
        if args.int8_matmuls:
            dit_cfg = dataclasses.replace(dit_cfg, int8_matmuls=True)
        pipe = ForecastPipeline(dit_cfg, dcae_cfg, EDMSchedulerConfig(), rcfg,
                                dit_params, dcae_params,
                                compute_dtype=compute_dtype,
                                host_step=args.host_step, device=device,
                                shard_ensemble=args.shard_ensemble)
        del dit_params, dcae_params
    records = [{"loaded": True, "load_s": sync() - t0}]
    print(json.dumps(records[0]), flush=True)

    # the init times' year, where there is one, bounds a tar directory's
    # index pass (frames_at reads any month of the archive)
    years = ({args.start_date[:4], args.end_date[:4]} if args.start_date
             else {str(args.year)})
    one_year = (len(years) == 1 and os.path.isdir(args.data)
                and not _is_zarr(args.data))
    source, _ = open_field_source(args.data, years.pop() if one_year else None)
    if args.start_date:
        init_times = time_utils.filter_eval_timestamps_range(
            time_utils.date_str_to_int(args.start_date),
            time_utils.date_str_to_int(args.end_date),
            args.num_samples_per_month)
    else:
        init_times = time_utils.filter_eval_timestamps(
            [args.year], args.num_samples_per_month)
    if not args.shard_ensemble:
        init_times = dist.shard_list(init_times)
    # the rank that writes this run's files: each its own, or rank 0 the
    # gathered ensembles
    writes = rank0 or not args.shard_ensemble

    os.makedirs(args.output_dir, exist_ok=True)
    fm, fs = static_data.era5_mean_std()
    decode = not args.save_as_latent
    for ts in init_times:
        t0 = time.perf_counter()
        input_ts = [time_utils.add_hours_int(ts, -args.step_size_hour * i)
                    for i in range(args.input_seq_len - 1, -1, -1)]
        try:
            with record_function("pred_rollout.read"):
                raw = source.frames_at(input_ts)  # (T_in, lat, lon, 84)
        except (KeyError, ValueError, FileNotFoundError) as e:
            records.append({"init_time": ts, "skipped": str(e)[:120]})
            print(json.dumps(records[-1]), flush=True)
            continue
        fields = torch.from_numpy(
            transforms.normalize(raw, fm, fs).astype(np.float32)).to(device)
        fields = torch.where(torch.isnan(fields), -2.0, fields)  # SST mask
        # The per-init stream folds the init TIMESTAMP into the seed, so a
        # (seed, init time) forecast is the same whatever other init times
        # the run holds or where it restarts.
        stats = {}
        with record_function("pred_rollout.forecast"):
            traj, decoded, z_phys = pipe.forecast_from_fields(
                fields, ts, stream_seed(args.seed, ts), decode=decode, stats=stats)
        if not writes:
            records.append({"init_time": ts, **stats,
                            "seconds": round(time.perf_counter() - t0, 2)})
            print(json.dumps(records[-1]), flush=True)
            continue

        # Prepend the t=0 encoded analysis frame; channels first
        # (ens, C, T+1, h, w), PHYSICAL latent scale: the reference's npy
        # convention, so that these files interchange with its scorer.
        z0 = z_phys[-1][None, None].expand(rcfg.ensemble_size, 1,
                                           *z_phys.shape[1:])
        with record_function("pred_rollout.write"):
            full = torch.cat([z0, pipe.unnormalize_latent(traj)], dim=1)
            np.save(os.path.join(args.output_dir, f"latent_{ts}.npy"),
                    full.movedim(-1, 1).cpu().numpy())
            if decoded is not None:
                decoded_to_npz(decoded.cpu().numpy(), ts,
                               os.path.join(args.output_dir, f"fields_{ts}.npz"),
                               step_size_hour=args.step_size_hour)
        records.append({"init_time": ts, **stats,
                        "seconds": round(time.perf_counter() - t0, 2)})
        print(json.dumps(records[-1]), flush=True)
    return records


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    # validate the flag pairing before the (slow) checkpoint loads
    if (args.start_date is None) != (args.end_date is None):
        ap.error("--start_date and --end_date must be given together")
    return run(args)


if __name__ == "__main__":
    main()
