"""DCAE reconstruction training CLI (the port of
``ladcast_tpu/cli/train_dcae.py``).

    python -m ladcast_torch.cli.train_dcae --config configs/dcae_84.yaml \\
        --data era5.npz [--val_data val.npz] [--num_steps N] \\
        [--resume latest | --init_weights <dir>] [--device cpu]

Trains the config's ``encdec`` autoencoder on CUDA unless ``--device
cpu`` is given, on one device or data-parallel over the ranks of
``torchrun --nproc_per_node N`` (the yaml's ``parallel.mesh`` may name the
``data`` axis only; ``train.batch_size`` is per rank), from raw fields in an ``.npz`` bundle or a
directory of monthly tars (``data.era5_tar``). A tar directory gives its
``train`` split (1979-2017) unless ``--split`` says otherwise and, without
``--val_data``, validates on its ``--val_split`` (2018), as the reference
does with one archive. Each batch of ``train.batch_size`` random frames
is normalized and SST-masked on the host and then serves
``train.subbatch_steps`` optimizer steps (the first unrolled, the others
periodic-rolled; ``train.trainer_dcae``). With
``train.ft_decoder_only`` the encoder is frozen (decoder finetuning, from
``--init_weights``). Outputs under ``--output_dir``: ``metrics.jsonl``,
``config.json``, ``ckpts/step_*.pt`` (the whole state, for ``--resume``)
and, with validation, ``best/step-<N>/``: the EMA weights of the 3 newest
best validation losses, as diffusers model directories that every CLI
loads.

:func:`main` parses the arguments and reads the YAML; :func:`run` trains
from a config dict, so a caller without PyYAML can pass the dict itself.
"""

from __future__ import annotations

import argparse
import os
import shutil
import time

import numpy as np
import torch

from ladcast_torch import channels as ch, resolve_device, static_data
from ladcast_torch.config import DCAEConfig, config_from_dict
from ladcast_torch.data import transforms
from ladcast_torch.parallel import dist
from ladcast_torch.parallel.mesh import make_mesh_from_spec
from ladcast_torch.train import checkpoint as ckpt
from ladcast_torch.train.optim import decoder_only_mask, make_optimizer
from ladcast_torch.train.trainer_dcae import DCAETrainConfig, make_dcae_train_step
from ladcast_torch.utils.logging_utils import MetricLogger
from ladcast_torch.utils.profiling import PhaseTimer

BEST_KEPT = 3  # best-validation weight directories kept


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=None, help="YAML config (main only)")
    ap.add_argument("--data", required=True,
                    help="ERA5 .npz bundle or directory of monthly tars")
    ap.add_argument("--output_dir", default=None)
    ap.add_argument("--num_steps", type=int, default=None)
    ap.add_argument("--resume", default=None, help="'latest' or a step")
    ap.add_argument("--init_weights", default=None,
                    help="weights-only warm start (a diffusers model "
                         "directory, a .safetensors file or a checkpoint "
                         "directory of this trainer): parameters and EMA "
                         "loaded, optimizer and step fresh; ignored when "
                         "--resume is given")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--val_data", default=None,
                    help="held-out ERA5 .npz bundle or tar directory for "
                         "validation")
    ap.add_argument("--val_every", type=int, default=None,
                    help="validation interval in steps (default: "
                         "general.val_every_steps or 1000)")
    ap.add_argument("--split", default=None,
                    help="keep only a split's years of --data (train, "
                         "validation, test, full or a year); default: train "
                         "for a tar directory, every frame of an .npz")
    ap.add_argument("--val_split", default="validation",
                    help="the split of --val_data or, without it, of a tar "
                         "directory --data")
    ap.add_argument("--log_every", type=int, default=50,
                    help="log every N steps (and the first)")
    ap.add_argument("--device", default="cuda")
    return ap


def run(cfg: dict, args: argparse.Namespace) -> dict:
    """Train from the config dict ``cfg`` with the options ``args``
    (:func:`build_parser`). Returns {"state": the final TrainState,
    "history": one record per logged step, "validations": one record per
    validation, "train_step": the step function}."""
    from ladcast_torch.cli.pred_rollout import _load_any_params, open_field_source

    dist.initialize(device=args.device)
    device = dist.local_device(resolve_device(args.device))
    par_cfg = cfg.get("parallel") or {}
    if par_cfg.get("zero"):
        raise ValueError(f"parallel: {par_cfg}: the DCAE trains data-parallel "
                         f"only, so zero does not apply")
    mesh = make_mesh_from_spec(par_cfg.get("mesh") or {"data": -1}, device.type)
    dcae_cfg = config_from_dict(DCAEConfig, cfg.get("encdec", {}))
    train_cfg = cfg.get("train", {})
    opt_cfg = cfg.get("optimizer", {})
    lr_cfg = cfg.get("lr_scheduler", {})
    gen_cfg = cfg.get("general", {})
    ema_cfg = cfg.get("ema", {})
    out_dir = args.output_dir or gen_cfg.get("output_dir", "runs/dcae")
    bs = train_cfg.get("batch_size", 4)
    num_steps = args.num_steps if args.num_steps is not None else (
        train_cfg.get("num_train_epochs", 30)
        * train_cfg.get("epoch_length", 341875) // max(bs, 1))

    tcfg = DCAETrainConfig(
        lat_weighted_loss=train_cfg.get("lat_weighted_loss", True),
        subbatch_steps=train_cfg.get("subbatch_steps", 3),
        use_ema=ema_cfg.get("use_ema", True),
        ema_max_decay=ema_cfg.get("ema_max_decay", 0.9999),
        ema_power=ema_cfg.get("ema_power", 0.66667),
        ema_update_after_step=ema_cfg.get("ema_update_after_step", 1000))
    optimizer = make_optimizer(
        lr=float(opt_cfg.get("lr", 1e-4)),
        weight_decay=float(opt_cfg.get("weight_decay", 1e-2)),
        betas=tuple(opt_cfg.get("betas", (0.9, 0.999))),
        num_warmup_steps=lr_cfg.get("num_warmup_steps", 1000),
        num_training_steps=num_steps,
        # decoder-only finetuning (the reference's --ft_decoder)
        trainable_mask=(decoder_only_mask if train_cfg.get("ft_decoder_only")
                        else None))
    init_fn, train_step, eval_step = make_dcae_train_step(
        dcae_cfg, tcfg, optimizer, device, mesh=mesh)
    # the global batch: batch_size per rank; every rank draws the same
    # frames from the seeded generator and reads its rows
    global_bs = bs * dist.process_count()
    rows = dist.host_local_slice(global_bs)

    split = args.split or ("train" if os.path.isdir(args.data) else None)
    src, all_ts = open_field_source(args.data, split=split)
    if len(all_ts) == 0:
        raise SystemExit(f"{args.data}: no frames in split {split!r}")
    fm, fs = static_data.era5_mean_std()
    statics = torch.from_numpy(
        static_data.static_conditioning_tensor(layout="HWC")).to(device)

    def make_batch(ts_chunk, source=src):
        """Normalized fields with the SST NaNs at -2, the NaN mask, and the
        statics, on the device."""
        x = transforms.normalize(source.frames_at(np.asarray(ts_chunk)[rows]), fm, fs)
        nan_mask = np.isnan(x[..., ch.SST_CHANNEL_INDEX])
        x = np.where(np.isnan(x), -2.0, x).astype(np.float32)
        return (torch.from_numpy(x).to(device),
                torch.from_numpy(nan_mask).to(device), statics)

    rng = np.random.RandomState(args.seed)
    batch = make_batch(rng.choice(all_ts, global_bs, replace=False))
    state = init_fn(args.seed)
    mgr = ckpt.make_manager(os.path.join(out_dir, "ckpts"))
    if args.resume:
        ckpt.restore_state(mgr, state,
                           None if args.resume == "latest" else int(args.resume))
    elif args.init_weights:
        raw = None
        if dist.process_index() == 0:
            raw, _ = _load_any_params(args.init_weights, "dcae", dcae_cfg)
        state.load_full_params(raw)
        if state.ema is not None:
            with torch.no_grad():
                torch._foreach_copy_(state.ema.params,
                                     list(state.model.parameters()))

    rank0 = dist.process_index() == 0
    logger = MetricLogger(out_dir if rank0 else None, config=cfg)
    validations = []
    val_src = None
    if args.val_data:
        val_src, val_ts = open_field_source(args.val_data, split=args.val_split)
    elif args.val_split and os.path.isdir(args.data):
        # the validation split of the training archive itself
        from ladcast_torch.data.era5_tar import available_timestamps

        val_ts = available_timestamps(args.data, args.val_split)
        val_src = src if len(val_ts) else None
    if val_src is not None:
        val_every = args.val_every or gen_cfg.get("val_every_steps", 1000)
        _, ss = static_data.static_mean_std()
        # physical RMSE per channel [84 dynamic | 5 static]: the normalized
        # MSE's root times the channel's std (the mean cancels)
        unnorm_std = np.concatenate([fs, ss]).astype(np.float32)
        names = ch.channel_names() + list(ch.STATIC_NAMES)
        best_val_loss = float("inf")
        best_dir = os.path.join(out_dir, "best")
        os.makedirs(best_dir, exist_ok=True)

    def run_validation(step):
        """EMA-weight validation: the frame-weighted loss and per-channel
        physical (lat-weighted) RMSE; a new best is written to best/."""
        nonlocal best_val_loss
        model = state.model
        val_params = state.ema.params if state.ema is not None else None
        total = {"loss": 0.0, "mse": 0.0, "lw_mse": 0.0}
        n = 0
        for i in range(0, len(val_ts) - global_bs + 1, global_bs):
            ev = eval_step(model, make_batch(val_ts[i:i + global_bs], val_src),
                           val_params)
            # the global batch's means: each rank's rows averaged over ranks
            dist.all_reduce_mean_([ev["loss"], ev["channel_mse"],
                                   ev["channel_lw_mse"]])
            total["loss"] += float(ev["loss"]) * global_bs
            total["mse"] = total["mse"] + ev["channel_mse"].cpu().numpy() * global_bs
            total["lw_mse"] = (total["lw_mse"]
                               + ev["channel_lw_mse"].cpu().numpy() * global_bs)
            n += global_bs
        if n == 0:
            return
        val_loss = total["loss"] / n
        rmse = np.sqrt(total["mse"] / n) * unnorm_std
        lw_rmse = np.sqrt(total["lw_mse"] / n) * unnorm_std
        logs = {"val_loss": val_loss}
        for c, name in enumerate(names):
            logs[f"val_rmse_{name}"] = float(rmse[c])
            logs[f"val_lw_rmse_{name}"] = float(lw_rmse[c])
        logger.log(logs, step)
        validations.append({"step": step, **logs})
        if val_loss < best_val_loss:
            best_val_loss = val_loss
            if rank0:  # rank 0 writes, the others wait for it
                save_best(step, model, val_params)
            dist.barrier("best-val-ckpt")

    def save_best(step, model, val_params):
        """The weights of a new best validation loss as ``best/step-<step>``,
        the oldest beyond BEST_KEPT removed."""
        existing = sorted((d for d in os.listdir(best_dir)
                           if d.startswith("step-")),
                          key=lambda d: int(d.split("-")[1]))
        for d in existing[: max(len(existing) - (BEST_KEPT - 1), 0)]:
            shutil.rmtree(os.path.join(best_dir, d))
        from ladcast_torch.models import hub

        weights = (dict(zip([k for k, _ in model.named_parameters()],
                            val_params))
                   if val_params is not None else model.state_dict())
        hub.save_pretrained(os.path.join(best_dir, f"step-{step}"), "dcae",
                            dcae_cfg, {k: v.detach().cpu()
                                       for k, v in weights.items()})

    ckpt_every = gen_cfg.get("checkpointing_steps", 40000)
    timer = PhaseTimer()
    history = []
    step = start_step = state.step
    t0, last = time.perf_counter(), step
    try:
        while step < num_steps:
            # a fresh batch every subbatch_steps steps, reused in between
            if step % tcfg.subbatch_steps == 0 and step > 0:
                with timer.phase("data"):
                    batch = make_batch(rng.choice(all_ts, global_bs, replace=False))
            with timer.phase("step_dispatch"):
                aux = train_step(state, batch, args.seed)
            step = state.step
            if step % args.log_every == 0 or step == start_step + 1:
                rec = {"loss": float(aux["loss"]),  # waits for the step
                       "grad_norm": float(aux["grad_norm"])}
                now = time.perf_counter()
                rec["step_s"] = (now - t0) / (step - last)
                t0, last = now, step
                if device.type == "cuda":
                    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated(device) / 2**30
                logger.log({**rec, "phases": timer.summary()}, step)
                history.append({"step": step, **rec})
            if step % ckpt_every == 0 or step == num_steps:
                with timer.phase("checkpoint"):
                    ckpt.save_state(mgr, step, state)
            if val_src is not None and (step % val_every == 0 or step == num_steps):
                with timer.phase("validation"):
                    run_validation(step)
                t0 = time.perf_counter()  # the step time leaves validation out
    finally:
        logger.close()
    return {"state": state, "history": history, "validations": validations,
            "train_step": train_step}


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.config:
        raise SystemExit("--config is required")
    from ladcast_torch.utils.registry import load_yaml

    return run(load_yaml(args.config), args)


if __name__ == "__main__":
    main()
