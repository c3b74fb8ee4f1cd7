"""AR diffusion training CLI (the port of ``ladcast_tpu/cli/train_ar.py``).

    python -m ladcast_torch.cli.train_ar --config configs/ladcast_375m.yaml \\
        --latents latents.npz [--num_steps N] [--resume latest] [--device cpu]

Trains the DiT of the config's ``ar_model`` on ``.npz`` latents
(``latents`` (time, h, w, C), ``timestamps`` (time,) YYYYMMDDHH) on one
device: CUDA unless ``--device cpu`` is given. fp32 master weights with
``--compute_dtype`` compute, AdamW with global-norm clip 1.0 and the
config's LR schedule, EMA, torch checkpoints with rotation under
``<output_dir>/ckpts``, and one JSON line per logged step in
``<output_dir>/metrics.jsonl``.

:func:`main` parses the arguments and reads the YAML; :func:`run` trains
from a config dict, so a caller without PyYAML can pass the dict itself.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ladcast_torch import resolve_device, static_data
from ladcast_torch.config import (
    EDMSchedulerConfig,
    LaDCastDiTConfig,
    NoiseSamplerConfig,
    config_from_dict,
)
from ladcast_torch.data.latent_dataset import (
    ARLatentDataset,
    ARWindowConfig,
    ArrayLatentSource,
    batch_iterator,
)
from ladcast_torch.train import checkpoint as ckpt
from ladcast_torch.train.optim import make_optimizer
from ladcast_torch.train.trainer_ar import ARTrainConfig, make_ar_train_step
from ladcast_torch.utils.logging_utils import MetricLogger
from ladcast_torch.utils.profiling import PhaseTimer


def load_latent_source(path: str) -> ArrayLatentSource:
    """An ``.npz`` of latents; the other layouts are not ported."""
    if not path.endswith(".npz"):
        raise NotImplementedError(
            f"{path}: only .npz latents are ported; shard directories and "
            f"zarr sources wait for ROADMAP.md Queue 1 item M13 (data)")
    d = np.load(path)
    return ArrayLatentSource(d["latents"], d["timestamps"])


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=None, help="YAML config (main only)")
    ap.add_argument("--latents", default=None)
    ap.add_argument("--output_dir", default=None)
    ap.add_argument("--resume", default=None, help="'latest' or a step")
    ap.add_argument("--init_weights", default=None,
                    help="weights-only warm start from a diffusers hub "
                         "directory, a .safetensors file or a checkpoint "
                         "directory of this trainer: parameters and EMA "
                         "loaded, optimizer and step fresh; ignored when "
                         "--resume is given")
    ap.add_argument("--hub_export", action="store_true",
                    help="at each checkpoint, also write the diffusers-layout "
                         "model directories <out>/hub/ar_model{,_ema}")
    ap.add_argument("--num_steps", type=int, default=None)
    ap.add_argument("--num_push_forward_steps", type=int, default=1)
    ap.add_argument("--lat_weighted_loss", action="store_true")
    ap.add_argument("--snr_gamma", type=float, default=None)
    ap.add_argument("--remat", action=argparse.BooleanOptionalAction,
                    default=None, help="per-block gradient checkpointing")
    ap.add_argument("--compute_dtype", default=None,
                    choices=["bfloat16", "float32"],
                    help="activation/matmul dtype (fp32 master weights "
                         "either way); yaml general.compute_dtype")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--log_every", type=int, default=50,
                    help="log every N steps (and the first)")
    # flags of the JAX CLI whose modules are not ported yet
    ap.add_argument("--reader", default="auto", choices=["auto", "native", "mmap"])
    ap.add_argument("--val_latents", default=None)
    ap.add_argument("--val_every", type=int, default=0)
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--zero", action=argparse.BooleanOptionalAction, default=None)
    return ap


_NOT_PORTED = [
    (lambda a: a.reader == "native",
     "--reader native: the C++ shard reader waits for ROADMAP.md Queue 1 "
     "item M13 (data)"),
    (lambda a: a.val_every and a.val_latents,
     "--val_every with --val_latents: train/validation.py waits for "
     "ROADMAP.md Queue 1 item M11 (training, validation)"),
    (lambda a: a.mesh or a.zero,
     "--mesh / --zero: parallelism waits for ROADMAP.md Queue 1 item M12"),
]


def _check_parallel(par_cfg: dict) -> None:
    """The yaml's ``parallel:`` section, read as the JAX CLI reads it
    (``mesh`` as a mapping or an "axis=size,..." string, ``zero``). The
    port trains on one device: a mesh of a ``data`` axis of size 1 (or -1,
    which fills the one device) trains as if there were no section; any
    other axis of a size other than 1, or ``zero: true``, raises, as
    ``--mesh`` and ``--zero`` do."""
    mesh = par_cfg.get("mesh") or {}
    if isinstance(mesh, str):
        pairs = [part.partition("=") for part in mesh.split(",")]
        sizes = {k.strip(): int(v) if v else -1 for k, _, v in pairs}
    else:
        sizes = {str(k): int(v) for k, v in mesh.items()}
    if (par_cfg.get("zero") or sizes.pop("data", 1) not in (-1, 1)
            or any(n != 1 for n in sizes.values())):
        raise NotImplementedError(
            f"parallel: {par_cfg} in the config: tensor parallelism and ZeRO "
            f"wait for ROADMAP.md Queue 1 item M12 (parallelism); the port "
            f"trains on one device, so drop the section to train there")


def export_hub(hub_dir: str, model_cfg, tcfg: ARTrainConfig, state) -> None:
    """The diffusers-layout export of a training state: ``ar_model/`` and,
    with EMA, ``ar_model_ema/`` with the EMA metadata in its config.json,
    as the reference's training hooks write them."""
    from ladcast_torch.models import hub

    hub.save_pretrained(os.path.join(hub_dir, "ar_model"), "dit", model_cfg,
                        state.model.state_dict())
    if state.ema is not None:
        names = [n for n, _ in state.model.named_parameters()]
        hub.save_pretrained(
            os.path.join(hub_dir, "ar_model_ema"), "dit", model_cfg,
            dict(zip(names, state.ema.params)),
            ema_metadata={"decay": tcfg.ema_max_decay, "power": tcfg.ema_power,
                          "inv_gamma": tcfg.ema_inv_gamma,
                          "update_after_step": tcfg.ema_update_after_step,
                          "optimization_step": int(state.step)})


def run(cfg: dict, args: argparse.Namespace) -> dict:
    """Train from the config dict ``cfg`` with the options ``args``
    (:func:`build_parser`). Returns {"state": the final TrainState,
    "history": one record per logged step, "train_step": the step function
    (see ``train.trainer_ar.make_ar_train_step``)}."""
    for unsupported, msg in _NOT_PORTED:
        if unsupported(args):
            raise NotImplementedError(msg)
    _check_parallel(cfg.get("parallel") or {})
    device = resolve_device(args.device)
    model_cfg = config_from_dict(LaDCastDiTConfig, cfg.get("ar_model", {}))
    sched_cfg = config_from_dict(EDMSchedulerConfig,
                                 cfg.get("noise_scheduler", {}).get("params", {}))
    ns_cfg = config_from_dict(NoiseSamplerConfig, cfg.get("noise_sampler", {}))
    dl_cfg = cfg.get("train_dataloader", {})
    opt_cfg = cfg.get("optimizer", {})
    lr_cfg = cfg.get("lr_scheduler", {})
    gen_cfg = cfg.get("general", {})
    ema_cfg = cfg.get("ema", {})

    out_dir = args.output_dir or gen_cfg.get("output_dir", "runs/ar")
    num_steps = (args.num_steps if args.num_steps is not None
                 else gen_cfg.get("num_training_steps") or 100000)

    def _opt(cli_val, key, default):
        return cli_val if cli_val is not None else gen_cfg.get(key, default)

    snr_gamma = _opt(args.snr_gamma, "snr_gamma", None)
    tcfg = ARTrainConfig(
        num_push_forward_steps=args.num_push_forward_steps,
        lat_weighted_loss=args.lat_weighted_loss,
        snr_gamma=None if snr_gamma is None else float(snr_gamma),
        remat=bool(_opt(args.remat, "remat", False)),
        compute_dtype=_opt(args.compute_dtype, "compute_dtype", "bfloat16"),
        use_ema=ema_cfg.get("use_ema", True),
        ema_max_decay=ema_cfg.get("ema_max_decay", 0.9999),
        ema_power=ema_cfg.get("ema_power", 2 / 3),
        ema_inv_gamma=ema_cfg.get("ema_inv_gamma", 1.0),
        ema_update_after_step=ema_cfg.get("ema_update_after_step", 1000),
        input_seq_len=dl_cfg.get("input_seq_len", 1),
    )
    optimizer = make_optimizer(
        lr=float(opt_cfg.get("lr", 1e-4)),
        weight_decay=float(opt_cfg.get("weight_decay", 1e-2)),
        betas=tuple(opt_cfg.get("betas", (0.9, 0.999))),
        eps=float(opt_cfg.get("eps", 1e-8)),
        num_warmup_steps=lr_cfg.get("num_warmup_steps", 1000),
        num_training_steps=num_steps,
        schedule=lr_cfg.get("name", "cosine"),
        min_lr=float(lr_cfg.get("min_lr", 0.0)),
    )
    init_fn, train_step = make_ar_train_step(model_cfg, sched_cfg, ns_cfg,
                                             tcfg, optimizer, device)

    lm, ls = static_data.latent_mean_std()
    source = load_latent_source(args.latents or dl_cfg.get("ds_path"))
    wcfg = ARWindowConfig(
        input_seq_len=dl_cfg.get("input_seq_len", 1),
        return_seq_len=dl_cfg.get("return_seq_len", 4),
        interval_between_pred=dl_cfg.get("interval_between_pred", 6),
        sampling_interval=dl_cfg.get("sampling_interval", 1))
    dataset = ARLatentDataset(source, wcfg, mean=lm, std=ls, target_std=0.5)
    batch_size = dl_cfg.get("batch_size", 4)
    shuffle = dl_cfg.get("shuffle", True)

    def epoch(seed):
        return batch_iterator(dataset, batch_size, shuffle=shuffle, seed=seed,
                              num_push_forward_steps=tcfg.num_push_forward_steps)

    state = init_fn(args.seed)
    mgr = ckpt.make_manager(os.path.join(out_dir, "ckpts"),
                            max_to_keep=gen_cfg.get("checkpoints_total_limit", 3))
    if args.resume:
        ckpt.restore_state(mgr, state,
                           None if args.resume == "latest" else int(args.resume))
    elif args.init_weights:
        from ladcast_torch.cli.pred_rollout import _load_any_params

        raw, _ = _load_any_params(args.init_weights, "dit", model_cfg)
        state.model.load_state_dict(raw, strict=True)
        if state.ema is not None:
            with torch.no_grad():
                torch._foreach_copy_(state.ema.params,
                                     list(state.model.parameters()))
    start_step = state.step
    logger = MetricLogger(out_dir, config=cfg)
    ckpt_every = gen_cfg.get("checkpointing_steps", 50000)
    timer = PhaseTimer()
    history = []
    it = epoch(args.seed)
    t0, last = time.perf_counter(), start_step
    try:
        while state.step < num_steps:
            with timer.phase("data"):
                batch = next(it, None)
                if batch is None:  # a new epoch, in a new order
                    it = epoch(args.seed + state.step)
                    batch = next(it)
                batch = [torch.from_numpy(x).to(device, non_blocking=True)
                         for x in batch]
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
                    if args.hub_export:
                        export_hub(os.path.join(out_dir, "hub"), model_cfg,
                                   tcfg, state)
    finally:
        it.close()
        logger.close()
    return {"state": state, "history": history, "train_step": train_step}


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.config:
        raise SystemExit("--config is required")
    from ladcast_torch.utils.registry import load_yaml

    return run(load_yaml(args.config), args)


if __name__ == "__main__":
    main()
