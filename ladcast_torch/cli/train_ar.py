"""AR diffusion training CLI (the port of ``ladcast_tpu/cli/train_ar.py``).

    python -m ladcast_torch.cli.train_ar --config configs/ladcast_375m.yaml \\
        --latents latents.npz [--num_steps N] [--resume latest] [--device cpu]

Trains the DiT of the config's ``ar_model`` on latents (an ``.npz`` with
``latents`` (time, h, w, C) and ``timestamps`` (time,) YYYYMMDDHH, or a
directory of ``.npy`` shards (time, h, w, C) in name order plus
``timestamps.npy``, read through ``--reader``) on CUDA unless ``--device
cpu`` is given: one device, or one process per card under ``torchrun
--nproc_per_node N`` with ``--mesh`` / ``--zero`` / the yaml's
``parallel:`` section (``parallel.sharding_rules``: DDP, FSDP or HSDP).
fp32 master weights with
``--compute_dtype`` compute, AdamW with global-norm clip 1.0 and the
config's LR schedule, EMA, torch checkpoints with rotation under
``<output_dir>/ckpts`` (none with ``--skip_state_ckpt``; ``--hub_export``
writes the diffusers directories first), and one JSON line per logged step
in ``<output_dir>/metrics.jsonl`` (and the yaml's ``accelerator.log_with``
back end: tensorboard or wandb); with ``--val_every N --val_latents
val.npz``, an ensemble validation every N steps (``train.validation``).

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
    ShardedLatentSource,
    batch_iterator,
)
from ladcast_torch.parallel import dist
from ladcast_torch.parallel.mesh import make_mesh_from_spec, mesh_sizes
from ladcast_torch.train import checkpoint as ckpt
from ladcast_torch.train.optim import make_optimizer
from ladcast_torch.train.trainer_ar import ARTrainConfig, make_ar_train_step
from ladcast_torch.utils.logging_utils import MetricLogger
from ladcast_torch.utils.profiling import PhaseTimer


def load_latent_source(path: str, reader: str = "auto"):
    """A latent source: an ``.npz`` in memory, or a directory of ``.npy``
    shards with ``timestamps.npy``, read by the C++ pread pool
    (``reader="native"``, which raises where the library cannot be built),
    by numpy mmap (``"mmap"``), or by the former where it builds and else,
    with one printed line, the latter (``"auto"``)."""
    if reader not in ("auto", "native", "mmap"):
        raise ValueError(f"reader {reader!r}: expected auto, native or mmap")
    if path.endswith(".npz"):
        d = np.load(path)
        return ArrayLatentSource(d["latents"], d["timestamps"])
    if os.path.isdir(path) and os.path.exists(os.path.join(path, "timestamps.npy")):
        ts = np.load(os.path.join(path, "timestamps.npy"))
        shards = sorted(os.path.join(path, f) for f in os.listdir(path)
                        if f.endswith(".npy") and f != "timestamps.npy")
        if reader != "mmap":
            from ladcast_torch.data.native_reader import NpyShardSource

            try:
                return NpyShardSource(shards, ts)
            except (OSError, RuntimeError) as e:
                if reader == "native":
                    raise
                print(f"native reader unavailable ({e}); falling back to "
                      f"numpy mmap", flush=True)
        return ShardedLatentSource(shards, ts)
    raise NotImplementedError(
        f"{path}: .npz latents and shard directories (*.npy + timestamps.npy) "
        f"are ported; zarr sources wait for ROADMAP.md Queue 1 item M13 "
        f"(part c, xarray)")


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
    ap.add_argument("--skip_state_ckpt", action="store_true",
                    help="skip the full-state checkpoints (parameters, "
                         "optimizer moments, EMA) and write only the "
                         "--hub_export directories: for runs whose only "
                         "artifact is the final weights (under FSDP this "
                         "also saves gathering the whole state to rank 0)")
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
    ap.add_argument("--val_latents", default=None,
                    help="held-out .npz latents for ensemble validation")
    ap.add_argument("--val_every", type=int, default=0,
                    help="run ensemble validation every N steps (0 = off)")
    ap.add_argument("--val_ensemble_size", type=int, default=10)
    ap.add_argument("--val_num_init_times", type=int, default=4)
    ap.add_argument("--val_total_lead_time_hour", type=int, default=240)
    ap.add_argument("--val_num_inference_steps", type=int, default=20)
    ap.add_argument("--val_dcae_params", default=None,
                    help="a DCAE (diffusers directory, .safetensors or "
                         "checkpoint directory): decode the validation "
                         "ensemble and log per-variable physical RMSE and "
                         "CRPS tables by lead time; omit for latent-only")
    ap.add_argument("--reader", default="auto", choices=["auto", "native", "mmap"],
                    help="the reader of a shard directory: native (the C++ "
                         "pread pool), mmap (numpy), auto (native, else mmap)")
    ap.add_argument("--mesh", default=None,
                    help="mesh over the ranks, e.g. data=-1 or data=-1,model=8 "
                         "(default: the yaml's parallel.mesh, else data=-1)")
    ap.add_argument("--zero", action=argparse.BooleanOptionalAction, default=None,
                    help="shard parameters, gradients, moments and EMA over "
                         "the data axis (FSDP); default: the yaml's "
                         "parallel.zero, else on when the model axis > 1")
    return ap


def parallel_setup(cfg: dict, args: argparse.Namespace, device: torch.device):
    """(mesh, zero, data size) from ``--mesh`` / ``--zero``, else the yaml's
    ``parallel:`` section, read as the JAX CLI reads it: the mesh must have
    a ``data`` axis, and ``zero`` defaults to on when ``model`` > 1. The
    sizes must multiply to the world size (one process without a process
    group: 1, and no mesh)."""
    par_cfg = cfg.get("parallel") or {}
    spec = args.mesh or par_cfg.get("mesh") or {"data": -1}
    sizes = dict(mesh_sizes(spec, dist.process_count()))
    if "data" not in sizes:
        raise SystemExit(f"mesh {spec!r} must include a 'data' axis")
    zero = args.zero if args.zero is not None else bool(
        par_cfg.get("zero", sizes.get("model", 1) > 1))
    return make_mesh_from_spec(spec, device.type), zero, sizes["data"]


def export_hub(hub_dir: str, model_cfg, tcfg: ARTrainConfig, state) -> None:
    """The diffusers-layout export of a training state: ``ar_model/`` and,
    with EMA, ``ar_model_ema/`` with the EMA metadata in its config.json,
    as the reference's training hooks write them. The weights are gathered
    whole (a collective under a process group, so every rank calls this)
    and rank 0 writes them."""
    from ladcast_torch.models import hub
    from ladcast_torch.parallel.sharding_rules import full_tensors

    params = dist.full_state_dict(state.model)
    ema = None
    if state.ema is not None:
        names = [n for n, _ in state.model.named_parameters()]
        ema = dict(zip(names, full_tensors(state.ema.params,
                                           list(state.model.parameters()))))
    if dist.process_index() != 0:
        return
    hub.save_pretrained(os.path.join(hub_dir, "ar_model"), "dit", model_cfg, params)
    if ema is not None:
        hub.save_pretrained(
            os.path.join(hub_dir, "ar_model_ema"), "dit", model_cfg, ema,
            ema_metadata={"decay": tcfg.ema_max_decay, "power": tcfg.ema_power,
                          "inv_gamma": tcfg.ema_inv_gamma,
                          "update_after_step": tcfg.ema_update_after_step,
                          "optimization_step": int(state.step)})


def make_validation(args, sched_cfg, wcfg, tcfg, cfg, device):
    """``run_validation(state, step) -> record``: the EMA weights (else the
    model's) in the trainer's compute dtype drive ``train.validation``'s
    ensemble rollouts from ``--val_num_init_times`` init times of
    ``--val_latents``, spread evenly; with ``--val_dcae_params`` the
    decoded tables as well."""
    from ladcast_torch import channels as ch
    from ladcast_torch.config import DCAEConfig, RolloutConfig
    from ladcast_torch.data import time_utils
    from ladcast_torch.metrics.weights import cos_lat_weights
    from ladcast_torch.train.validation import validate_ar_model

    lm, ls = static_data.latent_mean_std()
    rcfg = RolloutConfig(
        ensemble_size=args.val_ensemble_size,
        return_seq_len=wcfg.return_seq_len, input_seq_len=wcfg.input_seq_len,
        num_inference_steps=args.val_num_inference_steps,
        total_lead_time_hour=args.val_total_lead_time_hour, step_size_hour=6)
    val_ds = ARLatentDataset(
        load_latent_source(args.val_latents, args.reader),
        ARWindowConfig(wcfg.input_seq_len, rcfg.total_num_steps,
                       wcfg.interval_between_pred, 1),
        mean=lm, std=ls, target_std=0.5)
    vin, vtg, vyp = [], [], []
    for i in np.linspace(0, len(val_ds) - 1, args.val_num_init_times).astype(int):
        inp, tgt, ts = val_ds[int(i)]
        vin.append(inp)
        vtg.append(tgt)
        vyp.append(time_utils.rollout_year_progress(
            ts, rcfg.num_repetitions, rcfg.step_size_hour * rcfg.return_seq_len))
    vin = torch.from_numpy(np.stack(vin)).to(device)
    vtg = torch.from_numpy(np.stack(vtg)).to(device)
    vyp = np.stack(vyp)
    c_dtype = getattr(torch, tcfg.compute_dtype)

    decode = {}
    if args.val_dcae_params:
        from ladcast_torch.cli.pred_rollout import _load_any_params
        from ladcast_torch.models import hub

        params, dcae_cfg = _load_any_params(
            args.val_dcae_params, "dcae",
            config_from_dict(DCAEConfig, cfg.get("encdec", {})))
        dcae = hub.build_model("dcae", dcae_cfg, params, device, c_dtype)
        n_field = dcae_cfg.out_channels - dcae_cfg.static_channels
        if n_field == ch.NUM_DYNAMIC_CHANNELS:
            field_stats = static_data.era5_mean_std()
            channel_names = ch.channel_names()
        else:  # small configs: identity statistics, generic names
            field_stats = (np.zeros(n_field, np.float32), np.ones(n_field, np.float32))
            channel_names = [f"ch{i}" for i in range(n_field)]
        h_dec = vin.shape[-3] * 2 ** (len(dcae_cfg.decoder_block_out_channels) - 1)
        decode = dict(
            decode_fn=lambda z: dcae.decode(z.to(c_dtype)),
            latent_stats=(lm, ls), field_stats=field_stats,
            grid_lat_weight=cos_lat_weights(np.linspace(-88.5, 90.0, h_dec)))
        lead_hours = [rcfg.step_size_hour * (i + 1)
                      for i in range(rcfg.total_num_steps)]

    def run_validation(state, step) -> dict:
        model = state.model
        names = [n for n, _ in model.named_parameters()]
        weights = (state.ema.params if state.ema is not None
                   else state.optimizer.params)
        if state.regime in ("fsdp", "hsdp"):
            # sharded weights: gathered whole (every rank), validated by an
            # unsharded copy on rank 0, the record sent to every rank
            import torch.distributed as tdist
            from ladcast_torch.models import hub
            from ladcast_torch.parallel.sharding_rules import full_tensors

            full = full_tensors(weights, list(model.parameters()))
            rec = [None]
            if dist.process_index() == 0:
                plain = hub.build_model("dit", model.cfg, dict(zip(names, full)),
                                        device, c_dtype)
                rec = [summarize(validate_ar_model(
                    lambda x, c, k, y: plain(x.to(c_dtype), c, k.to(c_dtype), y).float(),
                    vin, vtg, vyp, 1234, sched_cfg, rcfg, **decode))]
                del plain
            tdist.broadcast_object_list(rec, src=0)
            return rec[0]
        cast = {n: p.to(c_dtype) for n, p in zip(names, weights)}

        def net_fn(latents, c_noise, cond, yp):
            return torch.func.functional_call(
                model, cast, (latents.to(c_dtype), c_noise, cond.to(c_dtype),
                              yp)).float()

        return summarize(validate_ar_model(net_fn, vin, vtg, vyp, 1234, sched_cfg,
                                           rcfg, **decode))

    def summarize(m) -> dict:
        rec = {"val_latent_rmse": float(m["latent_rmse"].mean()),
               "val_latent_crps": float(m["latent_crps"].mean())}
        if decode:
            # per-variable tables by lead time, averaged over init times
            for name, key in (("val_rmse_ens", "rmse_ens"),
                              ("val_rmse_single", "rmse_single"),
                              ("val_crps", "crps")):
                rec[name] = {"lead_hours": lead_hours,
                             **{cn: [round(float(x), 6) for x in row]
                                for cn, row in zip(channel_names,
                                                   m[key].mean(axis=0))}}
        return rec

    return run_validation


def run(cfg: dict, args: argparse.Namespace) -> dict:
    """Train from the config dict ``cfg`` with the options ``args``
    (:func:`build_parser`). Returns {"state": the final TrainState,
    "history": one record per logged step, "train_step": the step function
    (see ``train.trainer_ar.make_ar_train_step``), "validations": one
    record per validation (``--val_every`` with ``--val_latents``), "rows":
    the slice of each global batch that this rank fed}."""
    model_cfg = config_from_dict(LaDCastDiTConfig, cfg.get("ar_model", {}))
    if model_cfg.int8_matmuls:
        raise SystemExit("int8_matmuls is an inference-only path (the int8 "
                         "round and cast are not differentiable); remove it "
                         "from the ar_model training config")
    dist.initialize(device=args.device)
    device = dist.local_device(resolve_device(args.device))
    mesh, zero, n_data = parallel_setup(cfg, args, device)
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
    init_fn, train_step = make_ar_train_step(
        model_cfg, sched_cfg, ns_cfg, tcfg, optimizer, device, mesh, zero,
        batch_size=dl_cfg.get("batch_size", 4))

    lm, ls = static_data.latent_mean_std()
    source = load_latent_source(args.latents or dl_cfg.get("ds_path"), args.reader)
    wcfg = ARWindowConfig(
        input_seq_len=dl_cfg.get("input_seq_len", 1),
        return_seq_len=dl_cfg.get("return_seq_len", 4),
        interval_between_pred=dl_cfg.get("interval_between_pred", 6),
        sampling_interval=dl_cfg.get("sampling_interval", 1))
    dataset = ARLatentDataset(source, wcfg, mean=lm, std=ls, target_std=0.5)
    # the global batch is batch_size per data replica; every rank computes
    # the same seeded order and reads its rows: a replica's split over its
    # model group where they divide, else the replica's rows on every rank
    # of the group, which then repeats the compute
    global_bs = dl_cfg.get("batch_size", 4) * n_data
    rows = dist.batch_feed_slice(mesh, global_bs, announce=True)
    shuffle = dl_cfg.get("shuffle", True)

    def epoch(seed):
        return batch_iterator(dataset, global_bs, shuffle=shuffle, seed=seed,
                              num_push_forward_steps=tcfg.num_push_forward_steps,
                              batch_slice=rows)

    state = init_fn(args.seed)
    mgr = ckpt.make_manager(os.path.join(out_dir, "ckpts"),
                            max_to_keep=gen_cfg.get("checkpoints_total_limit", 3))
    if args.resume:
        ckpt.restore_state(mgr, state,
                           None if args.resume == "latest" else int(args.resume))
    elif args.init_weights:
        from ladcast_torch.cli.pred_rollout import _load_any_params

        raw = None
        if dist.process_index() == 0:
            raw, _ = _load_any_params(args.init_weights, "dit", model_cfg)
        state.load_full_params(raw)
        if state.ema is not None:
            with torch.no_grad():
                torch._foreach_copy_(state.ema.params, state.optimizer.params)
    start_step = state.step
    run_validation = None
    if args.val_every and args.val_latents:
        run_validation = make_validation(args, sched_cfg, wcfg, tcfg, cfg, device)
    validations = []
    # rank 0 writes the metrics
    logger = MetricLogger(out_dir if dist.process_index() == 0 else None, config=cfg,
                          log_with=cfg.get("accelerator", {}).get("log_with", "jsonl"))
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
            if run_validation is not None and step % args.val_every == 0:
                with timer.phase("validation"):
                    validations.append({"step": step,
                                        **run_validation(state, step)})
                logger.log(validations[-1], step)
                t0 = time.perf_counter()  # the step time leaves validation out
            if step % ckpt_every == 0 or step == num_steps:
                with timer.phase("checkpoint"):
                    # the inference weights first, then the whole state
                    if args.hub_export:
                        export_hub(os.path.join(out_dir, "hub"), model_cfg,
                                   tcfg, state)
                    if not args.skip_state_ckpt:
                        ckpt.save_state(mgr, step, state)
    finally:
        it.close()
        logger.close()
    return {"state": state, "history": history, "validations": validations,
            "train_step": train_step, "rows": rows}


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.config:
        raise SystemExit("--config is required")
    from ladcast_torch.utils.registry import load_yaml

    return run(load_yaml(args.config), args)


if __name__ == "__main__":
    main()
