"""The bench of the PyTorch port (the port of the root ``bench.py``): the
north-star workload on the card, timed, with one JSON line.

    python3 -m ladcast_torch.bench [--sampler edm|dpm] [--nfe N]
                                   [--profile DIR] [--dispatch-stats]
    torchrun --nproc_per_node N -m ladcast_torch.bench [the same flags]

The workload: the 375M DiT (``ladcast_375m_config``) and the shipped DCAE on
seeded random weights; one DCAE encode of the initial state (with its
static channels), the ensemble broadcast, then 10 host-stepped repetitions
(240 h), each a Heun-20 sampler (``2N-1`` = 39 DiT calls; DPM-Solver++(2M)
makes N) at the ensemble's batch followed by the decode of its
``return_seq_len`` x E frames. Network in bf16, trajectory in fp32. 20
members, padded to a multiple of the ranks.

Ranks: one process per card (``torchrun``; ``parallel.dist.initialize``
forms the group from its environment). Every rank builds the same seeded
weights and inputs, and rank r rolls out and decodes the members from
r x (E / ranks) on; member i draws its noise from its global index
(``rollout.engine.member_noise``), so the sharded ensemble is the
unsharded one, member for member. The mean of the decoded frames and the
trajectory's mean are averaged over the ranks, so every rank returns the
scalars of the whole forecast.

Prints ONE JSON line (rank 0):
  {"metric": ..., "value": s, "unit": "s", "member_denoise_steps_per_s": ...,
   "denoiser_mfu": ..., "forecast_tflops": ...}

``value`` is the best of two timed forecasts, after one warm-up forecast
(kernel builds, cuBLAS handles, first calls); with N ranks a barrier
brackets each timed forecast, so the time is the slowest rank's.
``denoiser_mfu`` is ``flops_per_forecast / (value x peak x cards)``: the
FLOPs that ``utils.profiling.FlopCount`` counts over one DiT call, one
repetition's decode and one encode (the aten ops and the hand-written
kernels, each kernel as its plain version counts), times their calls per
forecast, against the card's dense bf16 peak (``utils.profiling.
card_peaks``; the int8 peak under ``LADCAST_INT8=1``). The time includes the
host's gaps, so this is an end-to-end MFU, not a kernel window's. There is
no ``vs_baseline``: the JAX bench divides its TPU target (60 s on a v5e-8,
scaled by chip count) by its time, and no target carries over to the card.

Flags:
  --sampler edm|dpm   the denoiser's sampler (default edm: Heun, 2N-1 DiT
                      calls per repetition; dpm: DPM-Solver++(2M), N)
  --nfe N             num_inference_steps per repetition (default 20)
  --profile DIR       ``utils.profiling.device_trace`` of one more forecast,
                      written to DIR/trace.json (DIR/rank<r>/ with N ranks)
  --dispatch-stats    print the host's issue time against its wait for the
                      device for each timed forecast, on a line of its own
LADCAST_INT8=1 runs the DiT's projections as w8a8 int8 products
(``ops.quant``) and scores the MFU against the int8 peak.
LADCAST_BENCH_NO_WAIT=1 skips :func:`wait_for_backend`.

A forecast that yields non-finite values fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ladcast_torch import resolve_device
from ladcast_torch.config import (
    DCAEConfig,
    EDMSchedulerConfig,
    LaDCastDiTConfig,
    RolloutConfig,
    ladcast_375m_config,
)
from ladcast_torch.models.dcae import build_dcae
from ladcast_torch.models.ladcast_dit import build_dit
from ladcast_torch.parallel import dist
from ladcast_torch.rollout.engine import make_repetition_fn, stream_seed
from ladcast_torch.utils.profiling import FlopCount, card_peaks, device_trace, kernel_entries


def wait_for_backend(budget_s: float = 2700.0, probe_timeout_s: float = 180.0,
                     sleep_s: float = 120.0) -> None:
    """Block until the card answers a trivial computation: one CUDA
    reduction in a killable subprocess, retried every ``sleep_s`` seconds
    for up to ``budget_s`` (a card that hangs at its first computation
    would otherwise hang the bench). On a healthy card the first probe
    returns in seconds. Disable with LADCAST_BENCH_NO_WAIT=1."""
    if os.environ.get("LADCAST_BENCH_NO_WAIT"):
        return
    probe = ("import torch; "
             "print(float(torch.zeros(4, device='cuda').sum()))")
    deadline = time.monotonic() + budget_s
    attempt = 0
    while True:
        attempt += 1
        try:
            r = subprocess.run([sys.executable, "-c", probe],
                               timeout=probe_timeout_s,
                               capture_output=True, text=True)
            if r.returncode == 0:
                if attempt > 1:
                    print(f"# backend answered on probe {attempt}", flush=True)
                return
            err = (r.stderr or "").strip().splitlines()
            err = err[-1] if err else "nonzero exit"
        except subprocess.TimeoutExpired:
            err = f"probe hung >{probe_timeout_s:.0f}s"
        if time.monotonic() >= deadline:
            print(f"# backend still unavailable after {budget_s:.0f}s "
                  f"({attempt} probes; last: {err}) — proceeding anyway",
                  flush=True)
            return
        print(f"# backend probe {attempt} failed ({err}); retrying in "
              f"{sleep_s:.0f}s", flush=True)
        time.sleep(sleep_s)


def forecast_flops(rcfg: RolloutConfig, f_net: float, f_dec: float,
                   f_enc: float) -> float:
    """FLOPs of one forecast from its components: ``reps x (calls x f_net +
    f_dec) + f_enc``, with 2N-1 DiT calls a repetition for Heun and N for
    DPM-Solver++(2M). Exact sampling only: a Heun with skipped corrections
    makes fewer calls, and the bench refuses it."""
    if rcfg.correction_skip_period:
        raise ValueError("the bench counts exact Heun only "
                         f"(correction_skip_period={rcfg.correction_skip_period})")
    n = rcfg.num_inference_steps
    ncalls = 2 * n - 1 if rcfg.sampler_type == "edm" else n
    return rcfg.num_repetitions * (ncalls * f_net + f_dec) + f_enc


def make_bench(dit_cfg: LaDCastDiTConfig, dcae_cfg: DCAEConfig,
               sched_cfg: EDMSchedulerConfig, rcfg: RolloutConfig, *,
               device="cuda", compute_dtype: torch.dtype = torch.bfloat16,
               latent_hw=(15, 30), grid_hw=(120, 240), seed: int = 0):
    """Build the forecast closure over the ranks of the process group (one
    process without one). The ensemble must divide over the ranks. Returns
    a dict with

      full_forecast(seed, stats=None, dispatch_stats=None) -> (acc, mean):
        acc sums the mean of every repetition's decoded frames, mean is the
        latent trajectory's mean, both of the whole ensemble. With a
        ``stats`` dict, the device is synchronised around each phase; the
        wall seconds of the encode and of every repetition's sampling and
        decode, and this rank's shapes of the trajectory and of the last
        decode, are recorded in it. With a ``dispatch_stats`` list, one
        entry is appended: ``issue_s``, the host's time to enqueue the
        repetitions, ``sync_s``, its wait for the device after that (the
        ranks' means included), and ``launches``, each kernel entry's
        launches in the forecast. Kernels launch asynchronously, so the
        device runs behind the host; a host sync inside the loop (a value
        read back) makes the host wait there and shows up in ``issue_s``,
        which is the point of the figure: where ``issue_s`` is most of the
        time, the host gates the device.
      full_forecast_traj(seed) -> (E, steps, H, W, C) numpy: the test hook,
        the whole ensemble's trajectory from the same dispatch loop,
        gathered to every rank.
      flops_components() -> (f_net, f_dec, f_enc): the FLOPs that
        ``utils.profiling.FlopCount`` counts of one DiT call at the whole
        ensemble's batch, one repetition's decode of its E x return_seq_len
        frames and one encode, on this rank's device: the whole forecast's
        over all ranks, so an MFU divides by the cards.
      flops_per_forecast() -> float: :func:`forecast_flops` of those.
      dit, dcae: the seeded models; members, member_offset: this rank's
        share of the ensemble.
    """
    device = dist.local_device(resolve_device(device))
    cdt = compute_dtype
    ens, T_in, T_out = rcfg.ensemble_size, rcfg.input_seq_len, rcfg.return_seq_len
    ranks = dist.process_count()
    if ens % ranks:
        raise ValueError(f"{ens} members do not divide over {ranks} ranks")
    per = ens // ranks
    offset = dist.process_index() * per
    (H, W), C = latent_hw, dit_cfg.in_channels
    GH, GW = grid_hw
    g = torch.Generator(device=device).manual_seed(seed)
    fields = torch.randn((T_in, GH, GW, C), generator=g, device=device)
    static = torch.randn((GH, GW, dcae_cfg.static_channels), generator=g,
                         device=device)
    dcae = build_dcae(dcae_cfg, device, cdt, seed=seed + 2)
    dit = build_dit(dit_cfg, device, cdt, seed=seed + 3)
    rep_fn = make_repetition_fn(sched_cfg, rcfg)
    year_progress = np.linspace(0.4, 0.45, rcfg.num_repetitions)

    def net_fn(lat, cn, cond, yp):
        return dit(lat.to(cdt), cn, cond.to(cdt), yp).float()

    def encode():
        return dcae.encode(fields.to(cdt), static.to(cdt)).float()

    def decode(frames):
        return dcae.decode(frames.to(cdt))

    def sync_time(stats, name, t0):
        if stats is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            stats.setdefault(name, []).append(time.perf_counter() - t0)
        return time.perf_counter()

    @torch.inference_mode()
    def _run_forecast(forecast_seed: int, stats: Optional[Dict] = None,
                      dispatch_stats: Optional[List] = None,
                      collect_traj: bool = False):
        """The one dispatch loop that the timed path and the test hook
        share, so the tests hold what ``main`` times."""
        if dispatch_stats is not None:
            launched = {k: -f.launches for k, f in kernel_entries().items()}
        t = time.perf_counter()
        known = encode()[None].expand(per, T_in, H, W, C)
        t = sync_time(stats, "encode_s", t)
        acc = torch.zeros((), device=device)
        outs = []
        t_loop0 = time.perf_counter()
        for r in range(rcfg.num_repetitions):
            known, samples = rep_fn(net_fn, known, year_progress[r],
                                    stream_seed(forecast_seed, r + 1),
                                    member_offset=offset)
            t = sync_time(stats, "repetition_s", t)
            frames = samples.reshape(per * T_out, H, W, C)
            decoded = decode(frames)
            acc = acc + decoded.float().mean()
            t = sync_time(stats, "decode_s", t)
            outs.append(samples)
        t_issued = time.perf_counter()
        traj = torch.cat(outs, dim=1)[:, : rcfg.total_num_steps]
        scalars = torch.stack([acc, traj.mean()])
        dist.all_reduce_mean_([scalars])
        acc_f, mean_f = scalars.tolist()  # the host waits for the device here
        if dispatch_stats is not None:
            for k, f in kernel_entries().items():
                launched[k] += f.launches
            dispatch_stats.append({
                "issue_s": round(t_issued - t_loop0, 3),
                "sync_s": round(time.perf_counter() - t_issued, 3),
                "launches": {k: n for k, n in launched.items() if n}})
        if stats is not None:
            stats["traj_shape"] = tuple(traj.shape)
            stats["decode_shape"] = tuple(decoded.shape)
        # a bench that silently times NaN outputs is worse than a crash
        if not (np.isfinite(acc_f) and np.isfinite(mean_f)):
            raise FloatingPointError(f"non-finite forecast: {acc_f}, {mean_f}")
        if collect_traj:
            return dist.all_gather_arrays(traj.cpu().numpy())
        return acc_f, mean_f

    def full_forecast(forecast_seed: int, stats: Optional[Dict] = None,
                      dispatch_stats: Optional[List] = None):
        return _run_forecast(forecast_seed, stats, dispatch_stats)

    def full_forecast_traj(forecast_seed: int) -> np.ndarray:
        return _run_forecast(forecast_seed, collect_traj=True)

    @torch.inference_mode()
    def flops_components():
        x0 = torch.zeros((ens, T_out, H, W, C), device=device)
        kn0 = torch.zeros((ens, T_in, H, W, C), device=device)
        fr0 = torch.zeros((ens * T_out, H, W, C), device=device)
        ee = torch.zeros((ens,), device=device)
        counts = []
        for fn, args in ((net_fn, (x0, ee, kn0, ee)),
                         (lambda f: decode(f).float().mean(), (fr0,)), (encode, ())):
            with FlopCount() as c:
                fn(*args)
            if c.uncounted:
                raise RuntimeError(f"kernels launched without a FLOP count: "
                                   f"{c.uncounted}")
            counts.append(c.total)
        return tuple(counts)

    def flops_per_forecast():
        return forecast_flops(rcfg, *flops_components())

    return {"full_forecast": full_forecast,
            "full_forecast_traj": full_forecast_traj,
            "flops_components": flops_components,
            "flops_per_forecast": flops_per_forecast,
            "dit": dit, "dcae": dcae, "members": per, "member_offset": offset}


def run(dit_cfg: LaDCastDiTConfig, dcae_cfg: DCAEConfig, rcfg: RolloutConfig, *,
        device="cuda", peak: float, compute_dtype: torch.dtype = torch.bfloat16,
        latent_hw=(15, 30), grid_hw=(120, 240), profile_dir: Optional[str] = None,
        dispatch_stats: Optional[List] = None) -> Dict:
    """The bench on the ranks of the process group: build, one warm-up
    forecast, with ``profile_dir`` one traced forecast, then the best of
    two timed forecasts and the FLOP count. Returns the JSON line's dict on
    every rank; ``dispatch_stats`` gets the timed forecasts' entries
    (:func:`make_bench`). ``peak`` is one card's FLOP/s."""
    n_cards = dist.process_count()
    b = make_bench(dit_cfg, dcae_cfg, EDMSchedulerConfig(), rcfg, device=device,
                   compute_dtype=compute_dtype, latent_hw=latent_hw, grid_hw=grid_hw)
    full_forecast = b["full_forecast"]
    full_forecast(4)  # kernel builds, library handles, first calls (excluded)
    if profile_dir:
        pdir = (profile_dir if n_cards == 1
                else os.path.join(profile_dir, f"rank{dist.process_index()}"))
        with device_trace(pdir):
            full_forecast(99)
        if dist.process_index() == 0:
            print(f"# profiler trace written to {profile_dir}", flush=True)
    times = []
    for i in range(2):
        dist.barrier()
        t0 = time.perf_counter()
        full_forecast(5 + i, dispatch_stats=dispatch_stats)
        dist.barrier()
        times.append(time.perf_counter() - t0)
    measured = min(times)
    flops = b["flops_per_forecast"]()
    ens, nfe = rcfg.ensemble_size, rcfg.num_inference_steps
    member_steps = rcfg.num_repetitions * nfe * ens
    out = {
        "metric": f"375M 20-member 240h ensemble rollout wall-clock "
                  f"({n_cards} card{'s' if n_cards > 1 else ''}, "
                  f"{ens} members incl. encode+decode)",
        "value": round(measured, 3),
        "unit": "s",
        "member_denoise_steps_per_s": round(member_steps / measured, 1),
        "denoiser_mfu": round(flops / (measured * peak * n_cards), 4),
        "forecast_tflops": round(flops / 1e12, 1),
    }
    if rcfg.sampler_type != "edm" or nfe != 20:
        out["metric"] += f" [sampler={rcfg.sampler_type} nfe={nfe}]"
    return out


def main(argv: Optional[List[str]] = None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)

    def flag_val(name, default):
        if name not in argv:
            return default
        i = argv.index(name)
        if i + 1 >= len(argv):
            raise SystemExit(f"{name} requires a value")
        return argv[i + 1]

    sampler = flag_val("--sampler", "edm")
    if sampler not in ("edm", "dpm"):
        raise SystemExit(f"--sampler must be edm or dpm, got {sampler!r}")
    try:
        nfe = int(flag_val("--nfe", "20"))
    except ValueError:
        raise SystemExit("--nfe must be an integer")
    if nfe < 1:
        raise SystemExit("--nfe must be >= 1")
    profile_dir = flag_val("--profile", None)

    resolve_device("cuda")  # no CPU fallback: raises without CUDA
    wait_for_backend()
    dist.initialize()  # torchrun's environment; a no-op in one process
    try:
        n_cards = dist.process_count()
        # LADCAST_INT8=1: the opt-in w8a8 DiT projections (ops/quant.py),
        # approximate, scored against the int8 peak
        int8 = bool(os.environ.get("LADCAST_INT8"))
        ens = -(-20 // n_cards) * n_cards  # pad to a multiple of the cards
        rcfg = RolloutConfig(ensemble_size=ens, sampler_type=sampler,
                             num_inference_steps=nfe)
        peaks = card_peaks(torch.cuda.get_device_name(dist.local_device("cuda")))
        dstats = [] if "--dispatch-stats" in argv else None
        out = run(ladcast_375m_config(int8_matmuls=int8), DCAEConfig(), rcfg,
                  peak=peaks["int8"] if int8 else peaks["bf16"],
                  profile_dir=profile_dir, dispatch_stats=dstats)
        if dist.process_index() == 0:
            if dstats is not None:
                print(f"# dispatch stats (issue vs device-sync per forecast): "
                      f"{json.dumps(dstats)}", flush=True)
            print(json.dumps(out), flush=True)
    finally:
        if dist.is_initialized():
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
