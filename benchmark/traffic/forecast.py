"""Forecast traffic: a closed loop of ensemble forecasts, back to back,
through the program's public ``ForecastPipeline``, as ``cli.pred_rollout``
drives it.

Parameters (the workload's ``traffic``): ``members``, ``steps`` (Heun
steps: 2 steps - 1 DiT calls a repetition), ``input_seq_len``,
``return_seq_len`` (6 h frames a repetition), ``repetitions`` a forecast,
``decode_chunk`` (frames the decoder takes at a time), ``check_members``
(members the reference follows).

Each forecast encodes a new seeded initial state (``encode_fields``), then
runs its repetitions one at a time (``forecast_latents`` with the noise
made here from the seed, chaining the known latents) and decodes each
repetition's frames (``decode_latents``). The window starts at the first
forecast and ends at the first repetition boundary after ``--seconds``;
its time runs to that boundary's last kernel.

Correctness, once the window has closed and the program is freed: one
repetition drawn from the seed among those every window completes, and
``check_members`` members drawn from the seed. The reference encodes that
repetition's forecast's fields, runs the Heun sampler from the program's
known latents with the same noise, and decodes the program's sampled
frames; each is compared with what the program produced (relative L2 and
the widest gap of one element, on the reference's scale)."""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import harness, weights
from benchmark.reference import dcae as ref_dcae
from benchmark.reference import dit as ref_dit
from benchmark.reference import sampler as ref_sampler
from benchmark.weights import stream_seed
from benchmark.work import count_flops, meta_params

HOURS_PER_FRAME = 6
GRID = (120, 240)
LATENT = (15, 30)
DIT_TAG, DCAE_TAG, FIELDS_TAG, NOISE_TAG, YEAR_TAG, CHECK_TAG = 1, 2, 10, 11, 12, 13
WARM_UP = 1 << 30  # the forecast index of the warm-up's inputs


def fields_of(seed, f, t_in, device):
    """Forecast f's normalized initial fields, (t_in, 120, 240, 84)."""
    return torch.randn((t_in, *GRID, 84), device=device,
                       generator=weights.generator(device, seed, FIELDS_TAG, f))


def noise_of(seed, f, r, shape, device):
    return torch.randn(shape, device=device,
                       generator=weights.generator(device, seed, NOISE_TAG, f, r))


def year_of(seed, f, r, t_out):
    """Year progress of forecast f's repetition r: a seeded start in the
    year, 6 h a frame on."""
    y0 = np.random.RandomState(stream_seed(seed, YEAR_TAG, f) % 2**32).uniform()
    return float((y0 + r * t_out * HOURS_PER_FRAME / 8760.0) % 1.0)


def run(run: harness.Run) -> dict:
    from ladcast_torch.config import DCAEConfig, EDMSchedulerConfig, LaDCastDiTConfig, RolloutConfig
    from ladcast_torch.rollout.pipeline import ForecastPipeline

    p, cfg, dev, seed = run.traffic, run.config, run.device, run.seed
    E, steps, t_in, t_out = p["members"], p["steps"], p["input_seq_len"], p["return_seq_len"]
    reps_per_forecast, chunk = p["repetitions"], p["decode_chunk"]
    rcfg = RolloutConfig(ensemble_size=E, num_inference_steps=steps, return_seq_len=t_out,
                         input_seq_len=t_in, total_lead_time_hour=HOURS_PER_FRAME * t_out,
                         step_size_hour=HOURS_PER_FRAME, sampler_type="edm")
    with torch.no_grad():
        pipe = ForecastPipeline(
            LaDCastDiTConfig(**cfg["dit"]), DCAEConfig(**cfg["dcae"]), EDMSchedulerConfig(),
            rcfg, weights.make(ref_dit.param_spec(cfg["dit"]), seed, DIT_TAG, dev),
            weights.make(ref_dcae.param_spec(cfg["dcae"]), seed, DCAE_TAG, dev),
            compute_dtype="bfloat16", device=dev)
    if dev.startswith("cuda"):
        torch.cuda.empty_cache()
    noise_shape = (1, E, t_out, *LATENT, cfg["dit"]["in_channels"])
    check = np.random.RandomState(stream_seed(seed, CHECK_TAG) % 2**32)
    members = np.sort(check.choice(E, p["check_members"], replace=False))
    kept = {}

    def encode(f):
        with run.span("encode"):
            z = pipe.encode_fields(fields_of(seed, f, t_in, dev))
            return z, pipe.normalize_latent(z)[None].expand(E, *z.shape)

    def repetition(f, r, known):
        with run.span("rollout"):
            traj = pipe.forecast_latents(known, [year_of(seed, f, r, t_out)],
                                         stream_seed(seed, f, r),
                                         rep_noise=noise_of(seed, f, r, noise_shape, dev))
        with run.span("decode"):
            fields = pipe.decode_latents(traj, chunk)
        return traj, fields

    # warm-up: the cell's shapes once (encode, DiT at the ensemble's
    # batch, the decode's chunks), timed for the draw of the checked
    # repetition among those every window completes
    known = encode(WARM_UP)[1]
    t = time.perf_counter()
    repetition(WARM_UP, 0, known)
    run.sync()
    rep_s = time.perf_counter() - t
    k_check = int(check.randint(max(1, int(run.seconds // rep_s))))

    run.start_window()
    t0 = time.perf_counter()
    flags, rep, encodes = [], 0, 0
    while True:
        f, r = divmod(rep, reps_per_forecast)
        if r == 0:
            z, known = encode(f)
            encodes += 1
            if f == k_check // reps_per_forecast:
                kept["z"] = z.clone()
        if rep == k_check:
            kept["known"] = known[members].clone()
        traj, fields = repetition(f, r, known)
        if rep == k_check:
            kept["traj"], kept["fields"] = traj[members].clone(), fields[members].clone()
        flags.append(torch.isfinite(traj).all() & torch.isfinite(fields).all())
        known = traj[:, -t_in:]
        rep += 1
        if time.perf_counter() - t0 >= run.seconds:
            break
    run.sync()
    window_s = time.perf_counter() - t0
    failed = int((~torch.stack(flags)).sum())
    counts = {"window_reps": rep, "window_encodes": encodes, "window_s": window_s}

    if run.trace:  # one more repetition of the last forecast, no encode
        with run.traced():
            repetition(f, r + 1, known)
        counts.update(reps=1, dit_calls=2 * steps - 1)
    run.read_memory_peak()
    del pipe, known, traj, fields, flags
    if dev.startswith("cuda"):
        torch.cuda.empty_cache()

    f_k, r_k = divmod(k_check, reps_per_forecast)
    checks = compare(run, kept, f_k, r_k, members)
    return {"attempted": rep, "failed": failed, "checks": checks, "counts": counts,
            "end_to_end": {"forecast_rate": rep * E * t_out * HOURS_PER_FRAME / window_s},
            "flop_fns": flop_fns(cfg, p)}


@torch.no_grad()
def control(run: harness.Run):
    """The correctness control: the reference with float8 products (DiT and
    DCAE) in the program's place over the first repetition, held to the
    float32 reference as the program is."""
    from benchmark.reference.numerics import Numerics

    p, cfg, dev, seed = run.traffic, run.config, run.device, run.seed
    E, t_in, t_out = p["members"], p["input_seq_len"], p["return_seq_len"]
    fp8 = Numerics(fp8=True)
    check = np.random.RandomState(stream_seed(seed, CHECK_TAG) % 2**32)
    members = np.sort(check.choice(E, p["check_members"], replace=False))
    net = ref_dit.DiT(cfg["dit"], weights.make(ref_dit.param_spec(cfg["dit"]), seed, DIT_TAG, dev),
                      fp8)
    ae = ref_dcae.DCAE(cfg["dcae"], weights.make(ref_dcae.param_spec(cfg["dcae"]), seed,
                                                 DCAE_TAG, dev), fp8)
    lm, ls = (torch.from_numpy(a).to(dev) for a in ref_sampler.latent_stats())
    fm, fs = (torch.from_numpy(a).to(dev) for a in ref_sampler.field_stats())
    z = ae.encode(fields_of(seed, 0, t_in, dev),
                  torch.from_numpy(ref_sampler.static_fields()).to(dev))
    known = ((z - lm) / ls * ref_sampler.LATENT_TARGET_STD)[None].expand(len(members), *z.shape)
    noise = noise_of(seed, 0, 0, (1, E, t_out, *LATENT, cfg["dit"]["in_channels"]),
                     dev)[0, members]
    yp = torch.full((len(members),), year_of(seed, 0, 0, t_out), device=dev)
    traj = ref_sampler.heun(net, noise, known, yp, p["steps"])
    del net
    frames = (traj / ref_sampler.LATENT_TARGET_STD * ls + lm).flatten(0, 1)
    fields = ae.decode(frames) * fs + fm
    kept = {"z": z, "known": known, "traj": traj, "fields": fields.unflatten(0, traj.shape[:2])}
    del ae
    return compare(run, kept, 0, 0, members)


@torch.no_grad()
def compare(run, kept, f, r, members):
    """The reference over the checked repetition; the numbers and limits."""
    p, cfg, dev, seed = run.traffic, run.config, run.device, run.seed
    t_in, t_out, lim = p["input_seq_len"], p["return_seq_len"], run.workload["limits"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net = ref_dit.DiT(cfg["dit"], weights.make(ref_dit.param_spec(cfg["dit"]), seed, DIT_TAG, dev))
    ae = ref_dcae.DCAE(cfg["dcae"], weights.make(ref_dcae.param_spec(cfg["dcae"]), seed, DCAE_TAG, dev))
    static = torch.from_numpy(ref_sampler.static_fields()).to(dev)
    z = ae.encode(fields_of(seed, f, t_in, dev), static)
    noise = noise_of(seed, f, r, (1, p["members"], t_out, *LATENT, cfg["dit"]["in_channels"]),
                     dev)[0, members]
    yp = torch.full((len(members),), year_of(seed, f, r, t_out), device=dev)
    traj = ref_sampler.heun(net, noise, kept["known"], yp, p["steps"])
    del net
    lm, ls = (torch.from_numpy(a).to(dev) for a in ref_sampler.latent_stats())
    fm, fs = (torch.from_numpy(a).to(dev) for a in ref_sampler.field_stats())
    frames = (kept["traj"] / ref_sampler.LATENT_TARGET_STD * ls + lm).flatten(0, 1)
    ref_fields = torch.cat([ae.decode(frames[i:i + p["decode_chunk"]])
                            for i in range(0, len(frames), p["decode_chunk"])])
    prog_fields = ((kept["fields"] - fm) / fs).flatten(0, 1)
    out = []
    for name, a, b in (("encode", kept["z"], z), ("rollout", kept["traj"], traj),
                       ("decode", prog_fields, ref_fields)):
        out.append(harness.check(f"{name}_rel_l2", harness.rel_l2(a, b), lim[f"{name}_rel_l2"]))
        out.append(harness.check(f"{name}_max_gap", harness.max_gap(a, b), lim[f"{name}_max_gap"]))
    return out


def flop_fns(cfg, p):
    """FLOPs of a repetition (2 steps - 1 DiT calls at the ensemble's
    batch and the decode of its frames) and of an encode, counted on the
    reference on the meta device."""
    E, t_in, t_out = p["members"], p["input_seq_len"], p["return_seq_len"]
    C = cfg["dit"]["in_channels"]

    def dit_call():
        net = ref_dit.DiT(cfg["dit"], meta_params(ref_dit.param_spec(cfg["dit"])))
        m = lambda *s: torch.empty(s, device="meta")
        return count_flops(lambda: net(m(E, t_out, *LATENT, C), m(E), m(E, t_in, *LATENT, C), m(E)))

    def ae():
        return ref_dcae.DCAE(cfg["dcae"], meta_params(ref_dcae.param_spec(cfg["dcae"])))

    def decode():
        return count_flops(lambda: ae().decode(
            torch.empty((E * t_out, *LATENT, cfg["dcae"]["latent_channels"]), device="meta")))

    def encode():
        return count_flops(lambda: ae().encode(
            torch.empty((t_in, *GRID, 84), device="meta"),
            torch.empty((*GRID, cfg["dcae"]["static_channels"]), device="meta")))

    return {"repetition": lambda: (2 * p["steps"] - 1) * dit_call() + decode(),
            "dit_call": dit_call, "encode": encode}
