"""Autoregressive ensemble rollout (the port of
``ladcast_tpu/rollout/engine.py``).

Ensemble members ride the batch dimension of every denoiser call. Each
repetition denoises ``return_seq_len`` frames with the Heun or the DPM
sampler (``cfg.sampler_type``) and feeds its last ``input_seq_len`` frames
back as the next conditioning. :func:`ensemble_rollout` is the single-call
form (one scanned program in the JAX package; here a loop over
:func:`make_repetition_fn`, which :func:`ensemble_rollout_hostloop` also
drives: the two give the same trajectory).

Reproducible ensembles: member i of repetition r draws its noise from its
own ``torch.Generator``, seeded from (seed, r, i) alone, so member i's
stream is the same whatever the ensemble size or batch split; a rank that
rolls out members ``member_offset`` onwards (``rollout.pipeline``'s member
sharding) draws member i's noise from its global index. Tests pass
the noise in instead (``noise`` / ``rep_noise`` / ``pert_noise``) to hold
the rollout against the JAX engine, whose PRNG differs.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ladcast_torch.config import EDMSchedulerConfig, RolloutConfig
from ladcast_torch.diffusion import edm
from ladcast_torch.diffusion.samplers import dpm_multistep_sample, edm_heun_sample
from ladcast_torch.utils.profiling import spanned

# net_fn(latents (E,T,H,W,C), c_noise (E,), cond (E,Tin,H,W,C), yp (E,)) -> F
NetFn = Callable[..., torch.Tensor]


def stream_seed(*entropy: int) -> int:
    """A 63-bit generator seed from a tuple of non-negative integers."""
    state = np.random.SeedSequence(entropy).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def member_noise(seed: int, num_members: int, shape, device,
                 dtype=torch.float32, member_offset: int = 0) -> torch.Tensor:
    """(num_members, *shape) Gaussian noise of the members ``member_offset``
    onwards; member i's draw depends only on (seed, i)."""
    out = torch.empty((num_members, *shape), dtype=dtype, device=device)
    for i in range(num_members):
        g = torch.Generator(device=device).manual_seed(
            stream_seed(seed, member_offset + i))
        out[i] = torch.randn(shape, generator=g, dtype=dtype, device=device)
    return out


def make_repetition_fn(sched_cfg: EDMSchedulerConfig, cfg: RolloutConfig):
    """One AR repetition:

      rep_fn(net_fn, known, year_progress, rep_seed, noise=None,
             member_offset=0) -> (new_known, samples)

    known (E, T_in, H, W, C), the members ``member_offset`` onwards;
    samples (E, T_out, H, W, C) in known's dtype; ``noise`` (E, T_out, H,
    W, C) replaces the seeded draw.
    """
    if cfg.sampler_type not in ("edm", "dpm"):
        raise ValueError(f"sampler {cfg.sampler_type!r}: expected 'edm' or 'dpm'")
    traj_dtype = getattr(torch, cfg.trajectory_dtype)

    @spanned("rollout.repetition")
    def rep_fn(net_fn, known, year_progress, rep_seed,
               noise: Optional[torch.Tensor] = None, member_offset: int = 0):
        E, T_in, H, W, C = known.shape
        shape = (cfg.return_seq_len, H, W, C)
        if noise is None:
            noise = member_noise(rep_seed, E, shape, known.device, traj_dtype,
                                 member_offset)
        yp = torch.full((E,), float(year_progress), dtype=torch.float32,
                        device=known.device)

        def denoised_fn(x, sigma):
            x_in = edm.precondition_inputs(sched_cfg, x, sigma)
            c_noise = edm.precondition_noise(sigma).expand(E)
            f = net_fn(x_in.float(), c_noise.float(), known, yp)
            return edm.precondition_outputs(sched_cfg, x, f.to(x.dtype), sigma)

        if cfg.sampler_type == "edm":
            samples = edm_heun_sample(
                sched_cfg, denoised_fn, noise, cfg.num_inference_steps,
                dtype=traj_dtype,
                correction_skip_period=cfg.correction_skip_period)
        else:
            samples = dpm_multistep_sample(
                sched_cfg, denoised_fn, noise, cfg.num_inference_steps,
                dtype=traj_dtype, init_scale=cfg.dpm_init_scale)
        samples = samples.to(known.dtype)
        return samples[:, -T_in:], samples

    return rep_fn


def ensemble_rollout_hostloop(
    rep_fn,
    net_fn: NetFn,
    known_latents: torch.Tensor,
    year_progress: Sequence[float],
    seed: int,
    cfg: RolloutConfig,
    *,
    latent_std: Optional[torch.Tensor] = None,
    rep_noise: Optional[torch.Tensor] = None,
    pert_noise: Optional[torch.Tensor] = None,
    member_offset: int = 0,
) -> torch.Tensor:
    """Run ``cfg.num_repetitions`` repetitions from known_latents
    (E, T_in, H, W, C), the members ``member_offset`` onwards. Returns
    (E, total_num_steps, H, W, C).

    With ``cfg.noise_level > 0`` the initial latent gets one perturbation,
    shared by all members, scaled by noise_level x the per-channel
    physical latent std. ``rep_noise`` (n_reps, E, T_out, H, W, C) and
    ``pert_noise`` (T_in, H, W, C) replace the seeded draws.
    """
    n_reps = cfg.num_repetitions
    if len(year_progress) != n_reps:
        raise ValueError(f"{len(year_progress)} year_progress values for "
                         f"{n_reps} repetitions")
    known = known_latents
    if cfg.noise_level > 0:
        if latent_std is None:
            raise ValueError("noise_level > 0 needs latent_std")
        if pert_noise is None:
            g = torch.Generator(device=known.device).manual_seed(
                stream_seed(seed))
            pert_noise = torch.randn(known.shape[1:], generator=g,
                                     dtype=known.dtype, device=known.device)
        known = known + pert_noise.to(known.dtype) * cfg.noise_level * latent_std
    outs = []
    for r in range(n_reps):
        noise = None if rep_noise is None else rep_noise[r]
        known, samples = rep_fn(net_fn, known, year_progress[r],
                                stream_seed(seed, r + 1), noise, member_offset)
        outs.append(samples)
    return torch.cat(outs, dim=1)[:, : cfg.total_num_steps]


def ensemble_rollout(
    net_fn: NetFn,
    known_latents: torch.Tensor,
    year_progress: Sequence[float],
    seed: int,
    sched_cfg: EDMSchedulerConfig,
    cfg: RolloutConfig,
    *,
    latent_std: Optional[torch.Tensor] = None,
    rep_noise: Optional[torch.Tensor] = None,
    pert_noise: Optional[torch.Tensor] = None,
    member_offset: int = 0,
) -> torch.Tensor:
    """The whole AR ensemble forecast in one call: (E, T_in, H, W, C)
    normalized conditioning latents -> (E, total_num_steps, H, W, C)
    normalized forecast frames (lead times step_size_hour .. total; the t=0
    frame is the caller's input). ``seed`` takes the place of the JAX key;
    the noise arguments and ``member_offset`` (the global index of the
    first of these members) are those of :func:`ensemble_rollout_hostloop`,
    whose trajectory this equals."""
    if rep_noise is not None:
        E, _, H, W, C = known_latents.shape
        want = (cfg.num_repetitions, E, cfg.return_seq_len, H, W, C)
        if tuple(rep_noise.shape) != want:
            raise ValueError(f"rep_noise {tuple(rep_noise.shape)}, expected {want}")
    return ensemble_rollout_hostloop(
        make_repetition_fn(sched_cfg, cfg), net_fn, known_latents,
        year_progress, seed, cfg, latent_std=latent_std, rep_noise=rep_noise,
        pert_noise=pert_noise, member_offset=member_offset)


def make_rollout_fn(net_fn: NetFn, sched_cfg: EDMSchedulerConfig,
                    cfg: RolloutConfig):
    """``ensemble_rollout`` with the network and the configs bound:
    (known, year_progress, seed, **noise) -> trajectory."""
    return functools.partial(ensemble_rollout, net_fn, sched_cfg=sched_cfg,
                             cfg=cfg)
