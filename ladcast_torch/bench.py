"""The bench workload of the PyTorch port: the ensemble rollout of
``bench.py`` on one CUDA device.

One DCAE encode of the initial state (with its static channels), the
ensemble broadcast, then ``rcfg.num_repetitions`` host-stepped
repetitions, each a Heun sampler of ``2N-1`` DiT calls at batch E followed
by the decode of its ``return_seq_len`` x E frames. Network in
``compute_dtype``, trajectory in fp32. Weights are random, from a seed.
A forecast that yields non-finite values fails.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from ladcast_torch import resolve_device
from ladcast_torch.config import (
    DCAEConfig,
    EDMSchedulerConfig,
    LaDCastDiTConfig,
    RolloutConfig,
)
from ladcast_torch.models.dcae import build_dcae
from ladcast_torch.models.ladcast_dit import build_dit
from ladcast_torch.rollout.engine import make_repetition_fn, stream_seed


def make_bench(dit_cfg: LaDCastDiTConfig, dcae_cfg: DCAEConfig,
               sched_cfg: EDMSchedulerConfig, rcfg: RolloutConfig, *,
               device="cuda", compute_dtype: torch.dtype = torch.bfloat16,
               latent_hw=(15, 30), grid_hw=(120, 240), seed: int = 0):
    """Build the forecast closure. Returns a dict with

      full_forecast(seed, stats=None) -> (acc, mean): acc sums the mean
        of every repetition's decoded frames, mean is the latent
        trajectory's mean. With a ``stats`` dict, the device is
        synchronised around each phase; the wall seconds of the encode and
        of every repetition's sampling and decode, and the shapes of the
        trajectory and of the last decode, are recorded in it.
      dit, dcae: the seeded models.
    """
    device = resolve_device(device)
    cdt = compute_dtype
    ens, T_in = rcfg.ensemble_size, rcfg.input_seq_len
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

    def sync_time(stats, name, t0):
        if stats is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            stats.setdefault(name, []).append(time.perf_counter() - t0)
        return time.perf_counter()

    @torch.inference_mode()
    def full_forecast(forecast_seed: int, stats: Optional[Dict] = None):
        t = time.perf_counter()
        z = dcae.encode(fields.to(cdt), static.to(cdt)).float()
        known = z[None].expand(ens, T_in, H, W, C)
        t = sync_time(stats, "encode_s", t)
        acc = torch.zeros((), device=device)
        outs = []
        for r in range(rcfg.num_repetitions):
            known, samples = rep_fn(net_fn, known, year_progress[r],
                                    stream_seed(forecast_seed, r + 1))
            t = sync_time(stats, "repetition_s", t)
            frames = samples.reshape(ens * rcfg.return_seq_len, H, W, C)
            decoded = dcae.decode(frames.to(cdt))
            acc = acc + decoded.float().mean()
            t = sync_time(stats, "decode_s", t)
            outs.append(samples)
        traj = torch.cat(outs, dim=1)[:, : rcfg.total_num_steps]
        acc_f, mean_f = float(acc), float(traj.mean())
        if stats is not None:
            stats["traj_shape"] = tuple(traj.shape)
            stats["decode_shape"] = tuple(decoded.shape)
        # a bench that silently times NaN outputs is worse than a crash
        if not (np.isfinite(acc_f) and np.isfinite(mean_f)):
            raise FloatingPointError(f"non-finite forecast: {acc_f}, {mean_f}")
        return acc_f, mean_f

    return {"full_forecast": full_forecast, "dit": dit, "dcae": dcae}
