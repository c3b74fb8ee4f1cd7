"""Training-time ensemble validation of the AR model (the port of
``ladcast_tpu/train/validation.py``; the reference's ``log_validation``).

Per held-out init time an N-member ensemble rollout
(``rollout.engine.ensemble_rollout``) is scored in latent space
(lat-weighted ensemble-mean RMSE and CRPS per lead time, averaged over the
channels) and, given a decoder, in physical fields: the forecast members
and the truth latents are decoded one lead time at a time and scored per
(channel, lead time) with cos-lat weights: ensemble-mean RMSE, the RMSE
pooled over members and the CRPS.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ladcast_torch.config import EDMSchedulerConfig, RolloutConfig
from ladcast_torch.data import transforms
from ladcast_torch.metrics import scores
from ladcast_torch.metrics.weights import latent_lat_weights
from ladcast_torch.rollout.engine import ensemble_rollout, stream_seed


@torch.inference_mode()
def validate_ar_model(
    net_fn,
    val_inputs: torch.Tensor,
    val_targets: torch.Tensor,
    year_progress: np.ndarray,
    seed: int,
    sched_cfg: EDMSchedulerConfig,
    rcfg: RolloutConfig,
    *,
    decode_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    latent_stats=None,
    field_stats=None,
    grid_lat_weight=None,
    target_std: float = 0.5,
    rep_noise: Optional[Sequence[torch.Tensor]] = None,
) -> Dict[str, np.ndarray]:
    """Roll out and score every validation init time.

    net_fn(latents, c_noise, cond, yp) is the denoiser
    (``rollout.engine.NetFn``); ``val_inputs`` (N, T_in, h, w, C) and
    ``val_targets`` (N, total_steps, h, w, C) are normalized latents on the
    device, ``year_progress`` (N, num_repetitions). Init time i draws from
    ``stream_seed(seed, i)``; ``rep_noise[i]`` ((n_reps, E, T_out, h, w,
    C)), when given, replaces its sampler noise.

    Returns ``latent_rmse`` and ``latent_crps`` of shape (N, total_steps)
    and, with ``decode_fn`` (z (B, h, w, Cl) physical latents -> (B, H, W,
    Cf) normalized fields) and ``latent_stats``, ``field_stats`` (mean, std
    pairs) and ``grid_lat_weight`` (H,), ``rmse_ens``, ``rmse_single`` and
    ``crps`` of shape (N, Cf, total_steps).
    """
    dev = val_inputs.device
    lat_w = torch.as_tensor(latent_lat_weights(), dtype=torch.float32,
                            device=dev).reshape(-1, 1)
    decoded = decode_fn is not None
    if decoded:
        if latent_stats is None or field_stats is None or grid_lat_weight is None:
            raise ValueError("decoded validation needs latent_stats, "
                             "field_stats and grid_lat_weight")

        def const(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)

        lm, ls = map(const, latent_stats)
        fm, fs = map(const, field_stats)
        glw = const(grid_lat_weight).reshape(-1, 1)

    def decode_traj(z_norm):
        """(..., T, h, w, Cl) normalized latents -> (..., T, H, W, Cf)
        physical fields, one lead time (all members) per decode."""
        z = transforms.inverse_normalize(z_norm, lm, ls, target_std)
        tax = z.dim() - 4  # the lead-time axis, just before (h, w, C)
        zt = z.movedim(tax, 0)
        squeeze = zt.dim() == 4
        if squeeze:  # no member axis: a batch of one
            zt = zt[:, None]
        dec = torch.stack([decode_fn(zt[t].contiguous()).float()
                           for t in range(zt.shape[0])])
        if squeeze:
            dec = dec[:, 0]
        dec = dec.movedim(0, tax)
        return transforms.inverse_normalize(dec, fm, fs, 1.0)

    out: Dict[str, list] = {}
    for i in range(val_inputs.shape[0]):
        inp, tgt = val_inputs[i], val_targets[i].float()
        known = inp[None].expand(rcfg.ensemble_size, *inp.shape).contiguous()
        traj = ensemble_rollout(
            net_fn, known, [float(y) for y in year_progress[i]],
            stream_seed(seed, i), sched_cfg, rcfg,
            rep_noise=None if rep_noise is None else rep_noise[i]).float()
        # the last repetition may overshoot the horizon
        traj = traj[:, : tgt.shape[0]]
        ens_mean = traj.mean(dim=0)
        m = {"latent_rmse": torch.sqrt(scores.lat_weighted_mse(
                 ens_mean.movedim(-1, 1), tgt.movedim(-1, 1), lat_w)).mean(dim=1),
             "latent_crps": torch.mean(
                 scores.crps(traj.movedim(-1, 2), tgt.movedim(-1, 1), 0) * lat_w,
                 dim=(-2, -1)).mean(dim=1)}
        if decoded:
            fcc = decode_traj(traj).movedim(-1, 0)  # (Cf, E, T, H, W)
            trc = decode_traj(tgt).movedim(-1, 0)   # (Cf, T, H, W)
            m["rmse_ens"] = torch.sqrt(scores.lat_weighted_mse(
                fcc.mean(dim=1), trc, glw))
            m["rmse_single"] = torch.sqrt(torch.mean(
                (fcc - trc[:, None]) ** 2 * glw, dim=(1, -2, -1)))
            m["crps"] = torch.mean(scores.crps(fcc, trc[:, None], 1) * glw,
                                   dim=(-2, -1))
            del fcc, trc
        for k, v in m.items():
            out.setdefault(k, []).append(v.cpu().numpy())
    return {k: np.stack(v) for k, v in out.items()}
