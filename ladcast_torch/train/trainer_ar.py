"""AR diffusion trainer: EDM-objective training of the LaDCast DiT on
pre-encoded latents (the port of ``ladcast_tpu/train/trainer_ar.py``).

One step:

  * log-normal sigma-index sampling per example and Gaussian noise;
  * add_noise + precondition_inputs;
  * push-forward: the target frames split into chunks; chunks >= 1 are
    conditioned on the EDM-preconditioned prediction of the previous chunk,
    detached, with year progress advanced 6 h per chunk;
  * precondition_outputs + the EDM lambda(sigma) weighting, an optional
    latitude-weighted loss on the latent grid, or min-SNR-gamma;
  * global-norm clip, AdamW, the LR schedule, EMA.

Mixed precision as in the JAX package: the master parameters stay fp32 in
the model and the optimizer; every forward sees a ``compute_dtype`` copy of
each fp32 parameter through ``torch.func.functional_call``, and the copy's
backward brings the gradients back to fp32.

Random draws: the sigma indices and the noise of step s come from one
``torch.Generator`` on the training device, seeded from (seed, s) alone
(``rollout.engine.stream_seed``), indices first. A resumed run draws what
the uninterrupted run would have drawn. ``loss_given_noise`` takes the
indices and noise instead, which is how the tests hold the loss to the
JAX package, whose PRNG differs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ladcast_torch import resolve_device
from ladcast_torch.config import (
    EDMSchedulerConfig,
    LaDCastDiTConfig,
    NoiseSamplerConfig,
)
from ladcast_torch.diffusion import edm
from ladcast_torch.diffusion.noise_sampler import sample_sigma_indices
from ladcast_torch.metrics.weights import cos_lat_weights
from ladcast_torch.models.ladcast_dit import LaDCastTransformer3D, build_dit
from ladcast_torch.rollout.engine import stream_seed
from ladcast_torch.train import ema as ema_lib
from ladcast_torch.train.optim import AdamW


@dataclass(frozen=True)
class ARTrainConfig:
    num_push_forward_steps: int = 1
    lat_weighted_loss: bool = False
    snr_gamma: Optional[float] = None  # min-SNR-gamma weighting
    use_ema: bool = True
    ema_max_decay: float = 0.9999
    ema_power: float = 2.0 / 3.0
    ema_inv_gamma: float = 1.0
    ema_update_after_step: int = 1000
    input_seq_len: int = 1
    compute_dtype: str = "bfloat16"  # activations; parameters stay fp32
    remat: bool = False              # per-block gradient checkpointing


@dataclass
class TrainState:
    model: LaDCastTransformer3D      # fp32 master parameters
    optimizer: AdamW
    ema: Optional[ema_lib.EMAState]
    step: int = 0

    def state_dict(self) -> dict:
        return {"params": self.model.state_dict(),
                "opt_state": self.optimizer.state_dict(),
                "ema": None if self.ema is None else self.ema.state_dict(),
                "step": self.step}

    def load_state_dict(self, sd: dict) -> None:
        self.model.load_state_dict(sd["params"], strict=True)
        self.optimizer.load_state_dict(sd["opt_state"])
        if (sd["ema"] is None) != (self.ema is None):
            raise ValueError("checkpoint and trainer differ in use_ema")
        if self.ema is not None:
            self.ema.load_state_dict(sd["ema"])
        self.step = int(sd["step"])


Batch = Sequence[torch.Tensor]  # (initial_profile, clean, year_progress)


def make_ar_train_step(
    dit_cfg: LaDCastDiTConfig,
    sched_cfg: EDMSchedulerConfig,
    ns_cfg: NoiseSamplerConfig,
    tcfg: ARTrainConfig,
    optimizer: Callable[..., AdamW],
    device="cuda",
):
    """Returns (init_fn, train_step).

    init_fn(seed) -> TrainState: a seeded fp32 model on ``device`` (CUDA
      unless the caller asks for the CPU), its optimizer
      (``optimizer(named_parameters)``, see ``train.optim.make_optimizer``)
      and EMA.
    train_step(state, batch, seed) -> metrics: one update of ``state`` in
      place. batch holds, on ``device``,
        initial_profile (B, T_in, h, w, C) normalized conditioning latents,
        clean           (B, T_out, h, w, C) normalized target latents,
        year_progress   (B, num_push_forward_steps) float32;
      metrics are device scalars: loss, mean_sigma_index, grad_norm (the
      global norm of the gradients before the clip).
    train_step.loss_given_noise(model, batch, indices, noise) -> (loss,
      aux): the objective with injected sigma indices (B,) and noise
      (shaped like clean).
    """
    device = resolve_device(device)
    if tcfg.remat and not dit_cfg.remat:
        # per-block checkpointing, not a whole-model one: block boundaries
        # stay saved, block internals are recomputed
        import dataclasses
        dit_cfg = dataclasses.replace(dit_cfg, remat=True)
    c_dtype = getattr(torch, tcfg.compute_dtype)
    train_sig = edm.train_sigmas(sched_cfg, device=device)

    def lat_w(height: int) -> torch.Tensor:
        # cos-lat weights over the latent rows' centre latitudes
        w = cos_lat_weights(np.linspace(-83.25, 84.75, height))
        return torch.as_tensor(w, dtype=torch.float32,
                               device=device).reshape(1, 1, -1, 1, 1)

    def apply_model(model, x_in, c_noise, cond, yp):
        params = {n: p.to(c_dtype) if p.dtype == torch.float32 else p
                  for n, p in model.named_parameters()}
        out = torch.func.functional_call(
            model, params, (x_in.to(c_dtype), c_noise, cond.to(c_dtype), yp))
        return out.float()

    def loss_given_noise(model, batch: Batch, indices: torch.Tensor,
                         noise: torch.Tensor):
        initial_profile, clean, year_progress = batch
        B, T_out = clean.shape[0], clean.shape[1]
        n_pf = tcfg.num_push_forward_steps
        if T_out % n_pf:
            raise ValueError(f"{T_out} target frames do not split into "
                             f"{n_pf} push-forward chunks")
        n_slice = T_out // n_pf
        t_in = tcfg.input_seq_len

        sigma = train_sig[indices].reshape(B, 1, 1, 1, 1)
        c_noise = edm.precondition_noise(sigma.reshape(B))
        noisy = edm.add_noise(clean, noise, sigma)
        x_in = edm.precondition_inputs(sched_cfg, noisy, sigma)

        preds = []
        cond = initial_profile
        for s in range(n_pf):
            sl = slice(s * n_slice, (s + 1) * n_slice)
            if s >= 1:
                prev = slice(s * n_slice - t_in, s * n_slice)
                cond = edm.precondition_outputs(
                    sched_cfg, noisy[:, prev], preds[-1][:, -t_in:].detach(),
                    sigma)
            preds.append(apply_model(model, x_in[:, sl], c_noise, cond,
                                     year_progress[:, s]))
        model_pred = torch.cat(preds, dim=1)

        model_pred = edm.precondition_outputs(sched_cfg, noisy, model_pred, sigma)
        sq = (model_pred - clean.float()) ** 2
        if tcfg.snr_gamma is None:
            weighting = edm.edm_loss_weighting(sched_cfg, sigma)
            if tcfg.lat_weighted_loss:
                sq = lat_w(clean.shape[2]) * sq
            loss = torch.mean(weighting * sq)
        else:
            # min-SNR-gamma: per-example weight min(SNR, gamma)/SNR on the
            # unweighted MSE
            snr = (sched_cfg.sigma_data / sigma.reshape(B)) ** 2
            w = torch.clamp(snr, max=tcfg.snr_gamma) / snr
            loss = torch.mean(sq.reshape(B, -1).mean(dim=1) * w)
        return loss, {"loss": loss.detach(),
                      "mean_sigma_index": indices.float().mean()}

    def train_step(state: TrainState, batch: Batch, seed: int) -> Dict[str, torch.Tensor]:
        clean = batch[1]
        g = torch.Generator(device=device).manual_seed(stream_seed(seed, state.step))
        indices = sample_sigma_indices(g, clean.shape[0], state.step, ns_cfg,
                                       sched_cfg)
        noise = torch.randn(clean.shape, generator=g, device=device)
        loss, aux = loss_given_noise(state.model, batch, indices, noise)
        params = list(state.model.parameters())
        grads = torch.autograd.grad(loss, params)
        aux["grad_norm"] = state.optimizer.step(grads)
        del grads
        if state.ema is not None:
            ema_lib.ema_update(
                state.ema, params, inv_gamma=tcfg.ema_inv_gamma,
                power=tcfg.ema_power, max_decay=tcfg.ema_max_decay,
                update_after_step=tcfg.ema_update_after_step)
        state.step += 1
        return aux

    def init_fn(seed: int) -> TrainState:
        model = build_dit(dit_cfg, device, torch.float32, seed)
        opt = optimizer(model.named_parameters())
        ema = ema_lib.ema_init(model.parameters()) if tcfg.use_ema else None
        return TrainState(model, opt, ema, 0)

    train_step.loss_given_noise = loss_given_noise
    return init_fn, train_step
