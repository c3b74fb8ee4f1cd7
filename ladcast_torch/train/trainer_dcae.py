"""DCAE reconstruction trainer (the port of
``ladcast_tpu/train/trainer_dcae.py``).

One step:

  * SST-NaN masking: the prediction and the target are set to the mask
    value (-2) wherever the input's SST was NaN;
  * the target is [fields, statics]: the decoder reconstructs the static
    channels too (``decode(..., return_static=True)``);
  * the latitude-weighted relative L2 loss (``metrics.losses.lp_loss``);
  * periodic-roll augmentation: each batch is reused ``subbatch_steps``
    times, and every step with ``step % subbatch_steps != 0`` rolls each
    sample's fields, NaN mask, latitude weights and statics by its own
    random (x, y), H by -y and W by -x;
  * bf16 compute on fp32 masters (the trainer_ar scheme), AdamW, EMA.

Random draws: the roll of step s comes from a CPU ``torch.Generator``
seeded from (seed, s) alone. ``train_step.loss_given_roll`` takes the roll
instead, which is how the tests hold the loss to the JAX package.

Data-parallel over a mesh's ranks, as the JAX CLI is
(``sharding_rules.shard_dcae``): each rank trains on its rows of the global
batch (``dist.host_local_slice``) with the rolls of those rows, drawn for
the whole global batch; the gradients are averaged by an explicit
all-reduce after the backward (``trainer_ar.reduced_grads``), and the
logged metrics over the ranks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import torch

from ladcast_torch import channels as ch, resolve_device
from ladcast_torch.config import DCAEConfig
from ladcast_torch.metrics.losses import lp_loss, lp_loss_per_var
from ladcast_torch.metrics.weights import grid_lat_weights
from ladcast_torch.models.dcae import build_dcae
from ladcast_torch.parallel import dist
from ladcast_torch.parallel import sharding_rules as rules
from ladcast_torch.rollout.engine import stream_seed
from ladcast_torch.train import ema as ema_lib
from ladcast_torch.train.trainer_ar import TrainState, reduced_grads


@dataclass(frozen=True)
class DCAETrainConfig:
    lat_weighted_loss: bool = True
    subbatch_steps: int = 3
    use_ema: bool = True
    ema_max_decay: float = 0.9999
    ema_power: float = 0.66667
    ema_inv_gamma: float = 1.0
    ema_update_after_step: int = 1000
    sst_channel: int = ch.SST_CHANNEL_INDEX
    sst_mask_value: float = -2.0
    compute_dtype: str = "bfloat16"  # activations; parameters stay fp32


Batch = Sequence[torch.Tensor]  # (fields, nan_mask, statics)


def roll_samples(t: torch.Tensor, roll) -> torch.Tensor:
    """Each sample t[b] (H, W, ...) rolled periodically so that its new
    top-left pixel is (x, y) = roll[b]: H by -y, W by -x."""
    return torch.stack([torch.roll(t[b], shifts=(-int(y), -int(x)), dims=(0, 1))
                        for b, (x, y) in enumerate(roll)])


def make_dcae_train_step(cfg: DCAEConfig, tcfg: DCAETrainConfig, optimizer,
                         device="cuda", grid_lat: int = 120, mesh=None):
    """Returns (init_fn, train_step, eval_step).

    init_fn(seed) -> TrainState (``train.trainer_ar.TrainState``): a seeded
      fp32 DCAE on ``device`` (CUDA unless the caller asks for the CPU),
      data-parallel over ``mesh`` (None: one device), its optimizer
      (``optimizer(named_parameters)``) and EMA.
    train_step(state, batch, seed) -> metrics: one update of ``state`` in
      place. batch holds this rank's rows (all of them on one device), on
      ``device``,
        fields   (B, H, W, 84) normalized, SST NaNs already -2,
        nan_mask (B, H, W) bool, True where the SST was NaN,
        statics  (H, W, 5) normalized static conditioning;
      metrics: loss, loss_per_var and grad_norm (before the clip), device
      tensors.
    eval_step(model, batch, params=None) -> metrics: the loss and per
      output channel (dynamic and static) the MSE and the lat-weighted MSE
      in normalized units, of ``model`` or, given ``params`` (a list in
      ``named_parameters`` order, e.g. the EMA's), of those weights.
    train_step.loss_given_roll(model, fields, nan_mask, statics, roll) ->
      (loss, aux): the objective with an injected roll ((B, 2) ints
      (x, y), or None for none).
    """
    device = resolve_device(device)
    c_dtype = getattr(torch, tcfg.compute_dtype)
    lat_w = torch.as_tensor(grid_lat_weights("cos", grid_lat),
                            dtype=torch.float32, device=device)

    def apply_model(model, x, static, params=None):
        names = [n for n, _ in model.named_parameters()]
        params = list(model.parameters()) if params is None else params
        cast = {n: p.to(c_dtype) if p.dtype == torch.float32 else p
                for n, p in zip(names, params)}
        return torch.func.functional_call(
            model, cast, (x.to(c_dtype), static.to(c_dtype), True)).float()

    def loss_fn(model, fields, nan_mask, statics, roll, params=None):
        B, H, W, C = fields.shape
        lw = lat_w.reshape(1, H, 1, 1).expand(B, H, 1, 1)
        stat_b = statics[None].expand(B, *statics.shape)
        if roll is not None:
            fields = roll_samples(fields, roll)
            nan_mask = roll_samples(nan_mask, roll)
            lw = roll_samples(lw, roll)
            stat_b = roll_samples(stat_b, roll)
        pred = apply_model(model, fields, stat_b, params)
        sst = tcfg.sst_channel
        m_pred = nan_mask[..., None] & (
            torch.arange(pred.shape[-1], device=device) == sst)
        pred = torch.where(m_pred, tcfg.sst_mask_value, pred)
        m_in = nan_mask[..., None] & (torch.arange(C, device=device) == sst)
        fields = torch.where(m_in, tcfg.sst_mask_value, fields)
        target = torch.cat([fields, stat_b.to(fields.dtype)], dim=-1)
        w = lw if tcfg.lat_weighted_loss else None
        loss = lp_loss(pred, target, w)
        per_var = lp_loss_per_var(pred, target, w)
        return loss, {"loss": loss.detach(), "loss_per_var": per_var.detach(),
                      "_pred": pred, "_target": target, "_lw": lw}

    def draw_roll(seed: int, step: int, B: int, H: int, W: int):
        g = torch.Generator().manual_seed(stream_seed(seed, step))
        x = torch.randint(0, W, (B,), generator=g)
        y = torch.randint(0, H, (B,), generator=g)
        return torch.stack([x, y], dim=1).tolist()

    def train_step(state: TrainState, batch: Batch, seed: int) -> Dict[str, torch.Tensor]:
        fields, nan_mask, statics = batch
        B, H, W, _ = fields.shape
        # the first step of each batch trains unrolled, the reuses rolled;
        # the rolls of the whole global batch are drawn, this rank's rows kept
        roll = (draw_roll(seed, state.step, B * dist.process_count(), H, W)[
                    dist.host_local_slice(B * dist.process_count())]
                if state.step % tcfg.subbatch_steps else None)
        loss, aux = loss_fn(state.model, fields, nan_mask, statics, roll)
        for k in ("_pred", "_target", "_lw"):
            aux.pop(k)
        grads = reduced_grads(state, loss, [aux["loss"], aux["loss_per_var"]])
        aux["grad_norm"] = state.optimizer.step(grads)
        del grads
        if state.ema is not None:
            ema_lib.ema_update(
                state.ema, list(state.model.parameters()),
                inv_gamma=tcfg.ema_inv_gamma,
                power=tcfg.ema_power, max_decay=tcfg.ema_max_decay,
                update_after_step=tcfg.ema_update_after_step)
        state.step += 1
        return aux

    @torch.no_grad()
    def eval_step(model, batch: Batch, params: Optional[list] = None):
        fields, nan_mask, statics = batch
        _, aux = loss_fn(model, fields, nan_mask, statics, None, params)
        pred, target, lw = aux.pop("_pred"), aux.pop("_target"), aux.pop("_lw")
        se = (pred - target) ** 2  # (B, H, W, C_out)
        aux["channel_mse"] = se.mean(dim=(0, 1, 2))
        aux["channel_lw_mse"] = (se * lw).mean(dim=(0, 1, 2))
        return aux

    def init_fn(seed: int) -> TrainState:
        model = build_dcae(cfg, device, torch.float32, seed)
        regime = rules.shard_dcae(model, mesh)
        opt = optimizer(model.named_parameters())
        ema = ema_lib.ema_init(model.parameters()) if tcfg.use_ema else None
        return TrainState(model, opt, ema, 0, regime)

    train_step.loss_given_roll = loss_fn
    return init_fn, train_step, eval_step

