"""End-to-end forecast pipeline: ERA5 fields -> DCAE encode -> latent
ensemble rollout -> DCAE decode -> fields (the port of
``ladcast_tpu/rollout/pipeline.py``), on one device or with the ensemble's
members spread over the ranks of the process group
(``shard_ensemble``, the JAX ``ens_mesh``).

Every stage runs under ``torch.inference_mode``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import torch

from ladcast_torch import static_data
from ladcast_torch.config import (
    DCAEConfig,
    EDMSchedulerConfig,
    LaDCastDiTConfig,
    RolloutConfig,
)
from ladcast_torch.data import time_utils, transforms
from ladcast_torch.models import hub
from ladcast_torch.parallel import dist
from ladcast_torch.parallel.mesh import pad_to_multiple
from ladcast_torch.rollout.engine import (
    ensemble_rollout,
    ensemble_rollout_hostloop,
    make_repetition_fn,
)


@dataclass
class ForecastPipeline:
    """The models, their weights and the normalization constants.

    All public methods take and return channels-last tensors on
    ``device``. ``dit_params`` / ``dcae_params`` are state dicts in the
    reference names (``models.hub.load_pretrained``). Latents are
    normalized with the bundled 84-vector statistics to ``target_std`` =
    the EDM sigma_data.

    ``compute_dtype``: dtype of the weights and activations of both
    networks (bfloat16 by default); the EDM trajectory stays in
    ``rollout_cfg.trajectory_dtype`` (fp32).

    ``host_step``: drive the AR loop repetition by repetition from
    ``ensemble_rollout_hostloop`` rather than through the single-call
    ``ensemble_rollout``. In the JAX package the two are different
    programs; here both are the same loop and give the same trajectory.

    ``device``: CUDA unless the caller asks for the CPU.

    ``shard_ensemble``: each rank of the process group rolls out and
    decodes ceil(E / ranks) members, rank r those from r x that on; the
    member axis is padded to a multiple of the ranks and the extras are
    discarded, as the JAX package does. Member i draws its noise from its
    global index, so the sharded ensemble is the unsharded one member for
    member. :meth:`forecast_from_fields` gathers the trajectory (and the
    decoded fields) to rank 0; the other ranks get None. Every rank loads
    the weights once, here.
    """

    dit_cfg: LaDCastDiTConfig
    dcae_cfg: DCAEConfig
    sched_cfg: EDMSchedulerConfig
    rollout_cfg: RolloutConfig
    dit_params: Dict[str, torch.Tensor]
    dcae_params: Dict[str, torch.Tensor]
    compute_dtype: str = "bfloat16"
    host_step: bool = False
    device: object = "cuda"
    shard_ensemble: bool = False

    def __post_init__(self):
        cdt = getattr(torch, self.compute_dtype)
        self._cdt = cdt
        self.dit = hub.build_model("dit", self.dit_cfg, self.dit_params,
                                   self.device, cdt)
        self.dcae = hub.build_model("dcae", self.dcae_cfg, self.dcae_params,
                                    self.device, cdt)
        self.device = next(self.dit.parameters()).device
        # the modules hold the weights now
        self.dit_params = self.dcae_params = None

        def const(a):
            return torch.from_numpy(a).to(self.device)

        self.latent_mean, self.latent_std = map(const, static_data.latent_mean_std())
        self.field_mean, self.field_std = map(const, static_data.era5_mean_std())
        self.static_cond = const(static_data.static_conditioning_tensor(layout="HWC"))

    def _net_fn(self, latents, c_noise, cond, yp):
        cdt = self._cdt
        return self.dit(latents.to(cdt), c_noise, cond.to(cdt), yp).float()

    # -- latent-space helpers ----------------------------------------------

    def normalize_latent(self, z):
        return transforms.normalize(z, self.latent_mean, self.latent_std,
                                    self.rollout_cfg.latent_target_std)

    def unnormalize_latent(self, z):
        return transforms.inverse_normalize(
            z, self.latent_mean, self.latent_std,
            self.rollout_cfg.latent_target_std)

    # -- stages ------------------------------------------------------------

    @torch.inference_mode()
    def encode_fields(self, fields: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 84) normalized fields -> (B, 15, 30, 84) physical
        latents, fp32 (the static channels are appended inside)."""
        cdt = self._cdt
        return self.dcae.encode(fields.to(self.device, cdt),
                                self.static_cond.to(cdt)).float()

    @torch.inference_mode()
    def decode_latents(self, latents_norm: torch.Tensor,
                       chunk: int = 40) -> torch.Tensor:
        """(E, T, 15, 30, 84) normalized latents -> (E, T, H, W, 84) fields
        in physical units (the field z-scoring undone), fp32; the frames go
        through the decoder ``chunk`` at a time, which bounds the decoder's
        activation memory."""
        if chunk < 1:
            raise ValueError(f"chunk {chunk}")
        E, T = latents_norm.shape[:2]
        z = self.unnormalize_latent(latents_norm.to(self.device)).flatten(0, 1)
        out = []
        for i in range(0, E * T, chunk):
            dec = self.dcae.decode(z[i:i + chunk].to(self._cdt)).float()
            out.append(transforms.inverse_normalize(dec, self.field_mean,
                                                    self.field_std))
        dec = torch.cat(out)
        return dec.reshape(E, T, *dec.shape[1:])

    @torch.inference_mode()
    def forecast_latents(self, known_latents_norm: torch.Tensor,
                         year_progress: Sequence[float], seed: int,
                         *, rep_noise: Optional[torch.Tensor] = None,
                         pert_noise: Optional[torch.Tensor] = None,
                         member_offset: int = 0):
        """(E, T_in, 15, 30, 84) normalized conditioning latents ->
        (E, total_steps, 15, 30, 84) normalized forecast latents of the
        members ``member_offset`` onwards. ``seed`` takes the place of the
        JAX key; the noise arguments replace the seeded draws
        (``rollout.engine``)."""
        known = known_latents_norm.to(self.device)
        noise = dict(latent_std=self.latent_std, rep_noise=rep_noise,
                     pert_noise=pert_noise, member_offset=member_offset)
        if self.host_step:
            return ensemble_rollout_hostloop(
                make_repetition_fn(self.sched_cfg, self.rollout_cfg),
                self._net_fn, known, year_progress, seed, self.rollout_cfg,
                **noise)
        return ensemble_rollout(self._net_fn, known, year_progress, seed,
                                self.sched_cfg, self.rollout_cfg, **noise)

    # -- convenience -------------------------------------------------------

    def forecast_from_fields(self, fields: torch.Tensor, init_ts_int: int,
                             seed: int, decode: bool = True,
                             stats: Optional[Dict] = None, **noise):
        """fields: (T_in, H, W, 84) normalized ERA5 input frames.

        Returns (traj_latents_norm, decoded_fields_or_None, z_analysis):
        z_analysis is the (T_in, 15, 30, 84) physical-scale encoder output
        of the inputs (its last frame is what the reference stores at
        prediction_timedelta 0); the trajectory does not include the t=0
        frame. With a ``stats`` dict the device is synchronised after each
        stage and the stage's wall seconds are recorded in it
        (``encode_s``, ``rollout_s``, ``decode_s``, and under
        ``shard_ensemble`` ``gather_s``). Under ``shard_ensemble`` the
        trajectory and the decoded fields are rank 0's, None elsewhere.
        """
        def lap(name, t0):
            if stats is not None:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                stats[name] = time.perf_counter() - t0
            return time.perf_counter()

        cfg = self.rollout_cfg
        t = time.perf_counter()
        z_phys = self.encode_fields(fields)
        t = lap("encode_s", t)
        z = self.normalize_latent(z_phys)
        E = cfg.ensemble_size
        per, offset = E, 0
        if self.shard_ensemble:
            per = pad_to_multiple(E, dist.process_count()) // dist.process_count()
            offset = dist.process_index() * per
            if noise.get("rep_noise") is not None:
                rep = noise["rep_noise"]
                pad = rep.new_zeros(rep.shape[0], per * dist.process_count() - E,
                                    *rep.shape[2:])
                noise["rep_noise"] = torch.cat([rep, pad], 1)[:, offset:offset + per]
        known = z[None].expand(per, *z.shape)
        yp = time_utils.rollout_year_progress(
            init_ts_int, cfg.num_repetitions,
            cfg.step_size_hour * cfg.return_seq_len)
        traj = self.forecast_latents(known, yp, seed, member_offset=offset, **noise)
        t = lap("rollout_s", t)
        decoded = self.decode_latents(traj) if decode else None
        t = lap("decode_s", t)
        if self.shard_ensemble:
            traj = dist.gather_to_rank0(traj)
            decoded = None if decoded is None else dist.gather_to_rank0(decoded)
            if traj is not None:
                traj = traj[:E]
                decoded = None if decoded is None else decoded[:E]
            lap("gather_s", t)
        return traj, decoded, z_phys
