"""Typed configuration dataclasses of the PyTorch port.

The port's own copies of ``ladcast_tpu.config``'s ``DCAEConfig``,
``LaDCastDiTConfig``, ``ladcast_375m_config``, ``dcae_ray_1024_config``,
``ladcast_1p6b_config``, ``EDMSchedulerConfig``, ``NoiseSamplerConfig``,
``RolloutConfig``, ``config_to_json`` and ``config_from_dict``, with
the same fields and defaults (the shipped configs/DC_AE_84_pretrain.yaml
and configs/ladcast_375M.yaml settings). Frozen, so a config is hashable
and safe to share between modules.
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass
from typing import Optional, Tuple


def _tup(x):
    if isinstance(x, (list, tuple)):
        return tuple(_tup(v) for v in x)
    return x


def _freeze_tuples(cfg, names):
    for name in names:
        object.__setattr__(cfg, name, _tup(getattr(cfg, name)))


@dataclass(frozen=True)
class DCAEConfig:
    """The 84-latent ERA5 deep-compression autoencoder: 89 in-channels (84
    dynamic + 5 static), 84 latent channels, 4 stages with 8x spatial
    compression."""

    in_channels: int = 89
    out_channels: int = 89
    latent_channels: int = 84
    attention_head_dim: int = 32
    encoder_block_types: Tuple[str, ...] = (
        "ResBlock", "ResBlock", "EfficientViTBlock", "EfficientViTBlock")
    decoder_block_types: Tuple[str, ...] = (
        "ResBlock", "ResBlock", "EfficientViTBlock", "EfficientViTBlock")
    encoder_block_out_channels: Tuple[int, ...] = (252, 504, 504, 1008)
    decoder_block_out_channels: Tuple[int, ...] = (252, 504, 504, 1008)
    encoder_layers_per_block: Tuple[int, ...] = (4, 4, 4, 4)
    decoder_layers_per_block: Tuple[int, ...] = (4, 4, 4, 4)
    encoder_qkv_multiscales: Tuple[Tuple[int, ...], ...] = ((), (), (5,), (5,))
    decoder_qkv_multiscales: Tuple[Tuple[int, ...], ...] = ((), (), (5,), (5,))
    upsample_block_type: str = "pixel_shuffle"
    downsample_block_type: str = "pixel_unshuffle"
    decoder_norm_types: Tuple[str, ...] = ("rms_norm",) * 4
    decoder_act_fns: Tuple[str, ...] = ("silu",) * 4
    scaling_factor: float = 1.0
    static_channels: int = 5
    temb_channels: Optional[int] = None
    encoder_out_shortcut: bool = True
    decoder_in_shortcut: bool = True
    decoder_conv_act_fn: str = "relu"

    def __post_init__(self):
        _freeze_tuples(self, (
            "encoder_block_types", "decoder_block_types",
            "encoder_block_out_channels", "decoder_block_out_channels",
            "encoder_layers_per_block", "decoder_layers_per_block",
            "encoder_qkv_multiscales", "decoder_qkv_multiscales",
            "decoder_norm_types", "decoder_act_fns"))

    @property
    def spatial_compression_ratio(self) -> int:
        return 2 ** (len(self.encoder_block_out_channels) - 1)


@dataclass(frozen=True)
class LaDCastDiTConfig:
    """The AR diffusion transformer. Spatial RoPE grid positions are in
    degrees; ``spatial_deg2rad=True`` converts them when tables are built.

    ``attention_impl``: "auto" runs the hand-written kernels on CUDA
    tensors and their plain versions on CPU tensors; "plain" runs the
    PyTorch composite everywhere (the reference the kernels are held to).
    ``remat``: per-block gradient checkpointing of the dual- and
    single-stream blocks (training only; no effect without grad).
    ``int8_matmuls``: the transformer blocks' projections as dynamic w8a8
    int8 products (``ops.quant``; inference only, approximate).
    """

    in_channels: int = 84
    out_channels: int = 84
    num_attention_heads: int = 12
    attention_head_dim: int = 128
    num_layers: int = 2              # dual-stream blocks
    num_single_layers: int = 4       # single-stream blocks
    num_refiner_layers: int = 1
    mlp_ratio: float = 4.0
    patch_size: int = 1
    patch_size_t: int = 1
    qk_norm: str = "rms_norm"
    rope_theta: float = 256.0
    rope_axes_dim: Tuple[int, ...] = (16, 56, 56)
    rope_spatial_grid_start_pos: Tuple[float, float] = (-499.5, 5.25)
    rope_spatial_grid_end_pos: Tuple[float, float] = (508.5, 353.25)
    spatial_deg2rad: bool = True
    conditioning_tensor_in_channels: int = 84
    conditioning_tensor_intermediate_proj_dim: Optional[int] = None
    conditioning_tensor_rope_axes_dim: Tuple[int, ...] = (16, 56, 56)
    incl_time_elapsed: bool = True
    nope: bool = False
    scale_attn_by_lat: bool = False
    attention_impl: str = "auto"  # "auto" | "plain"
    int8_matmuls: bool = False
    remat: bool = False

    def __post_init__(self):
        _freeze_tuples(self, (
            "rope_axes_dim", "rope_spatial_grid_start_pos",
            "rope_spatial_grid_end_pos", "conditioning_tensor_rope_axes_dim"))
        if sum(self.rope_axes_dim) != self.attention_head_dim:
            raise ValueError("rope_axes_dim must sum to attention_head_dim")
        if sum(self.conditioning_tensor_rope_axes_dim) != self.attention_head_dim:
            raise ValueError("conditioning_tensor_rope_axes_dim must sum to "
                             "attention_head_dim")
        if self.attention_impl not in ("auto", "plain"):
            raise ValueError(f"attention_impl {self.attention_impl!r}: "
                             f"expected 'auto' or 'plain'")

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    def rope_spatial_grid_start_rad(self) -> Tuple[float, float]:
        if self.spatial_deg2rad:
            return tuple(math.radians(v) for v in self.rope_spatial_grid_start_pos)
        return self.rope_spatial_grid_start_pos

    def rope_spatial_grid_end_rad(self) -> Tuple[float, float]:
        if self.spatial_deg2rad:
            return tuple(math.radians(v) for v in self.rope_spatial_grid_end_pos)
        return self.rope_spatial_grid_end_pos


def ladcast_375m_config(**overrides) -> LaDCastDiTConfig:
    """configs/ladcast_375M.yaml:2-31."""
    return LaDCastDiTConfig(**overrides)


def dcae_ray_1024_config(**overrides) -> DCAEConfig:
    """The scaled-up DCAE of configs/dcae_ray_1024.yaml: widths (512, 1024,
    1024, 2048), 1024 latent channels, 90 input channels (84 dynamic + 6
    static, geopotential_at_surface added), 6 static channels."""
    base = dict(
        in_channels=90, out_channels=90, latent_channels=1024,
        encoder_block_out_channels=(512, 1024, 1024, 2048),
        decoder_block_out_channels=(512, 1024, 1024, 2048),
        static_channels=6)
    base.update(overrides)
    return DCAEConfig(**base)


def ladcast_1p6b_config(**overrides) -> LaDCastDiTConfig:
    """configs/ladcast_1.6B.yaml:2-31."""
    base = dict(num_attention_heads=16, num_layers=5, num_single_layers=10,
                num_refiner_layers=3)
    base.update(overrides)
    return LaDCastDiTConfig(**base)


@dataclass(frozen=True)
class EDMSchedulerConfig:
    """EDM noise schedule and preconditioning settings (sigma_data=0.5,
    1000 train timesteps)."""

    sigma_min: float = 0.002
    sigma_max: float = 80.0
    sigma_data: float = 0.5
    num_train_timesteps: int = 1000
    rho: float = 7.0
    solver_order: int = 2
    prediction_type: str = "epsilon"
    solver_type: str = "midpoint"
    final_sigmas_type: str = "zero"


@dataclass(frozen=True)
class NoiseSamplerConfig:
    """Log-normal training sigma sampler (configs/ladcast_375M.yaml:38-42):
    (P_mean, P_std) annealed linearly over ``num_max_steps``."""

    P_mean_start: float = -1.2
    P_std_start: float = 1.2
    P_mean_end: float = -1.2
    P_std_end: float = 1.2
    num_max_steps: int = 50000


@dataclass(frozen=True)
class RolloutConfig:
    """Ensemble AR rollout settings."""

    ensemble_size: int = 20
    num_inference_steps: int = 20
    return_seq_len: int = 4
    input_seq_len: int = 1
    total_lead_time_hour: int = 240
    step_size_hour: int = 6
    noise_level: float = 0.0
    latent_target_std: float = 0.5
    sampler_type: str = "edm"
    dpm_init_scale: Optional[float] = None
    trajectory_dtype: str = "float32"
    correction_skip_period: int = 0

    @property
    def total_num_steps(self) -> int:
        if self.total_lead_time_hour % self.step_size_hour:
            raise ValueError("total_lead_time_hour must be a multiple of "
                             "step_size_hour")
        return self.total_lead_time_hour // self.step_size_hour

    @property
    def num_repetitions(self) -> int:
        return -(-self.total_num_steps // self.return_seq_len)


def config_to_json(cfg) -> str:
    """A config dataclass as indented JSON with sorted keys."""
    return json.dumps(dataclasses.asdict(cfg), indent=2, sort_keys=True)


def config_from_dict(cls, d: dict):
    """``cls`` from the keys of ``d`` that are its fields (others, such as a
    YAML ``target``, are ignored)."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in names})
