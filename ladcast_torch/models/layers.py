"""Layers and initialisation shared by the DiT and the DCAE.

Parameters keep the reference diffusers names and torch layouts; the
defaults follow flax's: lecun-normal kernels, zero biases, unit norm
weights, so a seeded model has the scale of the JAX package's.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ladcast_torch import resolve_device

# stddev correction of flax's truncated-normal variance scaling
_TRUNC_STD = 0.87962566103423978


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ weight.T + bias`` in the promoted dtype of x and weight, as a
    flax Dense computes (fp32 activations through bf16 weights stay fp32)."""
    dt = torch.promote_types(x.dtype, weight.dtype)
    return F.linear(x.to(dt), weight.to(dt),
                    None if bias is None else bias.to(dt))


class Dense(nn.Linear):
    """nn.Linear with flax Dense's dtype promotion."""

    def forward(self, x):
        return dense(x, self.weight, self.bias)


class Affine(nn.Module):
    """A norm's affine parameters (``weight``, optional ``bias``); the norm
    itself is a function of ``ladcast_torch.ops.norms``."""

    def __init__(self, dim: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim)) if bias else None


class SiluLinear(nn.Module):
    """SiLU then ``linear``: the modulation head of the AdaLN layers."""

    def __init__(self, dim: int, out: int):
        super().__init__()
        self.linear = Dense(dim, out)

    def forward(self, x):
        return self.linear(F.silu(x))


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)


def init_flax_defaults_(module: nn.Module,
                        generator: Optional[torch.Generator] = None) -> None:
    """Re-initialise every parameter as flax's defaults would. A layer may
    set ``flax_fan_in`` where flax counts fan-in differently from torch
    (the grouped 1x1 projection)."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.Conv3d)):
            fan_in = getattr(m, "flax_fan_in", None) or m.weight[0].numel()
            lecun_normal_(m.weight, fan_in, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, Affine):
            nn.init.ones_(m.weight)
            if m.bias is not None:
                nn.init.zeros_(m.bias)


def build_module(make: Callable[[], nn.Module], device="cuda",
                 dtype: torch.dtype = torch.float32, seed: int = 0) -> nn.Module:
    """Construct ``make()`` directly on ``device`` with flax-default weights
    drawn from a generator seeded with ``seed``; eval mode, in ``dtype``.
    Raises when CUDA is asked for and absent."""
    device = resolve_device(device)
    with torch.device("meta"):
        module = make()
    module = module.to_empty(device=device)
    init_flax_defaults_(module, torch.Generator(device=device).manual_seed(seed))
    return module.to(dtype).eval()
