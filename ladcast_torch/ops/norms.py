"""Normalization primitives as plain functions on tensors.

  - rms_norm: diffusers RMSNorm -- variance in fp32, optional affine.
  - layer_norm: torch LayerNorm semantics (biased variance); with
    ``fp32=True`` statistics and affine run in float32 (FP32LayerNorm).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor], eps: float,
             bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RMS norm over the last axis. As in diffusers, a half-precision
    weight casts the normalized value to its dtype before the affine; an
    fp32 weight leaves it in fp32."""
    dtype = x.dtype
    var = x.float().square().mean(-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    if weight is not None:
        if weight.dtype in (torch.float16, torch.bfloat16):
            y = y.to(weight.dtype)
        y = y * weight
        if bias is not None:
            y = y + bias
    else:
        y = y.to(dtype)
    return y


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor],
               bias: Optional[torch.Tensor], eps: float,
               fp32: bool = False) -> torch.Tensor:
    """LayerNorm over the last axis (biased variance)."""
    dtype = x.dtype
    if fp32:
        x = x.float()
        weight = None if weight is None else weight.float()
        bias = None if bias is None else bias.float()
    else:
        weight = None if weight is None else weight.to(dtype)
        bias = None if bias is None else bias.to(dtype)
    y = F.layer_norm(x, (x.shape[-1],), weight, bias, eps)
    return y.to(dtype)
