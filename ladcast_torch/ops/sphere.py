"""Spherical-boundary padding and convolution, NHWC, on ``F.conv2d``.

SphereConv2d semantics: circular padding in longitude (width) and
antipodal pole padding in latitude (height) -- the pad rows above/below
the poles are the nearest rows rolled by half the longitude circle and
mirrored vertically. Output rows 0 and H-1 read their pad rows with the
width-flipped kernel rows; every other row, including rows 1..p-1 of a
p=2 kernel, uses the normal kernel.

Activations are NHWC at the interface and stay NHWC in memory: the
convolution runs on the NCHW view of the same storage (channels-last
strides), so cuDNN picks its channels-last kernels and no layout copy is
made. Kernels are torch OIHW.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def sphere_pad(x: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """Pad (B, H, W, C) with antipodal rows in H and circularly in W."""
    B, H, W, C = x.shape
    if W % 2:
        raise ValueError("width (longitude) must be even for antipodal rolling")
    half = W // 2
    top = torch.flip(torch.roll(x[:, :pad_h], half, dims=2), dims=[1])
    bottom = torch.flip(torch.roll(x[:, H - pad_h:], half, dims=2), dims=[1])
    x = torch.cat([top, x, bottom], dim=1)
    if pad_w > 0:
        x = torch.cat([x[:, :, W - pad_w:], x, x[:, :, :pad_w]], dim=2)
    return x


def conv2d_nhwc(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                groups: int = 1) -> torch.Tensor:
    """VALID convolution of NHWC ``x`` with an OIHW kernel, NHWC out."""
    return F.conv2d(x.permute(0, 3, 1, 2), weight, bias,
                    groups=groups).permute(0, 2, 3, 1)


def sphere_conv2d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    padding: Optional[int] = None,
    groups: int = 1,
) -> torch.Tensor:
    """(B, H, W, C_in) -> (B, H, W, C_out); weight (C_out, C_in/groups,
    k, k) with k = 2*padding + 1.

    The 3-slice form: one convolution over the padded input gives every
    row with the normal kernel; rows 0 and H-1 are then replaced by the
    convolutions of the first and last k padded rows with the pole kernels
    (their pad-row taps width-flipped).
    """
    kh, kw = weight.shape[-2:]
    p = kh // 2 if padding is None else padding
    if not kh == kw == 2 * p + 1:
        raise ValueError("sphere_conv2d expects odd square kernels with "
                         "padding = k // 2")
    xp = sphere_pad(x, p, p)
    k_top = torch.cat([torch.flip(weight[:, :, :p], dims=[3]),
                       weight[:, :, p:]], dim=2)
    k_bot = torch.cat([weight[:, :, :kh - p],
                       torch.flip(weight[:, :, kh - p:], dims=[3])], dim=2)
    out = conv2d_nhwc(xp, weight, bias, groups)
    out[:, :1] = conv2d_nhwc(xp[:, :kh], k_top, bias, groups)
    out[:, -1:] = conv2d_nhwc(xp[:, -kh:], k_bot, bias, groups)
    return out
