"""Spherical-boundary padding and convolution, NHWC.

SphereConv2d semantics: circular padding in longitude (width) and
antipodal pole padding in latitude (height) -- the pad rows above/below
the poles are the nearest rows rolled by half the longitude circle and
mirrored vertically. Output rows 0 and H-1 read their pad rows with the
width-flipped kernel rows; every other row, including rows 1..p-1 of a
p=2 kernel, uses the normal kernel.

Activations are NHWC at the interface and stay NHWC in memory; kernels are
torch OIHW. :data:`CONV_MODE` picks how the convolution runs:

  - ``"kernel"`` (the default): the fused-boundary form of the JAX package.
    The main convolution is one call of the hand-written dense
    (``ops.dense_conv``) or depthwise (``ops.depthwise_conv``) kernel on
    the unpadded input, with the H zero padding and the longitude wrap
    inside the kernel; the pole rows are then corrected from thin
    antipodal strips. A CUDA tensor reaches the CUDA kernel or raises; a
    CPU tensor takes the kernel's plain version.
  - ``"library"``: one ``F.conv2d`` (cuDNN on the card) over a padded
    copy, the pole rows replaced by two more: only when asked for, as the
    yardstick of the kernels.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

from ladcast_torch.ops.dense_conv import (
    PackedDenseWeight,
    dense_conv,
    pack_dense_weight,
)
from ladcast_torch.ops.depthwise_conv import depthwise_same_conv

# The counterpart of the JAX package's LADCAST_PALLAS_DENSE /
# LADCAST_PALLAS_DEPTHWISE switches, read at every call. Those default to
# off for reasons that are the TPU's (the dense kernel never lowered there,
# the depthwise one measured slower than the conv HLO); here the kernels
# are the path.
CONV_MODE = "kernel"  # "kernel" | "library"


def kernel_convs() -> bool:
    """Whether ``CONV_MODE`` asks for the kernels; a wrong value raises."""
    if CONV_MODE not in ("kernel", "library"):
        raise ValueError(f"CONV_MODE {CONV_MODE!r}: expected 'kernel' or "
                         f"'library'")
    return CONV_MODE == "kernel"


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
    """VALID convolution of NHWC ``x`` with an OIHW kernel, NHWC out. It
    runs on the NCHW view of the same storage (channels-last strides), so
    no layout copy is made."""
    return F.conv2d(x.permute(0, 3, 1, 2), weight, bias,
                    groups=groups).permute(0, 2, 3, 1)


def pack_weight(weight: torch.Tensor, groups: int = 1):
    """An OIHW kernel in the layout its kernel reads: for a dense conv
    (``groups == 1``) K4's packed tiles (``ops.dense_conv.pack_dense_weight``
    of the HWIO weight), for a depthwise one the (kh, kw, C) taps,
    contiguous. ``sphere_conv2d`` takes it as ``packed`` so that a layer can
    repack once per weight and not once per call."""
    if groups == 1:
        return pack_dense_weight(weight.permute(2, 3, 1, 0))
    return weight[:, 0].permute(1, 2, 0).contiguous()


def _strip_conv(strip, weight, groups, pad_h=(0, 0)):
    """The convolution of a thin pole strip (B, rows, W + 2p, C) with the
    kernel rows ``weight`` (OIHW), H zero-padded by ``pad_h``. Depthwise
    strips are shifted multiply-adds (a grouped convolution pays a fixed
    cost per group for a few rows of work); dense ones ``F.conv2d``."""
    if pad_h != (0, 0):
        strip = F.pad(strip, (0, 0, 0, 0, *pad_h))
    if groups == 1:
        return conv2d_nhwc(strip, weight, None, 1)
    kh, kw = weight.shape[-2:]
    h_out, w_out = strip.shape[1] - kh + 1, strip.shape[2] - kw + 1
    out = None
    for dy in range(kh):
        for dx in range(kw):
            t = strip[:, dy:dy + h_out, dx:dx + w_out] * weight[:, 0, dy, dx]
            out = t if out is None else out + t
    return out


def _sphere_conv2d_fused(x, weight, bias, p, groups, packed):
    """The fused-boundary form: main conv on the unpadded x (zero rows in
    H, wrap columns in W, both inside the kernel), then the pole rows."""
    B, H, W, C = x.shape
    kh = 2 * p + 1
    pads = ((p, p), (p, p))
    if groups == 1:
        # HWIO in grad mode (differentiable), the packed tiles otherwise
        k = weight.permute(2, 3, 1, 0).contiguous() if packed is None else packed
        out = dense_conv(x, k, pads, True)
    elif groups == C and weight.shape[0] == C and weight.shape[1] == 1:
        k = pack_weight(weight, groups) if packed is None else packed
        out = depthwise_same_conv(x, k, pads, True)
    else:
        raise ValueError(f"sphere_conv2d: groups {groups} with {C} -> "
                         f"{weight.shape[0]} channels is neither dense nor "
                         f"depthwise")
    if out._is_view():  # a plain version's permuted result: the rows
        out = out.clone()  # below are corrected in place
    # Pole rows: antipodal strips, circularly padded in W. Output rows 0
    # and H-1 read their pad rows with the width-flipped kernel rows;
    # output rows 1..p-1 (p = 2) read theirs with the normal kernel.
    half = W // 2

    def wrap(s):
        return torch.cat([s[:, :, W - p:], s, s[:, :, :p]], dim=2)

    pad_top = wrap(torch.flip(torch.roll(x[:, :p], half, dims=2), dims=[1]))
    pad_bot = wrap(torch.flip(torch.roll(x[:, H - p:], half, dims=2), dims=[1]))
    out[:, 0:1] += _strip_conv(pad_top, torch.flip(weight[:, :, :p], dims=[3]),
                               groups)
    out[:, H - 1:H] += _strip_conv(
        pad_bot, torch.flip(weight[:, :, kh - p:], dims=[3]), groups)
    if p > 1:
        out[:, 1:p] += _strip_conv(pad_top[:, 1:], weight[:, :, :p - 1],
                                   groups, (0, p - 2))
        out[:, H - p:H - 1] += _strip_conv(pad_bot[:, :p - 1],
                                           weight[:, :, p + 1:], groups,
                                           (p - 1, 0))
    if bias is not None:
        out += bias
    return out


def _check_sphere_conv(x, weight, padding):
    kh, kw = weight.shape[-2:]
    p = kh // 2 if padding is None else padding
    if not (kh == kw == 2 * p + 1 and p >= 1):
        raise ValueError("sphere_conv2d expects odd square kernels of 3 or "
                         "more with padding = k // 2")
    if x.shape[2] % 2:
        raise ValueError("width (longitude) must be even for antipodal rolling")
    return p


def sphere_conv2d_library(x, weight, bias=None, *, padding=None, groups=1):
    """The 3-slice form on ``F.conv2d``, the yardstick of the kernels: one
    convolution over the padded input gives every row with the normal
    kernel; rows 0 and H-1 are then replaced by the convolutions of the
    first and last k padded rows with the pole kernels (their pad-row taps
    width-flipped)."""
    p = _check_sphere_conv(x, weight, padding)
    kh = weight.shape[-2]
    xp = sphere_pad(x, p, p)
    k_top = torch.cat([torch.flip(weight[:, :, :p], dims=[3]),
                       weight[:, :, p:]], dim=2)
    k_bot = torch.cat([weight[:, :, :kh - p],
                       torch.flip(weight[:, :, kh - p:], dims=[3])], dim=2)
    out = conv2d_nhwc(xp, weight, bias, groups)
    out[:, :1] = conv2d_nhwc(xp[:, :kh], k_top, bias, groups)
    out[:, -1:] = conv2d_nhwc(xp[:, -kh:], k_bot, bias, groups)
    return out


def sphere_conv2d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    padding: Optional[int] = None,
    groups: int = 1,
    packed: Optional[Union[torch.Tensor, PackedDenseWeight]] = None,
) -> torch.Tensor:
    """(B, H, W, C_in) -> (B, H, W, C_out); weight (C_out, C_in/groups,
    k, k) with k = 2*padding + 1 > 1, dense (``groups == 1``) or depthwise
    (``groups == C_in == C_out``). ``packed`` is ``pack_weight(weight,
    groups)``, kept by the caller; only the ``"kernel"`` mode reads it, and
    a packed dense weight gets no gradient.

    Under ``CONV_MODE = "kernel"`` the fused-boundary form runs (module
    docstring); under ``"library"``, :func:`sphere_conv2d_library`.
    """
    if not kernel_convs():
        return sphere_conv2d_library(x, weight, bias, padding=padding,
                                     groups=groups)
    p = _check_sphere_conv(x, weight, padding)
    return _sphere_conv2d_fused(x, weight, bias, p, groups, packed)
