"""Pixel shuffle / unshuffle in NHWC, with the channel order of
``torch.nn.functional.pixel_(un)shuffle`` (out channel = c*f*f + i*f + j)."""

from __future__ import annotations

import torch


def pixel_unshuffle(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/f, W/f, C*f*f)."""
    B, H, W, C = x.shape
    f = factor
    x = x.reshape(B, H // f, f, W // f, f, C)
    x = x.permute(0, 1, 3, 5, 2, 4)  # (B, H/f, W/f, C, i, j)
    return x.reshape(B, H // f, W // f, C * f * f)


def pixel_shuffle(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """(B, H, W, C*f*f) -> (B, H*f, W*f, C), inverse of pixel_unshuffle."""
    B, H, W, Cff = x.shape
    f = factor
    C = Cff // (f * f)
    x = x.reshape(B, H, W, C, f, f)
    x = x.permute(0, 1, 4, 2, 5, 3)  # (B, H, i, W, j, C)
    return x.reshape(B, H * f, W * f, C)
