"""The products of the plain reference, in float32 or, for the correctness
control, with every product's operands rounded to float8 (e4m3, one scale
per row of the reduction): the precision below the bfloat16 that the
configurations state.

``Numerics.linear``, ``Numerics.conv2d`` and ``Numerics.einsum`` are the
only products the reference models make; the control swaps them, nothing
else changes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # the largest finite float8_e4m3fn value


def to_fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (its absolute maximum maps to the format's largest value), returned in
    float32."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Numerics:
    """float32 products (``fp8=False``, the reference) or float8 ones (the
    control)."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def linear(self, x, w, b=None):
        y = to_fp8(x, -1) @ to_fp8(w, -1).t() if self.fp8 else x @ w.t()
        return y if b is None else y + b

    def conv2d(self, x, w, b=None, groups=1):
        """NCHW convolution; in float8 each input pixel's channels and each
        output channel's weights are rounded."""
        if self.fp8:
            x = to_fp8(x, 1)
            w = to_fp8(w.flatten(1), 1).view_as(w)
        return F.conv2d(x, w, b, groups=groups)

    def einsum(self, eq: str, a, b):
        if self.fp8:
            # each operand rounded along its last axis, which every einsum
            # of the reference reduces or keeps whole
            a, b = to_fp8(a, -1), to_fp8(b, -1)
        return torch.einsum(eq, a, b)


FP32 = Numerics()
