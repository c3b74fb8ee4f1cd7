"""Dense 2-D convolution, NHWC x HWIO, with the padding inside the kernel.

The port of ``ladcast_tpu/ops/pallas/dense_conv.py``. :func:`dense_conv`
is the differentiable entry (the JAX ``custom_vjp``): its forward is
:func:`dense_conv_forward`, the hand-written CUDA implicit GEMM of
``csrc/dense_conv.cu`` on CUDA tensors and :func:`dense_conv_plain` on CPU
tensors; its backward is the VJP of the plain version, as ``_bwd`` of the
JAX module is the VJP of the conv HLO.

``pads = ((ph0, ph1), (pw0, pw1))`` zero-pads H and, unless ``circular_w``,
W. With ``circular_w`` the W taps wrap around (the sphere's longitude;
``pw0 + pw1`` must equal ``kw - 1`` so that the width is kept). No padded
copy of ``x`` is made on the kernel path. fp32 accumulation, output in the
input dtype.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from ladcast_torch.ops import _launch

Pads = Tuple[Tuple[int, int], Tuple[int, int]]
NO_PAD: Pads = ((0, 0), (0, 0))


def out_hw(x_shape, kh: int, kw: int, pads: Pads, circular_w: bool):
    """(H_out, W_out) of a (B, H, W, C) input; raises on pads that do not
    fit the circular form."""
    (ph0, ph1), (pw0, pw1) = pads
    if min(ph0, ph1, pw0, pw1) < 0:
        raise ValueError(f"negative padding {pads}")
    H, W = x_shape[1], x_shape[2]
    if circular_w and (pw0 + pw1 != kw - 1 or max(pw0, pw1) > W):
        raise ValueError(f"circular_w needs W pads summing to kw - 1 = "
                         f"{kw - 1}, each at most W = {W}; got {(pw0, pw1)}")
    return H + ph0 + ph1 - kh + 1, W + pw0 + pw1 - kw + 1


def pad_nhwc(x: torch.Tensor, pads: Pads, circular_w: bool) -> torch.Tensor:
    """The padded copy the plain versions convolve: wrap columns
    concatenated in W when ``circular_w``, zeros elsewhere."""
    (ph0, ph1), (pw0, pw1) = pads
    if circular_w:
        W = x.shape[2]
        x = torch.cat([x[:, :, W - pw0:], x, x[:, :, :pw1]], dim=2)
        pw0 = pw1 = 0
    if ph0 or ph1 or pw0 or pw1:
        x = F.pad(x, (0, 0, pw0, pw1, ph0, ph1))
    return x


def dense_conv_plain(x: torch.Tensor, w: torch.Tensor, pads: Pads = NO_PAD,
                     circular_w: bool = False) -> torch.Tensor:
    """Plain version of :func:`dense_conv_forward`: ``F.conv2d`` over the
    padded copy (``_xla_dense`` / ``_xla_dense_circular``)."""
    out_hw(x.shape, w.shape[0], w.shape[1], pads, circular_w)
    xp = pad_nhwc(x, pads, circular_w)
    return F.conv2d(xp.permute(0, 3, 1, 2),
                    w.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)


def dense_conv_forward(x: torch.Tensor, w: torch.Tensor, pads: Pads = NO_PAD,
                       circular_w: bool = False) -> torch.Tensor:
    """x (B, H, W, Cin), w (kh, kw, Cin, Cout) -> (B, H_out, W_out, Cout).
    The kernel on CUDA tensors (counted in ``launches``), the plain version
    on CPU tensors; the result carries no gradient."""
    if x.device.type == "cpu":
        return dense_conv_plain(x, w, pads, circular_w)
    if x.dim() != 4 or w.dim() != 4 or w.shape[2] != x.shape[3]:
        raise ValueError(f"dense_conv: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"expected (B, H, W, Cin) and (kh, kw, Cin, Cout)")
    _launch.check_cuda_inputs("dense_conv", (x, w))
    _launch.refuse_grad("dense_conv_forward", (x, w), "dense_conv")
    B, H, W, Cin = x.shape
    kh, kw, _, Cout = w.shape
    Ho, Wo = out_hw(x.shape, kh, kw, pads, circular_w)
    if Ho < 1 or Wo < 1:
        raise ValueError(f"dense_conv: no output for x {tuple(x.shape)}, "
                         f"kernel {kh}x{kw}, pads {pads}")
    out = torch.empty((B, Ho, Wo, Cout), dtype=x.dtype, device=x.device)
    if out.numel():
        fn = _launch.fn("dense_conv", "ladcast_dense_conv",
                        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 13
                        + [ctypes.c_void_p])
        _launch.check_launch("dense_conv", fn(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), B, H, W, Cin, Cout,
            kh, kw, pads[0][0], pads[1][0], Ho, Wo, int(circular_w),
            _launch.DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream))
        dense_conv_forward.launches += 1
    return out


dense_conv_forward.launches = 0


class DenseConv(torch.autograd.Function):
    """:func:`dense_conv_forward` with the VJP of the plain version as its
    backward (``_fwd`` / ``_bwd`` of the JAX module)."""

    @staticmethod
    def forward(ctx, x, w, pads, circular_w):
        ctx.pads, ctx.circular_w = pads, circular_w
        ctx.save_for_backward(x, w)
        return dense_conv_forward(x, w, pads, circular_w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        _, pull = _launch.with_vjp(
            lambda xx, ww: dense_conv_plain(xx, ww, ctx.pads, ctx.circular_w),
            (x, w), ctx.needs_input_grad[:2])
        return (*pull(g), None, None)


def dense_conv(x: torch.Tensor, w: torch.Tensor, pads: Pads = NO_PAD,
               circular_w: bool = False) -> torch.Tensor:
    """Dense conv, NHWC; ``w`` is HWIO. Differentiable in x and w."""
    return DenseConv.apply(x, w, pads, circular_w)
