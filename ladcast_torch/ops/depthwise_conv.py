"""Depthwise 2-D convolution, NHWC, with the padding inside the kernel.

The port of ``ladcast_tpu/ops/pallas/depthwise_conv.py``.
:func:`depthwise_same_conv` is the differentiable entry (the JAX
``custom_vjp``): its forward is :func:`depthwise_same_conv_forward`, the
hand-written CUDA kernel of ``csrc/depthwise_conv.cu`` on CUDA tensors and
:func:`depthwise_same_conv_plain` on CPU tensors; its backward is the VJP
of the plain version.

``out[b, h, w, c] = sum_{dy, dx} xp[b, h + dy, w + dx, c] * k[dy, dx, c]``
with ``xp`` the input padded by ``pads`` (zeros, or wrap columns in W with
``circular_w``): see :mod:`ladcast_torch.ops.dense_conv` for the padding
rules. fp32 accumulation, output in the input dtype.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ladcast_torch.ops import _launch
from ladcast_torch.ops.dense_conv import NO_PAD, Pads, conv_flops, out_hw, pad_nhwc
from ladcast_torch.utils.profiling import count_kernel

KERNEL_SIZES = (3, 5)  # the square kernels the CUDA kernel is built for


def depthwise_same_conv_plain(x: torch.Tensor, k: torch.Tensor,
                              pads: Pads = NO_PAD,
                              circular_w: bool = False) -> torch.Tensor:
    """Plain version of :func:`depthwise_same_conv_forward`: a grouped
    ``F.conv2d`` over the padded copy (``_xla_depthwise`` /
    ``_xla_depthwise_circular``)."""
    out_hw(x.shape, k.shape[0], k.shape[1], pads, circular_w)
    xp = pad_nhwc(x, pads, circular_w)
    C = x.shape[-1]
    return F.conv2d(xp.permute(0, 3, 1, 2), k.permute(2, 0, 1)[:, None],
                    groups=C).permute(0, 2, 3, 1)


def depthwise_same_conv_forward(x: torch.Tensor, k: torch.Tensor,
                                pads: Pads = NO_PAD,
                                circular_w: bool = False) -> torch.Tensor:
    """x (B, H, W, C), k (kh, kw, C) -> (B, H_out, W_out, C). The kernel on
    CUDA tensors (counted in ``launches``, its FLOPs reported to
    ``utils.profiling.count_kernel``), the plain version on CPU tensors; the
    result carries no gradient."""
    if x.device.type == "cpu":
        return depthwise_same_conv_plain(x, k, pads, circular_w)
    if x.dim() != 4 or k.dim() != 3 or k.shape[2] != x.shape[3]:
        raise ValueError(f"depthwise_same_conv: x {tuple(x.shape)}, k "
                         f"{tuple(k.shape)}, expected (B, H, W, C) and "
                         f"(kh, kw, C)")
    _launch.check_cuda_inputs("depthwise_same_conv", (x, k))
    _launch.refuse_grad("depthwise_same_conv_forward", (x, k),
                        "depthwise_same_conv")
    B, H, W, C = x.shape
    kh, kw, _ = k.shape
    if kh != kw or kw not in KERNEL_SIZES:
        raise ValueError(f"depthwise_same_conv: a {kh}x{kw} kernel, the CUDA "
                         f"kernel takes square ones of {KERNEL_SIZES}")
    Ho, Wo = out_hw(x.shape, kh, kw, pads, circular_w)
    if Ho < 1 or Wo < 1:
        raise ValueError(f"depthwise_same_conv: no output for x "
                         f"{tuple(x.shape)}, kernel {kh}x{kw}, pads {pads}")
    out = torch.empty((B, Ho, Wo, C), dtype=x.dtype, device=x.device)
    if out.numel():
        fn = _launch.fn("depthwise_conv", "ladcast_depthwise_conv",
                        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 12
                        + [ctypes.c_void_p])
        _launch.check_launch("depthwise_same_conv", fn(
            x.data_ptr(), k.data_ptr(), out.data_ptr(), B, H, W, C, kh, kw,
            pads[0][0], pads[1][0], Ho, Wo, int(circular_w),
            _launch.DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream))
        depthwise_same_conv_forward.launches += 1
        count_kernel("depthwise_conv", conv_flops(out, 1, kh, kw))
    return out


depthwise_same_conv_forward.launches = 0


class DepthwiseSameConv(torch.autograd.Function):
    """:func:`depthwise_same_conv_forward` with the VJP of the plain
    version as its backward."""

    @staticmethod
    def forward(ctx, x, k, pads, circular_w):
        ctx.pads, ctx.circular_w = pads, circular_w
        ctx.save_for_backward(x, k)
        return depthwise_same_conv_forward(x, k, pads, circular_w)

    @staticmethod
    def backward(ctx, g):
        x, k = ctx.saved_tensors
        _, pull = _launch.with_vjp(
            lambda xx, kk: depthwise_same_conv_plain(xx, kk, ctx.pads,
                                                     ctx.circular_w),
            (x, k), ctx.needs_input_grad[:2])
        return (*pull(g), None, None)


def depthwise_same_conv(x: torch.Tensor, k: torch.Tensor, pads: Pads = NO_PAD,
                        circular_w: bool = False) -> torch.Tensor:
    """Depthwise conv with padding ``pads``, NHWC; ``k`` is (kh, kw, C).
    Differentiable in x and k."""
    return DepthwiseSameConv.apply(x, k, pads, circular_w)
