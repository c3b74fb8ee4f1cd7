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

The weight is HWIO (the JAX entry's layout) or a :class:`PackedDenseWeight`,
the bf16 kernel's own layout, made once per weight version by
:func:`pack_dense_weight`: the kernel reads the packed form, and packs an
HWIO weight on the call.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple, Union

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


# The bf16 kernel's tiles: output channels per N tile (the wgmma widths it
# is built for, the narrowest that holds Cout, else 256) and input
# channels per step.
N_TILES = (96, 128, 256)
K_STEP = 64


def n_tile(cout: int) -> int:
    """The N tile of the bf16 kernel for ``cout`` output channels."""
    return next((n for n in N_TILES if cout <= n), N_TILES[-1])


def _swizzle(t: torch.Tensor) -> torch.Tensor:
    """(..., N, 64) rows with the 16-byte chunk j of row n moved to chunk
    j ^ (n % 8): the 128-byte swizzle of a wgmma K-major operand (in bf16;
    the same moves of 8 values in any dtype). Its own inverse."""
    *lead, n, k = t.shape
    rows = torch.arange(n, device=t.device)[:, None]
    chunks = torch.arange(k // 8, device=t.device)[None, :] ^ (rows % 8)
    return t.reshape(*lead, n, k // 8, 8)[..., rows, chunks, :].reshape(*lead, n, k)


@dataclasses.dataclass(frozen=True)
class PackedDenseWeight:
    """A (kh, kw, cin, cout) conv weight in the bf16 kernel's layout:
    ``data`` is (N tiles, channel steps, kh * kw, BN, 64), one (BN, 64)
    tile per (N tile, step of 64 input channels, tap) in the order the
    kernel reads them, K-major (row n holds the 64 input channels of output
    BN * tile + n) and swizzled (:func:`_swizzle`), zero past cin and cout.
    It carries no gradient."""

    data: torch.Tensor
    kh: int
    kw: int
    cin: int
    cout: int

    def unpack(self) -> torch.Tensor:
        """The HWIO weight, contiguous."""
        n_t, n_s, taps, bn, k = self.data.shape
        w = _swizzle(self.data).permute(2, 1, 4, 0, 3).reshape(
            self.kh, self.kw, n_s * k, n_t * bn)
        return w[:, :, :self.cin, :self.cout].contiguous()


def pack_dense_weight(w: torch.Tensor) -> PackedDenseWeight:
    """An HWIO weight (kh, kw, cin, cout) in the bf16 kernel's layout (any
    dtype; the fp32 kernel and the plain version unpack it)."""
    kh, kw, cin, cout = w.shape
    bn = n_tile(cout)
    n_t, n_s = -(-cout // bn), -(-cin // K_STEP)
    wp = F.pad(w.detach(), (0, n_t * bn - cout, 0, n_s * K_STEP - cin))
    wp = wp.reshape(kh * kw, n_s, K_STEP, n_t, bn).permute(3, 1, 0, 4, 2)
    return PackedDenseWeight(_swizzle(wp).contiguous(), kh, kw, cin, cout)


Weight = Union[torch.Tensor, PackedDenseWeight]


def _hwio(w: Weight) -> torch.Tensor:
    return w.unpack() if isinstance(w, PackedDenseWeight) else w


def dense_conv_plain(x: torch.Tensor, w: Weight, pads: Pads = NO_PAD,
                     circular_w: bool = False) -> torch.Tensor:
    """Plain version of :func:`dense_conv_forward`: ``F.conv2d`` over the
    padded copy (``_xla_dense`` / ``_xla_dense_circular``)."""
    w = _hwio(w)
    out_hw(x.shape, w.shape[0], w.shape[1], pads, circular_w)
    xp = pad_nhwc(x, pads, circular_w)
    return F.conv2d(xp.permute(0, 3, 1, 2),
                    w.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)


def dense_conv_forward(x: torch.Tensor, w: Weight, pads: Pads = NO_PAD,
                       circular_w: bool = False) -> torch.Tensor:
    """x (B, H, W, Cin), w (kh, kw, Cin, Cout) or its packed form ->
    (B, H_out, W_out, Cout). The kernel on CUDA tensors (counted in
    ``launches``; bf16 on the packed weight, packed here if given HWIO),
    the plain version on CPU tensors; the result carries no gradient."""
    if x.device.type == "cpu":
        return dense_conv_plain(x, w, pads, circular_w)
    packed = w if isinstance(w, PackedDenseWeight) else None
    shape = (packed.kh, packed.kw, packed.cin, packed.cout) if packed else tuple(w.shape)
    if x.dim() != 4 or len(shape) != 4 or shape[2] != x.shape[3]:
        raise ValueError(f"dense_conv: x {tuple(x.shape)}, w {shape}, expected "
                         f"(B, H, W, Cin) and (kh, kw, Cin, Cout)")
    kh, kw, _, cout = shape
    if packed is not None:  # the kernel reads whole tiles of this shape
        bn = n_tile(cout)
        want = (-(-cout // bn), -(-packed.cin // K_STEP), kh * kw, bn, K_STEP)
        if tuple(packed.data.shape) != want:
            raise ValueError(f"dense_conv: a packed weight of shape "
                             f"{tuple(packed.data.shape)}, expected {want}")
    w_data = packed.data if packed else w
    _launch.check_cuda_inputs("dense_conv", (x, w_data))
    _launch.refuse_grad("dense_conv_forward", (x, w_data), "dense_conv")
    B, H, W, Cin = x.shape
    Ho, Wo = out_hw(x.shape, kh, kw, pads, circular_w)
    if Ho < 1 or Wo < 1:
        raise ValueError(f"dense_conv: no output for x {tuple(x.shape)}, "
                         f"kernel {kh}x{kw}, pads {pads}")
    if x.dtype == torch.bfloat16:
        if packed is None:
            packed = pack_dense_weight(w)
        w_arg, bn = packed.data, packed.data.shape[3]
    else:  # the fp32 kernel reads HWIO
        w_arg, bn = _hwio(w).contiguous(), 0
    out = torch.empty((B, Ho, Wo, cout), dtype=x.dtype, device=x.device)
    if out.numel():
        fn = _launch.fn("dense_conv", "ladcast_dense_conv",
                        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 14
                        + [ctypes.c_void_p])
        _launch.check_launch("dense_conv", fn(
            x.data_ptr(), w_arg.data_ptr(), out.data_ptr(), B, H, W, Cin, cout,
            kh, kw, pads[0][0], pads[1][0], Ho, Wo, int(circular_w), bn,
            _launch.DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream))
        dense_conv_forward.launches += 1
    return out


dense_conv_forward.launches = 0


class DenseConv(torch.autograd.Function):
    """:func:`dense_conv_forward` with the VJP of the plain version as its
    backward (``_fwd`` / ``_bwd`` of the JAX module); a packed weight gets
    no gradient."""

    @staticmethod
    def forward(ctx, x, w, pads, circular_w):
        ctx.pads, ctx.circular_w = pads, circular_w
        ctx.packed = w if isinstance(w, PackedDenseWeight) else None
        ctx.save_for_backward(x, None if ctx.packed else w)
        return dense_conv_forward(x, w, pads, circular_w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        if ctx.packed is not None:
            w = ctx.packed.unpack()
        _, pull = _launch.with_vjp(
            lambda xx, ww: dense_conv_plain(xx, ww, ctx.pads, ctx.circular_w),
            (x, w), ctx.needs_input_grad[:2])
        return (*pull(g), None, None)


def dense_conv(x: torch.Tensor, w: Weight, pads: Pads = NO_PAD,
               circular_w: bool = False) -> torch.Tensor:
    """Dense conv, NHWC; ``w`` is HWIO or a :class:`PackedDenseWeight`.
    Differentiable in x and in an HWIO w."""
    return DenseConv.apply(x, w, pads, circular_w)
