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
the kernel's own layout, made once per weight version by
:func:`pack_dense_weight`: one bf16 plane of a bf16 weight, three bf16
planes (hi, mid, lo, each rounded to nearest, summing to the value) of an
fp32 weight, which the fp32 kernel multiplies in six plane products on the
tensor cores. The kernel reads the packed form, and packs an HWIO weight on
the call.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple, Union

import torch
import torch.nn.functional as F

from ladcast_torch.ops import _launch
from ladcast_torch.utils.profiling import count_kernel

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


def conv_flops(out: torch.Tensor, cin: int, kh: int, kw: int) -> int:
    """FLOPs of a conv of ``out`` (B, H_out, W_out, Cout) over ``cin`` input
    channels a group (1 for a depthwise conv) and kh x kw taps: what
    ``FlopCounterMode`` counts of the plain version's ``F.conv2d``."""
    return 2 * out.numel() * cin * kh * kw


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


# The kernel's tiles: output channels per N tile (the wgmma widths it is
# built for, the narrowest that holds Cout, else the widest: 256 in bf16,
# 128 in fp32, whose kernel holds a second accumulator) and input channels
# per step: 64 bf16 values, or 32 fp32 values carried by F32_PLANES bf16
# planes.
N_TILES = (96, 128, 256)
N_TILES_F32 = (96, 128)
K_STEP = 64
K_STEP_F32 = 32
F32_PLANES = 3
# The fp32 kernel's K order inside a step: position 16 k + 8 h + 2 j + e
# holds channel 8 j + 4 k + 2 h + e, so that the values a thread's wgmma A
# fragments hold of one pixel (columns 2 j, +1, +8, +9 of k-steps k = 0, 1)
# are 8 contiguous channels, read with two 16-byte loads.
F32_K_ORDER = tuple(8 * j + 4 * k + 2 * h + e for k in range(2) for h in range(2)
                    for j in range(4) for e in range(2))


def n_tile(cout: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """The N tile of the kernel for ``cout`` output channels of ``dtype``."""
    tiles = N_TILES_F32 if dtype == torch.float32 else N_TILES
    return next((n for n in tiles if cout <= n), tiles[-1])


def _swizzle(t: torch.Tensor) -> torch.Tensor:
    """(..., N, K) rows of K = 64 or 32 bf16 values with the 16-byte chunk j
    of row n moved to chunk j ^ (n K / 64 mod K / 8): the 128-byte swizzle
    of a wgmma K-major operand for rows of 128 bytes (j ^ n % 8), the
    64-byte one for rows of 64 (j ^ (n / 2) % 4). The same moves of 8
    values in any dtype; its own inverse."""
    *lead, n, k = t.shape
    rows = torch.arange(n, device=t.device)[:, None]
    chunks = torch.arange(k // 8, device=t.device)[None, :] ^ (rows * k // 64 % (k // 8))
    return t.reshape(*lead, n, k // 8, 8)[..., rows, chunks, :].reshape(*lead, n, k)


def split_planes(v: torch.Tensor) -> torch.Tensor:
    """fp32 ``v`` as F32_PLANES bf16 planes stacked in a new first
    dimension: hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid),
    each rounded to nearest. Their fp32 sum (hi + mid) + lo is v (8 + 8 + 8
    significant bits) for |v| above about 2^-100."""
    planes, rest = [], v.float()
    for _ in range(F32_PLANES):
        planes.append(rest.bfloat16())
        rest = rest - planes[-1].float()
    return torch.stack(planes)


def packed_shape(dtype: torch.dtype, kh: int, kw: int, cin: int,
                 cout: int) -> Tuple[int, ...]:
    """The shape of :class:`PackedDenseWeight` ``data`` that the kernel
    reads for inputs of ``dtype``."""
    bn = n_tile(cout, dtype)
    if dtype == torch.float32:
        return (-(-cout // bn), -(-cin // K_STEP_F32), kh * kw, F32_PLANES, bn,
                K_STEP_F32)
    return (-(-cout // bn), -(-cin // K_STEP), kh * kw, bn, K_STEP)


@dataclasses.dataclass(frozen=True)
class PackedDenseWeight:
    """A (kh, kw, cin, cout) conv weight in the kernel's layout, one tile
    per (N tile, channel step, tap) in the order the kernel reads them,
    K-major (row n holds the step's input channels of output BN * tile + n)
    and swizzled (:func:`_swizzle`), zero past cin and cout. From a bf16
    weight (or any other but fp32) ``data`` is (N tiles, steps of 64, kh *
    kw, BN, 64) in the weight's dtype; from an fp32 weight it is (N tiles,
    steps of 32, kh * kw, F32_PLANES, BN, 32) bf16: the planes of
    :func:`split_planes`, each step's channels in F32_K_ORDER. It carries no
    gradient."""

    data: torch.Tensor
    kh: int
    kw: int
    cin: int
    cout: int

    @property
    def planes(self) -> int:
        """The bf16 planes that carry each value: 3 for an fp32 weight."""
        return F32_PLANES if self.data.dim() == 6 else 1

    def unpack(self) -> torch.Tensor:
        """The HWIO weight, contiguous (fp32 from three planes: exact)."""
        data = _swizzle(self.data)
        if self.planes > 1:
            hi, mid, lo = data.float().unbind(-3)
            # position of each channel in the step: the inverse order
            data = ((hi + mid) + lo)[..., sorted(range(K_STEP_F32),
                                                 key=F32_K_ORDER.__getitem__)]
        n_t, n_s, taps, bn, k = data.shape
        w = data.permute(2, 1, 4, 0, 3).reshape(self.kh, self.kw, n_s * k, n_t * bn)
        return w[:, :, :self.cin, :self.cout].contiguous()


def pack_dense_weight(w: torch.Tensor) -> PackedDenseWeight:
    """An HWIO weight (kh, kw, cin, cout) in the kernel's layout: three
    bf16 planes of an fp32 weight, one plane of a weight of any other dtype
    (the bf16 kernel reads bf16; the plain version unpacks any)."""
    kh, kw, cin, cout = w.shape
    f32 = w.dtype == torch.float32
    bn, k = n_tile(cout, w.dtype), (K_STEP_F32 if f32 else K_STEP)
    n_t, n_s = -(-cout // bn), -(-cin // k)
    wp = F.pad(w.detach(), (0, n_t * bn - cout, 0, n_s * k - cin))
    wp = wp.reshape(kh * kw, n_s, k, n_t, bn).permute(3, 1, 0, 4, 2)
    if f32:
        wp = split_planes(wp[..., list(F32_K_ORDER)]).movedim(0, -3)
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
    ``launches``, and the fp32 kernel's also in ``f32_launches``; its FLOPs
    reported to ``utils.profiling.count_kernel``), on the
    packed weight, packed here if given HWIO; the plain version on CPU
    tensors. The result carries no gradient."""
    if x.device.type == "cpu":
        return dense_conv_plain(x, w, pads, circular_w)
    packed = w if isinstance(w, PackedDenseWeight) else None
    shape = (packed.kh, packed.kw, packed.cin, packed.cout) if packed else tuple(w.shape)
    if x.dim() != 4 or len(shape) != 4 or shape[2] != x.shape[3]:
        raise ValueError(f"dense_conv: x {tuple(x.shape)}, w {shape}, expected "
                         f"(B, H, W, Cin) and (kh, kw, Cin, Cout)")
    kh, kw, _, cout = shape
    if packed is not None:  # the kernel reads whole tiles of this shape
        want = packed_shape(x.dtype, *shape)
        if tuple(packed.data.shape) != want:
            raise ValueError(f"dense_conv: a packed weight of shape "
                             f"{tuple(packed.data.shape)}, expected {want} for "
                             f"{x.dtype} inputs")
    _launch.check_cuda_inputs("dense_conv", (x,) if packed else (x, w))
    _launch.refuse_grad("dense_conv_forward", (x,) if packed else (x, w), "dense_conv")
    if packed is None:
        packed = pack_dense_weight(w)
    _launch.check_cuda_inputs("dense_conv", (packed.data,))
    if packed.data.device != x.device or packed.data.dtype != torch.bfloat16:
        raise ValueError(f"dense_conv: a packed weight of {packed.data.dtype} on "
                         f"{packed.data.device}, expected bf16 on {x.device}")
    B, H, W, Cin = x.shape
    Ho, Wo = out_hw(x.shape, kh, kw, pads, circular_w)
    if Ho < 1 or Wo < 1:
        raise ValueError(f"dense_conv: no output for x {tuple(x.shape)}, "
                         f"kernel {kh}x{kw}, pads {pads}")
    out = torch.empty((B, Ho, Wo, cout), dtype=x.dtype, device=x.device)
    if out.numel():
        fn = _launch.fn("dense_conv", "ladcast_dense_conv",
                        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 14
                        + [ctypes.c_void_p])
        _launch.check_launch("dense_conv", fn(
            x.data_ptr(), packed.data.data_ptr(), out.data_ptr(), B, H, W, Cin, cout,
            kh, kw, pads[0][0], pads[1][0], Ho, Wo, int(circular_w),
            n_tile(cout, x.dtype), _launch.DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream))
        dense_conv_forward.launches += 1
        count_kernel("dense_conv", conv_flops(out, Cin, kh, kw))
        if x.dtype == torch.float32:
            dense_conv_forward.f32_launches += 1
    return out


dense_conv_forward.launches = 0  # every launch
dense_conv_forward.f32_launches = 0  # those of the fp32 kernel


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
