"""Deep-Compression AutoEncoder (DCAE) for ERA5 in PyTorch.

The port of ``ladcast_tpu/models/dcae.py`` (the reference
``AutoencoderDC`` at the shipped DC_AE_84_pretrain.yaml config): 89 input
channels (84 dynamic + 5 static), an 84-channel latent, 4 stages
[ResBlock, ResBlock, EfficientViTBlock, EfficientViTBlock] of widths
(252, 504, 504, 1008), pixel (un)shuffle resampling with channel-average /
repeat shortcuts, and spherical-boundary convolutions throughout.

Activations are NHWC, as in the JAX package; the sphere convolutions run
on the hand-written conv kernels or, when asked, on ``F.conv2d``
(``ops.sphere.CONV_MODE``). Parameters
keep the reference names and torch layouts: OIHW convs, 1x1 ``Conv2d``s
in GLUMBConv (``conv_inverted``, ``conv_point``, applied as Dense over
channels) and the grouped 1x1 ``proj_out`` of the Sana multiscale
projection.

The Sana linear attention keeps the reference's channel regrouping: the
post-projection reshape takes contiguous 3*head_dim channel blocks as
(query, key, value) whatever their projection role.

Timestep conditioning (``temb_channels``; no shipped config sets it):
``encode``, ``decode`` and ``forward`` take an optional ``time_elapsed``
(B,), embedded by ``timestep_embedder`` (a 256-wide sinusoid, sin and cos
flipped, then Linear-SiLU-Linear) into a (B, temb_channels) vector that
modulates every ResBlock (scale and shift between its convs, from
``time_emb_porj``: the reference's name, typo included, which published
weights use) and every EfficientViT attention (an AdaLayerNormZero-style
pre-norm ``norm_in`` and a gate on its output, from its own
``time_emb_porj``). The embedding and the modulations are fp32 whatever
the parameters' dtype, as in the JAX package, so the activations of a
bf16 model are promoted to fp32 from the first modulated block on (its
later convs run on the fp32 kernels). With ``temb_channels=None`` the
parameters and outputs are those of the unconditioned model.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ladcast_torch.config import DCAEConfig
from ladcast_torch.models.layers import (
    Affine,
    Dense,
    build_module,
    dense,
    init_flax_defaults_,
)
from ladcast_torch.ops.embeddings import timestep_embedding
from ladcast_torch.ops.norms import rms_norm
from ladcast_torch.ops.pixel_shuffle import pixel_shuffle, pixel_unshuffle
from ladcast_torch.ops.sphere import kernel_convs, pack_weight, sphere_conv2d
from ladcast_torch.utils.profiling import span, spanned


class SphereConv(nn.Conv2d):
    """Spherical conv layer: an OIHW kernel (+ optional bias) applied by
    ``sphere_conv2d`` to NHWC activations."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, bias: bool = True, groups: int = 1):
        super().__init__(in_channels, out_channels, kernel_size,
                         groups=groups, bias=bias)
        self._packed = None  # (key, the kernels' layout of the weight)

    def _packed_weight(self, dtype):
        """``pack_weight`` of the weight in ``dtype``, kept while the weight
        stays as it is; None under grad mode, where ``sphere_conv2d`` lays
        the weight out inside the graph, so that its gradient flows."""
        w = self.weight
        if torch.is_grad_enabled():
            return None
        key = (w.data_ptr(), w._version, w.device, dtype)
        if self._packed is None or self._packed[0] != key:
            self._packed = (key, pack_weight(w.detach().to(dtype), self.groups))
        return self._packed[1]

    def forward(self, x):
        # only the kernels read the packed layout
        with span("op.dense_conv" if self.groups == 1 else "op.depthwise_conv"):
            packed = self._packed_weight(x.dtype) if kernel_convs() else None
            return sphere_conv2d(
                x, self.weight.to(x.dtype),
                None if self.bias is None else self.bias.to(x.dtype),
                groups=self.groups, packed=packed)


class Conv1x1(nn.Conv2d):
    """A 1x1 ``Conv2d`` (reference layout) applied as Dense over channels."""

    def __init__(self, in_channels: int, out_channels: int, bias: bool = True):
        super().__init__(in_channels, out_channels, 1, bias=bias)

    def forward(self, x):
        return dense(x, self.weight.flatten(1), self.bias)


class RMSNormLayer(Affine):
    def __init__(self, dim: int, eps: float):
        super().__init__(dim, bias=True)
        self.eps = eps

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps, self.bias)


def _modulation(temb, linear, act, chunks):
    """``chunks`` (B, 1, 1, C) modulations from ``linear(act(temb))``."""
    return [m[:, None, None] for m in linear(act(temb)).chunk(chunks, dim=-1)]


class ResBlock(nn.Module):
    def __init__(self, channels: int, temb_channels: Optional[int] = None):
        super().__init__()
        self.conv1 = SphereConv(channels, channels)
        self.conv2 = SphereConv(channels, channels, bias=False)
        self.norm = RMSNormLayer(channels, 1e-5)
        if temb_channels:
            self.time_emb_porj = Dense(temb_channels, 2 * channels)

    def forward(self, x, temb=None):
        h = F.silu(self.conv1(x))
        if temb is not None:
            scale, shift = _modulation(temb, self.time_emb_porj, F.silu, 2)
            h = h * scale + shift
        return self.norm(self.conv2(h)) + x


class GLUMBConv(nn.Module):
    """Gated inverted-bottleneck conv."""

    def __init__(self, channels: int, expand_ratio: float = 4.0):
        super().__init__()
        hidden = int(expand_ratio * channels)
        self.conv_inverted = Conv1x1(channels, 2 * hidden)
        self.conv_depth = SphereConv(2 * hidden, 2 * hidden, groups=2 * hidden)
        self.conv_point = Conv1x1(hidden, channels, bias=False)
        self.norm = RMSNormLayer(channels, 1e-7)

    def forward(self, x):
        h = self.conv_depth(F.silu(self.conv_inverted(x)))
        h, gate = h.chunk(2, dim=-1)
        h = self.conv_point(h * F.silu(gate))
        return self.norm(h) + x


class SanaMultiscaleProjection(nn.Module):
    """Depthwise sphere conv + grouped 1x1 with 3*heads groups."""

    def __init__(self, channels: int, num_heads: int, kernel_size: int):
        super().__init__()
        self.groups = 3 * num_heads
        self.proj_in = SphereConv(channels, channels, kernel_size,
                                  bias=False, groups=channels)
        self.proj_out = nn.Conv2d(channels, channels, 1, groups=self.groups,
                                  bias=False)
        # flax counts the (g, gs, gs) kernel's fan-in as g * gs
        self.proj_out.flax_fan_in = channels

    def forward(self, qkv):
        h = self.proj_in(qkv)
        g = self.groups
        w = self.proj_out.weight.to(h.dtype).reshape(g, -1, h.shape[-1] // g)
        out = torch.einsum("...gi,goi->...go", h.unflatten(-1, (g, -1)), w)
        return out.flatten(-2)


class AdaLayerNormZeroSingle(nn.Module):
    """The attention's timestep pre-norm: an fp32 LayerNorm (eps 1e-15, no
    affine) of x, scaled and shifted by ``linear(silu(emb))``, which also
    gives the output gate. Returns (modulated x, gate (B, 1, 1, C))."""

    def __init__(self, channels: int):
        super().__init__()
        self.linear = Dense(channels, 3 * channels)

    def forward(self, x, emb):
        shift, scale, gate = _modulation(emb, self.linear, F.silu, 3)
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        xn = ((xf - mu) * torch.rsqrt(var + 1e-15)).to(x.dtype)
        return xn * (1.0 + scale) + shift, gate


class SanaMultiscaleLinearAttention(nn.Module):
    """ReLU linear attention over spatial tokens with the +1-pad
    normalization, in fp32, residual connected. With a timestep embedding
    the residual and the attention's input are the pre-normed x, and the
    gate scales the output projection before ``norm_out``."""

    def __init__(self, channels: int, attention_head_dim: int,
                 kernel_sizes: Tuple[int, ...], eps: float = 1e-15,
                 temb_channels: Optional[int] = None):
        super().__init__()
        self.head_dim = attention_head_dim
        self.eps = eps
        num_heads = channels // attention_head_dim
        inner = num_heads * attention_head_dim
        self.to_q = Dense(channels, inner, bias=False)
        self.to_k = Dense(channels, inner, bias=False)
        self.to_v = Dense(channels, inner, bias=False)
        self.to_qkv_multiscale = nn.ModuleList(
            [SanaMultiscaleProjection(3 * inner, num_heads, ks)
             for ks in kernel_sizes])
        self.to_out = Dense(inner * (1 + len(kernel_sizes)), channels, bias=False)
        self.norm_out = RMSNormLayer(channels, 1e-5)
        if temb_channels:
            self.time_emb_porj = Dense(temb_channels, channels)
            self.norm_in = AdaLayerNormZeroSingle(channels)

    def forward(self, x, temb=None):
        gate = None
        if temb is not None:
            x, gate = self.norm_in(x, self.time_emb_porj(F.relu(temb)))
        B, H, W, C = x.shape
        hd = self.head_dim
        qkv = torch.cat([self.to_q(x), self.to_k(x), self.to_v(x)], dim=-1)
        full = torch.cat([qkv] + [m(qkv) for m in self.to_qkv_multiscale],
                         dim=-1)
        G = full.shape[-1] // (3 * hd)
        t = full.reshape(B, H * W, G, 3 * hd).float()
        qg = F.relu(t[..., :hd])
        kg = F.relu(t[..., hd:2 * hd])
        v_pad = F.pad(t[..., 2 * hd:], (0, 1), value=1.0)  # (B, N, G, hd+1)
        scores = torch.einsum("bngi,bngj->bgij", v_pad, kg)
        out = torch.einsum("bgij,bngj->bngi", scores, qg)
        out = out[..., :hd] / (out[..., hd:] + self.eps)
        out = self.to_out(out.to(x.dtype).reshape(B, H, W, G * hd))
        if gate is not None:
            out = out * gate
        return self.norm_out(out) + x


class EfficientViTBlock(nn.Module):
    def __init__(self, channels: int, attention_head_dim: int,
                 qkv_multiscales: Tuple[int, ...],
                 temb_channels: Optional[int] = None):
        super().__init__()
        self.attn = SanaMultiscaleLinearAttention(
            channels, attention_head_dim, qkv_multiscales,
            temb_channels=temb_channels)
        self.conv_out = GLUMBConv(channels)

    def forward(self, x, temb=None):
        return self.conv_out(self.attn(x, temb))


class DCDownBlock(nn.Module):
    """Pixel-unshuffle downsample with a channel-mean shortcut."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.out_channels = out_channels
        self.conv = SphereConv(in_channels, out_channels // 4)

    def forward(self, x):
        h = pixel_unshuffle(self.conv(x), 2)
        y = pixel_unshuffle(x, 2)
        return h + y.unflatten(-1, (self.out_channels, -1)).mean(-1)


class DCUpBlock(nn.Module):
    """Pixel-shuffle upsample with a repeat shortcut."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.repeats = out_channels * 4 // in_channels
        self.conv = SphereConv(in_channels, out_channels * 4)

    def forward(self, x):
        h = pixel_shuffle(self.conv(x), 2)
        y = pixel_shuffle(x.repeat_interleave(self.repeats, dim=-1), 2)
        return h + y


def _make_block(block_type, channels, attention_head_dim, qkv_multiscales,
                temb_channels):
    if block_type == "ResBlock":
        return ResBlock(channels, temb_channels)
    if block_type == "EfficientViTBlock":
        return EfficientViTBlock(channels, attention_head_dim, qkv_multiscales,
                                 temb_channels)
    raise ValueError(f"unsupported block type {block_type}")


def _run_blocks(blocks, h, temb):
    """The stage blocks take the timestep embedding; the resamplers do not."""
    for block in blocks:
        h = (block(h, temb) if isinstance(block, (ResBlock, EfficientViTBlock))
             else block(h))
    return h


class Encoder(nn.Module):
    def __init__(self, cfg: DCAEConfig):
        super().__init__()
        self.cfg = cfg
        widths = cfg.encoder_block_out_channels
        if cfg.encoder_layers_per_block[0] <= 0:
            raise ValueError("the first encoder stage needs a block")
        self.conv_in = SphereConv(cfg.in_channels, widths[0])
        blocks = []
        for i, (width, n_layers) in enumerate(
                zip(widths, cfg.encoder_layers_per_block)):
            blocks += [_make_block(cfg.encoder_block_types[i], width,
                                   cfg.attention_head_dim,
                                   cfg.encoder_qkv_multiscales[i],
                                   cfg.temb_channels)
                       for _ in range(n_layers)]
            if i < len(widths) - 1 and n_layers > 0:
                blocks.append(DCDownBlock(width, widths[i + 1]))
        self.down_blocks = nn.ModuleList(blocks)
        self.conv_out = SphereConv(widths[-1], cfg.latent_channels)

    def forward(self, x, temb=None):
        h = _run_blocks(self.down_blocks, self.conv_in(x), temb)
        z = self.conv_out(h)
        if not self.cfg.encoder_out_shortcut:
            return z
        return z + h.unflatten(-1, (self.cfg.latent_channels, -1)).mean(-1)


_ACTS = {"relu": F.relu, "silu": F.silu, "relu6": F.relu6,
         "gelu": functools.partial(F.gelu, approximate="tanh"),  # flax's gelu
         "identity": lambda x: x}


class Decoder(nn.Module):
    def __init__(self, cfg: DCAEConfig):
        super().__init__()
        self.cfg = cfg
        widths = cfg.decoder_block_out_channels
        n_stages = len(widths)
        if cfg.decoder_layers_per_block[0] <= 0:
            raise ValueError("the first decoder stage needs a block")
        self.conv_in = SphereConv(cfg.latent_channels, widths[-1])
        blocks = []
        for i in reversed(range(n_stages)):
            n_layers = cfg.decoder_layers_per_block[i]
            if i < n_stages - 1 and n_layers > 0:
                blocks.append(DCUpBlock(widths[i + 1], widths[i]))
            blocks += [_make_block(cfg.decoder_block_types[i], widths[i],
                                   cfg.attention_head_dim,
                                   cfg.decoder_qkv_multiscales[i],
                                   cfg.temb_channels)
                       for _ in range(n_layers)]
        self.up_blocks = nn.ModuleList(blocks)
        self.norm_out = RMSNormLayer(widths[0], 1e-7)
        self.conv_out = SphereConv(widths[0], cfg.out_channels)
        self.act = _ACTS[cfg.decoder_conv_act_fn]

    def forward(self, z, temb=None):
        h = self.conv_in(z)
        if self.cfg.decoder_in_shortcut:
            h = h + z.repeat_interleave(h.shape[-1] // z.shape[-1], dim=-1)
        h = _run_blocks(self.up_blocks, h, temb)
        return self.conv_out(self.act(self.norm_out(h)))


class TimestepEmbedder(nn.Module):
    """A 256-wide sinusoid of the timestep (cos first) through
    Linear-SiLU-Linear: (B,) -> (B, dim), fp32."""

    def __init__(self, dim: int):
        super().__init__()
        self.linear_1 = Dense(256, dim)
        self.linear_2 = Dense(dim, dim)

    def forward(self, t):
        return self.linear_2(F.silu(self.linear_1(timestep_embedding(t, 256))))


class AutoencoderDC(nn.Module):
    """Top-level AE. Public layout is NHWC: ``encode`` appends the static
    channels, ``decode`` strips them unless ``return_static``. With
    ``cfg.temb_channels``, ``time_elapsed`` (B,) conditions both halves
    (or a ready embedding ``temb``, as ``forward`` passes its one)."""

    def __init__(self, cfg: DCAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        if cfg.temb_channels:
            self.timestep_embedder = TimestepEmbedder(cfg.temb_channels)
        if self.encoder.conv_in.weight.device.type != "meta":
            init_flax_defaults_(self)

    def _temb(self, time_elapsed, device):
        if time_elapsed is None:
            return None
        if not self.cfg.temb_channels:
            raise ValueError("time_elapsed given but cfg.temb_channels is unset")
        t = torch.as_tensor(time_elapsed, device=device).reshape(-1)
        return self.timestep_embedder(t)

    @spanned("dcae.encode")
    def encode(self, x, static_conditioning=None, time_elapsed=None, temb=None):
        if static_conditioning is not None:
            if static_conditioning.dim() == 3:
                static_conditioning = static_conditioning[None].expand(
                    x.shape[0], *static_conditioning.shape)
            x = torch.cat([x, static_conditioning.to(x.dtype)], dim=-1)
        if temb is None:
            temb = self._temb(time_elapsed, x.device)
        return self.encoder(x, temb)

    @spanned("dcae.decode")
    def decode(self, z, return_static: bool = False, time_elapsed=None,
               temb=None):
        if temb is None:
            temb = self._temb(time_elapsed, z.device)
        y = self.decoder(z, temb)
        if not return_static and self.cfg.static_channels:
            y = y[..., : -self.cfg.static_channels]
        return y

    def forward(self, x, static_conditioning=None, return_static: bool = False,
                time_elapsed=None):
        # one embedding for both halves
        temb = self._temb(time_elapsed, x.device)
        return self.decode(self.encode(x, static_conditioning, temb=temb),
                           return_static, temb=temb)


def build_dcae(cfg: DCAEConfig, device="cuda",
               dtype: torch.dtype = torch.float32, seed: int = 0) -> AutoencoderDC:
    """A seeded DCAE with flax-default weights on ``device`` (CUDA unless
    the caller asks for the CPU)."""
    return build_module(lambda: AutoencoderDC(cfg), device, dtype, seed)
