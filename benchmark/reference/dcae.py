"""The plain float32 reference of the LaDCast deep-compression autoencoder
(tonyzyl/ladcast ``AutoencoderDC`` at configs/DC_AE_84_pretrain.yaml), as
functions of a state dict in the published names, NCHW inside and NHWC at
its two entries.

Stages of [ResBlock, ResBlock, EfficientViTBlock, EfficientViTBlock],
pixel (un)shuffle resampling with channel-mean / repeat shortcuts, and
spherical-boundary 3x3 and 5x5 convolutions: circular in longitude, and
above and below the poles the nearest rows rolled by half the longitude
circle and mirrored, which output rows 0 and H-1 read with their pad
rows' taps flipped in width. The Sana linear attention regroups its
channels into contiguous (query, key, value) blocks of 3 x head_dim.
Every convolution is ``F.conv2d`` on a padded copy; it imports nothing
of the program.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.numerics import FP32, Numerics

P = Dict[str, torch.Tensor]


def _stage_blocks(cfg: dict, side: str):
    """[(kind, width, stage index)] in module order: the encoder's blocks
    and downsamplers, or the decoder's upsamplers and blocks."""
    widths = cfg[f"{side}_block_out_channels"]
    layers = cfg[f"{side}_layers_per_block"]
    types = cfg[f"{side}_block_types"]
    n = len(widths)
    out = []
    if side == "encoder":
        for i in range(n):
            out += [(types[i], widths[i], i)] * layers[i]
            if i < n - 1 and layers[i] > 0:
                out.append(("down", widths[i], i))
    else:
        for i in reversed(range(n)):
            if i < n - 1 and layers[i] > 0:
                out.append(("up", widths[i + 1], i))
            out += [(types[i], widths[i], i)] * layers[i]
    return out


def param_spec(cfg: dict) -> List[Tuple[str, tuple, str, int]]:
    """(name, shape, init, fan_in) of every parameter, as :func:`dit.param_spec`."""
    hd = cfg["attention_head_dim"]
    out: List[Tuple[str, tuple, str, int]] = []

    def conv(name, cin, cout, k=3, bias=True, groups=1, fan_in=None):
        out.append((f"{name}.weight", (cout, cin // groups, k, k), "normal",
                    fan_in or cin // groups * k * k))
        if bias:
            out.append((f"{name}.bias", (cout,), "zeros", 0))

    def norm(name, dim):
        out.append((f"{name}.weight", (dim,), "ones", 0))
        out.append((f"{name}.bias", (dim,), "zeros", 0))

    def block(name, kind, w, scales):
        if kind == "ResBlock":
            conv(f"{name}.conv1", w, w)
            conv(f"{name}.conv2", w, w, bias=False)
            norm(f"{name}.norm", w)
            return
        inner = w // hd * hd
        for q in ("to_q", "to_k", "to_v"):
            out.append((f"{name}.attn.{q}.weight", (inner, w), "normal", w))
        for j, ks in enumerate(scales):
            m = f"{name}.attn.to_qkv_multiscale.{j}"
            conv(f"{m}.proj_in", 3 * inner, 3 * inner, ks, bias=False, groups=3 * inner)
            conv(f"{m}.proj_out", 3 * inner, 3 * inner, 1, bias=False,
                 groups=3 * (w // hd), fan_in=3 * inner)
        out.append((f"{name}.attn.to_out.weight", (w, inner * (1 + len(scales))),
                    "normal", inner * (1 + len(scales))))
        norm(f"{name}.attn.norm_out", w)
        hid = 4 * w
        conv(f"{name}.conv_out.conv_inverted", w, 2 * hid, 1)
        conv(f"{name}.conv_out.conv_depth", 2 * hid, 2 * hid, groups=2 * hid)
        conv(f"{name}.conv_out.conv_point", hid, w, 1, bias=False)
        norm(f"{name}.conv_out.norm", w)

    for side in ("encoder", "decoder"):
        widths = cfg[f"{side}_block_out_channels"]
        scales = cfg[f"{side}_qkv_multiscales"]
        if side == "encoder":
            conv("encoder.conv_in", cfg["in_channels"], widths[0])
        else:
            conv("decoder.conv_in", cfg["latent_channels"], widths[-1])
        key = "down_blocks" if side == "encoder" else "up_blocks"
        for j, (kind, w, i) in enumerate(_stage_blocks(cfg, side)):
            name = f"{side}.{key}.{j}"
            if kind == "down":
                conv(f"{name}.conv", w, widths[i + 1] // 4)
            elif kind == "up":
                conv(f"{name}.conv", w, widths[i] * 4)
            else:
                block(name, kind, w, scales[i])
        if side == "encoder":
            conv("encoder.conv_out", widths[-1], cfg["latent_channels"])
        else:
            norm("decoder.norm_out", widths[0])
            conv("decoder.conv_out", widths[0], cfg["out_channels"])
    return out


def sphere_conv(x, w, b=None, groups=1, nm: Numerics = FP32):
    """NCHW spherical-boundary convolution, 'same' size, odd square kernel."""
    k = w.shape[-1]
    p = k // 2
    H, W = x.shape[-2:]
    top = torch.flip(torch.roll(x[:, :, :p], W // 2, dims=3), dims=[2])
    bot = torch.flip(torch.roll(x[:, :, H - p:], W // 2, dims=3), dims=[2])
    xp = torch.cat([top, x, bot], 2)
    xp = torch.cat([xp[..., W - p:], xp, xp[..., :p]], 3)
    out = nm.conv2d(xp, w, b, groups=groups)
    w_top = torch.cat([torch.flip(w[:, :, :p], dims=[3]), w[:, :, p:]], 2)
    w_bot = torch.cat([w[:, :, :k - p], torch.flip(w[:, :, k - p:], dims=[3])], 2)
    return torch.cat([nm.conv2d(xp[:, :, :k], w_top, b, groups=groups), out[:, :, 1:-1],
                      nm.conv2d(xp[:, :, -k:], w_bot, b, groups=groups)], 2)


def _rms(x, w, b, eps):
    """RMS norm over channels (dim 1) with weight and bias."""
    y = x * torch.rsqrt(x.square().mean(1, keepdim=True) + eps)
    return y * w[:, None, None] + b[:, None, None]


class DCAE:
    """encode(fields NHWC, static HWC) and decode(latent NHWC) of the
    reference over the state dict ``p``."""

    def __init__(self, cfg: dict, p: P, nm: Numerics = FP32):
        self.cfg, self.p, self.nm = cfg, p, nm
        self.hd = cfg["attention_head_dim"]

    def conv(self, name, x, groups=1):
        return sphere_conv(x, self.p[f"{name}.weight"], self.p.get(f"{name}.bias"), groups,
                           self.nm)

    def pointwise(self, name, x):
        """A 1x1 convolution or channel linear as a product over channels."""
        w = self.p[f"{name}.weight"]
        y = self.nm.linear(x.permute(0, 2, 3, 1), w.reshape(w.shape[0], -1),
                           self.p.get(f"{name}.bias"))
        return y.permute(0, 3, 1, 2)

    def resblock(self, name, x):
        h = F.silu(self.conv(f"{name}.conv1", x))
        h = self.conv(f"{name}.conv2", h)
        return _rms(h, self.p[f"{name}.norm.weight"], self.p[f"{name}.norm.bias"], 1e-5) + x

    def linear_attention(self, name, x, scales):
        hd, p = self.hd, self.p
        B, C, H, W = x.shape
        qkv = torch.cat([self.pointwise(f"{name}.to_{t}", x) for t in "qkv"], 1)
        parts = [qkv]
        for j in range(len(scales)):
            m = f"{name}.to_qkv_multiscale.{j}"
            h = sphere_conv(qkv, p[f"{m}.proj_in.weight"], None, qkv.shape[1], self.nm)
            w = p[f"{m}.proj_out.weight"]
            g = qkv.shape[1] // w.shape[1]
            hg = h.permute(0, 2, 3, 1).unflatten(-1, (g, -1))
            parts.append(self.nm.einsum("bhwgi,goi->bhwgo", hg, w.reshape(g, -1, w.shape[1]))
                         .flatten(-2).permute(0, 3, 1, 2))
        full = torch.cat(parts, 1)
        G = full.shape[1] // (3 * hd)
        t = full.permute(0, 2, 3, 1).reshape(B, H * W, G, 3 * hd)
        q, k = F.relu(t[..., :hd]), F.relu(t[..., hd:2 * hd])
        v = F.pad(t[..., 2 * hd:], (0, 1), value=1.0)
        scores = self.nm.einsum("bngi,bngj->bgij", v, k)
        out = self.nm.einsum("bgij,bngj->bngi", scores, q)
        out = out[..., :hd] / (out[..., hd:] + 1e-15)
        out = self.nm.linear(out.reshape(B, H, W, G * hd), p[f"{name}.to_out.weight"])
        out = out.permute(0, 3, 1, 2)
        return _rms(out, p[f"{name}.norm_out.weight"], p[f"{name}.norm_out.bias"], 1e-5) + x

    def glumb(self, name, x):
        h = F.silu(self.pointwise(f"{name}.conv_inverted", x))
        h = self.conv(f"{name}.conv_depth", h, groups=h.shape[1])
        h, gate = h.chunk(2, 1)
        h = self.pointwise(f"{name}.conv_point", h * F.silu(gate))
        return _rms(h, self.p[f"{name}.norm.weight"], self.p[f"{name}.norm.bias"], 1e-7) + x

    def blocks(self, side, key, h):
        cfg = self.cfg
        widths = cfg[f"{side}_block_out_channels"]
        scales = cfg[f"{side}_qkv_multiscales"]
        for j, (kind, w, i) in enumerate(_stage_blocks(cfg, side)):
            name = f"{side}.{key}.{j}"
            if kind == "down":
                y = F.pixel_unshuffle(h, 2)
                h = F.pixel_unshuffle(self.conv(f"{name}.conv", h), 2)
                n = widths[i + 1]
                h = h + y.unflatten(1, (n, -1)).mean(2)
            elif kind == "up":
                rep = widths[i] * 4 // w
                h = (F.pixel_shuffle(self.conv(f"{name}.conv", h), 2)
                     + F.pixel_shuffle(h.repeat_interleave(rep, 1), 2))
            elif kind == "ResBlock":
                h = self.resblock(name, h)
            else:
                h = self.linear_attention(f"{name}.attn", h, scales[i])
                h = self.glumb(f"{name}.conv_out", h)
        return h

    def encode(self, fields, static):
        """fields (B, H, W, C_dyn) normalized, static (H, W, C_static) ->
        (B, h, w, latent) float32."""
        x = torch.cat([fields, static[None].expand(fields.shape[0], -1, -1, -1)], -1)
        h = self.conv("encoder.conv_in", x.permute(0, 3, 1, 2))
        h = self.blocks("encoder", "down_blocks", h)
        z = self.conv("encoder.conv_out", h)
        z = z + h.unflatten(1, (self.cfg["latent_channels"], -1)).mean(2)
        return z.permute(0, 2, 3, 1)

    def decode(self, z):
        """(B, h, w, latent) -> (B, H, W, C_out - C_static) normalized fields."""
        z = z.permute(0, 3, 1, 2)
        h = self.conv("decoder.conv_in", z)
        h = h + z.repeat_interleave(h.shape[1] // z.shape[1], 1)
        h = self.blocks("decoder", "up_blocks", h)
        p = self.p
        h = F.relu(_rms(h, p["decoder.norm_out.weight"], p["decoder.norm_out.bias"], 1e-7))
        y = self.conv("decoder.conv_out", h)
        return y[:, :self.cfg["out_channels"] - self.cfg["static_channels"]].permute(0, 2, 3, 1)
