"""The plain float32 reference of the LaDCast DiT (tonyzyl/ladcast
``LaDCastTransformer3DModel``, a HunyuanVideo-style dual-stream /
single-stream transformer over latent frames), as functions of a state
dict in the published parameter names.

  latents (B, T, H, W, C) and a conditioning latent (B, T_in, H, W, C)
  -> 1x1x1 patch embeds -> conditioning token refiner
  -> dual-stream blocks (separate QKV, joint attention)
  -> single-stream blocks (one QKV over both streams, parallel MLP)
  -> AdaLN-continuous head -> (B, T, H, W, C_out)

Written from the model's published description and parameter layout, with
plain softmax attention; it imports nothing of the program. The details
the weights depend on: the dual-stream attention rotates the latent
stream only (the conditioning stream is RMS-normed with its own weights);
single-stream and refiner attentions have no output projection; RoPE
rotates interleaved pairs over (t, lat, lon) axes; LayerNorm eps is 1e-6
inside AdaLN-Zero and 1e-7 elsewhere; the head splits scale, then shift.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.numerics import FP32, Numerics

P = Dict[str, torch.Tensor]


def inner_dim(cfg: dict) -> int:
    return cfg["num_attention_heads"] * cfg["attention_head_dim"]


def param_spec(cfg: dict) -> List[Tuple[str, tuple, str, int]]:
    """(name, shape, init, fan_in) of every parameter: init is "normal"
    (std 1/sqrt(fan_in)), "zeros" or "ones"."""
    D, hd, C = inner_dim(cfg), cfg["attention_head_dim"], cfg["in_channels"]
    mlp = int(D * cfg["mlp_ratio"])
    out: List[Tuple[str, tuple, str, int]] = []

    def lin(name, n_in, n_out, bias=True, shape=None):
        out.append((f"{name}.weight", shape or (n_out, n_in), "normal", n_in))
        if bias:
            out.append((f"{name}.bias", (n_out,), "zeros", 0))

    def norm(name, dim, bias=True):
        out.append((f"{name}.weight", (dim,), "ones", 0))
        if bias:
            out.append((f"{name}.bias", (dim,), "zeros", 0))

    def embedder(name, n_in, n_out):
        lin(f"{name}.linear_1", n_in, n_out)
        lin(f"{name}.linear_2", n_out, n_out)

    lin("x_embedder.proj", C, D, shape=(D, C, 1, 1, 1))
    lin("context_embedder.proj", cfg["conditioning_tensor_in_channels"], D,
        shape=(D, cfg["conditioning_tensor_in_channels"], 1, 1, 1))
    r = "context_refiner"
    embedder(f"{r}.time_text_embed.timestep_embedder", 256, D)
    embedder(f"{r}.time_text_embed.text_embedder", D, D)
    lin(f"{r}.proj_in", D, D)
    for i in range(cfg["num_refiner_layers"]):
        b = f"{r}.token_refiner.refiner_blocks.{i}"
        norm(f"{b}.norm1", D)
        for q in ("to_q", "to_k", "to_v"):
            lin(f"{b}.attn.{q}", D, D)
        norm(f"{b}.attn.norm_q", hd, bias=False)
        norm(f"{b}.attn.norm_k", hd, bias=False)
        lin(f"{b}.norm_out.linear", D, 2 * D)
        norm(f"{b}.norm2", D)
        lin(f"{b}.ff.net.0.proj", D, 4 * D)
        lin(f"{b}.ff.net.2", 4 * D, D)
    embedder("time_text_embed.timestep_embedder", 256, D)
    embedder("time_text_embed.text_embedder", D, D)
    if cfg["incl_time_elapsed"]:
        embedder("time_elapsed_embed", 256, 2 * D)
    for i in range(cfg["num_layers"]):
        b = f"transformer_blocks.{i}"
        lin(f"{b}.norm1.linear", D, 6 * D)
        lin(f"{b}.norm1_context.linear", D, 6 * D)
        for q in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj"):
            lin(f"{b}.attn.{q}", D, D)
        for n in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            norm(f"{b}.attn.{n}", hd, bias=False)
        lin(f"{b}.attn.to_out.0", D, D)
        lin(f"{b}.attn.to_add_out", D, D)
        for ff in ("ff", "ff_context"):
            lin(f"{b}.{ff}.net.0.proj", D, mlp)
            lin(f"{b}.{ff}.net.2", mlp, D)
    for i in range(cfg["num_single_layers"]):
        b = f"single_transformer_blocks.{i}"
        lin(f"{b}.norm.linear", D, 3 * D)
        lin(f"{b}.proj_mlp", D, mlp)
        for q in ("to_q", "to_k", "to_v"):
            lin(f"{b}.attn.{q}", D, D)
        norm(f"{b}.attn.norm_q", hd, bias=False)
        norm(f"{b}.attn.norm_k", hd, bias=False)
        lin(f"{b}.proj_out", D + mlp, D)
    lin("norm_out.linear", D, 2 * D)
    lin("proj_out", D, cfg["out_channels"])
    return out


# -- positions ---------------------------------------------------------------

def rope_tables(cfg: dict, frames: int, height: int, width: int,
                conditioning: bool, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(S, head_dim) cos and sin over the (t, lat, lon) grid in C order:
    prediction frames at t = 1..T, conditioning frames at t = -T+1..0;
    lat and lon evenly spaced between the configured positions (degrees,
    converted to radians); each axis takes its share of the head's
    interleaved pairs, frequency theta^(-2i/d)."""
    conv = math.radians if cfg["spatial_deg2rad"] else float
    (lat0, lon0), (lat1, lon1) = ([conv(v) for v in cfg["rope_spatial_grid_start_pos"]],
                                  [conv(v) for v in cfg["rope_spatial_grid_end_pos"]])
    t = (np.arange(-frames + 1, 1) if conditioning else np.arange(1, frames + 1))
    axes = [t.astype(np.float64), np.linspace(lat0, lat1, height),
            np.linspace(lon0, lon1, width)]
    dims = (cfg["conditioning_tensor_rope_axes_dim"] if conditioning
            else cfg["rope_axes_dim"])
    grids = np.meshgrid(*axes, indexing="ij")
    cos, sin = [], []
    for d, g in zip(dims, grids):
        freqs = 1.0 / cfg["rope_theta"] ** (np.arange(0, d, 2) / d)
        ang = np.repeat(np.outer(g.reshape(-1), freqs), 2, axis=1)
        cos.append(np.cos(ang))
        sin.append(np.sin(ang))
    as_t = lambda parts: torch.tensor(np.concatenate(parts, 1), dtype=torch.float32,
                                      device=device)
    return as_t(cos), as_t(sin)


def sinusoid(t: torch.Tensor, dim: int = 256) -> torch.Tensor:
    """The diffusers timestep sinusoid, cos half first (flip_sin_to_cos)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, device=t.device,
                                                        dtype=torch.float32) / half)
    a = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(a), torch.sin(a)], -1)


def year_embedding(yp: torch.Tensor, dim: int = 256) -> torch.Tensor:
    """sin and cos of 2 pi k yp, k = 1..dim/2, magnitudes 10000^(-i/half)."""
    half = dim // 2
    i = torch.arange(half, device=yp.device, dtype=torch.float32)
    a = 2.0 * math.pi * yp.float()[:, None] * (i + 1)[None]
    mag = torch.exp(-math.log(10000.0) * i / half)
    return torch.cat([torch.sin(a) * mag, torch.cos(a) * mag], -1)


# -- pieces ------------------------------------------------------------------

def _ln(x, eps, w=None, b=None):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def _rotate_pairs(x):
    x2 = x.unflatten(-1, (-1, 2))
    return torch.stack([-x2[..., 1], x2[..., 0]], -1).flatten(-2)


def _norm_rope(x, w, cos, sin, eps=1e-7):
    """RMS norm over the head dim times ``w`` (S, D), then the rotation;
    x (B, S, H, D)."""
    x = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w[:, None]
    return x * cos[:, None] + _rotate_pairs(x) * sin[:, None]


def _attention(nm: Numerics, q, k, v):
    """Softmax attention, (B, S, H, D) in and out."""
    logits = nm.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    return nm.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), v)


def _segments(parts, device):
    """cos, sin and norm-weight rows of a token sequence made of segments
    (length, (cos, sin) or None for no rotation, norm weight)."""
    cs, ss, ws = [], [], []
    for n, table, w in parts:
        if table is None:
            cs.append(torch.ones(n, w.shape[0], device=device))
            ss.append(torch.zeros(n, w.shape[0], device=device))
        else:
            cs.append(table[0][:n])
            ss.append(table[1][:n])
        ws.append(w[None].expand(n, -1))
    return torch.cat(cs), torch.cat(ss), torch.cat(ws)


class DiT:
    """forward(latents, c_noise, conditioning, year_progress) of the
    reference over the state dict ``p`` (float32 on one device)."""

    def __init__(self, cfg: dict, p: P, nm: Numerics = FP32):
        self.cfg, self.p, self.nm = cfg, p, nm
        self.heads = cfg["num_attention_heads"]

    def lin(self, name, x, bias=True):
        w = self.p[f"{name}.weight"]
        return self.nm.linear(x, w.flatten(1) if w.dim() > 2 else w,
                              self.p.get(f"{name}.bias") if bias else None)

    def embedder(self, name, x):
        return self.lin(f"{name}.linear_2", F.silu(self.lin(f"{name}.linear_1", x)))

    def heads_of(self, x):
        return x.unflatten(-1, (self.heads, -1))

    def attend(self, q, k, v, qparts, kparts):
        qc, qs, qw = _segments(qparts, q.device)
        kc, ks, kw = _segments(kparts, q.device)
        out = _attention(self.nm, _norm_rope(q, qw, qc, qs),
                         _norm_rope(k, kw, kc, ks), v)
        return out.flatten(2)

    def refiner(self, x, c_noise, table):
        r = "context_refiner"
        temb = (self.embedder(f"{r}.time_text_embed.timestep_embedder", sinusoid(c_noise))
                + self.embedder(f"{r}.time_text_embed.text_embedder", x.mean(1)))
        h = self.lin(f"{r}.proj_in", x)
        n = h.shape[1]
        for i in range(self.cfg["num_refiner_layers"]):
            b = f"{r}.token_refiner.refiner_blocks.{i}"
            y = _ln(h, 1e-7, self.p[f"{b}.norm1.weight"], self.p[f"{b}.norm1.bias"])
            q, k, v = (self.heads_of(self.lin(f"{b}.attn.{t}", y))
                       for t in ("to_q", "to_k", "to_v"))
            a = self.attend(q, k, v, [(n, table, self.p[f"{b}.attn.norm_q.weight"])],
                            [(n, table, self.p[f"{b}.attn.norm_k.weight"])])
            g_msa, g_mlp = self.lin(f"{b}.norm_out.linear", F.silu(temb)).chunk(2, -1)
            h = h + a * g_msa[:, None]
            y = _ln(h, 1e-7, self.p[f"{b}.norm2.weight"], self.p[f"{b}.norm2.bias"])
            ff = self.lin(f"{b}.ff.net.2", F.silu(self.lin(f"{b}.ff.net.0.proj", y)))
            h = h + ff * g_mlp[:, None]
        return h

    def dual(self, i, x, c, temb, table):
        b, p = f"transformer_blocks.{i}", self.p
        m = self.lin(f"{b}.norm1.linear", F.silu(temb)).chunk(6, -1)
        mc = self.lin(f"{b}.norm1_context.linear", F.silu(temb)).chunk(6, -1)
        nx = _ln(x, 1e-6) * (1 + m[1][:, None]) + m[0][:, None]
        nc = _ln(c, 1e-6) * (1 + mc[1][:, None]) + mc[0][:, None]
        nl, ncd = x.shape[1], c.shape[1]
        qkv = [torch.cat([self.heads_of(self.lin(f"{b}.attn.{t}", nx)),
                          self.heads_of(self.lin(f"{b}.attn.{a}", nc))], 1)
               for t, a in (("to_q", "add_q_proj"), ("to_k", "add_k_proj"),
                            ("to_v", "add_v_proj"))]
        a = self.attend(*qkv,
                        [(nl, table, p[f"{b}.attn.norm_q.weight"]),
                         (ncd, None, p[f"{b}.attn.norm_added_q.weight"])],
                        [(nl, table, p[f"{b}.attn.norm_k.weight"]),
                         (ncd, None, p[f"{b}.attn.norm_added_k.weight"])])
        x = x + self.lin(f"{b}.attn.to_out.0", a[:, :nl]) * m[2][:, None]
        c = c + self.lin(f"{b}.attn.to_add_out", a[:, nl:]) * mc[2][:, None]
        gelu = lambda t: F.gelu(t, approximate="tanh")
        nx = _ln(x, 1e-7) * (1 + m[4][:, None]) + m[3][:, None]
        nc = _ln(c, 1e-7) * (1 + mc[4][:, None]) + mc[3][:, None]
        x = x + self.lin(f"{b}.ff.net.2", gelu(self.lin(f"{b}.ff.net.0.proj", nx))) * m[5][:, None]
        c = c + self.lin(f"{b}.ff_context.net.2",
                         gelu(self.lin(f"{b}.ff_context.net.0.proj", nc))) * mc[5][:, None]
        return x, c

    def single(self, i, x, c, temb, table, ctable):
        b, p = f"single_transformer_blocks.{i}", self.p
        res = torch.cat([x, c], 1)
        shift, scale, gate = self.lin(f"{b}.norm.linear", F.silu(temb)).chunk(3, -1)
        h = _ln(res, 1e-6) * (1 + scale[:, None]) + shift[:, None]
        mlp = F.gelu(self.lin(f"{b}.proj_mlp", h), approximate="tanh")
        q, k, v = (self.heads_of(self.lin(f"{b}.attn.{t}", h))
                   for t in ("to_q", "to_k", "to_v"))
        nl, ncd = x.shape[1], c.shape[1]
        wq, wk = p[f"{b}.attn.norm_q.weight"], p[f"{b}.attn.norm_k.weight"]
        a = self.attend(q, k, v, [(nl, table, wq), (ncd, ctable, wq)],
                        [(nl, table, wk), (ncd, ctable, wk)])
        out = gate[:, None] * self.lin(f"{b}.proj_out", torch.cat([a, mlp], 2)) + res
        return out[:, :nl], out[:, nl:]

    def __call__(self, latents, c_noise, conditioning, year_progress):
        cfg = self.cfg
        B, T, H, W, C = latents.shape
        Tin = conditioning.shape[1]
        dev = latents.device
        c_noise = c_noise.reshape(-1).expand(B).float()
        table = rope_tables(cfg, T, H, W, False, dev)
        ctable = rope_tables(cfg, Tin, H, W, True, dev)
        x = self.lin("x_embedder.proj", latents.reshape(B, T * H * W, C))
        c = self.lin("context_embedder.proj", conditioning.reshape(B, Tin * H * W, -1))
        c = self.refiner(c, c_noise, ctable)
        temb = (self.embedder("time_text_embed.timestep_embedder", sinusoid(c_noise))
                + self.embedder("time_text_embed.text_embedder", c.mean(1)))
        if cfg["incl_time_elapsed"]:
            ye = self.embedder("time_elapsed_embed",
                               year_embedding(year_progress.reshape(-1).expand(B)))
            scale, shift = ye.chunk(2, -1)
            temb = temb * (1 + scale) + shift
        for i in range(cfg["num_layers"]):
            x, c = self.dual(i, x, c, temb, table)
        for i in range(cfg["num_single_layers"]):
            x, c = self.single(i, x, c, temb, table, ctable)
        scale, shift = self.lin("norm_out.linear", F.silu(temb)).chunk(2, -1)
        x = _ln(x, 1e-7) * (1 + scale[:, None]) + shift[:, None]
        return self.lin("proj_out", x).reshape(B, T, H, W, cfg["out_channels"])
