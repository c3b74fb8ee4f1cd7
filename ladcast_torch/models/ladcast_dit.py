"""LaDCast AR diffusion transformer in PyTorch.

The port of ``ladcast_tpu/models/ladcast_dit.py`` (the reference
``LaDCastTransformer3DModel``, a HunyuanVideo-derived dual-stream /
single-stream DiT over latent frames):

  latent (B, T, 15, 30, 84) + conditioning latent (B, T_in, 15, 30, 84)
  -> 1x1x1 patch embeds -> conditioning token refiner
  -> N dual-stream blocks (separate QKV, joint attention)
  -> M single-stream blocks (the joint [latent; cond] stream, parallel MLP)
  -> AdaLN-continuous head -> (B, T, 15, 30, 84)

Quirks the weights depend on, kept as in the reference:
  * dual-stream attention rotates the latent stream only; the conditioning
    stream is qk-normed with its own weights and enters un-rotated;
  * single-stream and refiner attentions have no output projection;
  * the temb (time/text embed + year FiLM) is computed in fp32, through
    the (possibly bf16-stored) Dense weights;
  * LayerNorm eps is 1e-6 inside AdaLN-Zero and 1e-7 elsewhere;
  * the AdaLN-continuous head splits scale first, then shift.

Frames are channels-last (B, T, H, W, C); tokens (B, S, D); attention BSHD.
Parameter names are the reference diffusers ones. With ``cfg.remat`` each
dual- and single-stream block is a gradient checkpoint while grad is on (a
block that is an FSDP unit checkpoints itself inside its unit).
With ``cfg.int8_matmuls`` the projections the JAX package quantises run
as int8 products (``ops.quant.QuantizableDense``): the dual-stream
blocks' q/k/v, added q/k/v, output projections and both feed-forwards,
the single-stream blocks' q/k/v, ``proj_mlp`` and ``proj_out``; the
refiner, the AdaLN linears, the embedders and the top-level projections
stay in float. Where no input needs a gradient, the dual- and
single-stream blocks' and the head's LayerNorms, modulations, gates and
residual adds run as one pass per step (``ops.adaln_glue``, K7), and on
CUDA tensors the feed-forwards' and ``proj_mlp``'s tanh GELU runs in their
GEMM's epilogue (``ops.gelu_gemm``).

The single-stream blocks take and return the joint [latent; cond] stream
whole: it is concatenated once, before the first of them, and the head
reads its latent tokens as a view. ``proj_out`` reads the attention output
and the MLP activation through the two column blocks of its weight, two
GEMMs into one output, rather than one GEMM over their concatenation
(the int8 path, which scales each concatenated row as one, keeps the
concatenation).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.distributed.fsdp import FSDPModule
from torch.utils.checkpoint import checkpoint

from ladcast_torch.config import LaDCastDiTConfig
from ladcast_torch.metrics.weights import cos_lat_weights
from ladcast_torch.models.layers import (
    Affine,
    Dense,
    SiluLinear,
    build_module,
    dense,
    init_flax_defaults_,
)
from ladcast_torch.ops import adaln_glue as glue
from ladcast_torch.ops import rope as rope_ops
from ladcast_torch.ops.attention import norm_rope_attention
from ladcast_torch.ops.embeddings import timestep_embedding, year_sincos_embedding
from ladcast_torch.ops.gelu_gemm import dense_gelu_tanh
from ladcast_torch.ops.norms import layer_norm
from ladcast_torch.ops.quant import QuantizableDense
from ladcast_torch.utils.profiling import span, spanned

_gelu_tanh = functools.partial(F.gelu, approximate="tanh")


# ---------------------------------------------------------------------------
# Small shared pieces
# ---------------------------------------------------------------------------

class PatchEmbed(nn.Module):
    """1x1x1 Conv3d patch embed, applied to tokens as a Dense."""

    def __init__(self, in_channels: int, dim: int):
        super().__init__()
        self.proj = nn.Conv3d(in_channels, dim, 1)

    def forward(self, x):
        return dense(x, self.proj.weight.flatten(1), self.proj.bias)


class TimestepEmbedder(nn.Module):
    """diffusers TimestepEmbedding: Linear -> SiLU -> Linear."""

    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = Dense(in_dim, dim)
        self.linear_2 = Dense(dim, dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class CombinedTimestepTextProj(nn.Module):
    """256-dim sinusoid of the (c_noise) timestep through an MLP, plus a
    projected pooled embedding."""

    def __init__(self, dim: int, pooled_dim: int):
        super().__init__()
        self.timestep_embedder = TimestepEmbedder(256, dim)
        self.text_embedder = TimestepEmbedder(pooled_dim, dim)

    def forward(self, timestep, pooled):
        t = timestep_embedding(timestep, 256, flip_sin_to_cos=True,
                               downscale_freq_shift=0.0)
        return self.timestep_embedder(t.to(pooled.dtype)) + self.text_embedder(pooled)


def _dense_gelu_tanh(proj: QuantizableDense, x):
    """``gelu_tanh(proj(x))``: the GELU in the GEMM's epilogue where
    ``ops.gelu_gemm`` takes it; an int8 ``proj`` keeps its own product."""
    if proj.quant:
        return _gelu_tanh(proj(x))
    return dense_gelu_tanh(x, proj.weight, proj.bias)


class _ProjAct(nn.Module):
    def __init__(self, dim: int, inner: int, act, quant: bool = False):
        super().__init__()
        self.proj = QuantizableDense(dim, inner, quant=quant)
        self.act = act

    def forward(self, x):
        if self.act is _gelu_tanh:
            return _dense_gelu_tanh(self.proj, x)
        return self.act(self.proj(x))


class FeedForward(nn.Module):
    """diffusers FeedForward: ``net.0.proj`` -> act -> ``net.2``; both
    projections int8 with ``quant``. The tanh GELU (``_gelu_tanh``) runs
    in the up-projection's epilogue where it can."""

    def __init__(self, dim: int, mult: float, act, quant: bool = False):
        super().__init__()
        inner = int(dim * mult)
        self.net = nn.ModuleList([_ProjAct(dim, inner, act, quant), nn.Identity(),
                                  QuantizableDense(inner, dim, quant=quant)])

    @spanned("dit.mlp")
    def forward(self, x):
        return self.net[2](self.net[0](x))


def _split_heads(x, num_heads):  # (B, S, H*D) -> (B, S, H, D)
    return x.unflatten(-1, (num_heads, -1))


def segment_tables(segments):
    """(S, D) fp32 cos/sin/weight tables from segments (length, rope table
    or None for identity rows, norm weight)."""
    cos_parts, sin_parts, w_parts = [], [], []
    for length, table, w in segments:
        w = w.float()
        if table is None:
            cos_parts.append(w.new_ones(length, w.shape[-1]))
            sin_parts.append(w.new_zeros(length, w.shape[-1]))
        else:
            cos_parts.append(table[0][:length])
            sin_parts.append(table[1][:length])
        w_parts.append(w[None].expand(length, -1))
    return tuple(torch.cat(p).contiguous() for p in (cos_parts, sin_parts, w_parts))


def cached_segment_tables(cache: dict, side: str, segments):
    """:func:`segment_tables`, kept in ``cache[side]`` while the token
    counts, the RoPE tables and the norm weights stay the same: they are
    fixed at inference. An in-place change of a weight (``load_state_dict``)
    bumps its version and rebuilds them. Nothing is kept with grad on, nor
    for inference-mode weights, which carry no version."""
    weights = [w for _, _, w in segments]
    if torch.is_grad_enabled() or any(w.is_inference() for w in weights):
        return segment_tables(segments)
    key = tuple((n, None if t is None else t[0].data_ptr(), w.device,
                 w.data_ptr(), w._version) for n, t, w in segments)
    hit = cache.get(side)
    if hit is None or hit[0] != key:
        hit = cache[side] = (key, segment_tables(segments))
    return hit[1]


# ---------------------------------------------------------------------------
# Attention variants: all funnel into ops.attention.norm_rope_attention
# ---------------------------------------------------------------------------

class JointAttention(nn.Module):
    """Dual-stream joint attention: the latent stream rotated, the
    conditioning stream normed with its own weights and not rotated; every
    projection int8 with ``int8``."""

    def __init__(self, num_heads: int, head_dim: int, impl: str,
                 int8: bool = False):
        super().__init__()
        inner = num_heads * head_dim
        self.num_heads, self.impl = num_heads, impl
        for name in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj",
                     "add_v_proj"):
            setattr(self, name, QuantizableDense(inner, inner, quant=int8))
        for name in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            setattr(self, name, Affine(head_dim, bias=False))
        self.to_out = nn.ModuleList([QuantizableDense(inner, inner, quant=int8)])
        self.to_add_out = QuantizableDense(inner, inner, quant=int8)
        self._tables = {}

    @spanned("dit.attention")
    def forward(self, x, cond, rope_table, attn_bias=None):
        n_lat, n_cond = x.shape[1], cond.shape[1]
        h = self.num_heads
        q = torch.cat([_split_heads(self.to_q(x), h),
                       _split_heads(self.add_q_proj(cond), h)], dim=1)
        k = torch.cat([_split_heads(self.to_k(x), h),
                       _split_heads(self.add_k_proj(cond), h)], dim=1)
        v = torch.cat([_split_heads(self.to_v(x), h),
                       _split_heads(self.add_v_proj(cond), h)], dim=1)
        qcos, qsin, qw = cached_segment_tables(
            self._tables, "q", [(n_lat, rope_table, self.norm_q.weight),
                                (n_cond, None, self.norm_added_q.weight)])
        kcos, ksin, kw = cached_segment_tables(
            self._tables, "k", [(n_lat, rope_table, self.norm_k.weight),
                                (n_cond, None, self.norm_added_k.weight)])
        out = norm_rope_attention(q, k, v, qcos, qsin, qw, kcos, ksin, kw,
                                  bias=attn_bias, impl=self.impl)
        out = out.flatten(2).to(x.dtype)
        return self.to_out[0](out[:, :n_lat]), self.to_add_out(out[:, n_lat:])


class ConcatStreamAttention(nn.Module):
    """Single-stream attention: shared QKV over the joint [latent; cond]
    tokens, each segment rotated with its own table; no output projection;
    q/k/v int8 with ``int8``."""

    def __init__(self, num_heads: int, head_dim: int, impl: str,
                 int8: bool = False):
        super().__init__()
        inner = num_heads * head_dim
        self.num_heads, self.impl = num_heads, impl
        self.to_q, self.to_k, self.to_v = (QuantizableDense(inner, inner, quant=int8)
                                           for _ in range(3))
        self.norm_q = Affine(head_dim, bias=False)
        self.norm_k = Affine(head_dim, bias=False)
        self._tables = {}

    @spanned("dit.attention")
    def forward(self, h, n_cond, rope_table, cond_rope_table, attn_bias=None):
        n_lat = h.shape[1] - n_cond
        q = _split_heads(self.to_q(h), self.num_heads)
        k = _split_heads(self.to_k(h), self.num_heads)
        v = _split_heads(self.to_v(h), self.num_heads)
        qcos, qsin, qw = cached_segment_tables(
            self._tables, "q", [(n_lat, rope_table, self.norm_q.weight),
                                (n_cond, cond_rope_table, self.norm_q.weight)])
        kcos, ksin, kw = cached_segment_tables(
            self._tables, "k", [(n_lat, rope_table, self.norm_k.weight),
                                (n_cond, cond_rope_table, self.norm_k.weight)])
        out = norm_rope_attention(q, k, v, qcos, qsin, qw, kcos, ksin, kw,
                                  bias=attn_bias, impl=self.impl)
        return out.flatten(2).to(h.dtype)


class SelfAttentionPreOnly(nn.Module):
    """Refiner self-attention: QKV + qk-norm + RoPE, no output projection."""

    def __init__(self, num_heads: int, head_dim: int, impl: str):
        super().__init__()
        inner = num_heads * head_dim
        self.num_heads, self.impl = num_heads, impl
        self.to_q, self.to_k, self.to_v = (Dense(inner, inner) for _ in range(3))
        self.norm_q = Affine(head_dim, bias=False)
        self.norm_k = Affine(head_dim, bias=False)
        self._tables = {}

    @spanned("dit.attention")
    def forward(self, x, rope_table, attn_bias=None):
        n = x.shape[1]
        q = _split_heads(self.to_q(x), self.num_heads)
        k = _split_heads(self.to_k(x), self.num_heads)
        v = _split_heads(self.to_v(x), self.num_heads)
        qcos, qsin, qw = cached_segment_tables(
            self._tables, "q", [(n, rope_table, self.norm_q.weight)])
        kcos, ksin, kw = cached_segment_tables(
            self._tables, "k", [(n, rope_table, self.norm_k.weight)])
        out = norm_rope_attention(q, k, v, qcos, qsin, qw, kcos, ksin, kw,
                                  bias=attn_bias, impl=self.impl)
        return out.flatten(2).to(x.dtype)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _modulate(x, shift, scale):
    return x * (1 + scale[:, None]) + shift[:, None]


# The glue between a block's attention and MLPs. Where no input needs a
# gradient (inference) each step is one pass over its rows: K7 on CUDA
# tensors (which raises where it cannot take them), its plain version on
# bf16 or fp32 CPU tensors (ops.adaln_glue); with grad on, the expressions
# autograd differentiates.

def _ln_modulate(x, shift, scale, eps):
    """``LN(x; eps)`` modulated by ``shift`` and ``scale``."""
    if glue.applies((x,), (shift, scale)):
        return glue.ln_modulate(x, shift, scale, eps)
    return _modulate(layer_norm(x, None, None, eps), shift, scale)


def _gated_residual_ln_modulate(x, y, gate, shift, scale, eps):
    """``x + y * gate`` and its LN modulated by ``shift`` and ``scale``."""
    if glue.applies((x, y), (gate, shift, scale)):
        return glue.gated_residual_ln_modulate(x, y, gate, shift, scale, eps)
    x = x + y * gate[:, None]
    return x, _modulate(layer_norm(x, None, None, eps), shift, scale)


def _gated_residual(x, y, gate):
    """``x + y * gate``."""
    if glue.applies((x, y), (gate,)):
        return glue.gated_residual(x, y, gate)
    return x + y * gate[:, None]


class AdaLayerNormZero(nn.Module):
    """SiLU -> Linear(6*dim); LN (eps 1e-6, no affine) modulated."""

    def __init__(self, dim: int):
        super().__init__()
        self.linear = Dense(dim, 6 * dim)

    def forward(self, x, temb):
        (shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp,
         gate_mlp) = self.linear(F.silu(temb)).chunk(6, dim=-1)
        h = _ln_modulate(x, shift_msa, scale_msa, 1e-6)
        return h, gate_msa, shift_mlp, scale_mlp, gate_mlp


class AdaLayerNormZeroSingle(nn.Module):
    """SiLU -> Linear(3*dim); LN (eps 1e-6, no affine) modulated."""

    def __init__(self, dim: int):
        super().__init__()
        self.linear = Dense(dim, 3 * dim)

    def forward(self, x, temb):
        shift_msa, scale_msa, gate = self.linear(F.silu(temb)).chunk(3, dim=-1)
        return _ln_modulate(x, shift_msa, scale_msa, 1e-6), gate


class RefinerBlock(nn.Module):
    def __init__(self, num_heads: int, head_dim: int, mlp_ratio: float,
                 impl: str):
        super().__init__()
        dim = num_heads * head_dim
        self.norm1 = Affine(dim)
        self.attn = SelfAttentionPreOnly(num_heads, head_dim, impl)
        self.norm_out = SiluLinear(dim, 2 * dim)
        self.norm2 = Affine(dim)
        self.ff = FeedForward(dim, mlp_ratio, F.silu)

    @spanned("dit.refiner_block")
    def forward(self, x, temb, rope_table, attn_bias=None):
        h = layer_norm(x, self.norm1.weight, self.norm1.bias, 1e-7)
        attn_out = self.attn(h, rope_table, attn_bias)
        gate_msa, gate_mlp = self.norm_out(temb).chunk(2, dim=-1)
        x = x + attn_out * gate_msa[:, None]
        ff = self.ff(layer_norm(x, self.norm2.weight, self.norm2.bias, 1e-7))
        return x + ff * gate_mlp[:, None]


class _RefinerStack(nn.Module):
    def __init__(self, blocks):
        super().__init__()
        self.refiner_blocks = nn.ModuleList(blocks)


class TokenRefiner(nn.Module):
    """Conditioning token refiner (``context_refiner``)."""

    def __init__(self, dim: int, num_heads: int, head_dim: int,
                 num_layers: int, impl: str):
        super().__init__()
        inner = num_heads * head_dim
        self.time_text_embed = CombinedTimestepTextProj(inner, dim)
        self.proj_in = Dense(dim, inner)
        self.token_refiner = _RefinerStack(
            [RefinerBlock(num_heads, head_dim, 4.0, impl)
             for _ in range(num_layers)])

    def forward(self, x, timestep, rope_table, attn_bias=None):
        temb = self.time_text_embed(timestep, x.mean(dim=1))
        h = self.proj_in(x)
        for block in self.token_refiner.refiner_blocks:
            h = block(h, temb, rope_table, attn_bias)
        return h


class DualStreamBlock(nn.Module):
    def __init__(self, num_heads: int, head_dim: int, mlp_ratio: float,
                 impl: str, int8: bool = False):
        super().__init__()
        dim = num_heads * head_dim
        self.norm1 = AdaLayerNormZero(dim)
        self.norm1_context = AdaLayerNormZero(dim)
        self.attn = JointAttention(num_heads, head_dim, impl, int8)
        self.ff = FeedForward(dim, mlp_ratio, _gelu_tanh, int8)
        self.ff_context = FeedForward(dim, mlp_ratio, _gelu_tanh, int8)

    @spanned("dit.dual_block")
    def forward(self, x, cond, temb, rope_table, attn_bias=None):
        norm_x, gate_msa, shift_mlp, scale_mlp, gate_mlp = self.norm1(x, temb)
        norm_c, c_gate_msa, c_shift_mlp, c_scale_mlp, c_gate_mlp = \
            self.norm1_context(cond, temb)
        attn_x, attn_c = self.attn(norm_x, norm_c, rope_table, attn_bias)
        x, nx = _gated_residual_ln_modulate(x, attn_x, gate_msa, shift_mlp,
                                            scale_mlp, 1e-7)
        cond, nc = _gated_residual_ln_modulate(cond, attn_c, c_gate_msa,
                                               c_shift_mlp, c_scale_mlp, 1e-7)
        x = _gated_residual(x, self.ff(nx), gate_mlp)
        cond = _gated_residual(cond, self.ff_context(nc), c_gate_mlp)
        return x, cond


class SingleStreamBlock(nn.Module):
    def __init__(self, num_heads: int, head_dim: int, mlp_ratio: float,
                 impl: str, int8: bool = False):
        super().__init__()
        dim = num_heads * head_dim
        mlp_dim = int(dim * mlp_ratio)
        self.norm = AdaLayerNormZeroSingle(dim)
        self.proj_mlp = QuantizableDense(dim, mlp_dim, quant=int8)
        self.attn = ConcatStreamAttention(num_heads, head_dim, impl, int8)
        self.proj_out = QuantizableDense(dim + mlp_dim, dim, quant=int8)

    def _proj_out(self, attn_out, mlp_h):
        """``proj_out`` of [attn_out; mlp_h] along the features, without
        their concatenation: the bias and the attention output's column
        block of the weight in one GEMM, the MLP's block added into the
        same output by a second (int8: the concatenation, one scale a
        row)."""
        p = self.proj_out
        if p.quant:
            return p(torch.cat([attn_out, mlp_h], dim=2))
        d = attn_out.shape[-1]
        dt = torch.promote_types(torch.promote_types(attn_out.dtype, p.weight.dtype),
                                 p.bias.dtype)
        w = p.weight.to(dt)
        out = torch.addmm(p.bias.to(dt), attn_out.to(dt).flatten(0, 1),
                          w[:, :d].t())
        out = out.addmm_(mlp_h.to(dt).flatten(0, 1), w[:, d:].t())
        return out.view(*attn_out.shape[:-1], -1)

    @spanned("dit.single_block")
    def forward(self, h, n_cond, temb, rope_table, cond_rope_table,
                attn_bias=None):
        """``h`` the joint [latent; cond] stream (B, S, D), its last
        ``n_cond`` tokens the conditioning's; returns the next joint
        stream."""
        norm_h, gate = self.norm(h, temb)
        with span("dit.mlp"):
            mlp_h = _dense_gelu_tanh(self.proj_mlp, norm_h)
        attn_out = self.attn(norm_h, n_cond, rope_table, cond_rope_table,
                             attn_bias)
        return _gated_residual(h, self._proj_out(attn_out, mlp_h), gate)


# ---------------------------------------------------------------------------
# Top-level model
# ---------------------------------------------------------------------------

def _remat(block: nn.Module, *args):
    """``block(*args)`` as a non-reentrant gradient checkpoint: only its
    inputs are kept, its internals are recomputed in the backward. The
    block's parameters are passed as checkpoint inputs, so the recompute
    sees the tensors the forward saw, also under
    ``torch.func.functional_call`` (whose swap ends before the backward)."""
    names, tensors = zip(*block.named_parameters())

    def run(*flat):
        params = dict(zip(names, flat[:len(names)]))
        return torch.func.functional_call(block, params, flat[len(names):])

    return checkpoint(run, *tensors, *args, use_reentrant=False)


class LaDCastTransformer3D(nn.Module):
    """forward(latents, c_noise, conditioning, year_progress=None):

      latents:       (B, T, H, W, C)  preconditioned noisy prediction frames
      c_noise:       (B,) or (1,)     EDM preconditioned noise level
      conditioning:  (B, T_in, H, W, C) conditioning latent frames
      year_progress: (B,) float in [0, 1), or None

    returns the raw network output F(x), (B, T, H, W, C_out).
    """

    def __init__(self, cfg: LaDCastDiTConfig):
        super().__init__()
        if cfg.patch_size != 1 or cfg.patch_size_t != 1:
            raise NotImplementedError("shipped configs use 1x1x1 patches")
        self.cfg = cfg
        inner, heads, hd = cfg.inner_dim, cfg.num_attention_heads, cfg.attention_head_dim
        impl = cfg.attention_impl
        self.x_embedder = PatchEmbed(cfg.in_channels, inner)
        self.context_embedder = PatchEmbed(cfg.conditioning_tensor_in_channels, inner)
        self.context_refiner = TokenRefiner(inner, heads, hd,
                                            cfg.num_refiner_layers, impl)
        self.time_text_embed = CombinedTimestepTextProj(inner, inner)
        if cfg.incl_time_elapsed:
            self.time_elapsed_embed = TimestepEmbedder(256, 2 * inner)
        int8 = cfg.int8_matmuls
        self.transformer_blocks = nn.ModuleList(
            [DualStreamBlock(heads, hd, cfg.mlp_ratio, impl, int8)
             for _ in range(cfg.num_layers)])
        self.single_transformer_blocks = nn.ModuleList(
            [SingleStreamBlock(heads, hd, cfg.mlp_ratio, impl, int8)
             for _ in range(cfg.num_single_layers)])
        self.norm_out = SiluLinear(inner, 2 * inner)
        self.proj_out = Dense(inner, cfg.out_channels)
        self._tables = {}  # RoPE tables and lat biases, per shape and device
        if self.proj_out.weight.device.type != "meta":
            init_flax_defaults_(self)

    def _rope_tables(self, num_frames, height, width, conditioning, device):
        key = ("rope", num_frames, height, width, conditioning, device)
        if key not in self._tables:
            cfg = self.cfg
            if cfg.nope:
                # temporal-only RoPE over the full head dim, repeated per
                # spatial position
                t = (np.arange(-num_frames + 1, 1, dtype=np.float32)
                     if conditioning else
                     np.arange(1, num_frames + 1, dtype=np.float32))
                cos, sin = rope_ops.rotary_tables_1d(
                    cfg.attention_head_dim, t, cfg.rope_theta)
                cos = np.repeat(cos, height * width, axis=0)
                sin = np.repeat(sin, height * width, axis=0)
            else:
                lat0, lon0 = cfg.rope_spatial_grid_start_rad()
                lat1, lon1 = cfg.rope_spatial_grid_end_rad()
                coords = rope_ops.ladcast_axis_coords(
                    num_frames, height, width, lat0, lat1, lon0, lon1,
                    conditioning=conditioning)
                dims = (cfg.conditioning_tensor_rope_axes_dim if conditioning
                        else cfg.rope_axes_dim)
                cos, sin = rope_ops.multi_axis_rotary_tables(
                    dims, coords, cfg.rope_theta)
            self._tables[key] = (torch.from_numpy(cos).to(device),
                                 torch.from_numpy(sin).to(device))
        return self._tables[key]

    def _lat_attn_bias(self, seq_frames, height, width, device):
        """scale_attn_by_lat additive bias: normalized cos-lat weights per
        key position, (1, 1, 1, S)."""
        key = ("lat_bias", seq_frames, height, width, device)
        if key not in self._tables:
            w = cos_lat_weights(np.linspace(-83.25, 84.75, height))
            w = np.tile(np.repeat(w / w.sum(), width), seq_frames)
            self._tables[key] = torch.as_tensor(
                w, dtype=torch.float32).to(device)[None, None, None, :]
        return self._tables[key]

    @spanned("dit.call")
    def forward(self, latents, c_noise, conditioning, year_progress=None):
        cfg = self.cfg
        B, T, H, W, C = latents.shape
        T_in = conditioning.shape[1]
        dev = latents.device
        c_noise = torch.as_tensor(c_noise, device=dev).reshape(-1).expand(B)

        rope_table = self._rope_tables(T, H, W, False, dev)
        cond_rope_table = self._rope_tables(T_in, H, W, True, dev)
        if cfg.scale_attn_by_lat:
            pred_bias = self._lat_attn_bias(T + T_in, H, W, dev)
            cond_bias = self._lat_attn_bias(T_in, H, W, dev)
        else:
            pred_bias = cond_bias = None

        x = self.x_embedder(latents.reshape(B, T * H * W, C))
        cond = self.context_embedder(conditioning.reshape(B, T_in * H * W, -1))
        cond = self.context_refiner(cond, c_noise, cond_rope_table, cond_bias)

        # temb: an fp32 island, even through bf16-stored weights
        temb = self.time_text_embed(c_noise.float(), cond.mean(dim=1).float())
        if year_progress is not None and cfg.incl_time_elapsed:
            yp = torch.as_tensor(year_progress, device=dev).reshape(-1).expand(B)
            ye = self.time_elapsed_embed(year_sincos_embedding(yp, 256))
            scale, shift = ye.chunk(2, dim=-1)
            temb = temb * (1 + scale) + shift

        # each block gets its own compute-dtype copy of temb, so temb's
        # gradient is one term per block, summed over the blocks in fp32;
        # a block that is an FSDP unit (parallel.sharding_rules.shard_dit)
        # then sums it as a plain module does, and it checkpoints itself
        remat = cfg.remat and torch.is_grad_enabled()
        for block in self.transformer_blocks:
            args = (x, cond, temb.to(latents.dtype), rope_table, pred_bias)
            x, cond = (_remat(block, *args) if remat and not isinstance(block, FSDPModule)
                       else block(*args))
        # the single-stream blocks carry the joint stream whole
        n_lat, n_cond = x.shape[1], cond.shape[1]
        h = torch.cat([x, cond], dim=1)
        for block in self.single_transformer_blocks:
            args = (h, n_cond, temb.to(latents.dtype), rope_table, cond_rope_table,
                    pred_bias)
            h = (_remat(block, *args) if remat and not isinstance(block, FSDPModule)
                 else block(*args))

        scale, shift = self.norm_out(temb.to(latents.dtype)).chunk(2, dim=-1)
        x = _ln_modulate(h[:, :n_lat], shift, scale, 1e-7)
        x = self.proj_out(x)
        return x.reshape(B, T, H, W, cfg.out_channels)


def build_dit(cfg: LaDCastDiTConfig, device="cuda",
              dtype: torch.dtype = torch.float32,
              seed: int = 0) -> LaDCastTransformer3D:
    """A seeded DiT with flax-default weights on ``device`` (CUDA unless the
    caller asks for the CPU)."""
    return build_module(lambda: LaDCastTransformer3D(cfg), device, dtype, seed)
