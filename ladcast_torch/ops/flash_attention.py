"""Fused per-head RMS-norm (qk-norm) + RoPE + flash attention.

The port of ``ladcast_tpu/ops/pallas/flash_attention.py``'s inference
path. Two hand-written CUDA kernels (``ladcast_torch/csrc``), each beside
its plain PyTorch version:

  - :func:`norm_rope` (``csrc/norm_rope.cu``, the TPU ``_norm_rope_kernel``):
    the K-side fp32 RMS-norm x weight row + interleaved RoPE pass.
  - :func:`fused_attention` (``csrc/fused_attention.cu``, the TPU
    ``_fa_fused_kernel``): Q-side norm+RoPE, 1/sqrt(D) scale, cast, then
    online-softmax attention over the pre-normed K.

:func:`fused_norm_rope_attention` chains them as ``_fused_impl`` does.
:func:`composite_norm_rope_attention` is the reference composite
(``_xla_composite`` / ``xla_norm_rope_attention``), which also takes the
additive bias the kernels do not.

Tables are per position, (S, D) fp32: identity rows (cos=1, sin=0) leave a
segment un-rotated, and weight rows let segments carry different norm
weights. Layout is BSHD throughout.

A wrapper given CPU tensors runs its plain version. Given CUDA tensors it
launches its kernel, counting the launch in its ``launches`` attribute, or
raises; it never falls back to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ladcast_torch.ops import _build
from ladcast_torch.ops.rope import rotate_pairs

HEAD_DIM = 128  # the only head size the kernels take
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _norm_rope_f32(x, w, cos, sin, eps):
    """fp32 RMS-norm over D x weight row, then RoPE. x (B, S, H, D); tables
    (S, D)."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    xn = xf * torch.rsqrt(var + eps) * w[:, None, :].float()
    return xn * cos[:, None, :].float() + rotate_pairs(xn) * sin[:, None, :].float()


# --------------------------------------------------------------- K2 -------

def norm_rope_plain(x, w, cos, sin, eps: float = 1e-7):
    """Plain version of :func:`norm_rope`."""
    return _norm_rope_f32(x, w, cos, sin, eps).to(x.dtype)


def norm_rope(x: torch.Tensor, w: torch.Tensor, cos: torch.Tensor,
              sin: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """RMS-norm x weight row + interleaved RoPE of every (b, s, head) row
    of x (B, S, H, D), in fp32, stored in x's dtype."""
    if x.device.type == "cpu":
        return norm_rope_plain(x, w, cos, sin, eps)
    B, S, H, D = x.shape
    _check_cuda("norm_rope", (x,), (w, cos, sin), S)
    out = torch.empty_like(x)
    if out.numel():
        fn = _fn("norm_rope", "ladcast_norm_rope",
                 [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_float,
                                          ctypes.c_int, ctypes.c_void_p])
        _launched("norm_rope", fn(
            x.data_ptr(), out.data_ptr(), w.data_ptr(), cos.data_ptr(),
            sin.data_ptr(), B * S * H, S, H, eps, _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream))
        norm_rope.launches += 1
    return out


norm_rope.launches = 0


# --------------------------------------------------------------- K1 -------

def fused_attention_plain(q, kn, v, qcos, qsin, qw, eps: float = 1e-7):
    """Plain version of :func:`fused_attention`, in the kernel's order:
    Q normed and rotated in fp32, scaled, cast to the input dtype; fp32
    logits; P cast to the input dtype before P.V; fp32 sums."""
    dtype = q.dtype
    scale = 1.0 / (q.shape[-1] ** 0.5)
    qs = (_norm_rope_f32(q, qw, qcos, qsin, eps) * scale).to(dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", qs.float(), kn.float())
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(dtype).float(), v.float())
    return (acc / l).permute(0, 2, 1, 3).to(dtype)


def fused_attention(q: torch.Tensor, kn: torch.Tensor, v: torch.Tensor,
                    qcos: torch.Tensor, qsin: torch.Tensor, qw: torch.Tensor,
                    eps: float = 1e-7) -> torch.Tensor:
    """Softmax attention of norm+RoPE(q) over the pre-normed keys ``kn``.
    q (B, Sq, H, D); kn, v (B, Sk, H, D); Q tables (Sq, D)."""
    if q.device.type == "cpu":
        return fused_attention_plain(q, kn, v, qcos, qsin, qw, eps)
    B, Sq, H, D = q.shape
    Sk = kn.shape[1]
    if kn.shape != (B, Sk, H, D) or v.shape != kn.shape:
        raise ValueError(f"fused_attention: q {tuple(q.shape)}, "
                         f"kn {tuple(kn.shape)}, v {tuple(v.shape)}")
    if Sk == 0:
        raise ValueError("fused_attention: no keys")
    _check_cuda("fused_attention", (q, kn, v), (qcos, qsin, qw), Sq)
    out = torch.empty_like(q)
    if out.numel():
        fn = _fn("fused_attention", "ladcast_fused_attention",
                 [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                 + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                    ctypes.c_void_p])
        _launched("fused_attention", fn(
            q.data_ptr(), kn.data_ptr(), v.data_ptr(), qcos.data_ptr(),
            qsin.data_ptr(), qw.data_ptr(), out.data_ptr(), B, Sq, Sk, H,
            eps, 1.0 / (D ** 0.5), _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream))
        fused_attention.launches += 1
    return out


fused_attention.launches = 0


def fused_norm_rope_attention(q, k, v, qcos, qsin, qw, kcos, ksin, kw,
                              norm_eps: float = 1e-7) -> torch.Tensor:
    """RMS-norm(q, k) -> RoPE -> attention: the K pass once, then the fused
    Q-side kernel (``_fused_impl``'s order)."""
    kn = norm_rope(k, kw, kcos, ksin, norm_eps)
    return fused_attention(q, kn, v, qcos, qsin, qw, norm_eps)


# ------------------------------------------------------------ composite ---

def composite_norm_rope_attention(q, k, v, qcos, qsin, qw, kcos, ksin, kw,
                                  norm_eps: float = 1e-7,
                                  bias: Optional[torch.Tensor] = None):
    """The reference composite. Without bias, normed q/k are cast back to
    the input dtype before fp32 logits (``_xla_composite``); with an
    additive bias (broadcastable to (B, H, Sq, Sk)) they stay fp32
    (``xla_norm_rope_attention``)."""
    qn = _norm_rope_f32(q, qw, qcos, qsin, norm_eps)
    kn = _norm_rope_f32(k, kw, kcos, ksin, norm_eps)
    if bias is None:
        qn, kn = qn.to(q.dtype), kn.to(k.dtype)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", qn.float(), kn.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v).to(q.dtype)


# ------------------------------------------------------------- helpers ----

def _check_cuda(name, tensors, tables, S):
    """What the kernels take: CUDA, contiguous, 16-byte aligned, one
    dtype of bf16/fp32, D = 128, fp32 (S, D) tables on the same device."""
    dev = tensors[0].device
    dtype = tensors[0].dtype
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev}, expected cpu or cuda")
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {dtype}, expected bfloat16 or float32")
    for t in tensors:
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name}: inputs differ in device or dtype")
        if t.dim() != 4 or t.shape[-1] != HEAD_DIM:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"(B, S, H, {HEAD_DIM})")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be contiguous and "
                             f"16-byte aligned")
    for t in tables:
        if (t.device != dev or t.dtype != torch.float32
                or tuple(t.shape) != (S, HEAD_DIM) or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"{name}: tables must be contiguous fp32 "
                             f"({S}, {HEAD_DIM}) on {dev}")


def _fn(lib: str, symbol: str, argtypes):
    fn = getattr(_build.load(lib), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _launched(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
