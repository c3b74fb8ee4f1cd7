"""Fused per-head RMS-norm (qk-norm) + RoPE + flash attention.

The port of ``ladcast_tpu/ops/pallas/flash_attention.py``. Hand-written
CUDA kernels (``ladcast_torch/csrc``), each beside its plain PyTorch
version:

  - :func:`norm_rope` (``csrc/norm_rope.cu``, the TPU ``_norm_rope_kernel``):
    the K-side fp32 RMS-norm x weight row + interleaved RoPE pass.
  - :func:`fused_attention` (``csrc/fused_attention.cu``, the TPU
    ``_fa_fused_kernel``): Q-side norm+RoPE, 1/sqrt(D) scale, cast, then
    online-softmax attention over the pre-normed K; with
    ``return_lse=True`` also the per-row logsumexp for the backward.
  - :func:`flash_bwd_dq` and :func:`flash_bwd_dkv` (``csrc/flash_bwd.cu``,
    the TPU ``_fa_bwd_dq_kernel`` and ``_fa_bwd_dkv_kernel``): the flash
    backward over the pre-normed q and k; :func:`flash_bwd_plain` is the
    plain version of both, :func:`flash_bwd_dq_plain` and
    :func:`flash_bwd_dkv_plain` of each alone.

:func:`fused_norm_rope_attention` chains the forward kernels as
``_fused_impl`` does, inside :class:`FusedNormRopeAttention`, the
counterpart of the JAX ``custom_vjp``: its backward runs the flash backward
kernels or the VJP of the composite, as :data:`BWD_MODE` says.
:func:`composite_norm_rope_attention` is the reference composite
(``_xla_composite`` / ``xla_norm_rope_attention``), which also takes the
additive bias the kernels do not.

Tables are per position, (S, D) fp32: identity rows (cos=1, sin=0) leave a
segment un-rotated, and weight rows let segments carry different norm
weights. Layout is BSHD throughout.

A wrapper given CPU tensors runs its plain version. Given CUDA tensors it
launches its kernel, counting the launch in its ``launches`` attribute, or
raises; it never falls back to the plain version. A kernel's result carries
no gradient, so a wrapper also raises when a CUDA input requires grad while
grad mode is on: differentiable callers go through
:func:`fused_norm_rope_attention`.
"""

from __future__ import annotations

import ctypes
import functools
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
    _refuse_grad("norm_rope", (x, w, cos, sin))
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

def fused_attention_plain(q, kn, v, qcos, qsin, qw, eps: float = 1e-7,
                          return_lse: bool = False):
    """Plain version of :func:`fused_attention`, in the kernel's order:
    Q normed and rotated in fp32, scaled, cast to the input dtype; fp32
    logits; P cast to the input dtype before P.V; fp32 sums. The lse is
    m + log(l) per row, (B, H, Sq) fp32."""
    dtype = q.dtype
    scale = 1.0 / (q.shape[-1] ** 0.5)
    qs = (_norm_rope_f32(q, qw, qcos, qsin, eps) * scale).to(dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", qs.float(), kn.float())
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(dtype).float(), v.float())
    out = (acc / l).permute(0, 2, 1, 3).to(dtype)
    if return_lse:
        return out, (m + torch.log(l)).squeeze(-1)
    return out


def fused_attention(q: torch.Tensor, kn: torch.Tensor, v: torch.Tensor,
                    qcos: torch.Tensor, qsin: torch.Tensor, qw: torch.Tensor,
                    eps: float = 1e-7, return_lse: bool = False):
    """Softmax attention of norm+RoPE(q) over the pre-normed keys ``kn``.
    q (B, Sq, H, D); kn, v (B, Sk, H, D); Q tables (Sq, D). With
    ``return_lse`` also the rows' logsumexp, (B, H, Sq) fp32 (the launch
    is then also counted in ``lse_launches``)."""
    if q.device.type == "cpu":
        return fused_attention_plain(q, kn, v, qcos, qsin, qw, eps, return_lse)
    B, Sq, H, D = q.shape
    Sk = kn.shape[1]
    if kn.shape != (B, Sk, H, D) or v.shape != kn.shape:
        raise ValueError(f"fused_attention: q {tuple(q.shape)}, "
                         f"kn {tuple(kn.shape)}, v {tuple(v.shape)}")
    if Sk == 0:
        raise ValueError("fused_attention: no keys")
    _check_cuda("fused_attention", (q, kn, v), (qcos, qsin, qw), Sq)
    _refuse_grad("fused_attention", (q, kn, v, qcos, qsin, qw))
    out = torch.empty_like(q)
    lse = (torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel():
        fn = _fn("fused_attention", "ladcast_fused_attention",
                 [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                 + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                    ctypes.c_void_p])
        _launched("fused_attention", fn(
            q.data_ptr(), kn.data_ptr(), v.data_ptr(), qcos.data_ptr(),
            qsin.data_ptr(), qw.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), B, Sq, Sk, H,
            eps, 1.0 / (D ** 0.5), _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream))
        fused_attention.launches += 1
        fused_attention.lse_launches += return_lse
    return (out, lse) if return_lse else out


fused_attention.launches = 0
fused_attention.lse_launches = 0


# --------------------------------------------------------------- K3 -------

def _bwd_p_ds(qn, kn, v, g, lse, delta, scale):
    """fp32 P and dS of the flash backward, dS rounded through the input
    dtype (the kernels cast it before its products)."""
    qf, kf, vf, gf = (t.float() for t in (qn, kn, v, g))
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
                  - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    return p, (p * (dp - delta[..., None])).to(qn.dtype).float()


def _bwd_dq(ds, kn, scale, dtype):
    return (torch.einsum("bhqk,bkhd->bqhd", ds, kn.float()) * scale).to(dtype)


def _bwd_dkv(p, ds, qn, g, scale, dtype):
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qn.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dtype).float(), g.float())
    return dk.to(dtype), dv.to(dtype)


def flash_bwd_plain(qn, kn, v, g, lse, delta, scale: float):
    """Plain version of :func:`flash_bwd_dq` and :func:`flash_bwd_dkv`, in
    the kernels' order: fp32 products of input-dtype operands; P and dS
    in fp32, cast to the input dtype before the products they feed.
    Returns (dq, dk, dv) in the input dtype."""
    p, ds = _bwd_p_ds(qn, kn, v, g, lse, delta, scale)
    return (_bwd_dq(ds, kn, scale, qn.dtype),
            *_bwd_dkv(p, ds, qn, g, scale, qn.dtype))


def flash_bwd_dq_plain(qn, kn, v, g, lse, delta, scale: float):
    """Plain version of :func:`flash_bwd_dq` alone."""
    return _bwd_dq(_bwd_p_ds(qn, kn, v, g, lse, delta, scale)[1], kn, scale,
                   qn.dtype)


def flash_bwd_dkv_plain(qn, kn, v, g, lse, delta, scale: float):
    """Plain version of :func:`flash_bwd_dkv` alone."""
    p, ds = _bwd_p_ds(qn, kn, v, g, lse, delta, scale)
    return _bwd_dkv(p, ds, qn, g, scale, qn.dtype)


def flash_bwd_dq(qn, kn, v, g, lse, delta, scale: float) -> torch.Tensor:
    """dq of softmax attention over the pre-normed ``qn`` (B, Sq, H, D) and
    ``kn`` (B, Sk, H, D), from the forward's ``lse`` and
    ``delta = rowsum(g * out)``, both (B, H, Sq) fp32."""
    if qn.device.type == "cpu":
        return flash_bwd_dq_plain(qn, kn, v, g, lse, delta, scale)
    dq = torch.empty_like(qn)
    _launch_bwd("flash_bwd_dq", "ladcast_flash_bwd_dq",
                (qn, kn, v, g, lse, delta), (dq,), scale)
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(qn, kn, v, g, lse, delta, scale: float):
    """(dk, dv) of the same attention as :func:`flash_bwd_dq`."""
    if qn.device.type == "cpu":
        return flash_bwd_dkv_plain(qn, kn, v, g, lse, delta, scale)
    dk, dv = torch.empty_like(kn), torch.empty_like(v)
    _launch_bwd("flash_bwd_dkv", "ladcast_flash_bwd_dkv",
                (qn, kn, v, g, lse, delta), (dk, dv), scale)
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


def _launch_bwd(name, symbol, inputs, outputs, scale):
    qn, kn, v, g, lse, delta = inputs
    B, Sq, H, D = qn.shape
    Sk = kn.shape[1]
    if kn.shape != (B, Sk, H, D) or v.shape != kn.shape or g.shape != qn.shape:
        raise ValueError(f"{name}: qn {tuple(qn.shape)}, kn {tuple(kn.shape)}, "
                         f"v {tuple(v.shape)}, g {tuple(g.shape)}")
    if Sk == 0:
        raise ValueError(f"{name}: no keys")
    _check_cuda(name, (qn, kn, v, g), (), Sq)
    for t in (lse, delta):
        if (t.device != qn.device or t.dtype != torch.float32
                or tuple(t.shape) != (B, H, Sq) or not t.is_contiguous()):
            raise ValueError(f"{name}: lse and delta must be contiguous fp32 "
                             f"({B}, {H}, {Sq}) on {qn.device}")
    _refuse_grad(name, inputs)
    if not qn.numel():
        return
    fn = _fn("flash_bwd", symbol, [ctypes.c_void_p] * (6 + len(outputs))
             + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                     ctypes.c_void_p])
    _launched(name, fn(*(t.data_ptr() for t in inputs + outputs), B, Sq, Sk,
                       H, scale, _DTYPE_CODES[qn.dtype],
                       torch.cuda.current_stream(qn.device).cuda_stream))


# ------------------------------------------------------------- autograd ---

# Which backward the fused attention runs (JAX: BWD_MODE, whose "pallas"
# is "kernel" here and "xla" is "composite"). "kernel", the default, runs
# the flash backward kernels at every length; the JAX package's length
# threshold, set from TPU timings, is not kept (the H100's training step
# is faster with the kernels at 2250 tokens, see PERF.md). "composite"
# runs the VJP of the composite below: an explicit choice, for the A/B in
# chip_smoke.py and the parity tests.
BWD_MODE = "kernel"  # "kernel" | "composite"


def _kernel_backward() -> bool:
    if BWD_MODE not in ("kernel", "composite"):
        raise ValueError(f"BWD_MODE {BWD_MODE!r}: expected 'kernel' or "
                         f"'composite'")
    return BWD_MODE == "kernel"


def _with_vjp(fn, args, needs):
    """fn(*args), detached, and its pullback to the args flagged in needs
    (None for the others)."""
    xs = [a.detach().requires_grad_(n) for a, n in zip(args, needs)]
    with torch.enable_grad():
        y = fn(*xs)

    def pull(cotangent):
        wrt = [x for x, n in zip(xs, needs) if n]
        got = iter(torch.autograd.grad(y, wrt, cotangent) if wrt else ())
        return [next(got) if n else None for n in needs]

    return y.detach(), pull


class FusedNormRopeAttention(torch.autograd.Function):
    """``fused_norm_rope_attention`` with its backward (``_fnra_fwd`` /
    ``_fnra_bwd``). The forward runs K2 on k, then K1, with the lse rows
    when the kernel backward will run. The kernel backward recomputes the
    normed q and k in fp32 under autograd, runs K3 over them (cast to the
    input dtype) with delta = rowsum(g * out), and pulls dq and dk back
    through the norm+RoPE to q, k and the tables; the composite backward
    is the VJP of the recomputed composite. Both give a gradient to every
    input that needs one."""

    @staticmethod
    def forward(ctx, q, k, v, qcos, qsin, qw, kcos, ksin, kw, norm_eps,
                need_lse):
        kn = norm_rope(k, kw, kcos, ksin, norm_eps)
        if need_lse:
            out, lse = fused_attention(q, kn, v, qcos, qsin, qw, norm_eps,
                                       return_lse=True)
        else:
            out, lse = fused_attention(q, kn, v, qcos, qsin, qw, norm_eps), None
        ctx.norm_eps = norm_eps
        ctx.save_for_backward(q, k, v, qcos, qsin, qw, kcos, ksin, kw, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, qcos, qsin, qw, kcos, ksin, kw, out, lse = ctx.saved_tensors
        eps, needs = ctx.norm_eps, ctx.needs_input_grad[:9]
        g = g.to(q.dtype).contiguous()
        if lse is None:
            _, pull = _with_vjp(
                functools.partial(composite_norm_rope_attention, norm_eps=eps),
                (q, k, v, qcos, qsin, qw, kcos, ksin, kw), needs)
            return (*pull(g), None, None)
        nr = functools.partial(_norm_rope_f32, eps=eps)
        qn, pull_q = _with_vjp(nr, (q, qw, qcos, qsin),
                               (needs[0], needs[5], needs[3], needs[4]))
        kn, pull_k = _with_vjp(nr, (k, kw, kcos, ksin),
                               (needs[1], needs[8], needs[6], needs[7]))
        delta = torch.einsum("bqhd,bqhd->bhq", g.float(), out.float()).contiguous()
        qn, kn = qn.to(q.dtype), kn.to(k.dtype)
        scale = 1.0 / (q.shape[-1] ** 0.5)
        dqn = flash_bwd_dq(qn, kn, v, g, lse, delta, scale)
        dkn, dv = flash_bwd_dkv(qn, kn, v, g, lse, delta, scale)
        dq, dqw, dqcos, dqsin = pull_q(dqn.float())
        dk, dkw, dkcos, dksin = pull_k(dkn.float())
        return (dq, dk, dv if needs[2] else None, dqcos, dqsin, dqw,
                dkcos, dksin, dkw, None, None)


def fused_norm_rope_attention(q, k, v, qcos, qsin, qw, kcos, ksin, kw,
                              norm_eps: float = 1e-7) -> torch.Tensor:
    """RMS-norm(q, k) -> RoPE -> attention: the K pass once, then the fused
    Q-side kernel (``_fused_impl``'s order), differentiable through
    :class:`FusedNormRopeAttention`. The lse rows are computed only when a
    gradient will be asked for and the kernel backward is chosen; the
    backward follows the mode chosen at the forward."""
    args = (q, k, v, qcos, qsin, qw, kcos, ksin, kw)
    need_lse = (torch.is_grad_enabled() and any(t.requires_grad for t in args)
                and _kernel_backward())
    return FusedNormRopeAttention.apply(*args, norm_eps, need_lse)


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


def _refuse_grad(name, tensors):
    """A kernel's result has no grad_fn: refuse rather than drop the
    gradient silently."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: a CUDA input requires grad, and the kernel's result "
            f"would carry no gradient; call fused_norm_rope_attention, or "
            f"run under torch.no_grad()")


def _fn(lib: str, symbol: str, argtypes):
    fn = getattr(_build.load(lib), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _launched(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
