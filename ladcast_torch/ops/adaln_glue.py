"""K7: the DiT block glue -- LayerNorm, AdaLN modulation, gates and
residual adds -- in one pass over each token row.

``csrc/adaln_glue.cu`` has three entries on one row routine, each with its
plain version here (fp32 inside, rounded once to the stream's dtype, as the
kernel does):

  - :func:`ln_modulate`: ``h = LN(x) * (1 + scale[b]) + shift[b]``;
  - :func:`gated_residual_ln_modulate`: ``x' = x + y * gate[b]`` and
    ``h = LN(x') * (1 + scale[b]) + shift[b]``, both returned;
  - :func:`gated_residual`: ``x' = x + y * gate[b]``.

LN is LayerNorm without affine (biased variance). ``x``, ``y`` and the
outputs are (B, S, D); ``shift``, ``scale`` and ``gate`` are (B, D), views of
an AdaLN linear's chunked output, passed with their strides and never
copied. The kernel replaces no TPU kernel: the JAX package leaves these
steps to XLA's fusion.

A wrapper given CPU tensors runs its plain version. Given CUDA tensors it
launches the kernel, counting the launch in its ``launches`` attribute and
reporting it (``utils.profiling.count_kernel``; ``FlopCounterMode`` counts
no FLOPs of the plain version), or raises; it never falls back to the
plain version. The kernel's results carry no gradient, so a wrapper raises
when an input requires grad under grad mode: the DiT's blocks ask
:func:`applies` first, which on CUDA tensors looks at grad alone, and keep
their differentiable expressions otherwise.
"""

from __future__ import annotations

import ctypes

import torch

from ladcast_torch.ops._launch import (
    DTYPE_CODES,
    check_launch,
    fn as _fn,
    refuse_grad,
)
from ladcast_torch.utils.profiling import count_kernel

MAX_DIM = 2048  # a warp holds the row in registers: 64 fp32 values a lane

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


# ------------------------------------------------------- plain versions ---

def _ln_modulate_f32(xf, shift, scale, eps):
    mean = xf.mean(-1, keepdim=True)
    d = xf - mean
    n = d * torch.rsqrt(d.square().mean(-1, keepdim=True) + eps)
    return n * (1 + scale.float()[:, None]) + shift.float()[:, None]


def _gated_residual_f32(x, y, gate):
    return x.float() + y.float() * gate.float()[:, None]


def ln_modulate_plain(x, shift, scale, eps: float):
    """Plain version of :func:`ln_modulate`."""
    return _ln_modulate_f32(x.float(), shift, scale, eps).to(x.dtype)


def gated_residual_ln_modulate_plain(x, y, gate, shift, scale, eps: float):
    """Plain version of :func:`gated_residual_ln_modulate`: LN reads the
    fp32 sum, before its rounding."""
    xf = _gated_residual_f32(x, y, gate)
    return xf.to(x.dtype), _ln_modulate_f32(xf, shift, scale, eps).to(x.dtype)


def gated_residual_plain(x, y, gate):
    """Plain version of :func:`gated_residual`."""
    return _gated_residual_f32(x, y, gate).to(x.dtype)


# ------------------------------------------------------------- dispatch ---

def applies(tokens, rows) -> bool:
    """Whether the DiT's blocks take these entries for (B, S, D) ``tokens``
    and (B, D) ``rows``: where no input needs a gradient (training keeps
    the expressions that autograd differentiates). On CUDA tensors the
    entry then launches K7 or raises; on CPU tensors of one dtype of bf16
    or fp32 it runs its plain version (other CPU tensors keep the
    expressions)."""
    ts = (*tokens, *rows)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        return False
    x = tokens[0]
    return x.device.type != "cpu" or (x.dtype in DTYPE_CODES
                                      and all(t.dtype == x.dtype for t in ts))


def _layout_error(tokens, rows):
    """Why the kernel cannot take (B, S, D) ``tokens`` and (B, D) ``rows``,
    or None: D a multiple of 16 bytes and at most MAX_DIM, unit stride on
    D, every row start 16-byte aligned."""
    x = tokens[0]
    if x.dim() != 3:
        return f"x of shape {tuple(x.shape)}, expected (B, S, D)"
    B, S, D = x.shape
    vec = 16 // x.element_size()
    if D % vec or D > MAX_DIM:
        return f"D = {D}: expected a multiple of {vec} up to {MAX_DIM}"
    for t in tokens:
        if t.shape != x.shape:
            return f"token shapes {tuple(x.shape)} and {tuple(t.shape)}"
    for t in rows:
        if t.shape != (B, D):
            return f"a modulation row of shape {tuple(t.shape)}, expected {(B, D)}"
    for t in (*tokens, *rows):
        if (t.stride(-1) != 1 or any(st % vec for st in _strides(t))
                or t.data_ptr() % 16):
            return "unit stride on D and 16-byte aligned rows expected"
    return None


def _strides(t):
    """t's strides but the last, 0 on a dimension of size 1."""
    return [st if n > 1 else 0 for n, st in zip(t.shape[:-1], t.stride()[:-1])]


_MODES = {"ln_modulate": 0, "gated_residual_ln_modulate": 1, "gated_residual": 2}


def _launch(entry, x, y, gate, shift, scale, eps=0.0):
    """K7 as ``entry`` (one of the three entries below) on CUDA tensors: x
    and y (B, S, D), gate, shift and scale (B, D), None where the entry
    takes none. Returns (x', h), None for what the entry does not store;
    raises where the kernel cannot take the inputs."""
    name = entry.__name__
    tokens = [t for t in (x, y) if t is not None]
    rows = [t for t in (gate, shift, scale) if t is not None]
    if x.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {x.device}, expected cpu or cuda")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {x.dtype}, expected bfloat16 or float32")
    for t in (*tokens, *rows):
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"{name}: inputs differ in device or dtype")
    err = _layout_error(tokens, rows)
    if err:
        raise ValueError(f"{name}: {err}")
    refuse_grad(name, (*tokens, *rows), "the DiT block's own expressions")
    mode = _MODES[name]
    xo = None if mode == 0 else torch.empty_like(x, memory_format=torch.contiguous_format)
    h = None if mode == 2 else torch.empty_like(x, memory_format=torch.contiguous_format)
    if x.numel():
        f = _fn("adaln_glue", "ladcast_adaln_glue",
                [_I] + [_P, _LL, _LL] * 2 + [_P, _LL] * 3
                + [_P, _P, _LL, _I, _I, ctypes.c_float, _I, _P])

        def operand(t, n):  # pointer and n strides, or null and zeros
            return [t.data_ptr(), *_strides(t)] if t is not None else [None] + [0] * n

        B, S, D = x.shape
        rc = f(mode, *operand(x, 2), *operand(y, 2), *operand(gate, 1),
               *operand(shift, 1), *operand(scale, 1),
               xo.data_ptr() if xo is not None else None,
               h.data_ptr() if h is not None else None, B, S, D, eps,
               DTYPE_CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
        check_launch(name, rc)
        entry.launches += 1
        count_kernel(name, 0)
    return xo, h


# ----------------------------------------------------------- the entries ---

def ln_modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor,
                eps: float) -> torch.Tensor:
    """``LN(x; eps) * (1 + scale[b]) + shift[b]`` for x (B, S, D), shift
    and scale (B, D)."""
    if x.device.type == "cpu":
        return ln_modulate_plain(x, shift, scale, eps)
    return _launch(ln_modulate, x, None, None, shift, scale, eps)[1]


def gated_residual_ln_modulate(x: torch.Tensor, y: torch.Tensor, gate: torch.Tensor,
                               shift: torch.Tensor, scale: torch.Tensor, eps: float):
    """``(x', LN(x'; eps) * (1 + scale[b]) + shift[b])`` with
    ``x' = x + y * gate[b]``, for x, y (B, S, D) and the rows (B, D)."""
    if x.device.type == "cpu":
        return gated_residual_ln_modulate_plain(x, y, gate, shift, scale, eps)
    return _launch(gated_residual_ln_modulate, x, y, gate, shift, scale, eps)


def gated_residual(x: torch.Tensor, y: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """``x + y * gate[b]`` for x, y (B, S, D) and gate (B, D)."""
    if x.device.type == "cpu":
        return gated_residual_plain(x, y, gate)
    return _launch(gated_residual, x, y, gate, None, None)[0]


ENTRIES = (ln_modulate, gated_residual_ln_modulate, gated_residual)
for _entry in ENTRIES:
    _entry.launches = 0


def launches() -> int:
    """K7's launches so far, over its three entries."""
    return sum(f.launches for f in ENTRIES)
