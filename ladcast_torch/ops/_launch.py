"""What every kernel wrapper shares: the ctypes binding of a kernel's C
entry, the launch check, the refusal of inputs that need a gradient, and
the pullback of a plain version for the backward of an autograd Function."""

from __future__ import annotations

import ctypes

import torch

from ladcast_torch.ops import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def fn(lib: str, symbol: str, argtypes):
    """The C function ``symbol`` of ``lib<lib>.so`` (built at first use),
    returning a CUDA error code."""
    f = getattr(_build.load(lib), symbol)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f


def check_launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def check_cuda_inputs(name: str, tensors) -> None:
    """What every kernel takes: CUDA tensors of one device and one dtype of
    bf16/fp32, contiguous and 16-byte aligned."""
    dev, dtype = tensors[0].device, tensors[0].dtype
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev}, expected cpu or cuda")
    if dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {dtype}, expected bfloat16 or float32")
    for t in tensors:
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name}: inputs differ in device or dtype")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be contiguous and "
                             f"16-byte aligned")


def refuse_grad(name: str, tensors, instead: str) -> None:
    """A kernel's result has no grad_fn: refuse rather than drop the
    gradient silently. ``instead`` names the differentiable entry."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: a CUDA input requires grad, and the kernel's result "
            f"would carry no gradient; call {instead}, or run under "
            f"torch.no_grad()")


def with_vjp(f, args, needs):
    """f(*args), detached, and its pullback to the args flagged in needs
    (None for the others)."""
    xs = [a.detach().requires_grad_(n) for a, n in zip(args, needs)]
    with torch.enable_grad():
        y = f(*xs)

    def pull(cotangent):
        wrt = [x for x, n in zip(xs, needs) if n]
        got = iter(torch.autograd.grad(y, wrt, cotangent) if wrt else ())
        return [next(got) if n else None for n in needs]

    return y.detach(), pull
