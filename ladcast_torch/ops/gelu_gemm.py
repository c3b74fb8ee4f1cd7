"""The DiT's up-projections with their tanh GELU: ``gelu_tanh(x @ W.T + b)``
as one GEMM where it can be.

On CUDA tensors where no input needs a gradient (the rule
``ops.adaln_glue.applies`` uses for K7), :func:`dense_gelu_tanh` calls
``torch._addmm_activation(bias, x2d, W.t(), use_gelu=True)``: cuBLASLt's
``GELU_BIAS`` epilogue, which adds the bias and applies the tanh
approximation to the fp32 accumulator before the one rounding to the
output's dtype. The 4x-wide activation is then written once and never read
back by a separate GELU pass. Everywhere else it runs its plain version,
``F.gelu(dense(x, W, b), approximate="tanh")``: ``_addmm_activation`` has no
derivative, and on CPU tensors it computes the erf GELU, not the tanh one.

Torch takes the epilogue only for a 1-D contiguous bias of the inputs'
dtype and a 2-D contiguous result; given anything else it runs the GEMM and
a separate GELU pass without an error. So the CUDA entry passes exactly
that: x as a 2-D (M, K) view (a copy only if x's rows are not contiguous),
the bias as it is (a Linear's bias is contiguous), all three in x's and
W's promoted dtype.

Each call that takes the epilogue counts in ``dense_gelu_tanh.launches``
and reports its FLOPs to ``utils.profiling.count_kernel``, since
``FlopCounterMode`` has no formula for ``_addmm_activation`` in the torch
this was written for (it counts the plain version's GEMM as 2 M K N).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ladcast_torch.models.layers import dense
from ladcast_torch.utils.profiling import count_kernel


def dense_gelu_tanh_plain(x: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`dense_gelu_tanh`: the GEMM, then the GELU."""
    return F.gelu(dense(x, weight, bias), approximate="tanh")


def gelu_gemm_flops(m: int, k: int, n: int) -> int:
    """FLOPs of the epilogue GEMM that ``FlopCounterMode`` does not count:
    2 M K N, what it counts of the plain version's GEMM (the GELU counts
    none), where it has no formula for ``_addmm_activation``, and none where
    it has one."""
    from torch.utils.flop_counter import flop_registry

    if torch.ops.aten._addmm_activation in flop_registry:
        return 0
    return 2 * m * k * n


def applies(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> bool:
    """Whether :func:`dense_gelu_tanh` takes the epilogue: CUDA tensors,
    none of which needs a gradient."""
    ts = (x, weight, bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        return False
    return all(t.device.type == "cuda" for t in ts)


def dense_gelu_tanh(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """``gelu_tanh(x @ weight.T + bias)`` for x (..., K), weight (N, K),
    bias (N,), in the promoted dtype of the three, as ``layers.dense``."""
    if not applies(x, weight, bias):
        return dense_gelu_tanh_plain(x, weight, bias)
    dt = torch.promote_types(torch.promote_types(x.dtype, weight.dtype), bias.dtype)
    k, n = weight.shape[1], weight.shape[0]
    x2d = x.to(dt).reshape(-1, k)
    out = torch._addmm_activation(bias.to(dt), x2d, weight.to(dt).t(), use_gelu=True)
    dense_gelu_tanh.launches += 1
    count_kernel("dense_gelu_tanh", gelu_gemm_flops(x2d.shape[0], k, n))
    return out.view(*x.shape[:-1], n)


dense_gelu_tanh.launches = 0
