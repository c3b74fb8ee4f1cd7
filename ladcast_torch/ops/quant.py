"""Opt-in int8 (w8a8) matmuls for the DiT's inference (the port of
``ladcast_tpu/ops/quant.py``).

The scheme is dynamic per-token x per-channel quantisation:
  - activations: symmetric int8 per row, scale = amax / 127 in fp32
    (all-zero rows get scale 1);
  - weights: symmetric int8 per output channel;
  - the product: int8 x int8 -> int32, exact; on CUDA tensors
    ``torch._int_mm`` (cuBLASLt's int8 GEMM) on the 2-D (M, K) x (K, N)
    view, on CPU tensors an int32 ``torch.matmul`` (its plain version);
  - dequantisation in fp32: row scale times column scale, then the bias,
    then a cast to the promoted dtype of the input, weight and bias.

In the JAX package this is an XLA composite (``lax.dot_general`` from
int8 to int32), not a Pallas kernel, so the library's int8 GEMM is its
counterpart on the card. A shape ``_int_mm`` refuses (M <= 16, K or N not
a multiple of 8) raises: there is no quiet float path.

``QuantizableDense`` quantises its weight once per weight version (the
quantised copy is kept until the weight changes in place or moves) outside
grad mode; the numbers are those of quantising it on every call.

The result is an approximation of the float product (about 1 % relative
per layer on Gaussian inputs), opt-in through
``LaDCastDiTConfig.int8_matmuls`` and inference only: the trainer refuses
such a config.
"""

from __future__ import annotations

from typing import Optional

import torch

from ladcast_torch.models.layers import Dense, dense


def quantize_rows(x: torch.Tensor):
    """Symmetric int8 quantisation along the last axis: ``(q, scale)``, q
    int8 of x's shape and scale fp32 of x.shape[:-1] + (1,), with
    ``q * scale ~= x``; round half to even. The row maxima are exact in x's
    dtype and the division is in fp32 (x promoted), as an fp32 copy of x
    would give, without writing that copy."""
    amax = x.abs().amax(dim=-1, keepdim=True).float()
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return torch.div(x, scale).round_().to(torch.int8), scale


def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The exact int32 product of int8 ``a`` (M, K) and ``b`` (K, N). On
    CUDA tensors ``torch._int_mm`` (counted in ``launches``); on CPU
    tensors an int32 matmul."""
    if a.dtype != torch.int8 or b.dtype != torch.int8 or a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"int8_mm: expected 2-D int8 operands, got {a.dtype} "
                         f"{tuple(a.shape)} and {b.dtype} {tuple(b.shape)}")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return torch.matmul(a.to(torch.int32), b.to(torch.int32))
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"int8_mm: tensors on {a.device} and {b.device}, "
                         f"expected cpu or one cuda device")
    (M, K), N = a.shape, b.shape[1]
    if M <= 16 or K % 8 or N % 8:
        raise ValueError(f"int8_mm: torch._int_mm needs M > 16 and K, N "
                         f"multiples of 8; got M={M}, K={K}, N={N}")
    int8_mm.launches += 1
    return torch._int_mm(a, b)


int8_mm.launches = 0


def int8_matmul_quantized(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                          bias: Optional[torch.Tensor], out_dtype: torch.dtype
                          ) -> torch.Tensor:
    """``x @ W.T + bias`` with W given quantised: ``wq`` (N, K) int8 and
    ``ws`` (N, 1) its per-row scales (``quantize_rows`` of W)."""
    xq, xs = quantize_rows(x)
    acc = int8_mm(xq.reshape(-1, xq.shape[-1]), wq.t())
    # int32 * fp32 promotes to fp32 as acc.float() would, in one pass
    out = torch.mul(acc.reshape(*x.shape[:-1], -1), xs).mul_(ws[:, 0])
    if bias is not None:
        out.add_(bias.float())
    return out.to(out_dtype)


def int8_matmul(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ weight.T + bias`` with dynamic w8a8 quantisation. x (..., K),
    weight (N, K) (torch's Linear layout), bias (N,) or None; the result
    has the promoted dtype of the three, as ``layers.dense``."""
    out_dtype = torch.promote_types(x.dtype, weight.dtype)
    if bias is not None:
        out_dtype = torch.promote_types(out_dtype, bias.dtype)
    wq, ws = quantize_rows(weight)
    return int8_matmul_quantized(x, wq, ws, bias, out_dtype)


class QuantizableDense(Dense):
    """``layers.Dense`` with an int8 path: the same parameters (``weight``,
    ``bias``) and the same state dict whatever ``quant`` is. With
    ``quant=False`` it is ``Dense``; with ``quant=True`` it runs
    :func:`int8_matmul`, its weight quantised once per weight version
    outside grad mode."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 quant: bool = False):
        super().__init__(in_features, out_features, bias=bias)
        self.quant = quant
        self._qweight = None  # (key, (wq, ws))

    def _quantized_weight(self):
        w = self.weight
        if torch.is_grad_enabled() or w.is_inference():
            return quantize_rows(w)
        key = (w.data_ptr(), w._version, w.device, w.dtype)
        if self._qweight is None or self._qweight[0] != key:
            self._qweight = (key, quantize_rows(w.detach()))
        return self._qweight[1]

    def forward(self, x):
        if not self.quant:
            return dense(x, self.weight, self.bias)
        out_dtype = torch.promote_types(x.dtype, self.weight.dtype)
        if self.bias is not None:
            out_dtype = torch.promote_types(out_dtype, self.bias.dtype)
        wq, ws = self._quantized_weight()
        return int8_matmul_quantized(x, wq, ws, self.bias, out_dtype)
