"""The DiT's attention primitive: RMS-norm(Q, K) -> RoPE -> attention."""

from __future__ import annotations

from ladcast_torch.ops.flash_attention import (
    composite_norm_rope_attention,
    fused_norm_rope_attention,
)


def norm_rope_attention(q, k, v, qcos, qsin, qw, kcos, ksin, kw,
                        bias=None, impl: str = "auto",
                        norm_eps: float = 1e-7):
    """q/k/v (B, S, H, D); tables (S, D) fp32. The JAX dispatch rule: with
    no bias and D a multiple of 128 the fused path runs (the CUDA kernels
    on CUDA tensors, their plain versions on CPU tensors); otherwise, or
    with ``impl="plain"``, the composite."""
    if impl == "auto" and bias is None and q.shape[-1] % 128 == 0:
        return fused_norm_rope_attention(q, k, v, qcos, qsin, qw, kcos,
                                         ksin, kw, norm_eps)
    return composite_norm_rope_attention(q, k, v, qcos, qsin, qw, kcos,
                                         ksin, kw, norm_eps, bias=bias)
