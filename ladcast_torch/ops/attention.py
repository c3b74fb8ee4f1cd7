"""Attention with a selectable implementation: the plain softmax attention
(:func:`dot_product_attention`) and the DiT's primitive, RMS-norm(Q, K) ->
RoPE -> attention (:func:`norm_rope_attention`). Layout is BSHD."""

from __future__ import annotations

from ladcast_torch.ops.flash_attention import (
    MAX_HEAD_DIM,
    attention_composite,
    composite_norm_rope_attention,
    flash_attention,
    fused_norm_rope_attention,
)
from ladcast_torch.utils.profiling import spanned


def dot_product_attention(q, k, v, bias=None, impl: str = "auto"):
    """Non-causal softmax attention. q/k/v (B, S, H, D); ``bias``
    broadcastable to (B, H, Sq, Sk), added to the logits. Softmax
    statistics are fp32 whatever the input dtype.

    ``impl="auto"`` takes the flash attention (the CUDA kernel on CUDA
    tensors, its plain version on CPU tensors) when there is no bias and D
    <= 256, else the composite; ``"kernel"`` insists on the flash attention
    and raises where it does not apply; ``"plain"`` is the composite. A
    failing kernel raises: nothing gives way to the composite.
    """
    if impl not in ("auto", "kernel", "plain"):
        raise ValueError(f"unknown attention impl {impl!r}")
    fits = bias is None and q.shape[-1] <= MAX_HEAD_DIM
    if impl == "kernel" and not fits:
        raise ValueError("the flash attention takes no bias and D <= "
                         f"{MAX_HEAD_DIM}")
    if impl != "plain" and fits:
        return flash_attention(q, k, v)
    return attention_composite(q, k, v, bias)


@spanned("op.attention")
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
