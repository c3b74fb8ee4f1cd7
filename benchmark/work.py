"""The yardstick's peaks and operation counts.

``PEAKS`` is a frozen copy of the H100 SXM entry (the last) of
``ladcast_torch``'s ``utils.profiling.CARD_PEAKS`` (NVIDIA's data sheet,
dense rates: 989 TFLOP/s in bf16, 3.35 TB/s of HBM). The FLOPs of a unit of work are
what ``torch.utils.flop_counter.FlopCounterMode`` counts over the
benchmark's own reference on the meta device: the products of every
matmul, einsum and convolution, never a count the program reports."""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils.flop_counter import FlopCounterMode

PEAKS = {"bf16": 989e12, "fp32": 67e12, "bytes": 3.35e12, "tf32": 494.5e12,
         "int8": 1979e12}


def least_time_s(flops: float, nbytes: float) -> float:
    """The least time the card needs for the work: the larger of its
    operations over the bf16 peak and its bytes over the HBM bandwidth."""
    return max(flops / PEAKS["bf16"], nbytes / PEAKS["bytes"])


def count_flops(fn: Callable[[], object]) -> float:
    """FLOPs of ``fn()`` as FlopCounterMode counts them (forward and, where
    ``fn`` calls backward, backward)."""
    with FlopCounterMode(display=False) as c:
        fn()
    return float(c.get_total_flops())


def meta_params(spec):
    """A state dict of meta tensors from a reference parameter spec."""
    return {name: torch.empty(shape, device="meta") for name, shape, _, _ in spec}
