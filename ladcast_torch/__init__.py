"""LaDCast in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

The port of ``ladcast_tpu`` (the JAX reference, kept beside it). Module
paths mirror the JAX package: ``ladcast_torch/ops/norms.py`` is the
counterpart of ``ladcast_tpu/ops/norms.py``, and so on.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. CUDA unless the caller asks for
    the CPU; raises when CUDA is asked for and absent, so nothing carries
    on quietly on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return device
