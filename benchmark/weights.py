"""Seeded weights and inputs, made on the device in a few large calls.

Every leaf that the reference's ``param_spec`` initialises from a normal
distribution is a view of one float32 buffer filled by one ``randn`` of a
generator seeded from (seed, tag), scaled to std 1/sqrt(fan_in) (LeCun's
normal); biases are zeros and norm weights ones. The same (seed, tag) gives
the same weights on every call, so the reference makes them again after
the window instead of keeping a copy."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch


def stream_seed(*entropy: int) -> int:
    """A 63-bit generator seed from a tuple of non-negative integers,
    folded by numpy's SeedSequence."""
    s = np.random.SeedSequence(entropy).generate_state(2, np.uint32)
    return (int(s[0]) << 31) ^ int(s[1])


def generator(device, *entropy: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(*entropy))


def make(spec: Sequence[Tuple[str, tuple, str, int]], seed: int, tag: int,
         device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor} from a parameter spec."""
    sizes = [torch.Size(shape).numel() for _, shape, init, _ in spec if init == "normal"]
    buf = torch.randn(sum(sizes), generator=generator(device, seed, tag), device=device)
    out, off = {}, 0
    for name, shape, init, fan_in in spec:
        if init == "normal":
            n = torch.Size(shape).numel()
            out[name] = buf[off:off + n].view(shape).mul_(fan_in ** -0.5)
            off += n
        elif init == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif init == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            raise ValueError(f"{name}: unknown init {init!r}")
    return out
