"""Training losses (the port of ``ladcast_tpu/metrics/losses.py``): the
relative Lp loss with optional latitude weights, its per-variable
breakdown, and the MSE. Tensors are channels last, (B, H, W, C)."""

from __future__ import annotations

from typing import Optional

import torch

from ladcast_torch import channels as ch


def lp_loss(y_pred: torch.Tensor, y: torch.Tensor,
            weight: Optional[torch.Tensor] = None, *, d: int = 2, p: int = 2,
            reduce: str = "mean") -> torch.Tensor:
    """Relative Lp loss ||w (pred - y)||_p / ||w y||_p over the trailing
    ``d`` = 2 spatial dims of each (example, channel), then reduced
    ("mean", "sum" or "none": the (B, C) values). ``weight`` broadcasts
    with (B, H, W, C), e.g. (B, H, 1, 1) latitude weights."""
    if d != 2:
        raise ValueError(f"d={d}: the loss is taken over (H, W)")
    diff, ref = y_pred - y, y
    if weight is not None:
        diff, ref = weight * diff, weight * ref
    dims = (1, 2)  # (H, W) of (B, H, W, C)
    rel = (torch.linalg.vector_norm(diff, ord=p, dim=dims)
           / torch.linalg.vector_norm(ref, ord=p, dim=dims))  # (B, C)
    if reduce == "mean":
        return rel.mean()
    if reduce == "sum":
        return rel.sum()
    if reduce == "none":
        return rel
    raise ValueError(f"reduce {reduce!r}: expected 'mean', 'sum' or 'none'")


def lp_loss_per_var(y_pred: torch.Tensor, y: torch.Tensor,
                    weight: Optional[torch.Tensor] = None,
                    num_atm_vars: int = ch.NUM_ATM_VARS,
                    num_levels: int = ch.NUM_LEVELS) -> torch.Tensor:
    """Per-variable relative L2: each atmospheric variable averages its
    level channels; every later channel stands alone."""
    rel = lp_loss(y_pred, y, weight, reduce="none")  # (B, C)
    parts = [rel[:, i * num_levels:(i + 1) * num_levels].mean()
             for i in range(num_atm_vars)]
    parts += [rel[:, i].mean()
              for i in range(num_atm_vars * num_levels, rel.shape[1])]
    return torch.stack(parts)


def mse_loss(y_pred: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((y_pred.float() - y.float()) ** 2)
