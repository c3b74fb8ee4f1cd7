"""AdamW with global-norm clipping and the LR schedules, as the JAX
package's ``make_optimizer`` builds them from optax
(``ladcast_tpu/train/optim.py``), step for step:

  * the clip scales every gradient by ``max_norm / g_norm`` (divide, then
    multiply, with no epsilon) when the global norm reaches ``max_norm``,
    as ``optax.clip_by_global_norm`` does (``clip_grad_norm_`` would add
    1e-6);
  * Adam's moments and bias corrections are optax's ``scale_by_adam``;
    weight decay adds ``wd * param`` to the update before the LR
    (``add_decayed_weights``), for trainable parameters only;
  * the schedule is evaluated at the update count *before* the increment,
    as ``scale_by_schedule`` does: with warmup, step 0 has LR 0;
  * frozen parameters (``trainable_mask``) get zero gradients before the
    clip and zero updates after.

The update runs in place with ``torch._foreach_*`` ops over the parameter
list; the LR and bias corrections are host scalars, and the clip factor
stays on the device.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch


def cosine_with_min_lr(base_lr: float, min_lr: float, num_warmup_steps: int,
                       num_training_steps: int) -> Callable[[int], float]:
    """Linear warmup, then min_ratio + (1 - min_ratio) * 0.5 * (1 +
    cos(pi * progress)), times base_lr."""
    min_ratio = min_lr / base_lr if base_lr > 0 else 0.0

    def schedule(step: int) -> float:
        if step < num_warmup_steps:
            return base_lr * step / max(1, num_warmup_steps)
        progress = (step - num_warmup_steps) / max(
            1, num_training_steps - num_warmup_steps)
        progress = min(max(progress, 0.0), 1.0)
        cos = 0.5 * (1.0 + math.cos(math.pi * progress))
        return base_lr * (min_ratio + (1.0 - min_ratio) * cos)

    return schedule


def polynomial_with_min_lr(base_lr: float, min_lr: float,
                           num_warmup_steps: int, num_training_steps: int,
                           power: float = 1.0) -> Callable[[int], float]:
    """Linear warmup, then polynomial decay to ``min_lr``."""

    def schedule(step: int) -> float:
        if step < num_warmup_steps:
            return base_lr * step / max(1, num_warmup_steps)
        progress = (step - num_warmup_steps) / max(
            1, num_training_steps - num_warmup_steps)
        progress = min(max(progress, 0.0), 1.0)
        return (base_lr - min_lr) * (1 - progress) ** power + min_lr

    return schedule


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``),
    as a 0-d fp32 tensor on the tensors' device."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def _bias_correction(decay: float, count: int) -> float:
    # optax computes 1 - decay**count in fp32
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


class AdamW:
    """The optimizer state and update of one list of parameters."""

    def __init__(self, params: Sequence[torch.Tensor],
                 lr_fn: Callable[[int], float], betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 1e-2,
                 grad_clip_norm: Optional[float] = 1.0,
                 trainable: Optional[Sequence[bool]] = None):
        self.params = list(params)
        self.lr_fn = lr_fn
        self.b1, self.b2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.grad_clip_norm = grad_clip_norm
        self.trainable = (list(trainable) if trainable is not None
                          else [True] * len(self.params))
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """Apply one update from ``grads`` (one per parameter). Returns their
        global norm as given, before the mask and the clip."""
        g_norm = global_norm(grads)
        frozen = not all(self.trainable)
        grads = [g if t else torch.zeros_like(g)
                 for g, t in zip(grads, self.trainable)]
        if self.grad_clip_norm is not None:
            clip_norm = global_norm(grads) if frozen else g_norm
            keep = clip_norm < self.grad_clip_norm
            one = torch.ones_like(clip_norm)
            grads = torch._foreach_div(grads, torch.where(keep, one, clip_norm))
            torch._foreach_mul_(grads, torch.where(
                keep, one, torch.full_like(clip_norm, self.grad_clip_norm)))
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - self.b2)
        lr = self.lr_fn(self.count)
        self.count += 1
        den = torch._foreach_div(self.nu, _bias_correction(self.b2, self.count))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(self.mu, _bias_correction(self.b1, self.count))
        torch._foreach_div_(upd, den)
        del den
        decayed = [(u, p) for u, p, t in zip(upd, self.params, self.trainable) if t]
        if self.weight_decay and decayed:
            torch._foreach_add_([u for u, _ in decayed], [p for _, p in decayed],
                                alpha=self.weight_decay)
        moved = [(p, u) for p, u, t in zip(self.params, upd, self.trainable) if t]
        if moved:
            torch._foreach_add_([p for p, _ in moved], [u for _, u in moved],
                                alpha=-lr)
        return g_norm

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        self.count = int(sd["count"])
        for dst, key in ((self.mu, "mu"), (self.nu, "nu")):
            if len(sd[key]) != len(dst):
                raise ValueError(f"optimizer state has {len(sd[key])} "
                                 f"{key} tensors, expected {len(dst)}")
            torch._foreach_copy_(dst, [t.to(d.device) for t, d in zip(sd[key], dst)])


def make_optimizer(
    lr: float = 1e-4,
    *,
    min_lr: float = 0.0,
    weight_decay: float = 1e-2,
    betas=(0.9, 0.999),
    eps: float = 1e-8,
    grad_clip_norm: Optional[float] = 1.0,
    num_warmup_steps: int = 1000,
    num_training_steps: int = 100000,
    schedule: str = "cosine",
    trainable_mask: Optional[Callable[[str], bool]] = None,
) -> Callable[[Iterable[Tuple[str, torch.Tensor]]], AdamW]:
    """The optimizer's init: ``make_optimizer(...)(named_parameters)``
    gives its :class:`AdamW`. ``trainable_mask(name)`` False freezes a
    parameter (zero updates)."""
    if schedule == "cosine":
        lr_fn = cosine_with_min_lr(lr, min_lr, num_warmup_steps,
                                   num_training_steps)
    elif schedule == "polynomial":
        lr_fn = polynomial_with_min_lr(lr, min_lr, num_warmup_steps,
                                       num_training_steps)
    elif schedule == "constant":
        def lr_fn(step: int) -> float:
            return lr
    else:
        raise ValueError(f"schedule {schedule!r}: expected 'cosine', "
                         f"'polynomial' or 'constant'")

    def init(named_params: Iterable[Tuple[str, torch.Tensor]]) -> AdamW:
        named: List[Tuple[str, torch.Tensor]] = list(named_params)
        trainable = (None if trainable_mask is None
                     else [bool(trainable_mask(n)) for n, _ in named])
        return AdamW([p for _, p in named], lr_fn, betas, eps, weight_decay,
                     grad_clip_norm, trainable)

    return init
