"""Exponential moving average of parameters (the port of
``ladcast_tpu/train/ema.py``; diffusers ``EMAModel``'s decay schedule):
decay_t = clip(1 - (1 + t/inv_gamma)^(-power), 0, max_decay), with the
step counter offset by update_after_step. The average is updated in place
with ``torch._foreach_lerp_``: e + (1 - d)(p - e) is JAX's e - (1 - d)(e - p).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List

import torch


@dataclass
class EMAState:
    params: List[torch.Tensor]
    step: int = 0

    def state_dict(self) -> dict:
        return {"params": self.params, "step": self.step}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        if len(sd["params"]) != len(self.params):
            raise ValueError(f"EMA state has {len(sd['params'])} tensors, "
                             f"expected {len(self.params)}")
        torch._foreach_copy_(self.params, [t.to(p.device) for t, p in
                                           zip(sd["params"], self.params)])
        self.step = int(sd["step"])


def ema_init(params: Iterable[torch.Tensor]) -> EMAState:
    return EMAState([p.detach().clone() for p in params])


def ema_decay(step: int, *, inv_gamma: float = 1.0, power: float = 2.0 / 3.0,
              max_decay: float = 0.9999, update_after_step: int = 1000) -> float:
    eff = max(step - update_after_step - 1, 0)
    if eff <= 0:
        return 0.0
    decay = 1.0 - (1.0 + eff / inv_gamma) ** (-power)
    return min(max(decay, 0.0), max_decay)


@torch.no_grad()
def ema_update(state: EMAState, new_params: Iterable[torch.Tensor],
               **decay_kwargs) -> EMAState:
    """Advance ``state`` by one step towards ``new_params``, in place."""
    state.step += 1
    d = ema_decay(state.step, **decay_kwargs)
    torch._foreach_lerp_(state.params, [p.detach() for p in new_params], 1.0 - d)
    return state
