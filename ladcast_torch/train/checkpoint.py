"""Checkpoints as torch files (the port of
``ladcast_tpu/train/checkpoint.py``, which uses orbax).

A :class:`CheckpointManager` keeps the full training state of a step
(model, optimizer, EMA, step) in ``<directory>/step_<step>.pt``, written
to a temporary name and renamed, and removes the oldest beyond
``max_to_keep``. :func:`save_params` / :func:`load_params` store a bare
state dict (weights only). Files load with ``weights_only=True``.

Under a process group the file is the same: :func:`save_state` gathers the
whole state to rank 0 (FSDP shards included), which writes it, and
:func:`restore_state` reads it on rank 0 and places each rank's part, so a
checkpoint written by N ranks resumes in one process and the other way
round. A single process writes what it always wrote: its own state dict,
tensors on their device.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional

import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory))
                      if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Dict[str, Any]) -> str:
        path = self.path(step)
        _save(state, path)
        if self.max_to_keep:
            for old in self.all_steps()[:-self.max_to_keep]:
                os.remove(self.path(old))
        return path

    def restore(self, step: Optional[int] = None, map_location=None) -> Dict[str, Any]:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(self.path(step), map_location=map_location,
                          weights_only=True)


def make_manager(directory: str, max_to_keep: int = 3) -> CheckpointManager:
    return CheckpointManager(directory, max_to_keep)


def save_state(mgr: CheckpointManager, step: int, state) -> str:
    """``state``: the trainer's TrainState (``full_state_dict()``, a
    collective under a process group: every rank calls this)."""
    from ladcast_torch.parallel import dist

    sd = state.full_state_dict()
    path = mgr.save(step, sd) if dist.process_index() == 0 else mgr.path(step)
    dist.barrier("checkpoint-written")
    return path


def restore_state(mgr: CheckpointManager, state, step: Optional[int] = None):
    """Load a saved step (the latest by default) into ``state`` in place;
    returns it. Under a process group every rank calls this; rank 0 reads
    the file."""
    from ladcast_torch.parallel import dist

    step = mgr.latest_step() if step is None else step
    if step is None or not os.path.exists(mgr.path(step)):
        # every rank raises, rather than rank 0 alone
        raise FileNotFoundError(f"no checkpoint of step {step} in {mgr.directory}")
    sd = None
    if dist.process_index() == 0:
        sd = mgr.restore(step, map_location="cpu")
    state.load_full_state_dict(sd)
    return state


def save_params(path: str, params: Dict[str, torch.Tensor]) -> None:
    """A weights-only snapshot: a state dict of tensors."""
    _save({k: v.detach() for k, v in params.items()}, path)


def load_params(path: str, map_location=None) -> Dict[str, torch.Tensor]:
    return torch.load(path, map_location=map_location, weights_only=True)


def _save(obj, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)
