"""Metric logging: one JSON record per logged step in
``<output_dir>/metrics.jsonl`` (always), the run's config, dot-flattened,
in ``<output_dir>/config.json``, and the back end that ``log_with`` names
(``accelerator.log_with`` of the yaml): ``tensorboard`` event files under
``<output_dir>/tb`` through ``torch.utils.tensorboard``, or a ``wandb`` run.
The port of ``ladcast_tpu/utils/logging_utils.py``: where the back end
cannot start (its package absent), the JAX logger goes on with JSON lines
alone without a word; this one prints one line saying so. A logger without
an output directory (the ranks other than 0 of a process group) writes
nothing."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


def flatten_config(d: Dict, prefix: str = "") -> Dict:
    """Dot-flatten nested config dicts."""
    out = {}
    for k, v in d.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_config(v, key))
        elif isinstance(v, (int, float, str, bool, type(None))):
            out[key] = v
        else:
            out[key] = str(v)
    return out


class MetricLogger:
    def __init__(self, output_dir: Optional[str], project: Optional[str] = None,
                 config: Optional[Dict] = None, log_with: str = "jsonl"):
        self._f = self._wandb = self._tb = None
        if output_dir is None:
            return
        os.makedirs(output_dir, exist_ok=True)
        self._f = open(os.path.join(output_dir, "metrics.jsonl"), "a")
        self._t0 = time.time()
        if config is not None:
            with open(os.path.join(output_dir, "config.json"), "w") as f:
                json.dump(flatten_config(config), f, indent=2)
        try:
            if log_with == "wandb":
                import wandb

                self._wandb = wandb.init(project=project or "ladcast_torch",
                                         config=flatten_config(config or {}))
            elif log_with == "tensorboard":
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(output_dir, "tb"))
        except Exception as e:  # the back end's package absent or failing
            print(f"MetricLogger: log_with={log_with!r} unavailable "
                  f"({type(e).__name__}: {e}); logging JSON lines only", flush=True)

    def log(self, metrics: Dict, step: int):
        if self._f is None:
            return
        rec = {"step": step, "wall": round(time.time() - self._t0, 2)}
        rec.update({k: (float(v) if hasattr(v, "__float__") else v)
                    for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)
        if self._tb is not None:
            for k, v in metrics.items():
                try:
                    self._tb.add_scalar(k, float(v), step)
                except (TypeError, ValueError):
                    pass

    def close(self):
        if self._f is not None:
            self._f.close()
        if self._wandb is not None:
            self._wandb.finish()
        if self._tb is not None:
            self._tb.close()
