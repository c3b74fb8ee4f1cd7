"""JSON-lines metric logging: one record per logged step in
``<output_dir>/metrics.jsonl``, and the run's config, dot-flattened, in
``<output_dir>/config.json``."""

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
    def __init__(self, output_dir: str, config: Optional[Dict] = None):
        os.makedirs(output_dir, exist_ok=True)
        self._f = open(os.path.join(output_dir, "metrics.jsonl"), "a")
        self._t0 = time.time()
        if config is not None:
            with open(os.path.join(output_dir, "config.json"), "w") as f:
                json.dump(flatten_config(config), f, indent=2)

    def log(self, metrics: Dict, step: int):
        rec = {"step": step, "wall": round(time.time() - self._t0, 2)}
        rec.update({k: (float(v) if hasattr(v, "__float__") else v)
                    for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()
