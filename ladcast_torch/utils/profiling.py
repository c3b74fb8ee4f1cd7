"""Named wall-clock phases of a host loop."""

from __future__ import annotations

import contextlib
import time
from typing import Dict


class PhaseTimer:
    """Accumulating named wall-clock phases of the host; ``summary()``
    gives seconds and counts per phase."""

    def __init__(self):
        self._acc: Dict[str, float] = {}
        self._count: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._acc[name] = self._acc.get(name, 0.0) + dt
            self._count[name] = self._count.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": round(v, 4), "count": self._count[k]}
                for k, v in self._acc.items()}
