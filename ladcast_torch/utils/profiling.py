"""Tracing and profiling: named wall-clock phases of a host loop, device
traces that TensorBoard or Perfetto open, and a report of a function's
first and steady calls."""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional

import torch


def _sync_device() -> None:
    """Wait for the current CUDA device's work; nothing without CUDA."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class PhaseTimer:
    """Accumulating named wall-clock phases of the host; ``summary()``
    gives seconds and counts per phase."""

    def __init__(self):
        self._acc: Dict[str, float] = {}
        self._count: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync: bool = False):
        """Time the block; with ``sync`` the time includes the device work
        the block queued (it ends in a synchronise of the current CUDA
        device)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync:
                _sync_device()
            dt = time.perf_counter() - t0
            self._acc[name] = self._acc.get(name, 0.0) + dt
            self._count[name] = self._count.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": round(v, 4), "count": self._count[k]}
                for k, v in self._acc.items()}

    def dump(self, path: Optional[str] = None) -> str:
        s = json.dumps(self.summary(), indent=2)
        if path:
            with open(path, "w") as f:
                f.write(s)
        return s


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the block with ``torch.profiler`` (host ops, and CUDA kernels
    where CUDA is available) and write it on exit as a Chrome-trace JSON,
    ``<log_dir>/trace.json``, which Perfetto and TensorBoard open. Kernels
    launched through ctypes (the port's) are recorded by CUPTI like any
    other. Yields the profiler, whose ``events()`` the caller may read."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    _sync_device()
    with profile(activities=activities) as prof:
        yield prof
        _sync_device()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def compile_report(fn, *args, **kwargs) -> Dict:
    """What stands in for compilation in the port, which has no lowering
    step: ``first_call_s``, the first call (it builds the port's kernels
    with nvcc at first use and warms cuBLAS), ``steady_s``, a second call,
    each ending in a synchronise, and ``flops``, the FLOPs of the aten ops
    that ``torch.utils.flop_counter.FlopCounterMode`` counts in a third.
    The hand-written kernels are launched through ctypes, not as aten ops,
    so the count leaves their work out: ``uncounted`` lists the port's
    kernel entry points that the third call launched, with their launches,
    and ``flops_complete`` is False where that list is not empty."""
    from torch.utils.flop_counter import FlopCounterMode

    from ladcast_torch.ops import (
        dense_conv,
        depthwise_conv,
        flash_attention,
        quant,
    )

    entries = {"norm_rope": flash_attention.norm_rope,
               "fused_attention": flash_attention.fused_attention,
               "flash_bwd_dq": flash_attention.flash_bwd_dq,
               "flash_bwd_dkv": flash_attention.flash_bwd_dkv,
               "flash_attention": flash_attention.flash_attention_forward,
               "dense_conv": dense_conv.dense_conv_forward,
               "depthwise_conv": depthwise_conv.depthwise_same_conv_forward,
               "int8_mm": quant.int8_mm}

    def timed():
        _sync_device()
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        _sync_device()
        return time.perf_counter() - t0

    first_s = timed()
    steady_s = timed()
    before = {k: f.launches for k, f in entries.items()}
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    _sync_device()
    uncounted = {k: f.launches - before[k] for k, f in entries.items()
                 if f.launches > before[k]}
    return {"first_call_s": round(first_s, 3), "steady_s": round(steady_s, 4),
            "flops": float(counter.get_total_flops()),
            "flops_complete": not uncounted, "uncounted": uncounted}
