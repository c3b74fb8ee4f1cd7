"""Tracing and profiling: named wall-clock phases of a host loop, device
traces that TensorBoard or Perfetto open, a FLOP count that includes the
port's hand-written kernels, a report of a function's first and steady
calls, and the peak rates of the cards the port runs on."""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List, Optional

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


# -- FLOP counts that include the port's kernels ------------------------------

# The counts that are open (:class:`FlopCount`), innermost last: each maps a
# kernel entry's name to [launches reported, FLOPs reported]. Outside a count
# a wrapper's report is a loop over nothing.
_OPEN_COUNTS: List[Dict[str, List[int]]] = []


def count_kernel(name: str, flops: int) -> None:
    """A wrapper's report of one launch of its hand-written kernel, made next
    to its ``launches`` counter: ``flops`` is what ``FlopCounterMode`` counts
    for the kernel's plain version at the same shapes. The kernels launch
    through ctypes, so ``FlopCounterMode`` does not see them; it sees the
    plain versions' aten ops instead where those run (on the CPU), and there
    no wrapper reports, so nothing is counted twice."""
    for counts in _OPEN_COUNTS:
        c = counts.setdefault(name, [0, 0])
        c[0] += 1
        c[1] += flops


def kernel_entries() -> Dict:
    """The port's kernel entry points by the names they report under; each
    keeps a ``launches`` counter."""
    from ladcast_torch.ops import dense_conv, depthwise_conv, flash_attention, quant

    return {"norm_rope": flash_attention.norm_rope,
            "fused_attention": flash_attention.fused_attention,
            "flash_bwd_dq": flash_attention.flash_bwd_dq,
            "flash_bwd_dkv": flash_attention.flash_bwd_dkv,
            "flash_attention": flash_attention.flash_attention_forward,
            "dense_conv": dense_conv.dense_conv_forward,
            "depthwise_conv": depthwise_conv.depthwise_same_conv_forward,
            "int8_mm": quant.int8_mm}


class FlopCount:
    """The FLOPs of the block: those of the aten ops that
    ``torch.utils.flop_counter.FlopCounterMode`` counts, plus those the
    port's kernels report as they launch (:func:`count_kernel`). A call
    counts the same where its kernels launch (CUDA tensors) and where their
    plain versions run (CPU tensors).

    ``kernels`` maps each kernel that reported to {"launches", "flops"};
    ``uncounted`` maps each entry of :func:`kernel_entries` that launched
    more often than it reported to the difference (empty unless a wrapper
    launches without reporting); ``total`` is every FLOP counted."""

    def __init__(self):
        from torch.utils.flop_counter import FlopCounterMode

        self._aten = FlopCounterMode(display=False)
        self._reported: Dict[str, List[int]] = {}
        self._launched: Dict[str, int] = {}

    def __enter__(self):
        self._launched = {k: -f.launches for k, f in kernel_entries().items()}
        _OPEN_COUNTS.append(self._reported)
        self._aten.__enter__()
        return self

    def __exit__(self, *exc):
        self._aten.__exit__(*exc)
        if _OPEN_COUNTS.pop() is not self._reported:
            raise RuntimeError("FlopCount blocks closed out of order")
        for k, f in kernel_entries().items():
            self._launched[k] += f.launches
        return False

    @property
    def kernels(self) -> Dict[str, Dict[str, int]]:
        return {k: {"launches": n, "flops": f} for k, (n, f) in self._reported.items()}

    @property
    def uncounted(self) -> Dict[str, int]:
        return {k: n - self._reported.get(k, (0, 0))[0]
                for k, n in self._launched.items()
                if n > self._reported.get(k, (0, 0))[0]}

    @property
    def total(self) -> float:
        return float(self._aten.get_total_flops()
                     + sum(f for _, f in self._reported.values()))


def compile_report(fn, *args, **kwargs) -> Dict:
    """What stands in for compilation in the port, which has no lowering
    step: ``first_call_s``, the first call (it builds the port's kernels
    with nvcc at first use and warms cuBLAS), ``steady_s``, a second call,
    each ending in a synchronise, and ``flops``, the FLOPs that
    :class:`FlopCount` counts in a third: the aten ops and the hand-written
    kernels that launched (``kernels``, each with its launches and FLOPs).
    ``uncounted`` lists the kernel entries that launched without reporting
    their FLOPs, and ``flops_complete`` is False where that list is not
    empty."""

    def timed():
        _sync_device()
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        _sync_device()
        return time.perf_counter() - t0

    first_s = timed()
    steady_s = timed()
    with FlopCount() as count:
        fn(*args, **kwargs)
        _sync_device()
    return {"first_call_s": round(first_s, 3), "steady_s": round(steady_s, 4),
            "flops": count.total, "kernels": count.kernels,
            "flops_complete": not count.uncounted, "uncounted": count.uncounted}


# -- peak rates of the cards ---------------------------------------------------

# Dense peaks (NVIDIA data sheets), matched on the card's name, the H100 SXM
# the default: bf16 tensor-core, fp32 CUDA-core and TF32 tensor-core (half
# the bf16 rate) FLOP/s, int8 tensor-core op/s and HBM bytes/s. The rates
# assume the card's full power limit.
CARD_PEAKS = [
    ("H100 PCIe", {"bf16": 756e12, "fp32": 51e12, "bytes": 2.0e12,
                   "tf32": 378e12, "int8": 1513e12}),
    ("H100 NVL", {"bf16": 835e12, "fp32": 60e12, "bytes": 3.9e12,
                  "tf32": 417.5e12, "int8": 1671e12}),
    ("H200", {"bf16": 989e12, "fp32": 67e12, "bytes": 4.8e12,
              "tf32": 494.5e12, "int8": 1979e12}),
    ("", {"bf16": 989e12, "fp32": 67e12, "bytes": 3.35e12,
          "tf32": 494.5e12, "int8": 1979e12}),
]


def card_peaks(name: str) -> Dict[str, float]:
    """The peak rates of the card named ``name``
    (``torch.cuda.get_device_name``): the first entry of
    :data:`CARD_PEAKS` whose key is part of the name."""
    return dict(next(p for key, p in CARD_PEAKS if key in name))
