"""Tracing and profiling: spans at the layer boundaries of the port, named
wall-clock phases of a host loop, device traces that TensorBoard or
Perfetto open, a FLOP count that includes the port's hand-written kernels,
a report of a function's first and steady calls, and the peak rates of the
cards the port runs on.

The spans (:func:`span`, :func:`spanned`) are off unless a
``torch.profiler`` records: then each keeps its own record (name, parent,
trace id, host interval, device time from CUDA events, the hand-written
kernels it launched), which :func:`span_table` and :func:`span_records`
read and :func:`device_trace` writes beside the profiler's events. A span
adds nothing to the profiler's own event list, so a reduction of the
profiler's trace sees the same events with the spans on or off."""

from __future__ import annotations

import collections
import contextlib
import functools
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler


def _sync_device() -> None:
    """Wait for the current CUDA device's work; nothing without CUDA."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Totals:
    """Totals by name, in the order the names first came: a count and the
    sums of the amounts given (``add(name, total_s=0.2)``); an amount of
    None makes its sum None."""

    def __init__(self):
        self.rows: Dict[str, Dict[str, Optional[float]]] = {}

    def add(self, name: str, **amounts: Optional[float]) -> None:
        row = self.rows.setdefault(name, {"count": 0})
        row["count"] += 1
        for k, v in amounts.items():
            total = row.get(k, 0)
            row[k] = None if v is None or total is None else total + v


class PhaseTimer:
    """Accumulating named wall-clock phases of the host; ``summary()``
    gives seconds and counts per phase."""

    def __init__(self):
        self._totals = Totals()

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
            self._totals.add(name, total_s=time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": round(r["total_s"], 4), "count": r["count"]}
                for k, r in self._totals.rows.items()}


# -- spans ---------------------------------------------------------------------

SPAN_PREFIX = "ladcast."


@dataclass(slots=True)
class SpanRecord:
    """One span: ``name`` (with :data:`SPAN_PREFIX`), ``parent`` (the index
    in :func:`span_records` of the innermost span open at its entry, None
    for an outermost one), ``trace_id`` (shared by the spans of one
    outermost call), the host's entry and exit on the wall clock
    (``time.time_ns``, the clock of a written profiler trace; the exit None
    while it is open), ``device_s`` (the current stream's time between the
    entry and the exit, from a pair of CUDA events; None without CUDA or
    until resolved) and ``launches`` (the port's hand-written kernels that
    reported a launch (:func:`count_kernel`) while it was the innermost
    open span, by name)."""

    name: str
    parent: Optional[int]
    trace_id: int
    host_start_ns: int
    host_end_ns: Optional[int] = None
    device_s: Optional[float] = None
    launches: Dict[str, int] = field(default_factory=dict)

    @property
    def host_s(self) -> float:
        return (self.host_end_ns - self.host_start_ns) / 1e9


class SpanRecorder:
    """The spans recorded while a profiler ran, in entry order. The CUDA
    events come from a pool per device and go back to it once resolved:
    when the pool runs dry with ``RESOLVE_BATCH`` more spans closed since the
    last try, every closed span whose events the device has passed is
    resolved, and a reader resolves the rest, waiting for them. Under a CUDA
    profiler each CUDA call costs microseconds of host time, and the host
    runs hundreds of spans ahead of the device, so a span makes only its two
    event records where it can."""

    RESOLVE_BATCH = 256

    def __init__(self):
        self.records: List[SpanRecord] = []
        self._open: List[int] = []  # indices in records, innermost last
        self._unresolved = collections.deque()  # (record, start, end, device), closing order
        self._pools: Dict[int, list] = {}
        self._traces = 0
        self._closed = self._next_try = 0  # spans closed; when to try resolving
        self._stream_key, self._stream = None, None

    def _current_stream(self):
        """``torch.cuda.current_stream()``, built again only when the
        current stream changes."""
        key = torch._C._cuda_getCurrentStream(torch.cuda.current_device())
        if key != self._stream_key:
            self._stream_key, self._stream = key, torch.cuda.current_stream()
        return self._stream

    def enter(self, name: str):
        """Open a span; returns what :meth:`exit` takes."""
        parent = self._open[-1] if self._open else None
        if parent is None:
            self._traces += 1
        rec = SpanRecord(SPAN_PREFIX + name, parent, self._traces, time.time_ns())
        self._open.append(len(self.records))
        self.records.append(rec)
        timing = None
        if torch.cuda.is_initialized():
            stream = self._current_stream()
            device = self._stream_key[1]
            pool = self._pools.setdefault(device, [])
            if not pool and self._closed >= self._next_try:
                self._next_try = self._closed + self.RESOLVE_BATCH
                self.resolve(wait=False)
            start, end = pool.pop() if pool else (torch.cuda.Event(enable_timing=True),
                                                  torch.cuda.Event(enable_timing=True))
            start.record(stream)
            timing = (stream, start, end, device)
        return len(self.records) - 1, rec, timing

    def exit(self, entered) -> None:
        index, rec, timing = entered
        if timing is not None:
            stream, start, end, device = timing
            end.record(stream)
            self._unresolved.append((rec, start, end, device))
            self._closed += 1
        rec.host_end_ns = time.time_ns()
        if self._open and self._open[-1] == index:
            self._open.pop()
        elif index in self._open:  # not if the record was reset meanwhile
            del self._open[self._open.index(index):]

    def count_launch(self, kernel: str) -> None:
        if self._open:
            launches = self.records[self._open[-1]].launches
            launches[kernel] = launches.get(kernel, 0) + 1

    def resolve(self, wait: bool) -> None:
        """Give the closed spans their device time, in closing order: all of
        them with ``wait``, else up to the first the device has not passed."""
        while self._unresolved:
            rec, start, end, device = self._unresolved[0]
            if wait:
                end.synchronize()
            elif not end.query():
                return
            rec.device_s = start.elapsed_time(end) / 1e3
            self._unresolved.popleft()
            self._pools.setdefault(device, []).append((start, end))

    def reset(self) -> None:
        self.resolve(wait=True)  # return the events to their pools
        self.records, self._open = [], []
        self._traces = self._closed = self._next_try = 0


_RECORDER = SpanRecorder()


class _NoSpan:
    """What :func:`span` returns while no profiler records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("_name", "_entered")

    def __init__(self, name: str):
        self._name = name

    def __enter__(self):
        self._entered = _RECORDER.enter(self._name)
        return None

    def __exit__(self, *exc):
        _RECORDER.exit(self._entered)
        return False


def span(name: str):
    """A span named ``ladcast.<name>`` around the block while a
    ``torch.profiler`` records; otherwise a shared object that does
    nothing (one check of the profiler's flag, no allocation, no CUDA
    call)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name)


def spanned(name: str):
    """Decorate a function so that each call is a :func:`span`."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _autograd_profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def span_records() -> List[SpanRecord]:
    """Every span recorded since :func:`reset_spans`, in entry order, each
    closed one with its device time (this waits for the device)."""
    _RECORDER.resolve(wait=True)
    return list(_RECORDER.records)


def span_table() -> Dict[str, Dict[str, Optional[float]]]:
    """The closed spans by name: ``count``, ``host_s``, ``device_s``,
    ``self_device_s`` (``device_s`` less that of the spans' children) and
    ``launches`` (of the port's kernels, launched in no child span). The two
    device times are None where a span of the name has none."""
    recs = span_records()
    children_s = [0.0] * len(recs)
    for r in recs:
        if r.parent is not None and r.device_s is not None and r.host_end_ns is not None:
            children_s[r.parent] += r.device_s
    totals = Totals()
    for i, r in enumerate(recs):
        if r.host_end_ns is not None:
            totals.add(r.name, host_s=r.host_s, device_s=r.device_s,
                       self_device_s=None if r.device_s is None else r.device_s - children_s[i],
                       launches=sum(r.launches.values()))
    return totals.rows


def reset_spans() -> None:
    """Forget every span recorded so far; trace ids start again at 1."""
    _RECORDER.reset()


def _span_trace_events(base_ns: int) -> List[dict]:
    """The closed spans as Chrome-trace events of their own track (host
    intervals, us from ``base_ns``), with their device times as arguments."""
    pid = 0x1ADCA5  # a track apart from the profiler's processes
    events = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
               "args": {"name": "ladcast spans"}}]
    for i, r in enumerate(span_records()):
        if r.host_end_ns is None:
            continue
        events.append({"ph": "X", "cat": "ladcast_span", "name": r.name, "pid": pid,
                       "tid": 0, "ts": (r.host_start_ns - base_ns) / 1e3,
                       "dur": (r.host_end_ns - r.host_start_ns) / 1e3,
                       "args": {"index": i, "parent": r.parent, "trace_id": r.trace_id,
                                "device_ms": None if r.device_s is None else r.device_s * 1e3,
                                "launches": r.launches}})
    return events


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the block with ``torch.profiler`` (host ops, and CUDA kernels
    where CUDA is available) and write it on exit as a Chrome-trace JSON,
    ``<log_dir>/trace.json``, which Perfetto and TensorBoard open. Kernels
    launched through ctypes (the port's) are recorded by CUPTI like any
    other. The block's spans (:func:`span`; the record is emptied on entry)
    are one more track of the file, on the same clock, and stay readable by
    :func:`span_table` afterwards. Yields the profiler, whose ``events()``
    the caller may read."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    _sync_device()
    reset_spans()
    with profile(activities=activities) as prof:
        yield prof
        _sync_device()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    if _RECORDER.records:
        with open(path) as f:
            trace = json.load(f)
        trace["traceEvents"] += _span_trace_events(int(trace.get("baseTimeNanoseconds", 0)))
        with open(path, "w") as f:
            json.dump(trace, f)


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
    no wrapper reports, so nothing is counted twice. The launch also counts
    in the innermost open span (:func:`span`)."""
    for counts in _OPEN_COUNTS:
        c = counts.setdefault(name, [0, 0])
        c[0] += 1
        c[1] += flops
    _RECORDER.count_launch(name)


def kernel_entries() -> Dict:
    """The port's kernel entry points by the names they report under; each
    keeps a ``launches`` counter. Beside the hand-written kernels, two
    library calls that ``FlopCounterMode`` does not count: ``int8_mm`` and
    the epilogue GEMM ``dense_gelu_tanh``."""
    from ladcast_torch.ops import (
        adaln_glue,
        dense_conv,
        depthwise_conv,
        flash_attention,
        gelu_gemm,
        quant,
    )

    return {"norm_rope": flash_attention.norm_rope,
            "fused_attention": flash_attention.fused_attention,
            "flash_bwd_dq": flash_attention.flash_bwd_dq,
            "flash_bwd_dkv": flash_attention.flash_bwd_dkv,
            "flash_attention": flash_attention.flash_attention_forward,
            "dense_conv": dense_conv.dense_conv_forward,
            "depthwise_conv": depthwise_conv.depthwise_same_conv_forward,
            "int8_mm": quant.int8_mm,
            "dense_gelu_tanh": gelu_gemm.dense_gelu_tanh,
            **{f.__name__: f for f in adaln_glue.ENTRIES}}


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
