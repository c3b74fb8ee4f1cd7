"""The reduction of a ``torch.profiler`` trace to what the per-layer
metrics read: the device's busy time over the traced slice, device time by
kernel name and by harness span, and the longest idle gaps with what the
host was doing in each.

``merged_spans``, ``CATEGORIES`` and ``category`` are frozen copies of
``chip_smoke.py``'s (``merged_spans``, ``trace_summary``'s busy time and
``category``): the spans that the profiler draws on the device's timeline
for ``record_function`` labels are not device work."""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

SPAN_PREFIX = "bench."  # the harness's record_function spans
Interval = Tuple[float, float]  # microseconds


def merged_spans(intervals: Iterable[Interval]) -> List[List[float]]:
    """The union of (start, end) intervals, sorted, in us."""
    spans = sorted(intervals)
    if not spans:
        return []
    out = [list(spans[0])]
    for s0, e0 in spans[1:]:
        if s0 > out[-1][1]:
            out.append([s0, e0])
        else:
            out[-1][1] = max(out[-1][1], e0)
    return out


CATEGORIES = [("fused_attention", ("fa_bf16_wgmma_kernel", "fa_f32_wgmma_kernel",
                                    "fa_f32_split_kernel")),
              ("flash_bwd", ("bwd_dq_bf16_wgmma_kernel", "bwd_dkv_bf16_wgmma_kernel",
                             "bwd_dq_f32_wgmma_kernel", "bwd_dkv_f32_wgmma_kernel",
                             "bwd_f32_split_kernel")),
              ("norm_rope", ("norm_rope_kernel",)),
              ("flash_plain (K6)", ("fa_plain_wgmma_kernel", "fa_plain_split_kernel")),
              ("dense_conv (K4)", ("conv_bf16_wgmma_kernel", "conv_f32_wgmma_kernel")),
              ("depthwise_conv (K5)", ("dw_rows_kernel",)),
              ("foreach (AdamW, EMA, norms)", ("multi_tensor_apply",)),
              ("cudnn_conv", ("fprop", "dgrad", "conv", "winograd", "nchwToNhwc",
                              "nhwcToNchw")),
              ("gemm", ("nvjet", "gemm", "xmma", "cutlass", "s16816", "wgmma")),
              ("reduction", ("reduce", "norm", "softmax")),
              ("copy_cat", ("CatArray", "Copy", "copy", "flip", "roll",
                            "index")),
              ("elementwise", ("elementwise", "vectorized", "fill"))]


def category(kernel_name: str) -> str:
    """The profile category of a device kernel, by name."""
    return next((c for c, frags in CATEGORIES
                 if any(f in kernel_name for f in frags)), "other")


def _clip(a: Sequence[List[float]], b: Sequence[List[float]]) -> float:
    """Length of the intersection of two sorted unions of intervals, us."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


@dataclass
class Trace:
    """The traced slice: device events (name, start, end), the harness's
    spans on the host and, where the profiler drew them, on the device's
    timeline, and the host's ops, all in us."""

    t0: float
    t1: float
    device: List[Tuple[str, float, float]]
    host_spans: Dict[str, List[Interval]] = field(default_factory=dict)
    device_spans: Dict[str, List[Interval]] = field(default_factory=dict)
    host_ops: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in merged_spans((s, e) for _, s, e in self.device)) / 1e6

    def span_intervals(self, span: str) -> List[List[float]]:
        """Where the device worked for ``span``: its extent on the device's
        timeline where the profiler drew it, else its extent on the host."""
        return merged_spans(self.device_spans.get(span) or self.host_spans.get(span, []))

    def device_s(self, patterns: Optional[Sequence[str]] = None,
                 within: Optional[str] = None) -> float:
        """Seconds in which a device event ran whose name matches one of the
        regular expressions ``patterns`` (all events without), inside
        ``span`` if given."""
        rx = None if patterns is None else re.compile("|".join(patterns))
        ev = merged_spans((s, e) for n, s, e in self.device if rx is None or rx.search(n))
        if within is None:
            return sum(e - s for s, e in ev) / 1e6
        return _clip(ev, self.span_intervals(within)) / 1e6

    def top_ops(self, n: int = 10) -> List[list]:
        """The device ops that took most time, named with their category."""
        by: Dict[str, float] = {}
        for name, s, e in self.device:
            key = f"{category(name)}: {name[:80]}"
            by[key] = by.get(key, 0.0) + (e - s) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The longest stretches without device work, each named by the
        harness span and the host op that overlap it most."""
        busy = merged_spans((s, e) for _, s, e in self.device)
        edges = [self.t0] + [x for s, e in busy for x in (s, e)] + [self.t1]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                       for i in range(0, len(edges) - 1, 2) if edges[i + 1] > edges[i]),
                      reverse=True)[:n]
        out = []
        for length, g0, g1 in gaps:
            def most(items):
                acc: Dict[str, float] = {}
                for name, s, e in items:
                    o = min(e, g1) - max(s, g0)
                    if o > 0:
                        acc[name] = acc.get(name, 0.0) + o
                return max(acc, key=acc.get) if acc else "-"
            spans = [(k, s, e) for k, iv in self.host_spans.items() for s, e in iv]
            out.append([f"{most(spans)} / {most(self.host_ops)[:64]}", length / 1e6])
        return out


WINDOW_SPAN = SPAN_PREFIX + "trace"  # encloses the traced slice


def from_profiler(prof) -> Trace:
    """A :class:`Trace` of the events of ``prof`` inside its
    ``bench.trace`` span, which ends after the device's work."""
    from torch.autograd import DeviceType

    events = prof.events()
    win = next(e for e in events if e.name == WINDOW_SPAN
               and e.device_type == DeviceType.CPU)
    tr = Trace(win.time_range.start, win.time_range.end, [])
    for e in events:
        if e.name == WINDOW_SPAN:
            continue
        s, en, name = e.time_range.start, e.time_range.end, e.name
        if e.device_type == DeviceType.CUDA:
            if name.startswith(SPAN_PREFIX):
                tr.device_spans.setdefault(name, []).append((s, en))
            else:
                tr.device.append((name, s, en))
        elif name.startswith(SPAN_PREFIX):
            tr.host_spans.setdefault(name, []).append((s, en))
        else:
            tr.host_ops.append((name, s, en))
    return tr
