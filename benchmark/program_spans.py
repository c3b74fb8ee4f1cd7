"""What the program's own spans recorded in the traced slice, for the
per-layer metrics that read them.

The spans are ``ladcast_torch.utils.profiling``'s: live only while a
profiler records, so here only in the traced repetition, each with its
device time from CUDA events on the stream it ran on (no event of theirs is
in the profiler's trace). A program without them gives None, and so does a
traced slice whose count of a span differs from the harness's count of the
same work, or whose spans have no device time (the CPU)."""

from __future__ import annotations

from typing import Dict, List, Optional

CALL = "ladcast.dit.call"  # one a DiT call
FORECAST = "ladcast.pipeline.forecast"  # one a repetition's rollout
DECODE = "ladcast.pipeline.decode"  # one a repetition's decode


def _profiling():
    from ladcast_torch.utils import profiling

    return profiling


def table() -> Optional[Dict[str, dict]]:
    """The program's ``span_table()``, or None where it has none."""
    read = getattr(_profiling(), "span_table", None)
    return None if read is None else read()


def records() -> Optional[List]:
    """The program's ``span_records()``, or None where it has none."""
    read = getattr(_profiling(), "span_records", None)
    return None if read is None else read()


def counted(r, span: str, count: str) -> Optional[Dict[str, dict]]:
    """The span table where the program's count of ``span`` equals the
    harness's ``r.counts[count]`` and the spans have device time; else
    None."""
    if r.trace is None or not r.counts.get(count):
        return None
    t = table()
    row = None if t is None else t.get(span)
    if row is None or row["count"] != r.counts[count] or not row["device_s"]:
        return None
    return t


def device_s(t: Dict[str, dict], *spans: str, key: str = "device_s") -> Optional[float]:
    """The summed ``key`` (``device_s`` or ``self_device_s``) of the named
    spans that ran, or None where one of them has no device time or none
    ran."""
    rows = [t[s] for s in spans if s in t]
    if not rows or any(row[key] is None for row in rows):
        return None
    return sum(row[key] for row in rows)


def within(span: str, ancestor: str) -> Optional[float]:
    """Device seconds of the spans ``span`` that ran inside a span
    ``ancestor``; None where one of them has no device time."""
    recs = records()
    if recs is None:
        return None
    total = 0.0
    for rec in recs:
        if rec.name != span:
            continue
        up = rec.parent
        while up is not None and recs[up].name != ancestor:
            up = recs[up].parent
        if up is not None:
            if rec.device_s is None:
                return None
            total += rec.device_s
    return total
