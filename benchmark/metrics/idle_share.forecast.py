"""The device's idle share over a traced forecast repetition: 100 % minus
the union of its device events over the slice's wall time (the forecast
keeps the device busy, so the profiler's cost on the host does not
stretch the slice)."""

UNIT = "%"


def read(r):
    if r.trace is None or not r.trace.busy_s or not r.counts.get("reps"):
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
