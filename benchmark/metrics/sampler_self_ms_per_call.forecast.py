"""Device time of the program's ``pipeline.forecast`` span (the rollout
engine and the sampler around the DiT) less that of its ``dit.call``
spans, per DiT call, in a traced repetition: the sampler's own updates, the
EDM preconditioning and the casts around each call."""

from benchmark import program_spans as ps

UNIT = "ms"


def read(r):
    t = ps.counted(r, ps.CALL, "dit_calls")
    s = None if t is None else ps.device_s(t, ps.FORECAST)
    if s is None:
        return None
    return 1e3 * (s - t[ps.CALL]["device_s"]) / r.counts["dit_calls"]
