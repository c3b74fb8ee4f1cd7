"""Device time of the program's ``dit.call`` spans (the DiT's forward)
per DiT call, in a traced repetition: the inside counterpart of
``rollout_ms_per_call.forecast``, less the sampler's own work."""

from benchmark import program_spans as ps

UNIT = "ms"


def read(r):
    t = ps.counted(r, ps.CALL, "dit_calls")
    return None if t is None else 1e3 * t[ps.CALL]["device_s"] / r.counts["dit_calls"]
