"""Device time of the program's ``dit.attention`` spans (the DiT's
attention modules: Q/K/V projections, the joint-stream concatenations, K2
and K1 or whatever implements them, the output projections) per DiT call,
in a traced repetition."""

from benchmark import program_spans as ps

UNIT = "ms"


def read(r):
    t = ps.counted(r, ps.CALL, "dit_calls")
    s = None if t is None else ps.device_s(t, "ladcast.dit.attention")
    return None if s is None else 1e3 * s / r.counts["dit_calls"]
