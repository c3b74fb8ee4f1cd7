"""Device time of the program's ``dit.mlp`` spans (the DiT's MLPs: the
feed-forwards' two GEMMs and activation, and the single-stream blocks'
``proj_mlp`` and GELU) per DiT call, in a traced repetition."""

from benchmark import program_spans as ps

UNIT = "ms"


def read(r):
    t = ps.counted(r, ps.CALL, "dit_calls")
    s = None if t is None else ps.device_s(t, "ladcast.dit.mlp")
    return None if s is None else 1e3 * s / r.counts["dit_calls"]
