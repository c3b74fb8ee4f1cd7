"""Device time of the program's ``pipeline.decode`` span (the DCAE
decoder over the repetition's frames) per repetition, in a traced
repetition: the inside counterpart of ``decode_ms_per_rep.forecast``."""

from benchmark import program_spans as ps

UNIT = "ms"


def read(r):
    t = ps.counted(r, ps.DECODE, "reps")
    return None if t is None else 1e3 * t[ps.DECODE]["device_s"] / r.counts["reps"]
