"""Device time inside the harness's ``bench.decode`` span (the
pipeline's ``decode_latents``: the DCAE decoder over the repetition's
frames) per repetition, in a traced repetition."""

UNIT = "ms"


def read(r):
    if r.trace is None or not r.counts.get("reps"):
        return None
    s = r.trace.device_s(within="bench.decode")
    return 1e3 * s / r.counts["reps"] if s > 0 else None
