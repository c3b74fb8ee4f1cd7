"""Device time inside the harness's ``bench.rollout`` span (the
pipeline's ``forecast_latents``: the sampler, the rollout engine and the
DiT) per DiT call, in a traced repetition."""

UNIT = "ms"


def read(r):
    if r.trace is None or not r.counts.get("dit_calls"):
        return None
    s = r.trace.device_s(within="bench.rollout")
    return 1e3 * s / r.counts["dit_calls"] if s > 0 else None
