"""The whole forecast's share of the card's dense bf16 peak over the
window: the repetitions' and encodes' FLOPs (counted on the reference:
2 steps - 1 DiT calls at the ensemble's batch and the decode of its
frames a repetition) over the window's time."""

from benchmark.work import PEAKS

UNIT = "%"


def read(r):
    c = r.counts
    if not c.get("window_reps"):
        return None
    flops = c["window_reps"] * r.flops("repetition") + c["window_encodes"] * r.flops("encode")
    return 100.0 * flops / (c["window_s"] * PEAKS["bf16"])
