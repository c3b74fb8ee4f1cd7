"""Self device time of the program's DiT block spans (``dit.refiner_block``,
``dit.dual_block``, ``dit.single_block``: each block's time less its
attention and MLP spans) per DiT call, in a traced repetition: the block
glue, that is the AdaLN modulation, the gates, the residual adds, the
joint-stream concatenations and the single-stream ``proj_out``."""

from benchmark import program_spans as ps

UNIT = "ms"
BLOCKS = ("ladcast.dit.refiner_block", "ladcast.dit.dual_block", "ladcast.dit.single_block")


def read(r):
    t = ps.counted(r, ps.CALL, "dit_calls")
    s = None if t is None else ps.device_s(t, *BLOCKS, key="self_device_s")
    return None if s is None else 1e3 * s / r.counts["dit_calls"]
