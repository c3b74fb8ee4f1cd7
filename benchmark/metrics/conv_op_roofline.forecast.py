"""The decode's dense 3x3 convolutions' share of their roofline in a
traced repetition, over the device time of the program's ``op.dense_conv``
spans inside ``pipeline.decode`` (every kernel of each conv, K4 and the
pole rows' cuDNN strips alike) in place of kernels matched by name. The
work is the formula of ``conv_roofline.forecast``, loaded from its file."""

from pathlib import Path

from benchmark import program_spans as ps
from benchmark.harness import load_module

UNIT = "%"
WORK = load_module(Path(__file__).with_name("conv_roofline.forecast.py"),
                   "benchmark_metric_conv_roofline_forecast_work")


def read(r):
    if ps.counted(r, ps.DECODE, "reps") is None:
        return None
    s = ps.within("ladcast.op.dense_conv", ps.DECODE)
    if not s:
        return None
    return 100.0 * r.counts["reps"] * WORK.rep_least_s(r.config, r.traffic) / s
