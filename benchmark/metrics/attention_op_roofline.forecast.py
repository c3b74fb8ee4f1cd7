"""The forecast attention's share of its roofline in a traced repetition,
over the device time of the program's ``op.attention`` spans (K2 and K1,
or whatever implements them, with the gaps between their launches) in
place of kernels matched by name. The work is the formula of
``attention_roofline.forecast``, loaded from its file."""

from pathlib import Path

from benchmark import program_spans as ps
from benchmark.harness import load_module

UNIT = "%"
WORK = load_module(Path(__file__).with_name("attention_roofline.forecast.py"),
                   "benchmark_metric_attention_roofline_forecast_work")


def read(r):
    t = ps.counted(r, ps.CALL, "dit_calls")
    s = None if t is None else ps.device_s(t, "ladcast.op.attention")
    if not s:
        return None
    return 100.0 * r.counts["dit_calls"] * WORK.call_least_s(r.config, r.traffic) / s
