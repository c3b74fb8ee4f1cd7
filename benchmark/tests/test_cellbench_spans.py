"""The per-layer metrics that read the program's spans, on hand-built span
tables: their arithmetic, None where the program's count of a span differs
from the harness's, None without device time (the CPU) and None from a
program that has no spans."""

from types import SimpleNamespace

import pytest

from benchmark import harness, trace
from ladcast_torch.utils import profiling

REG = harness.Registry()
CALLS, REPS = 39, 1
NAMES = ["dit_ms_per_call.forecast", "sampler_self_ms_per_call.forecast",
         "dit_attention_ms_per_call.forecast", "dit_mlp_ms_per_call.forecast",
         "dit_block_self_ms_per_call.forecast", "dcae_decode_ms_per_rep.forecast",
         "attention_op_roofline.forecast", "conv_op_roofline.forecast"]


def row(count, device_s, self_s=None):
    return {"count": count, "host_s": 0.0, "launches": 0, "device_s": device_s,
            "self_device_s": device_s if self_s is None else self_s}


def rec(name, parent, device_s):
    return SimpleNamespace(name="ladcast." + name, parent=parent, device_s=device_s)


def hand_built(calls=CALLS, decodes=REPS, timed=True):
    """A repetition's spans, in seconds: the DiT 1.8 s over ``calls`` calls,
    the rollout 1.9 s, the decode 0.37 s with 0.2 s of dense convs in it."""
    t = lambda s: s if timed else None
    table = {"ladcast.pipeline.forecast": row(1, t(1.9)),
             "ladcast.dit.call": row(calls, t(1.8), t(0.3)),
             "ladcast.dit.refiner_block": row(calls, t(0.1), t(0.02)),
             "ladcast.dit.dual_block": row(2 * calls, t(0.6), t(0.2)),
             "ladcast.dit.single_block": row(4 * calls, t(0.8), t(0.25)),
             "ladcast.dit.attention": row(7 * calls, t(0.5)),
             "ladcast.dit.mlp": row(9 * calls, t(0.53)),
             "ladcast.op.attention": row(7 * calls, t(0.4)),
             "ladcast.pipeline.decode": row(decodes, t(0.37)),
             "ladcast.op.dense_conv": row(3, t(0.25))}
    records = [rec("pipeline.decode", None, t(0.37)), rec("dcae.decode", 0, t(0.36)),
               rec("op.dense_conv", 1, t(0.15)), rec("op.dense_conv", 1, t(0.05)),
               rec("pipeline.encode", None, t(0.05)), rec("op.dense_conv", 4, t(0.05))]
    return table, records


def reading(tr=None):
    cfg = REG.config("ladcast-375m")
    mix = REG.mix("heun20-e20")
    return harness.Reading(tr if tr is not None else trace.Trace(0.0, 1.0, []),
                           {"reps": REPS, "dit_calls": CALLS}, cfg, mix)


@pytest.fixture
def program(monkeypatch):
    def use(table, records):
        monkeypatch.setattr(profiling, "span_table", lambda: table)
        monkeypatch.setattr(profiling, "span_records", lambda: records)
    return use


def read_all(r):
    return {n: REG.metric(n).read(r) for n in NAMES}


def test_each_metric_in_benchmark_json_reads_spans_in_both_forecast_cells():
    entries = {m["name"]: m for m in REG.benchmark()["per_layer"]}
    for n in NAMES:
        m = entries[n]
        assert m["source"] == "program_counter" and m["moves"] == "forecast_rate"
        assert m["workloads"] == ["forecast-375m-heun20", "forecast-1.6b-heun20"]
        assert REG.metric(n).UNIT == m["unit"]


def test_the_arithmetic(program):
    program(*hand_built())
    got = read_all(reading())
    assert got["dit_ms_per_call.forecast"] == pytest.approx(1e3 * 1.8 / CALLS)
    assert got["sampler_self_ms_per_call.forecast"] == pytest.approx(1e3 * 0.1 / CALLS)
    assert got["dit_attention_ms_per_call.forecast"] == pytest.approx(1e3 * 0.5 / CALLS)
    assert got["dit_mlp_ms_per_call.forecast"] == pytest.approx(1e3 * 0.53 / CALLS)
    assert got["dit_block_self_ms_per_call.forecast"] == pytest.approx(1e3 * 0.47 / CALLS)
    assert got["dcae_decode_ms_per_rep.forecast"] == pytest.approx(1e3 * 0.37)
    # the dense convs inside the decode only: 0.2 s, not the encode's 0.05
    conv = REG.metric("conv_roofline.forecast")
    assert got["conv_op_roofline.forecast"] == pytest.approx(
        100.0 * REPS * conv.rep_least_s(REG.config("ladcast-375m"), REG.mix("heun20-e20")) / 0.2)


def test_the_rooflines_read_what_the_name_matched_ones_read_on_the_same_time(program):
    """Where the kernels that the old rooflines match take the time that the
    spans hold, the two read the same: the work formulas are shared."""
    program(*hand_built())
    tr = trace.Trace(0.0, 3e6, [("fa_bf16_wgmma_kernel", 0.0, 0.4e6),
                                ("conv_bf16_wgmma_kernel", 2e6, 2.2e6)])
    tr.host_spans = {"bench.rollout": [(0.0, 1.9e6)], "bench.decode": [(1.9e6, 2.3e6)]}
    r = reading(tr)
    assert REG.metric("attention_op_roofline.forecast").read(r) == pytest.approx(
        REG.metric("attention_roofline.forecast").read(r))
    assert REG.metric("conv_op_roofline.forecast").read(r) == pytest.approx(
        REG.metric("conv_roofline.forecast").read(r))


@pytest.mark.parametrize("calls,decodes", [(CALLS - 1, REPS), (CALLS, REPS + 1)])
def test_none_where_the_programs_count_differs(program, calls, decodes):
    program(*hand_built(calls, decodes))
    got = read_all(reading())
    dit = [n for n in NAMES if n not in ("dcae_decode_ms_per_rep.forecast",
                                         "conv_op_roofline.forecast")]
    off = dit if calls != CALLS else ["dcae_decode_ms_per_rep.forecast",
                                      "conv_op_roofline.forecast"]
    assert all(got[n] is None for n in off)
    assert all(got[n] is not None for n in NAMES if n not in off)


def test_none_without_device_time(program):
    program(*hand_built(timed=False))
    assert all(v is None for v in read_all(reading()).values())


def test_none_from_a_program_without_spans(monkeypatch):
    monkeypatch.delattr(profiling, "span_table")
    monkeypatch.delattr(profiling, "span_records")
    assert all(v is None for v in read_all(reading()).values())


def test_none_on_the_cpu_from_real_spans():
    """The spans that a CPU run records have no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(CALLS):
            with profiling.span("dit.call"):
                torch.ones(2).sum()
        with profiling.span("pipeline.decode"):
            pass
    assert profiling.span_table()["ladcast.dit.call"]["count"] == CALLS
    assert all(v is None for v in read_all(reading()).values())
    profiling.reset_spans()
