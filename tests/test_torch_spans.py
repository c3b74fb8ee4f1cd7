"""The port's spans (``utils.profiling.span``) on the CPU: off without a
profiler, a record with parents, trace ids, self time and kernel launches
under one, nothing of theirs among the profiler's events, the forecast
path's span sites at tiny widths, and the track that ``device_trace``
writes."""

import collections
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ladcast_torch.config import DCAEConfig, EDMSchedulerConfig, LaDCastDiTConfig, RolloutConfig
from ladcast_torch.models.dcae import SphereConv, build_dcae
from ladcast_torch.models.ladcast_dit import build_dit
from ladcast_torch.rollout.pipeline import ForecastPipeline
from ladcast_torch.utils import profiling

DIT_KW = dict(in_channels=84, out_channels=84, num_attention_heads=2,
              attention_head_dim=16, num_layers=1, num_single_layers=1,
              num_refiner_layers=1, mlp_ratio=2.0, rope_axes_dim=(4, 6, 6),
              conditioning_tensor_rope_axes_dim=(4, 6, 6),
              conditioning_tensor_in_channels=84)
DCAE_KW = dict(in_channels=89, out_channels=89, latent_channels=84,
               attention_head_dim=4,
               encoder_block_out_channels=(84, 84, 84, 84),
               decoder_block_out_channels=(84, 84, 84, 84),
               encoder_layers_per_block=(1, 1, 1, 1),
               decoder_layers_per_block=(1, 1, 1, 1), static_channels=5)
STEPS = 2


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Two intra-op threads per worker on the shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def stand_in_kernel(x):
    """As a wrapper that launched a hand-written kernel: it reports it."""
    profiling.count_kernel("fused_attention", 0)
    return x + 1


def test_spans_are_off_without_a_profiler(monkeypatch):
    def no_cuda(*a, **k):
        raise AssertionError("a span made a CUDA call with no profiler")

    monkeypatch.setattr(torch.cuda, "is_initialized", no_cuda)
    monkeypatch.setattr(torch.cuda, "Event", no_cuda)
    profiling.reset_spans()
    off = profiling.span("a")
    assert off is profiling.span("b")  # the shared no-op object
    with off as got:
        assert got is None
        stand_in_kernel(torch.ones(2))

    @profiling.spanned("c")
    def f(x):
        return stand_in_kernel(x)

    assert f(torch.ones(1)).item() == 2.0
    assert profiling.span_records() == [] and profiling.span_table() == {}


def test_live_spans_nest_with_parents_trace_ids_and_launches():
    profiling.reset_spans()
    with cpu_profile() as prof:
        with profiling.span("call"):
            with profiling.span("block"):
                stand_in_kernel(torch.ones(3) @ torch.ones(3))
                with profiling.span("op"):
                    stand_in_kernel(torch.ones(2))
                    stand_in_kernel(torch.ones(2))
            with profiling.span("block"):
                pass
        with profiling.span("call"):
            pass
    recs = profiling.span_records()
    assert [r.name for r in recs] == ["ladcast.call", "ladcast.block", "ladcast.op",
                                      "ladcast.block", "ladcast.call"]
    assert [r.parent for r in recs] == [None, 0, 1, 0, None]
    assert [r.trace_id for r in recs] == [1, 1, 1, 1, 2]
    assert [r.launches for r in recs] == [{}, {"fused_attention": 1},
                                          {"fused_attention": 2}, {}, {}]
    for r in recs:
        assert r.device_s is None  # no CUDA
        assert r.host_end_ns >= r.host_start_ns
        if r.parent is not None:
            p = recs[r.parent]
            assert p.host_start_ns <= r.host_start_ns and r.host_end_ns <= p.host_end_ns
    table = profiling.span_table()
    assert list(table) == ["ladcast.call", "ladcast.block", "ladcast.op"]
    assert [table[k]["count"] for k in table] == [2, 2, 1]
    assert [table[k]["launches"] for k in table] == [0, 1, 2]
    assert all(t["device_s"] is None and t["self_device_s"] is None for t in table.values())
    assert table["ladcast.call"]["host_s"] >= table["ladcast.block"]["host_s"] >= 0
    # no span of the program among the profiler's own events
    assert not [e for e in prof.events() if e.name.startswith(profiling.SPAN_PREFIX)]
    assert any(e.name == "aten::matmul" for e in prof.events())


def test_self_time_is_device_time_less_the_childrens():
    profiling.reset_spans()
    with cpu_profile():
        with profiling.span("call"):
            with profiling.span("block"):
                with profiling.span("op"):
                    pass
            with profiling.span("block"):
                pass
    recs = profiling.span_records()
    for r, ms in zip(recs, (10.0, 6.0, 4.0, 3.0)):  # as CUDA events would resolve
        r.device_s = ms / 1e3
    table = profiling.span_table()
    got = {k: (round(v["device_s"] * 1e3, 9), round(v["self_device_s"] * 1e3, 9))
           for k, v in table.items()}
    assert got == {"ladcast.call": (10.0, 1.0), "ladcast.block": (9.0, 5.0),
                   "ladcast.op": (4.0, 4.0)}
    profiling.reset_spans()
    assert profiling.span_records() == []


def test_reset_inside_an_open_span_keeps_the_record_whole():
    profiling.reset_spans()
    with cpu_profile():
        with profiling.span("outer"):
            profiling.reset_spans()
            with profiling.span("inner"):
                pass
        with profiling.span("next"):
            pass
    recs = profiling.span_records()
    assert [(r.name, r.parent) for r in recs] == [("ladcast.inner", None),
                                                  ("ladcast.next", None)]


class StandInEvent:
    """A CUDA event on a stand-in device whose clock advances 1 ms a record;
    the device is ``LAG`` records behind the host."""
    LAG = 6
    made = 0
    clock = 0.0
    failed_queries = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        StandInEvent.made += 1
        self.at = None

    def record(self, stream):
        assert stream == "the stream"
        StandInEvent.clock += 1.0
        self.at = StandInEvent.clock

    def query(self):
        done = self.at is not None and self.at <= StandInEvent.clock - self.LAG
        StandInEvent.failed_queries += not done
        return done

    def synchronize(self):
        assert self.at is not None

    def elapsed_time(self, end):
        return end.at - self.at


def test_device_times_come_from_pooled_events(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentStream", lambda d: (7, d, 1), raising=False)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: "the stream")
    monkeypatch.setattr(torch.cuda, "Event", StandInEvent)
    monkeypatch.setattr(profiling.SpanRecorder, "RESOLVE_BATCH", 4)
    monkeypatch.setattr(profiling, "_RECORDER", profiling.SpanRecorder())
    StandInEvent.made = StandInEvent.failed_queries = 0
    with cpu_profile():
        with profiling.span("call"):  # records at 1 and 4
            with profiling.span("op"):  # 2 and 3
                pass
        for _ in range(50):
            with profiling.span("step"):
                pass
    recs = profiling.span_records()
    assert [r.device_s for r in recs[:2]] == [3e-3, 1e-3]
    assert all(r.device_s == 1e-3 for r in recs[2:])
    table = profiling.span_table()
    assert table["ladcast.call"]["self_device_s"] == pytest.approx(2e-3)
    # the events go back to the pool once resolved: far fewer than 2 a span;
    # a try that finds the device behind waits for RESOLVE_BATCH more spans
    assert StandInEvent.made <= 2 * (profiling.SpanRecorder.RESOLVE_BATCH + StandInEvent.LAG + 3)
    assert 0 < StandInEvent.failed_queries <= 52 // profiling.SpanRecorder.RESOLVE_BATCH + 1
    assert profiling._RECORDER._unresolved == collections.deque()


@pytest.fixture(scope="module")
def pipe():
    dit_cfg, dcae_cfg = LaDCastDiTConfig(**DIT_KW), DCAEConfig(**DCAE_KW)
    rcfg = RolloutConfig(ensemble_size=2, num_inference_steps=STEPS, return_seq_len=2,
                         input_seq_len=1, total_lead_time_hour=12, step_size_hour=6)
    dit = build_dit(dit_cfg, "cpu", seed=1)
    dcae = build_dcae(dcae_cfg, "cpu", seed=2)
    return ForecastPipeline(dit_cfg, dcae_cfg, EDMSchedulerConfig(), rcfg,
                            dit.state_dict(), dcae.state_dict(),
                            compute_dtype="float32", device="cpu")


def test_the_forecast_path_records_its_spans(pipe):
    g = torch.Generator().manual_seed(3)
    fields = torch.randn(1, 120, 240, 84, generator=g)
    profiling.reset_spans()
    with cpu_profile() as prof:
        z = pipe.encode_fields(fields)
        known = pipe.normalize_latent(z)[None].expand(2, *z.shape)
        traj = pipe.forecast_latents(known, [0.1], seed=4)
        pipe.decode_latents(traj, chunk=3)
    assert not [e for e in prof.events() if e.name.startswith(profiling.SPAN_PREFIX)]
    recs = profiling.span_records()
    table = profiling.span_table()
    count = {k[len(profiling.SPAN_PREFIX):]: v["count"] for k, v in table.items()}
    frames = 2 * 2
    assert count["pipeline.encode"] == count["dcae.encode"] == 1
    assert count["pipeline.forecast"] == count["pipeline.decode"] == 1
    assert count["rollout.repetition"] == 1
    assert count["sampler.step"] == STEPS
    assert count["dit.call"] == 2 * STEPS - 1
    assert count["dcae.decode"] == -(-frames // 3)

    def children(i, name):
        return [r for r in recs if r.parent == i and r.name == profiling.SPAN_PREFIX + name]

    blocks = {"dit.refiner_block": 1, "dit.dual_block": 2, "dit.single_block": 1}
    for i, r in enumerate(recs):
        short = r.name[len(profiling.SPAN_PREFIX):]
        if short == "dit.call":
            assert recs[r.parent].name == "ladcast.sampler.step"
            assert sum(len(children(i, b)) for b in blocks) == 3
        if short in blocks:
            # one attention a block; the dual-stream block's two MLPs (ff,
            # ff_context), one in the others
            assert recs[r.parent].name == "ladcast.dit.call"
            assert len(children(i, "dit.attention")) == 1
            assert len(children(i, "dit.mlp")) == blocks[short]
        if short == "dit.attention":
            assert len(children(i, "op.attention")) == 1
    assert count["dit.attention"] == count["op.attention"] == 3 * (2 * STEPS - 1)
    assert count["dit.mlp"] == 4 * (2 * STEPS - 1)

    dec = pipe.dcae.decoder.modules()
    dense = sum(isinstance(m, SphereConv) and m.groups == 1 for m in dec)
    depthwise = sum(isinstance(m, SphereConv) and m.groups > 1
                    for m in pipe.dcae.decoder.modules())
    in_decode = [r for r in recs if r.name.startswith("ladcast.op.")
                 and any(recs[a].name == "ladcast.pipeline.decode" for a in ancestors(recs, r))]
    assert sum(r.name == "ladcast.op.dense_conv" for r in in_decode) == dense * count["dcae.decode"]
    assert (sum(r.name == "ladcast.op.depthwise_conv" for r in in_decode)
            == depthwise * count["dcae.decode"])
    assert dense and depthwise
    assert len({r.trace_id for r in recs}) == 3  # encode, forecast, decode
    assert all(t["device_s"] is None for t in table.values())


def ancestors(recs, r):
    while r.parent is not None:
        yield r.parent
        r = recs[r.parent]


def test_device_trace_writes_the_spans_on_the_profilers_clock(tmp_path):
    x = torch.randn(64, 64)
    with profiling.span("before"):  # off: no profiler yet
        pass
    with profiling.device_trace(str(tmp_path)) as prof:
        with profiling.span("outer"):
            with profiling.span("inner"):
                y = x @ x
            y.relu_()
    assert not [e for e in prof.events() if e.name.startswith(profiling.SPAN_PREFIX)]
    trace = json.loads((tmp_path / "trace.json").read_text())
    events = trace["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("cat") == "ladcast_span"}
    assert set(spans) == {"ladcast.outer", "ladcast.inner"}
    assert spans["ladcast.inner"]["args"]["parent"] == spans["ladcast.outer"]["args"]["index"]

    def op(name):
        return next(e for e in events if e.get("name") == name and e.get("ph") == "X")

    def encloses(s, e):
        return s["ts"] <= e["ts"] and e["ts"] + e["dur"] <= s["ts"] + s["dur"]

    mm, relu = op("aten::mm"), op("aten::relu_")
    assert encloses(spans["ladcast.outer"], mm) and encloses(spans["ladcast.outer"], relu)
    assert encloses(spans["ladcast.inner"], mm) and not encloses(spans["ladcast.inner"], relu)
    # the record stays readable after the trace
    assert profiling.span_table()["ladcast.inner"]["count"] == 1


def test_device_trace_of_a_dit_call_holds_every_span(tmp_path, pipe):
    lat = torch.randn(1, 2, 15, 30, 84)
    cond = torch.randn(1, 1, 15, 30, 84)
    with profiling.device_trace(str(tmp_path)):
        with torch.no_grad():
            pipe.dit(lat, torch.ones(1), cond, torch.zeros(1))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    in_file = {}
    for e in events:
        if e.get("cat") == "ladcast_span":
            in_file[e["name"]] = in_file.get(e["name"], 0) + 1
    assert in_file == {k: v["count"] for k, v in profiling.span_table().items()}
    assert in_file["ladcast.dit.call"] == 1 and in_file["ladcast.op.attention"] == 3
    ops = [e for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"
           and e["name"].startswith("aten::")]
    call = next(e for e in events if e.get("name") == "ladcast.dit.call")
    # the ops of the call lie inside its span, and some op runs in it
    assert any(call["ts"] <= e["ts"] and e["ts"] + e["dur"] <= call["ts"] + call["dur"]
               for e in ops)
