"""The trace reduction (the frozen copies from chip_smoke.py and what the
metrics read) on synthetic events."""

from benchmark import trace


def synthetic():
    # device: two overlapping kernels, a foreach pass, a cuDNN conv; us
    tr = trace.Trace(0.0, 100.0, [("fa_bf16_wgmma_kernel", 0.0, 10.0),
                                  ("nvjet_tst_gemm", 5.0, 20.0),
                                  ("multi_tensor_apply_kernel", 30.0, 40.0),
                                  ("sm90_xmma_fprop_implicit_gemm", 60.0, 70.0)])
    tr.host_spans = {"bench.rollout": [(0.0, 22.0)], "bench.decode": [(22.0, 80.0)]}
    tr.host_ops = [("aten::linear", 20.0, 30.0), ("aten::cat", 40.0, 60.0)]
    return tr


def test_merged_spans_and_busy_time():
    assert trace.merged_spans([(5, 20), (0, 10), (30, 40), (40, 41)]) == [[0, 20], [30, 41]]
    assert trace.merged_spans([]) == []
    tr = synthetic()
    assert tr.busy_s == 40e-6 and tr.window_s == 100e-6


def test_device_time_by_pattern_and_span():
    tr = synthetic()
    assert tr.device_s(["fa_bf16"]) == 10e-6
    assert tr.device_s(within="bench.rollout") == 20e-6
    assert tr.device_s(within="bench.decode") == 20e-6
    assert tr.device_s(["fprop"], within="bench.rollout") == 0.0
    # the device's own extent of a span wins over the host's
    tr.device_spans = {"bench.rollout": [(0.0, 8.0)]}
    assert tr.device_s(within="bench.rollout") == 8e-6


def test_categories_top_ops_and_gaps():
    assert trace.category("fa_bf16_wgmma_kernel") == "fused_attention"
    assert trace.category("multi_tensor_apply_kernel") == "foreach (AdamW, EMA, norms)"
    assert trace.category("something_else") == "other"
    tr = synthetic()
    top = tr.top_ops()
    assert top[0] == ["gemm: nvjet_tst_gemm", 15e-6]
    gaps = tr.idle_gaps()
    assert [g[1] for g in gaps] == [30e-6, 20e-6, 10e-6]
    assert gaps[0][0] == "bench.decode / -"  # 70..100: no host op
    assert gaps[1][0] == "bench.decode / aten::cat"  # 40..60
    assert gaps[2][0] == "bench.decode / aten::linear"  # 20..30
