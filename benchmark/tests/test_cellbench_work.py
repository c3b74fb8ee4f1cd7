"""The work formulas of the roofline metrics against what
FlopCounterMode counts over the reference, at tiny widths, and the FLOP
counts behind the MFU metrics."""

import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import harness
from benchmark.reference import dcae as ref_dcae
from benchmark.reference import dit as ref_dit
from benchmark.reference.numerics import Numerics
from benchmark.tests import cellbench_tiny
from benchmark.work import meta_params

REG = harness.Registry()


def tiny_config():
    cfg = REG.config("ladcast-375m")
    cfg["dit"].update(cellbench_tiny.TINY_DIT)
    cfg["dcae"].update(cellbench_tiny.TINY_DCAE)
    return cfg


def meta(*shape):
    return torch.empty(shape, device="meta")


def test_attention_work_is_what_the_reference_attention_counts():
    B, S, H, D = 2, 90, 3, 16
    q, k, v = (torch.randn(B, S, H, D, requires_grad=True) for _ in range(3))
    with FlopCounterMode(display=False) as fwd:
        out = ref_dit._attention(Numerics(), q, k, v)
    assert fwd.get_total_flops() == 4 * B * H * S * S * D
    with FlopCounterMode(display=False) as bwd:
        out.sum().backward()
    assert bwd.get_total_flops() == 8 * B * H * S * S * D  # dP, dV, dQ, dK


def attention_flops(cfg):
    """FlopCounterMode's count of each attention of the tiny reference DiT's
    forward at two members, one frame."""
    counts, real = [], ref_dit._attention

    def counted(nm, q, k, v):
        with FlopCounterMode(display=False) as c:
            out = real(nm, q, k, v)
        counts.append(c.get_total_flops())
        return out

    ref_dit._attention = counted
    try:
        net = ref_dit.DiT(cfg["dit"], meta_params(ref_dit.param_spec(cfg["dit"])))
        net(meta(2, 1, 15, 30, 84), meta(2), meta(2, 1, 15, 30, 84), meta(2))
    finally:
        ref_dit._attention = real
    return counts


def test_forecast_attention_roofline_counts_every_attention_of_a_call():
    cfg = tiny_config()
    mix = dict(REG.mix("heun20-e20"), members=2, return_seq_len=1)
    mod = REG.metric("attention_roofline.forecast")
    assert sorted(f for f, _ in mod.attentions(cfg, mix)) == sorted(attention_flops(cfg))


def test_decode_dense_convs_are_the_reference_decoders():
    cfg = tiny_config()
    mod = REG.metric("conv_roofline.forecast")
    seen = []
    nm = Numerics()
    real = nm.conv2d

    def record(x, w, b=None, groups=1):
        if groups == 1 and w.shape[-1] == 3:
            seen.append((x.shape[2] - 2, x.shape[3] - 2, w.shape[1], w.shape[0]))
        return real(x, w, b, groups)

    nm.conv2d = record
    ae = ref_dcae.DCAE(cfg["dcae"], meta_params(ref_dcae.param_spec(cfg["dcae"])), nm)
    ae.decode(meta(1, 15, 30, 84))
    main = [s for s in seen if s[0] > 1]  # the pole rows' convs read k rows
    assert sorted(main) == sorted(mod.dense_convs(cfg["dcae"]))
    h, w, ci, co = main[0]
    with FlopCounterMode(display=False) as c:
        torch.nn.functional.conv2d(meta(3, ci, h, w), meta(co, ci, 3, 3), padding=1)
    assert c.get_total_flops() == 18 * 3 * h * w * ci * co


def test_repetition_flops_are_counted_on_the_reference():
    cfg = tiny_config()
    fmix = dict(REG.mix("heun20-e20"), members=2, return_seq_len=1, steps=3)
    forecast = REG.traffic("forecast").flop_fns(cfg, fmix)
    call, dec = forecast["dit_call"](), forecast["repetition"]() - 5 * forecast["dit_call"]()
    assert call > 0 and dec > 0 and forecast["encode"]() > 0


def test_peaks_are_the_h100_entry():
    from benchmark.work import PEAKS
    assert PEAKS["bf16"] == 989e12 and PEAKS["bytes"] == 3.35e12
    assert json.dumps(PEAKS)
