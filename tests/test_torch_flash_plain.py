"""K6, the plain flash attention with fp32 products (``csrc/flash_plain.cu``):
an emulation of the kernel's tile loop on the CPU, with its tile sizes,
ring depth and number of bf16 terms read from the source, holds
chip_smoke.py's K6 check to the contract (passes the faithful loop, fails
a P rounded once to bf16, fp32 products from two bf16 terms and three
faults of the loop), at Sk = 2250 where the last tile is ragged; K6's bound
and its routing of inputs; and on a card, the kernel against its plain
version at every shape class chip_smoke.py checks."""

import math
import re
from pathlib import Path

import pytest
import torch

import chip_smoke
from ladcast_torch.ops import flash_attention as t_fa

# K6's loop, which the fp32 fused attention shares, lives in the header
SOURCE = (Path(__file__).resolve().parent.parent / "ladcast_torch" / "csrc"
          / "flash_plain.cuh")


def _constant(name):
    """A ``constexpr int`` of K6's loop."""
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text()).group(1))


def _terms(x, n):
    """x as n bf16 terms (fp32 tensors of bf16 values): each the bf16
    rounding of what the terms before it left, as the kernel splits P and
    its split pass splits fp32 inputs."""
    out = []
    for _ in range(n):
        t = x.bfloat16().float()
        out.append(t)
        x = x - t
    return out


def _pairs(ni, nj, top):
    """(i, j) with i < ni, j < nj and i + j <= top, smallest terms first:
    the order of the kernel's products."""
    return [(i, ij - i) for ij in range(top, -1, -1) for i in range(ij, -1, -1)
            if i < ni and ij - i < nj]


def _emulated_k6(q, k, v, fault=None):
    """K6's loop over key tiles, emulated in fp32: the products of bf16 terms
    are exact in fp32, as on the tensor cores; each tile's P.V is summed
    apart and added to O, rounded. The tiles come through a ring of kStages
    slots, as TMA fills them: rows past Sk are zero and keys >= Sk are
    masked."""
    f32 = q.dtype == torch.float32
    planes = _constant("kPlanesF32") if f32 else 1
    tile = _constant("kKeysSplit") if f32 else _constant("kKeysBf16")
    stages, p_terms = _constant("kStages"), _constant("kPTerms")
    top = 1 if fault == "fp32_hi_lo_only" else 2
    if fault == "fp32_hi_lo_only":
        planes = p_terms = 2
    if fault == "p_one_bf16_term":
        p_terms = 1
    B, Sk, H, D = k.shape
    n = -(-Sk // tile)
    pad = torch.zeros(B, n * tile - Sk, H, D)

    def split(x, padded):
        x = torch.cat([x.float(), pad], 1) if padded else x.float()
        return _terms(x.transpose(1, 2), planes)

    qs, ks, vs = split(q, False), split(k, True), split(v, True)
    sl = D ** -0.5 * math.log2(math.e)
    m = torch.full(qs[0].shape[:-1] + (1,), -1e30)
    l = torch.zeros_like(m)
    o = torch.zeros_like(qs[0])
    for t in range(n):
        # a consumer that does not wait on its stage's "full" barrier reads
        # what the slot held kStages tiles before
        src = t - stages if fault == "stale_ring_slot" and t >= 9 else t
        cut = slice(src * tile, (src + 1) * tile)
        s = sum(qs[i] @ ks[j][:, :, cut].transpose(-1, -2)
                for i, j in _pairs(planes, planes, top)) * sl
        if fault != "unmasked_tail":
            s[..., Sk - t * tile:] = -1e30
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        ps = _terms(p, p_terms)
        ot = sum(ps[i] @ vs[j][:, :, cut] for i, j in _pairs(p_terms, planes, top))
        o = (o if fault == "stale_rescale" and t == 5 else o * alpha) + ot
        m = m_new
    return (o / l).transpose(1, 2).to(q.dtype)


def _case(dtype):
    torch.manual_seed(0)
    q = torch.randn(1, 300, 2, 128).to(dtype)
    k, v = (torch.randn(1, 2250, 2, 128).to(dtype) for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("dtype,fault", [
    (torch.bfloat16, None), (torch.float32, None),
    (torch.bfloat16, "p_one_bf16_term"), (torch.float32, "p_one_bf16_term"),
    (torch.float32, "fp32_hi_lo_only"),
    (torch.bfloat16, "stale_ring_slot"), (torch.float32, "stale_ring_slot"),
    (torch.bfloat16, "unmasked_tail"), (torch.float32, "unmasked_tail"),
    (torch.bfloat16, "stale_rescale"), (torch.float32, "stale_rescale")])
def test_smoke_k6_check_holds_the_fp32_contract(dtype, fault):
    """chip_smoke.py's K6 check at Sk = 2250 (ragged last tiles of 10 keys
    from 32 or 64): it passes the faithful emulation of the kernel's loop in
    both dtypes and fails each fault, including the two that break the
    contract's arithmetic without breaking the loop: a P rounded once to
    bf16 (what SDPA and the composite do) and fp32 products carried by two
    bf16 terms instead of three."""
    assert [_constant(n) for n in ("kPTerms", "kPlanesF32", "kStages", "kKeysBf16",
                                   "kKeysSplit")] == [3, 3, 2, 64, 32]
    q, k, v = _case(dtype)
    dname = str(dtype).split(".")[-1]
    ref = t_fa.flash_attention_plain(q, k, v)
    out = _emulated_k6(q, k, v, fault)
    rec = chip_smoke.compare(out, ref, chip_smoke.kernel_tolerance(
        "flash_attention", dname, ref))
    assert rec["ok"] == (fault is None), rec


def test_k6_limits_are_its_own():
    """K6's relative L2 limits are tighter than the other kernels'; the
    composite it is compared with on the op's path keeps the general ones,
    and so does K1 in bf16 (in fp32 it has a limit of its own, since it runs
    K6's loop: tests/test_torch_flash_f32.py)."""
    ref = torch.randn(4, 8)
    for dname, k6, general in (("bfloat16", 5e-4, 5e-3), ("float32", 2e-6, 1e-4)):
        assert chip_smoke.kernel_tolerance("flash_attention", dname, ref)["rel_l2"] == k6
        assert chip_smoke.kernel_tolerance("dot_product_attention", dname,
                                           ref)["rel_l2"] == general
        k1 = chip_smoke.F32_REL_L2["fused_attention"] if dname == "float32" else general
        assert chip_smoke.kernel_tolerance("fused_attention", dname,
                                           ref)["rel_l2"] == k1 <= general


@pytest.mark.parametrize("dname,passes,ms", [("bfloat16", 4, 0.125800), ("float32", 6, 0.377399)])
def test_k6_bound_at_the_timed_shape(dname, passes, ms):
    """K6's bound at (2, 2250, 12, 128) on an H100 SXM: passes of 2 B H S^2 D
    = 3.1104e10 flop, bf16 at 989 TFLOP/s or TF32 at 494.5, well above the
    bytes of q, k, v and o (27.6 or 55.3 MB at 3.35 TB/s: 8.3 or 16.5 us)."""
    peaks = chip_smoke.PEAKS[-1][1:]
    got = chip_smoke.flash_plain_bound(2, 2250, 2250, 12, 128, dname, peaks)
    assert got["bound_passes"] == passes
    assert got["flops"] == passes * 31_104_000_000
    assert got["bound_by"] == "operations"
    assert got["bound_ms"] == pytest.approx(ms, abs=1e-6)


def test_peaks_give_tf32_at_half_the_bf16_rate():
    for _, bf16, _, _, tf32 in chip_smoke.PEAKS:
        assert tf32 == bf16 / 2


def test_k6_routes_inputs_by_dtype_and_head_size():
    """fp32 inputs go through the three-plane split; bf16 inputs are read in
    place unless TMA cannot load their rows (D no multiple of 8), which
    chip_smoke.py's d36 case covers; heads pad to 64, 128 or 256."""
    assert t_fa.split_planes(torch.float32, 128) == _constant("kPlanesF32")
    assert [t_fa.split_planes(torch.bfloat16, d) for d in (64, 128, 256, 72, 36, 130)] \
        == [0, 0, 0, 0, 1, 1]
    assert [t_fa.padded_head(d) for d in (1, 36, 64, 65, 128, 130, 256)] \
        == [64, 64, 64, 128, 128, 256, 256]
    cases = {name: shape for name, shape, _ in chip_smoke.K6_CASES}
    assert cases["s2250"] == (2, 2250, 2250, 12, 128)
    assert cases["sq75_sk150"][1] != cases["sq75_sk150"][2]
    assert cases["d256"][-1] == 256
    assert t_fa.split_planes(torch.bfloat16, cases["d36"][-1]) == 1


# ------------------------------------------------------------- on a card --

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k6_matches_plain_on_cuda(dtype):
    """K6 against its plain version at each untimed shape class of
    chip_smoke.py, with K6's own limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dname = str(dtype).split(".")[-1]
    g = torch.Generator(device="cuda").manual_seed(0)
    for name, (B, Sq, Sk, H, D), timed in chip_smoke.K6_CASES:
        if timed:
            continue
        q = torch.randn(B, Sq, H, D, generator=g, device="cuda").to(dtype)
        k, v = (torch.randn(B, Sk, H, D, generator=g, device="cuda").to(dtype)
                for _ in range(2))
        before = t_fa.flash_attention_forward.launches
        out, ref = t_fa.flash_attention_forward(q, k, v), t_fa.flash_attention_plain(q, k, v)
        assert t_fa.flash_attention_forward.launches == before + 1
        rec = chip_smoke.compare(out, ref, chip_smoke.kernel_tolerance(
            "flash_attention", dname, ref))
        assert rec["ok"], (name, rec)
