"""The fp32 K1 (``csrc/fused_attention.cu`` ``fa_f32_wgmma_kernel``, on the
loop of ``csrc/flash_plain.cuh``) and the fp32 K3 (``csrc/flash_bwd.cu``
``bwd_dq_f32_wgmma_kernel``, ``bwd_dkv_f32_wgmma_kernel``): emulations of
the kernels' tile loops on the CPU, with their tile sizes, ring depth and
numbers of bf16 planes and terms read from the sources, hold chip_smoke.py's
fp32 checks to the contract. At S = 2250 (ragged last tiles of 10 rows) the
checks pass the faithful loops and fail each injected fault, including
those that break the arithmetic without breaking the loop: fp32 products
from two bf16 planes (hi.hi, hi.mid, mid.hi) instead of three, and P or dS
carried by one bf16 term. Also the Q-side split (norm, RoPE and scale in
fp32, then the planes) against ``_norm_rope_f32``, and on a card, the
kernels against their plain versions.

The emulations sum exact products of bf16 terms in fp32, as the tensor
cores do, each walked tile's products apart (the kernels' fresh
accumulator), added to the running sums in fp32; wgmma's own accumulation,
coarser than fp32 adds, is not emulated (on the card the plain attention,
which shares K1's loop, read about twice its emulation's error: PERF.md).
"""

import functools
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from ladcast_torch.ops import flash_attention as t_fa
from tests.test_torch_ops import _segment_inputs

CSRC = Path(__file__).resolve().parent.parent / "ladcast_torch" / "csrc"
S, D = 2250, 128  # the training and inference length; the only head size
LOG2E = math.log2(math.e)


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """The test suite runs files in parallel workers on a shared CPU; two
    intra-op threads per worker keep them from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _constant(source, name):
    """A ``constexpr int NAME = N;`` of a CUDA source in csrc/."""
    text = (CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def _k1_constants():
    """The fp32 K1's loop: K6's at D = 128 with three planes."""
    return {n: _constant("flash_plain.cuh", n)
            for n in ("kPTerms", "kPlanesF32", "kStages", "kKeysSplit")}


def _k3_constants():
    return {"planes": _constant("norm_rope.cuh", "kPlanes"),
            **{n: _constant("flash_bwd.cu", n)
               for n in ("kF32Rows", "kF32Walk", "kF32Stages")}}


def _terms(x, n):
    """x as n bf16 terms (fp32 tensors of bf16 values): each the rounding
    to nearest of what the terms before it left, as the split passes split
    the inputs and the kernels split P and dS."""
    out = []
    for _ in range(n):
        t = x.bfloat16().float()
        out.append(t)
        x = x - t
    return out


def _pairs(ni, nj, top):
    """(i, j) with i < ni, j < nj and i + j <= top, smallest terms first:
    the order of the kernels' products."""
    return [(i, ij - i) for ij in range(top, -1, -1) for i in range(ij, -1, -1)
            if i < ni and ij - i < nj]


def _products(a, b, top, a_t=False):
    """sum of a[i] @ b[j] (b[j] transposed when ``a_t`` is False: logits)
    over the plane pairs, smallest first, summed in fp32."""
    out = None
    for i, j in _pairs(len(a), len(b), top):
        x = a[i] @ (b[j] if a_t else b[j].transpose(-1, -2))
        out = x if out is None else out + x
    return out


@functools.lru_cache(maxsize=None)
def _inputs(seed=0):
    """numpy-seeded fp32 inputs at S = 2250, one head: q, k, v, g and the
    Q and K tables (a rotated head and an un-rotated tail with its own norm
    weight, as the DiT's dual-stream segments)."""
    q, k, v, qcos, qsin, qw, kcos, ksin, kw = map(
        torch.from_numpy, _segment_inputs(1, S, S, 1, D, seed, n_ident=450))
    g = torch.from_numpy(np.random.RandomState(seed + 1).randn(1, S, 1, D)
                         .astype(np.float32))
    return q, k, v, g, qcos, qsin, qw, kcos, ksin, kw


@functools.lru_cache(maxsize=None)
def _k1_case():
    """K1's inputs (q, kn, v and Q's tables) and its plain (out, lse)."""
    q, k, v, _, qcos, qsin, qw, kcos, ksin, kw = _inputs()
    kn = t_fa.norm_rope_plain(k, kw, kcos, ksin)
    args = (q, kn, v, qcos, qsin, qw)
    return args, t_fa.fused_attention_plain(*args, return_lse=True)


@functools.lru_cache(maxsize=None)
def _k3_case():
    """K3's inputs over the plain forward's statistics, and its plain
    (dq, dk, dv)."""
    q, k, v, g, qcos, qsin, qw, kcos, ksin, kw = _inputs()
    (q_, kn, v_, *_), (out, lse) = _k1_case()
    qn = t_fa.norm_rope_plain(q, qw, qcos, qsin)
    delta = torch.einsum("bqhd,bqhd->bhq", g, out)
    args = (qn, kn, v, g, lse, delta, D ** -0.5)
    return args, t_fa.flash_bwd_plain(*args)


# ------------------------------------------------------------------ K1 ---

def _split_q(q, qw, qcos, qsin, fault=None):
    """The Q side of the fp32 K1's split pass: norm, RoPE and 1/sqrt(D)
    scale in fp32, before the planes. Faults: Q rounded to bf16 before its
    norm (``q_rounded_before_norm``), the RoPE left out
    (``q_split_before_rope``)."""
    scale = 1.0 / (D ** 0.5)  # as the wrapper passes it
    if fault == "q_rounded_before_norm":
        q = q.bfloat16().float()
    if fault == "q_split_before_rope":
        xf = q.float()
        var = xf.square().mean(-1, keepdim=True)
        return xf * torch.rsqrt(var + 1e-7) * qw[:, None, :] * scale
    return t_fa._norm_rope_f32(q, qw, qcos, qsin, 1e-7) * scale


def _emulated_k1_f32(q, kn, v, qcos, qsin, qw, fault=None):
    """The fp32 K1: the split pass (three planes of the normed, rotated and
    scaled Q, of kn and v), then K6's loop over key tiles of kKeysSplit keys
    through a ring of kStages slots (rows past Sk zero, keys >= Sk masked):
    S the six plane products Qi.Kj^T (i + j <= 2) in log2 units, an online
    softmax, P split into kPTerms terms, the six Pi.Vj of a tile summed apart
    and added to O; lse = (m + log2 l) ln 2. Returns (out, lse)."""
    c = _k1_constants()
    planes, p_terms, tile = c["kPlanesF32"], c["kPTerms"], c["kKeysSplit"]
    top = 2
    if fault == "two_planes":
        planes, p_terms, top = 2, 2, 1
    if fault == "p_one_term":
        p_terms = 1
    B, Sk, H, _ = kn.shape
    n = -(-Sk // tile)
    pad = torch.zeros(B, n * tile - Sk, H, D)
    qs = _terms(_split_q(q, qw, qcos, qsin, fault).transpose(1, 2), planes)
    ks, vs = (_terms(torch.cat([x.float(), pad], 1).transpose(1, 2), planes)
              for x in (kn, v))
    m = torch.full(qs[0].shape[:-1] + (1,), -1e30)
    l = torch.zeros_like(m)
    o = torch.zeros_like(qs[0])
    for t in range(n):
        cut = slice(t * tile, (t + 1) * tile)
        s = _products(qs, [x[:, :, cut] for x in ks], top) * LOG2E
        if fault != "unmasked_key_tail":
            s[..., Sk - t * tile:] = -1e30
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        ot = _products(_terms(p, p_terms), [x[:, :, cut] for x in vs], top, a_t=True)
        o = o * alpha + ot
        m = m_new
    lse = m + torch.log2(l)
    if fault != "lse_log2_units":
        lse = lse * math.log(2.0)
    return (o / l).transpose(1, 2), lse.squeeze(-1)


K1_FAULTS = [None, "two_planes", "p_one_term", "unmasked_key_tail",
             "q_rounded_before_norm", "q_split_before_rope", "lse_log2_units"]


@functools.lru_cache(maxsize=None)
def _k1_readings(fault):
    args, (ref, ref_lse) = _k1_case()
    out, lse = _emulated_k1_f32(*args, fault)
    return (chip_smoke.compare(out, ref, chip_smoke.kernel_tolerance(
                "fused_attention", "float32", ref)),
            chip_smoke.compare(lse, ref_lse, chip_smoke.kernel_tolerance(
                "fused_attention_lse", "float32", ref_lse)))


@pytest.mark.parametrize("fault", K1_FAULTS)
def test_smoke_k1_f32_check_holds_the_contract(fault):
    """chip_smoke.py's fp32 K1 check (the output, and with the lse variant
    its rows) at Sk = 2250: the faithful emulation passes both; each fault
    fails one of them, the lse in log2 units its rows."""
    c = _k1_constants()
    assert [c[n] for n in ("kPTerms", "kPlanesF32", "kStages", "kKeysSplit")] \
        == [3, 3, 2, 32]
    out_rec, lse_rec = _k1_readings(fault)
    if fault is None:
        assert out_rec["ok"] and lse_rec["ok"], (out_rec, lse_rec)
    elif fault == "lse_log2_units":
        assert out_rec["ok"] and not lse_rec["ok"], (out_rec, lse_rec)
    else:
        assert not out_rec["ok"], out_rec


def test_k1_f32_split_is_norm_rope_then_scale():
    """The Q side of the split pass: the three planes sum to the fp32
    normed, rotated and scaled Q (``_norm_rope_f32`` / sqrt(D)) to within
    the last plane's rounding, each plane holds bf16 values, and each is
    the rounding to nearest of what the planes before it left (a split by
    truncation also sums to the value, and no output check sees it)."""
    q, _, _, _, qcos, qsin, qw, *_ = _inputs()
    want = t_fa._norm_rope_f32(q, qw, qcos, qsin, 1e-7) * (1.0 / (D ** 0.5))
    planes = _terms(_split_q(q, qw, qcos, qsin), _constant("norm_rope.cuh", "kPlanes"))
    for p in planes:
        assert torch.equal(p, p.bfloat16().float())
    rest = want.double()
    for p in planes:
        assert torch.equal(p, rest.float().bfloat16().float())
        rest = rest - p.double()
    got = sum(p.double() for p in planes)
    assert (got - want.double()).abs().max() <= 2.0 ** -24 * want.abs().max()
    assert (planes[0] - want).abs().max() > 1e-4  # one plane is not fp32


# ------------------------------------------------------------------ K3 ---

def _emulated_k3_f32(qn, kn, v, g, lse, delta, scale, fault=None):
    """The fp32 K3: the split pass (three planes of qn, kn, v and g), then
    each kernel's walk. A block keeps kF32Rows rows and its two consumers
    take the walked tiles of kF32Walk rows in turn, each keeping its own
    sums, added at the end (consumer 0's + consumer 1's). Per tile: S and
    dP the six plane products each; P = exp(scale S - lse), masked past
    the ragged tail; dS = P (dP - delta); P and dS split into three terms;
    the six products of a tile summed apart and added to the consumer's
    sum. Walked tiles come through a ring of kF32Stages slots as TMA fills
    them: rows past S are zero. Faults: two planes, P or dS as one term,
    the mask left off while the padded rows of the last key tile
    (``unmasked_key_tail``) or query tile (``unmasked_query_tail``) hold
    what their slot held before, and the dk/dv consumers reading the lse
    or delta rows of the stage's previous tile from the tenth tile on
    (``stale_lse_rows``, ``stale_delta_rows``). Returns (dq, dk, dv)."""
    c = _k3_constants()
    planes, walk, stages = c["planes"], c["kF32Walk"], c["kF32Stages"]
    p_terms = ds_terms = planes
    top = 2
    if fault == "two_planes":
        planes = p_terms = ds_terms = 2
        top = 1
    if fault == "p_one_term":
        p_terms = 1
    if fault == "ds_one_term":
        ds_terms = 1
    _, Sq, _, _ = qn.shape
    Sk = kn.shape[1]
    qf, kf, vf, gf = (x.float().transpose(1, 2) for x in (qn, kn, v, g))
    stats = torch.stack([lse, delta], -1)  # (B, H, Sq, 2)

    def walked(x, t, unmasked):
        """Walked tile t of x (rows on dim 2) as its ring slot holds it."""
        lo = t * walk
        part = x[:, :, lo:lo + walk]
        pad = walk - part.shape[2]
        if pad and unmasked:
            prev = lo - stages * walk
            return torch.cat([part, x[:, :, prev + walk - pad:prev + walk]], 2)
        return torch.cat([part, part.new_zeros(*part.shape[:2], pad,
                                               *part.shape[3:])], 2)

    qs, gs = _terms(qf, planes), _terms(gf, planes)
    ks, vs = _terms(kf, planes), _terms(vf, planes)
    # dq: every query row at once (rows are independent), key tiles walked
    sums = [torch.zeros_like(qf), torch.zeros_like(qf)]
    unmasked = fault == "unmasked_key_tail"
    L, Dl = lse[..., None] * LOG2E, delta[..., None]
    for t in range(-(-Sk // walk)):
        kt = [walked(x, t, unmasked) for x in ks]
        vt = [walked(x, t, unmasked) for x in vs]
        p = torch.exp2(_products(qs, kt, top) * (scale * LOG2E) - L)
        if not unmasked:
            p[..., max(Sk - t * walk, 0):] = 0
        ds = p * (_products(gs, vt, top) - Dl)
        sums[t % 2] = sums[t % 2] + _products(_terms(ds, ds_terms), kt, top, a_t=True)
    dq = (sums[0] + sums[1]) * scale
    # dk, dv: every key at once, query tiles walked with their statistics
    dks = [torch.zeros_like(kf), torch.zeros_like(kf)]
    dvs = [torch.zeros_like(vf), torch.zeros_like(vf)]
    unmasked = fault == "unmasked_query_tail"
    for t in range(-(-Sq // walk)):
        qt = [walked(x, t, unmasked) for x in qs]
        gt = [walked(x, t, unmasked) for x in gs]
        st = walked(stats, t, unmasked)
        lt, dt = st[..., 0], st[..., 1]
        if t >= 9 and fault in ("stale_lse_rows", "stale_delta_rows"):
            old = walked(stats, t - stages, False)
            lt = old[..., 0] if fault == "stale_lse_rows" else lt
            dt = old[..., 1] if fault == "stale_delta_rows" else dt
        pt = torch.exp2(_products(ks, qt, top) * (scale * LOG2E) - lt[..., None, :] * LOG2E)
        if not unmasked:
            pt[..., max(Sq - t * walk, 0):] = 0
        dst = pt * (_products(vs, gt, top) - dt[..., None, :])
        dvs[t % 2] = dvs[t % 2] + _products(_terms(pt, p_terms), gt, top, a_t=True)
        dks[t % 2] = dks[t % 2] + _products(_terms(dst, ds_terms), qt, top, a_t=True)
    dk = (dks[0] + dks[1]) * scale
    dv = dvs[0] + dvs[1]
    return tuple(x.transpose(1, 2) for x in (dq, dk, dv))


K3_FAULTS = {None: [], "two_planes": [0, 1, 2], "p_one_term": [2],
             "ds_one_term": [0, 1], "unmasked_key_tail": [0],
             "unmasked_query_tail": [1, 2], "stale_lse_rows": [1, 2],
             "stale_delta_rows": [1]}


@functools.lru_cache(maxsize=None)
def _k3_readings(fault):
    args, refs = _k3_case()
    outs = _emulated_k3_f32(*args, fault)
    return [chip_smoke.compare(o, r, chip_smoke.kernel_tolerance(
        kname, "float32", r)) for kname, o, r in zip(
            ("flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_dkv"), outs, refs)]


@pytest.mark.parametrize("fault", list(K3_FAULTS))
def test_smoke_k3_f32_check_holds_the_contract(fault):
    """chip_smoke.py's fp32 checks of dq, dk and dv at S = 2250: the
    faithful emulation passes all three; each fault fails the outputs it
    corrupts and only those."""
    c = _k3_constants()
    assert [c[n] for n in ("planes", "kF32Rows", "kF32Walk", "kF32Stages")] \
        == [3, 64, 32, 2]
    recs = _k3_readings(fault)
    assert [r["ok"] for r in recs] == [i not in K3_FAULTS[fault] for i in range(3)], \
        [(r["rel_l2"], r["max_abs_err"]) for r in recs]


# -------------------------------------------------------------- limits ---

def test_f32_limits_are_per_kernel_and_never_looser():
    """The fp32 K1 and K3 checks have their own relative L2 limits, tighter
    than the general fp32 1e-4 (which a two-plane split passes), with the
    general |d| <= 1e-4; the other kernels keep the general ones."""
    ref = torch.randn(4, 8)
    for kname, limit in chip_smoke.F32_REL_L2.items():
        tol = chip_smoke.kernel_tolerance(kname, "float32", ref)
        assert tol["rel_l2"] == limit < chip_smoke.REL_L2["float32"]
        assert tol["atol"] == 1e-4 and tol["rtol"] == 0.0
    assert set(chip_smoke.F32_REL_L2) == {"fused_attention", "flash_bwd_dq",
                                          "flash_bwd_dkv"}
    for kname in ("norm_rope", "dense_conv", "depthwise_conv"):
        assert chip_smoke.kernel_tolerance(kname, "float32", ref)["rel_l2"] \
            == chip_smoke.REL_L2["float32"]


@pytest.mark.parametrize("kernel", ["fused_attention", "flash_bwd_dq", "flash_bwd_dkv"])
def test_f32_limits_leave_margin_both_ways(kernel):
    """Each per-kernel limit sits at least 2x above the faithful
    emulation's relative L2 and at least 2x below the two-plane split's,
    in every output the kernel writes."""
    limit = chip_smoke.F32_REL_L2[kernel]
    if kernel == "fused_attention":
        faithful, two = [_k1_readings(None)[0]], [_k1_readings("two_planes")[0]]
    else:
        idx = [0] if kernel == "flash_bwd_dq" else [1, 2]
        faithful = [_k3_readings(None)[i] for i in idx]
        two = [_k3_readings("two_planes")[i] for i in idx]
    assert all(2 * r["rel_l2"] <= limit for r in faithful), faithful
    assert all(r["rel_l2"] >= 2 * limit for r in two), two


# ------------------------------------------------------------- on a card --

@pytest.mark.cuda
def test_f32_kernels_match_plain_on_cuda():
    """The fp32 K1 (with its lse rows) and K3 against their plain versions
    on the card at a ragged (2, 130, 12, 128), each launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v, qcos, qsin, qw, kcos, ksin, kw = (
        torch.from_numpy(x).cuda() for x in _segment_inputs(2, 130, 130, 12, D, 5))
    g = torch.from_numpy(np.random.RandomState(6).randn(2, 130, 12, D)
                         .astype(np.float32)).cuda()
    kn = t_fa.norm_rope_plain(k, kw, kcos, ksin)
    before = t_fa.fused_attention.lse_launches
    out, lse = t_fa.fused_attention(q, kn, v, qcos, qsin, qw, return_lse=True)
    assert t_fa.fused_attention.lse_launches == before + 1
    ref, ref_lse = t_fa.fused_attention_plain(q, kn, v, qcos, qsin, qw, return_lse=True)
    assert chip_smoke.compare(out, ref, chip_smoke.kernel_tolerance(
        "fused_attention", "float32", ref))["ok"]
    assert chip_smoke.compare(lse, ref_lse, chip_smoke.kernel_tolerance(
        "fused_attention_lse", "float32", ref_lse))["ok"]
    qn = t_fa.norm_rope_plain(q, qw, qcos, qsin)
    delta = torch.einsum("bqhd,bqhd->bhq", g, ref).contiguous()
    args = (qn, kn, v, g, ref_lse.contiguous(), delta, D ** -0.5)
    got = (t_fa.flash_bwd_dq(*args), *t_fa.flash_bwd_dkv(*args))
    for kname, o, r in zip(("flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_dkv"), got,
                           t_fa.flash_bwd_plain(*args)):
        assert chip_smoke.compare(o, r, chip_smoke.kernel_tolerance(
            kname, "float32", r))["ok"], kname
