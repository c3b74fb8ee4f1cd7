"""The differentiable attention of the PyTorch port against the JAX package,
in fp32 on the CPU: the plain versions of the K1 lse variant and of the
flash backward (K3) against the Pallas kernels in interpret mode, the
autograd Function against the JAX ``custom_vjp`` in both backward modes,
and chip_smoke.py's bf16 check of K3 against injected faults.

Tolerances: fp32 parity between two implementations of the same sums in
another order, 2e-5 absolute and relative on O(1) values (the fused
forward tests in test_torch_ops.py use the same); gradients of the
(S, D) tables sum over batch and heads, so they are compared in relative
L2 (1e-5) beside the elementwise check.
"""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ladcast_torch.ops import flash_attention as t_fa
from ladcast_tpu.ops.pallas import flash_attention as j_fa
from tests.test_torch_ops import _segment_inputs


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """The test suite runs files in parallel workers on a shared CPU; two
    intra-op threads per worker keep them from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("B,Sq,Sk,H", [(1, 75, 150, 2), (2, 130, 90, 1)])
def test_plain_versions_match_pallas_kernels(B, Sq, Sk, H):
    """K1's lse variant and K3's plain versions against ``_fused_impl(
    return_lse=True)`` and ``_fa_bwd_impl`` at ragged Sq != Sk (both pad
    to their 128-row blocks; the port's plain versions do not pad)."""
    args = _segment_inputs(B, Sq, Sk, H, 128, 11)
    q, k, v, qcos, qsin, qw, kcos, ksin, kw = map(jnp.asarray, args)
    g = jnp.asarray(np.random.RandomState(12).randn(B, Sq, H, 128)
                    .astype(np.float32))
    with pltpu.force_tpu_interpret_mode():
        out, lse_pad = j_fa._fused_impl(q, k, v, qcos, qsin, qw, kcos, ksin,
                                        kw, 1e-7, return_lse=True)
        qn = j_fa._xla_norm_rope(q, qw[None, :, None], qcos[None, :, None],
                                 qsin[None, :, None], 1e-7)
        kn = j_fa._xla_norm_rope(k, kw[None, :, None], kcos[None, :, None],
                                 ksin[None, :, None], 1e-7)
        delta = jnp.einsum("bqhd,bqhd->bhq", g, out)
        want = j_fa._fa_bwd_impl(qn, kn, v, g, lse_pad, delta, 128 ** -0.5)

    tq, tk, tv, tqc, tqs, tqw, tkc, tks, tkw = map(_t, args)
    tkn = t_fa.norm_rope_plain(tk, tkw, tkc, tks)
    t_out, t_lse = t_fa.fused_attention_plain(tq, tkn, tv, tqc, tqs, tqw,
                                              return_lse=True)
    assert t_lse.shape == (B, H, Sq) and t_lse.dtype == torch.float32
    np.testing.assert_allclose(t_out.numpy(), np.asarray(out), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(lse_pad)[..., :Sq],
                               atol=2e-5, rtol=2e-5)
    got = t_fa.flash_bwd_plain(_t(qn), _t(kn), tv, _t(g), t_lse, _t(delta),
                               128 ** -0.5)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5,
                                   rtol=2e-5, err_msg=name)
    # the CPU wrappers are the plain versions and count no launch
    counts = (t_fa.flash_bwd_dq.launches, t_fa.flash_bwd_dkv.launches)
    dq = t_fa.flash_bwd_dq(_t(qn), _t(kn), tv, _t(g), t_lse, _t(delta), 128 ** -0.5)
    dk, dv = t_fa.flash_bwd_dkv(_t(qn), _t(kn), tv, _t(g), t_lse, _t(delta),
                                128 ** -0.5)
    for a, b in zip((dq, dk, dv), got):
        assert torch.equal(a, b)
    assert (t_fa.flash_bwd_dq.launches, t_fa.flash_bwd_dkv.launches) == counts


@pytest.mark.parametrize("mode,jax_mode", [("kernel", "pallas"),
                                           ("composite", "xla")])
def test_function_grads_match_custom_vjp(mode, jax_mode):
    """The gradients of all nine inputs of the port's autograd Function
    against the VJP of JAX's ``fused_norm_rope_attention`` with the same
    backward mode (the Pallas kernels in interpret mode)."""
    _function_grads_match(mode, jax_mode, 1, 90, 70, 2)


@pytest.mark.parametrize("mode,jax_mode", [("kernel", "pallas"),
                                           ("composite", "xla")])
def test_function_grads_match_custom_vjp_at_16_heads(mode, jax_mode):
    """The same at the 1.6B's 16 heads (the only shipped config with other
    than 12), whose DiT parity test runs at a head size the fused path
    does not take."""
    _function_grads_match(mode, jax_mode, 1, 40, 30, 16)


def _function_grads_match(mode, jax_mode, B, Sq, Sk, H):
    args = _segment_inputs(B, Sq, Sk, H, 128, 13)
    ct = np.random.RandomState(14).randn(B, Sq, H, 128).astype(np.float32)
    j_fa.BWD_MODE = jax_mode
    try:
        with pltpu.force_tpu_interpret_mode():
            j_out, vjp = jax.vjp(
                lambda *a: j_fa.fused_norm_rope_attention(*a, 1e-7),
                *map(jnp.asarray, args))
            want = vjp(jnp.asarray(ct))
    finally:
        j_fa.BWD_MODE = "auto"

    xs = [_t(a).requires_grad_(True) for a in args]
    prev, t_fa.BWD_MODE = t_fa.BWD_MODE, mode
    try:
        out = t_fa.fused_norm_rope_attention(*xs, 1e-7)
        # the lse rows are saved only for the kernel backward
        assert (out.grad_fn.saved_tensors[-1] is None) == (mode == "composite")
        got = torch.autograd.grad(out, xs, _t(ct))
    finally:
        t_fa.BWD_MODE = prev
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               atol=2e-5, rtol=2e-5)
    names = ("q", "k", "v", "qcos", "qsin", "qw", "kcos", "ksin", "kw")
    for name, a, b in zip(names, got, want):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        assert _rel(a.numpy(), b) <= 1e-5, (name, _rel(a.numpy(), b))
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=1e-5 * np.abs(b).max(), err_msg=name)


def test_output_carries_the_function_and_lse_only_for_a_gradient():
    """The kernel backward is the default at any length (the JAX package's
    4096-token threshold is not kept): the lse rows are saved whenever a
    gradient will be asked for, unless the composite is chosen."""
    args = [_t(a) for a in _segment_inputs(1, 20, 20, 1, 128, 15)]
    assert t_fa.BWD_MODE == "kernel"
    assert t_fa.fused_norm_rope_attention(*args).grad_fn is None
    args[5].requires_grad_(True)  # a norm-weight table, as in the DiT
    out = t_fa.fused_norm_rope_attention(*args)
    assert type(out.grad_fn).__name__ == "FusedNormRopeAttentionBackward"
    assert out.grad_fn.saved_tensors[-1].shape == (1, 1, 20)
    with torch.no_grad():
        assert t_fa.fused_norm_rope_attention(*args).grad_fn is None
    prev, t_fa.BWD_MODE = t_fa.BWD_MODE, "composite"
    try:
        out = t_fa.fused_norm_rope_attention(*args)
        assert out.grad_fn.saved_tensors[-1] is None
    finally:
        t_fa.BWD_MODE = prev
    for bad in ("pallas", "auto"):
        with pytest.raises(ValueError, match="BWD_MODE"):
            t_fa.BWD_MODE = bad
            try:
                t_fa.fused_norm_rope_attention(*args)
            finally:
                t_fa.BWD_MODE = prev


def test_kernel_entries_refuse_inputs_that_need_grad():
    """The check every CUDA entry runs before its launch: an input that
    requires grad under grad mode raises; no_grad lets it through."""
    x = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="would carry no gradient"):
        t_fa._refuse_grad("norm_rope", (torch.zeros(2), x))
    with torch.no_grad():
        t_fa._refuse_grad("norm_rope", (x,))
    t_fa._refuse_grad("norm_rope", (torch.zeros(2),))


@pytest.mark.cuda
def test_cuda_entries_refuse_grad_and_function_keeps_it():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = [_t(a).cuda() for a in _segment_inputs(1, 40, 40, 2, 128, 16)]
    q, k, v, qcos, qsin, qw, kcos, ksin, kw = args
    k.requires_grad_(True)
    with pytest.raises(RuntimeError, match="would carry no gradient"):
        t_fa.norm_rope(k, kw, kcos, ksin)
    with pytest.raises(RuntimeError, match="would carry no gradient"):
        t_fa.fused_attention(q, k, v, qcos, qsin, qw)
    out = t_fa.fused_norm_rope_attention(*args)
    assert type(out.grad_fn).__name__ == "FusedNormRopeAttentionBackward"
    (dk,) = torch.autograd.grad(out.square().sum(), (k,))
    assert torch.isfinite(dk).all() and dk.abs().max() > 0


# ------------------------------------------- chip_smoke's bf16 check ---

def _kernel_constants():
    """The tile constants of the flash backward's CUDA source: each
    ``constexpr int NAME = [N *] VALUE;`` evaluated over those before it."""
    src = (Path(__file__).resolve().parent.parent / "ladcast_torch" / "csrc"
           / "flash_bwd.cu").read_text()
    env = {}
    for name, mul, val in re.findall(r"constexpr int (\w+) = (?:(\d+) \* )?(\w+);", src):
        if val.isdigit() or val in env:
            env[name] = int(mul or 1) * (int(val) if val.isdigit() else env[val])
    return env


def _bwd_emulation(qn, kn, v, g, lse, delta, scale, fault=None):
    """The CUDA kernels' loops in fp32, dS and P cast to bf16 before their
    products: each consumer of a dq block (kDqRows query rows, 64 a
    consumer) walks the key tiles of kDqKeys keys, each consumer of a dk/dv
    block (kDkvKeys keys) the query tiles of kDkvRows rows with their lse
    and delta rows. Walked tiles come through a ring of kStages slots as
    TMA fills them: rows past S are zero, keys >= Sk and query rows >= Sq
    masked. Faults: the mask left off while the padded rows of the last
    key tile (``unmasked_key_tail``) or query tile
    (``unmasked_query_rows``) hold what their slot held before, a key tile
    dropped (``dropped_tile``), or a consumer that reads its slot without
    waiting on its "full" barrier from the tenth tile on, and so reads what
    the slot held kStages tiles before (``stale_ring_slot``)."""
    c = _kernel_constants()
    rows, stages = c["kRows"], c["kStages"]
    bq, tk, bk, tq = c["kDqRows"], c["kDqKeys"], c["kDkvKeys"], c["kDkvRows"]
    B, Sq, H, D = qn.shape
    Sk = kn.shape[1]
    qf, kf, vf, gf = (t.float().transpose(1, 2) for t in (qn, kn, v, g))
    stats = torch.stack([lse, delta], -1)  # (B, H, Sq, 2)

    def slot(x, t, tile, unmasked):
        """Walked tile t of x (rows on dim 2) as the ring holds it."""
        if fault == "stale_ring_slot" and t >= 9:
            t -= stages
        lo = t * tile
        part = x[:, :, lo:lo + tile]
        pad = tile - part.shape[2]
        if pad and unmasked:
            return torch.cat([part, x[:, :, lo - stages * tile + tile - pad:
                                      lo - stages * tile + tile]], 2)
        return torch.cat([part, part.new_zeros(*part.shape[:2], pad, *part.shape[3:])], 2)

    dq = torch.zeros_like(qf)
    unmasked = fault == "unmasked_key_tail"
    for q0 in range(0, Sq, bq):
        for c0 in range(q0, min(q0 + bq, Sq), rows):  # a consumer's rows
            q, gg = qf[:, :, c0:c0 + rows], gf[:, :, c0:c0 + rows]
            L, Dl = lse[..., c0:c0 + rows, None], delta[..., c0:c0 + rows, None]
            for t in range(-(-Sk // tk)):
                if fault == "dropped_tile" and t == 17:
                    continue
                kt, vt = slot(kf, t, tk, unmasked), slot(vf, t, tk, unmasked)
                p = torch.exp(q @ kt.transpose(-1, -2) * scale - L)
                if not unmasked:
                    p[..., max(Sk - t * tk, 0):] = 0
                ds = (p * (gg @ vt.transpose(-1, -2) - Dl)).bfloat16().float()
                dq[:, :, c0:c0 + rows] += ds @ kt
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    unmasked = fault == "unmasked_query_rows"
    for k0 in range(0, Sk, bk):
        for c0 in range(k0, min(k0 + bk, Sk), rows):  # a consumer's keys
            k, vv = kf[:, :, c0:c0 + rows], vf[:, :, c0:c0 + rows]
            for t in range(-(-Sq // tq)):
                qt, gt = slot(qf, t, tq, unmasked), slot(gf, t, tq, unmasked)
                st = slot(stats, t, tq, unmasked)
                pt = torch.exp(k @ qt.transpose(-1, -2) * scale - st[..., None, :, 0])
                if not unmasked:
                    pt[..., max(Sq - t * tq, 0):] = 0
                dst = pt * (vv @ gt.transpose(-1, -2) - st[..., None, :, 1])
                dv[:, :, c0:c0 + rows] += pt.bfloat16().float() @ gt
                dk[:, :, c0:c0 + rows] += dst.bfloat16().float() @ qt
    return tuple((x * s).transpose(1, 2).bfloat16()
                 for x, s in ((dq, scale), (dk, scale), (dv, 1.0)))


@functools.lru_cache(maxsize=None)
def _bwd_case(S=2250, H=1, D=128):
    """bf16 inputs at the training S with the forward's statistics, and
    the plain backward's (dq, dk, dv)."""
    torch.manual_seed(0)
    q, k, v, g = (torch.randn(1, S, H, D).bfloat16() for _ in range(4))
    cos, sin = torch.ones(S, D), torch.zeros(S, D)
    w = (1 + 0.1 * torch.randn(D)).expand(S, D).contiguous()
    qn, kn = (t_fa.norm_rope_plain(x, w, cos, sin) for x in (q, k))
    out, lse = t_fa.fused_attention_plain(q, kn, v, cos, sin, w, return_lse=True)
    delta = torch.einsum("bqhd,bqhd->bhq", g.float(), out.float())
    args = (qn, kn, v, g, lse, delta)
    return args, t_fa.flash_bwd_plain(*args, D ** -0.5)


@pytest.mark.parametrize("fault", [None, "unmasked_key_tail",
                                   "unmasked_query_rows", "dropped_tile",
                                   "stale_ring_slot"])
def test_smoke_flash_bwd_bf16_check_catches_faults(fault):
    """chip_smoke.py's bf16 check of K3 at the training S=2250 (a ragged
    last tile of 10 rows): it passes a faithful emulation of the kernels'
    tile loops and fails each injected fault in the output it corrupts."""
    import chip_smoke

    c = _kernel_constants()
    assert [c[n] for n in ("kRows", "kDqRows", "kDqKeys", "kDkvKeys", "kDkvRows",
                           "kStages")] == [64, 128, 64, 128, 64, 2]
    args, refs = _bwd_case()
    outs = _bwd_emulation(*args, 128 ** -0.5, fault)
    ok = [chip_smoke.compare(o, r, chip_smoke.kernel_tolerance(
        "flash_bwd", "bfloat16", r))["ok"] for o, r in zip(outs, refs)]
    broken = {None: [], "unmasked_key_tail": [0], "unmasked_query_rows": [1, 2],
              "dropped_tile": [0], "stale_ring_slot": [0, 1, 2]}[fault]
    assert ok == [i not in broken for i in range(3)], ok
