"""The port's conv kernels (K4 dense, K5 depthwise), the plain flash
attention (K6) and the sphere conv's two modes against the JAX package, in
fp32 on the CPU, where each wrapper runs its kernel's plain version; K4's
packed weight layouts (one bf16 plane, and three of an fp32 weight); and
emulations of K4's strip loop (bf16, and fp32 on three planes) and K5's
row walk that hold chip_smoke.py's checks to injected faults."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ladcast_torch.ops import attention as t_attn
from ladcast_torch.ops import dense_conv as t_dc
from ladcast_torch.ops import depthwise_conv as t_dw
from ladcast_torch.ops import flash_attention as t_fa
from ladcast_torch.ops import sphere as t_sphere
from ladcast_tpu.ops import attention as j_attn
from ladcast_tpu.ops import sphere as j_sphere
from ladcast_tpu.ops.pallas import dense_conv as j_dc
from ladcast_tpu.ops.pallas import depthwise_conv as j_dw
from ladcast_tpu.ops.pallas.flash_attention import flash_attention as j_flash

SAME3, SAME5 = ((1, 1), (1, 1)), ((2, 2), (2, 2))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------------ K4 ----

@pytest.mark.parametrize("shape,cout,ksz,pads,circular", [
    ((2, 8, 12, 89), 21, 3, SAME3, False),    # ragged channels
    ((2, 8, 12, 89), 21, 3, SAME3, True),
    ((1, 9, 6, 16), 24, 5, SAME5, True),      # W = 6, odd H, 5x5
    ((1, 10, 14, 6), 9, 3, ((0, 2), (1, 0)), False),  # asymmetric pads
    ((2, 9, 12, 4), 7, 3, ((0, 0), (0, 0)), False),   # VALID
    ((1, 6, 8, 5), 3, 3, ((1, 1), (2, 0)), True),     # asymmetric wrap
])
def test_dense_conv_matches_pallas_interpret(shape, cout, ksz, pads, circular):
    """The plain version of K4 (what the wrapper runs on CPU tensors)
    against the TPU kernel in interpret mode; fp32 sums of up to 9 * 89
    products of O(1) values agree to 1e-4."""
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32)
    k = (rng.randn(ksz, ksz, shape[-1], cout) * 0.2).astype(np.float32)
    want = np.asarray(j_dc.dense_conv_interpret(jnp.asarray(x), jnp.asarray(k),
                                                pads, circular))
    before = t_dc.dense_conv_forward.launches
    got = t_dc.dense_conv(_t(x), _t(k), pads, circular).numpy()
    assert t_dc.dense_conv_forward.launches == before  # CPU: plain version
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)
    np.testing.assert_array_equal(
        got, t_dc.dense_conv_plain(_t(x), _t(k), pads, circular).numpy())


@pytest.mark.parametrize("circular", [False, True])
def test_dense_conv_gradients_match_jax(circular):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 6, 8, 5).astype(np.float32)
    k = (rng.randn(3, 3, 5, 7) * 0.3).astype(np.float32)
    g = rng.randn(2, 6, 8, 7).astype(np.float32)
    jx, jk = jax.grad(
        lambda a, b: jnp.sum(j_dc.dense_conv(a, b, SAME3, circular) * g),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(k))
    tx, tk = _t(x).requires_grad_(), _t(k).requires_grad_()
    (t_dc.dense_conv(tx, tk, SAME3, circular) * _t(g)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(tk.grad.numpy(), np.asarray(jk), atol=1e-4, rtol=1e-5)


# ------------------------------------------------------------------ K5 ----

@pytest.mark.parametrize("shape,ksz,pads,circular", [
    ((2, 8, 12, 130), 3, SAME3, False),   # ragged channel block
    ((2, 8, 12, 130), 3, SAME3, True),
    ((1, 9, 6, 130), 5, SAME5, True),     # W = 6, odd H, 5x5
    ((1, 7, 10, 256), 5, SAME5, False),
    ((1, 8, 10, 128), 3, ((0, 2), (1, 0)), False),
])
def test_depthwise_conv_matches_pallas_interpret(shape, ksz, pads, circular):
    rng = np.random.RandomState(2)
    x = rng.randn(*shape).astype(np.float32)
    k = (rng.randn(ksz, ksz, shape[-1]) * 0.3).astype(np.float32)
    want = np.asarray(j_dw.depthwise_same_conv_interpret(
        jnp.asarray(x), jnp.asarray(k), pads, circular))
    before = t_dw.depthwise_same_conv_forward.launches
    got = t_dw.depthwise_same_conv(_t(x), _t(k), pads, circular).numpy()
    assert t_dw.depthwise_same_conv_forward.launches == before
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("circular", [False, True])
def test_depthwise_conv_gradients_match_jax(circular):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 6, 8, 9).astype(np.float32)
    k = (rng.randn(5, 5, 9) * 0.3).astype(np.float32)
    g = rng.randn(2, 6, 8, 9).astype(np.float32)
    jx, jk = jax.grad(
        lambda a, b: jnp.sum(j_dw.depthwise_same_conv(a, b, SAME5, circular) * g),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(k))
    tx, tk = _t(x).requires_grad_(), _t(k).requires_grad_()
    (t_dw.depthwise_same_conv(tx, tk, SAME5, circular) * _t(g)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tk.grad.numpy(), np.asarray(jk), atol=1e-4, rtol=1e-5)


def test_conv_wrappers_check_their_inputs():
    x, k = torch.zeros(1, 4, 6, 3), torch.zeros(3, 3, 3, 2)
    with pytest.raises(ValueError, match="circular_w needs W pads"):
        t_dc.dense_conv(x, k, ((1, 1), (1, 0)), True)
    with pytest.raises(ValueError, match="negative padding"):
        t_dw.depthwise_same_conv(x, k[..., 0], ((-1, 1), (1, 1)))
    xm, km = x.to("meta"), k.to("meta")
    with pytest.raises(ValueError, match="expected cpu or cuda"):
        t_dc.dense_conv_forward(xm, km, SAME3)
    # a packed weight must hold the tiles the kernel reads for the inputs'
    # dtype: one bf16 plane in 64-channel steps, three in 32-channel steps
    assert tuple(t_dc.pack_dense_weight(k.bfloat16()).data.shape) == (1, 1, 9, 96, 64)
    packed = t_dc.pack_dense_weight(k)
    assert tuple(packed.data.shape) == (1, 1, 9, 3, 96, 32)
    bad = t_dc.PackedDenseWeight(packed.data[..., :32, :], 3, 3, 3, 2)
    with pytest.raises(ValueError, match="packed weight of shape"):
        t_dc.dense_conv_forward(xm, bad, SAME3)
    with pytest.raises(ValueError, match="packed weight of shape"):
        t_dc.dense_conv_forward(xm, t_dc.pack_dense_weight(k.bfloat16()), SAME3)
    with pytest.raises(ValueError, match="expected cpu or cuda"):
        t_dc.dense_conv_forward(xm, t_dc.PackedDenseWeight(packed.data.to("meta"),
                                                           3, 3, 3, 2), SAME3)
    with pytest.raises(ValueError, match="expected cpu or cuda"):
        t_dw.depthwise_same_conv_forward(xm, km[..., 0].contiguous(), SAME3)


# -------------------------------------------------------- sphere conv -----

@pytest.mark.parametrize("k,cin,cout,groups", [(3, 5, 7, 1), (5, 4, 6, 1),
                                               (3, 6, 6, 6), (5, 6, 6, 6)])
def test_sphere_conv2d_modes_match_jax(k, cin, cout, groups, monkeypatch):
    """Dense and depthwise, p = 1 and 2: the fused-boundary form on the
    kernels' plain versions and the 3-slice ``F.conv2d`` form against the
    JAX sphere conv, and against each other."""
    rng = np.random.RandomState(k + groups)
    x = rng.randn(2, 8, 12, cin).astype(np.float32)
    w_hwio = rng.randn(k, k, cin // groups, cout).astype(np.float32)
    b = rng.randn(cout).astype(np.float32)
    want = np.asarray(j_sphere.sphere_conv2d(
        jnp.asarray(x), jnp.asarray(w_hwio), jnp.asarray(b), groups=groups))
    w = _t(w_hwio.transpose(3, 2, 0, 1))
    got = {}
    for mode in ("kernel", "library"):
        monkeypatch.setattr(t_sphere, "CONV_MODE", mode)
        got[mode] = t_sphere.sphere_conv2d(_t(x), w, _t(b), groups=groups).numpy()
        np.testing.assert_allclose(got[mode], want, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(got["kernel"], got["library"], atol=1e-4, rtol=1e-5)
    # a kept repacked weight gives the same result
    monkeypatch.setattr(t_sphere, "CONV_MODE", "kernel")
    packed = t_sphere.pack_weight(w, groups)
    np.testing.assert_array_equal(
        t_sphere.sphere_conv2d(_t(x), w, _t(b), groups=groups, packed=packed).numpy(),
        got["kernel"])


CHANNEL_PAIRS = [(84, 84), (89, 252), (126, 126), (252, 89), (252, 252)]


@pytest.mark.parametrize("cin,cout", CHANNEL_PAIRS)
def test_packed_dense_weight_unpacks_to_hwio(cin, cout):
    """K4's packed layout: (N tiles, channel steps, taps, BN, 64) tiles,
    K-major and swizzled, zero past cin and cout, and unpacking gives the
    HWIO weight back."""
    rng = np.random.RandomState(cin + cout)
    w = _t(rng.randn(3, 3, cin, cout).astype(np.float32)).bfloat16()
    packed = t_dc.pack_dense_weight(w)
    bn = t_dc.n_tile(cout)
    assert bn == min(n for n in t_dc.N_TILES if n >= cout or n == 256)
    n_t, n_s = -(-cout // bn), -(-cin // 64)
    assert tuple(packed.data.shape) == (n_t, n_s, 9, bn, 64)
    assert packed.data.dtype == torch.bfloat16 and packed.data.is_contiguous()
    assert torch.equal(packed.unpack(), w)
    # element (tile t, step s, tap, row n, chunk j ^ n % 8, e) is
    # w[tap, 64 s + 8 j + e, bn t + n]; everything past cin or cout is zero
    full = torch.zeros(9, n_s * 64, n_t * bn, dtype=torch.bfloat16)
    full[:, :cin, :cout] = w.reshape(9, cin, cout)
    rows = torch.arange(bn)[:, None]
    want = full.reshape(9, n_s, 64, n_t, bn).permute(3, 1, 0, 4, 2)
    want = want.reshape(n_t, n_s, 9, bn, 8, 8)
    got = packed.data.reshape(n_t, n_s, 9, bn, 8, 8)
    assert torch.equal(got[..., rows, torch.arange(8)[None, :] ^ (rows % 8), :], want)
    assert int((packed.data != 0).sum()) == int((w != 0).sum())


@pytest.mark.parametrize("cin,cout", [(84, 2016), (89, 252), (252, 89), (2016, 84)])
def test_three_plane_packed_weight_unpacks_to_hwio(cin, cout):
    """The fp32 kernel's packed layout: (N tiles of at most 128, steps of
    32 channels, taps, 3 planes, BN, 32) bf16; each step's channels in
    F32_K_ORDER, each (BN, 32) tile in the 64-byte swizzle, the planes
    split_planes' hi, mid, lo, zero past cin and cout; unpacking gives the
    fp32 HWIO weight back bit for bit."""
    rng = np.random.RandomState(cin + cout)
    w = _t(rng.randn(3, 3, cin, cout).astype(np.float32))
    packed = t_dc.pack_dense_weight(w)
    bn = t_dc.n_tile(cout, torch.float32)
    assert bn == (96 if cout <= 96 else 128)
    n_t, n_s = -(-cout // bn), -(-cin // 32)
    assert tuple(packed.data.shape) == (n_t, n_s, 9, 3, bn, 32)
    assert packed.data.dtype == torch.bfloat16 and packed.data.is_contiguous()
    assert packed.planes == 3 and torch.equal(packed.unpack(), w)
    assert sorted(t_dc.F32_K_ORDER) == list(range(32))
    # element (tile t, step s, tap, plane, row n, chunk j ^ (n / 2) % 4, e)
    # is plane p of w[tap, 32 s + F32_K_ORDER[8 j + e], bn t + n]
    full = torch.zeros(9, n_s * 32, n_t * bn)
    full[:, :cin, :cout] = w.reshape(9, cin, cout)
    want = full.reshape(9, n_s, 32, n_t, bn).permute(3, 1, 0, 4, 2)
    want = t_dc.split_planes(want[..., list(t_dc.F32_K_ORDER)]).movedim(0, -3)
    rows = torch.arange(bn)[:, None]
    got = packed.data.reshape(n_t, n_s, 9, 3, bn, 4, 8)
    got = got[..., rows, torch.arange(4)[None, :] ^ (rows // 2 % 4), :]
    assert torch.equal(got.reshape(want.shape), want)
    assert int((packed.data[:, :, :, 0] != 0).sum()) == int((w != 0).sum())


def test_split_planes_round_each_plane_to_nearest():
    """``split_planes``: each plane the rounding to nearest of what the
    planes before it left (the kernel's cvt.rn), and the three sum to the
    value exactly. A split by truncation sums to the value too (8 + 8 + 8
    bits hold any fp32 significand), so no output check can tell the two
    apart (see test_smoke_conv_f32_check_catches_faults): this test holds
    the rounding."""
    v = torch.from_numpy(np.random.RandomState(4).randn(4096).astype(np.float32))
    hi, mid, lo = t_dc.split_planes(v).float().unbind(0)
    assert torch.equal(hi, v.bfloat16().float())
    assert torch.equal(mid, (v - hi).bfloat16().float())
    assert torch.equal(lo, (v - hi - mid).bfloat16().float())
    assert torch.equal((hi + mid) + lo, v)
    t_hi, t_mid, t_lo = _split_truncated(v)
    assert torch.equal((t_hi + t_mid) + t_lo, v)
    assert not torch.equal(t_hi, hi) and not torch.equal(t_mid, mid)


@pytest.mark.parametrize("cin,cout", CHANNEL_PAIRS[:4])
def test_sphere_conv2d_packed_weight_matches_jax(cin, cout, monkeypatch):
    """``sphere_conv2d`` given K4's packed weight equals it without, in both
    ``CONV_MODE``s, and the JAX sphere conv, at the DCAE's channel counts
    that are no multiple of 8."""
    rng = np.random.RandomState(cin * cout)
    x = rng.randn(1, 4, 6, cin).astype(np.float32)
    w_hwio = (rng.randn(3, 3, cin, cout) / np.sqrt(9 * cin)).astype(np.float32)
    b = rng.randn(cout).astype(np.float32)
    want = np.asarray(j_sphere.sphere_conv2d(
        jnp.asarray(x), jnp.asarray(w_hwio), jnp.asarray(b)))
    w = _t(w_hwio.transpose(3, 2, 0, 1))
    packed = t_sphere.pack_weight(w)
    assert isinstance(packed, t_dc.PackedDenseWeight)
    for mode in ("kernel", "library"):
        monkeypatch.setattr(t_sphere, "CONV_MODE", mode)
        plain = t_sphere.sphere_conv2d(_t(x), w, _t(b)).numpy()
        got = t_sphere.sphere_conv2d(_t(x), w, _t(b), packed=packed).numpy()
        np.testing.assert_array_equal(got, plain)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


def test_sphere_conv2d_gradients_agree_between_modes(monkeypatch):
    rng = np.random.RandomState(5)
    x, w = rng.randn(1, 6, 8, 4).astype(np.float32), rng.randn(4, 1, 5, 5).astype(np.float32)
    grads = {}
    for mode in ("kernel", "library"):
        monkeypatch.setattr(t_sphere, "CONV_MODE", mode)
        tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
        t_sphere.sphere_conv2d(tx, tw, groups=4).square().sum().backward()
        grads[mode] = (tx.grad.numpy(), tw.grad.numpy())
    for a, b in zip(grads["kernel"], grads["library"]):
        np.testing.assert_allclose(a, b, atol=1e-3, rtol=1e-4)


def test_conv_mode_rejects_other_values(monkeypatch):
    monkeypatch.setattr(t_sphere, "CONV_MODE", "cudnn")
    with pytest.raises(ValueError, match="CONV_MODE"):
        t_sphere.sphere_conv2d(torch.zeros(1, 4, 6, 2), torch.zeros(2, 2, 3, 3))
    monkeypatch.setattr(t_sphere, "CONV_MODE", "kernel")
    with pytest.raises(ValueError, match="neither dense nor depthwise"):
        t_sphere.sphere_conv2d(torch.zeros(1, 4, 6, 4), torch.zeros(4, 2, 3, 3),
                               groups=2)


# ------------------------------------------------------------------ K6 ----

@pytest.mark.parametrize("B,S,Sk,H,D", [(1, 130, 130, 3, 64), (2, 75, 150, 2, 128)])
def test_flash_attention_matches_pallas_interpret(B, S, Sk, H, D):
    rng = np.random.RandomState(D)
    q = rng.randn(B, S, H, D).astype(np.float32)
    k, v = (rng.randn(B, Sk, H, D).astype(np.float32) for _ in range(2))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    xla = np.asarray(j_attn.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), impl="xla"))
    before = t_fa.flash_attention_forward.launches
    plain = t_fa.flash_attention_plain(_t(q), _t(k), _t(v)).numpy()
    auto = t_attn.dot_product_attention(_t(q), _t(k), _t(v)).numpy()
    comp = t_attn.dot_product_attention(_t(q), _t(k), _t(v), impl="plain").numpy()
    assert t_fa.flash_attention_forward.launches == before
    np.testing.assert_array_equal(auto, plain)  # auto: the flash attention
    for got in (plain, comp):  # softmax outputs of O(0.1): 1e-5
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got, xla, atol=1e-5, rtol=1e-5)


def test_dot_product_attention_bias_and_gradients():
    rng = np.random.RandomState(7)
    q, k, v = (rng.randn(2, 9, 2, 16).astype(np.float32) for _ in range(3))
    bias = rng.randn(1, 2, 9, 9).astype(np.float32)
    want = np.asarray(j_attn.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias), "xla"))
    got = t_attn.dot_product_attention(_t(q), _t(k), _t(v), _t(bias)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="takes no bias"):
        t_attn.dot_product_attention(_t(q), _t(k), _t(v), _t(bias), impl="kernel")
    with pytest.raises(ValueError, match="unknown attention impl"):
        t_attn.dot_product_attention(_t(q), _t(k), _t(v), impl="pallas")
    # the flash attention's backward is the VJP of the composite
    jg = jax.grad(lambda a, b, c: jnp.sum(j_flash(a, b, c) ** 2), argnums=(0, 1, 2))
    with pltpu.force_tpu_interpret_mode():
        wants = jg(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [_t(a).requires_grad_() for a in (q, k, v)]
    t_attn.dot_product_attention(*ts, impl="kernel").square().sum().backward()
    for t, w in zip(ts, wants):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-5, rtol=1e-4)


# ------------------------------ chip_smoke's bf16 check of K4 and K5 -----

def _k4_tiling(Ho, Wo):
    """(TR, TC): the bf16 K4's M tile for a 3x3 conv (``plan`` in
    csrc/dense_conv.cu, whose strips fit at these widths): whole output
    rows where Wo <= 128, else the fewest column tiles of equal width."""
    tc = -(-Wo // -(-Wo // 128))
    return min(128 // tc, Ho), tc


def _split_truncated(v):
    """fp32 ``v`` as three bf16 planes, each cut toward zero (a fault of the
    split: the kernel rounds to nearest), as fp32 tensors."""
    planes, rest = [], v.float()
    for _ in range(3):
        planes.append((rest.view(torch.int32) & -65536).view(torch.float32))
        rest = rest - planes[-1]
    return planes


def _tap_products(a, w, fault):
    """One tap of the fp32 K4: fp32 A (pixels, 32) and W (32, Cout) as three
    bf16 planes each, split to nearest, and the six plane products in the
    kernel's order, smallest first, into a fresh fp32 sum."""
    ah, am, al = (_split_truncated(a) if fault == "truncated_split"
                  else t_dc.split_planes(a).float().unbind(0))
    wh, wm, wl = t_dc.split_planes(w).float().unbind(0)
    terms = [(al, wh), (ah, wl), (am, wm), (am, wh), (ah, wm), (ah, wh)]
    if fault == "drop_hi_wmid":
        del terms[4]
    part = torch.zeros(a.shape[0], w.shape[1])
    for pa, pw in terms:
        part += pa @ pw
    return part


def _tiled_dense_conv(x, w, p, fault=None, bk=64):
    """The K4 loop, emulated: M tiles of TR whole output rows of TC columns;
    per step of ``bk`` input channels one strip of (TR + kh - 1) x (TC + kw
    - 1) input pixels (rows outside H zero, the W pads the wrapped columns),
    from which every tap reads its A: tap (dy, dx) of tile pixel (r, c) is
    strip pixel (r + dy, c + dx). bf16: fp32 accumulation of bf16 products,
    circular W, one cast at the store. fp32 x (the fp32 kernel, ``bk`` 32):
    each tap's six plane products (:func:`_tap_products`; the K order a step
    is permuted in does not change them) summed into a fresh fp32
    accumulator and added to the sum. With an optional fault injected."""
    B, H, W, Cin = x.shape
    kh, kw, _, Cout = w.shape
    tr, tc = _k4_tiling(H, W)
    f32 = x.dtype == torch.float32
    xf = x.float().reshape(B * H, W, Cin)  # rows of all frames, as in memory
    wf = w.float()
    out = torch.empty(B, H, W, Cout)
    for b in range(B):
        for oh0 in range(0, H, tr):
            for ow0 in range(0, W, tc):
                rows, cols = min(tr, H - oh0), min(tc, W - ow0)
                ih = oh0 - p + torch.arange(rows + kh - 1)
                iw = ow0 - p + torch.arange(cols + kw - 1)
                valid = ((ih >= 0) & (ih < H))[:, None] & torch.ones(len(iw), dtype=bool)
                if fault == "missing_wrap_column":
                    valid = valid & ((iw >= 0) & (iw < W))[None, :]
                if fault == "unmasked_halo_row":
                    # the rows just outside the frame, as they lie in
                    # memory: the neighbouring frames' (or, at the ends of
                    # the buffer, this frame's far) rows
                    valid = torch.ones_like(valid)
                src = xf[((b * H + ih) % (B * H))[:, None], (iw % W)[None, :]]
                acc = torch.zeros(rows, cols, Cout)
                for c0 in range(0, Cin, bk):
                    strip = src[..., c0:c0 + bk] * valid[..., None]
                    # one zero row below the strip, for the fault's reads
                    strip = torch.cat([strip, torch.zeros_like(strip[:1])])
                    for dy in range(kh):
                        for dx in range(kw):
                            if fault == "drop_tap" and (dy, dx) == (2, 1):
                                continue
                            a = strip[dy:dy + rows, dx:dx + cols].clone()
                            if (fault == "tap_crosses_row" and dx == kw - 1
                                    and ow0 + cols == W):
                                # the row's last pixel reads on into the
                                # next strip row's first input column
                                a[:, -1] = strip[dy + 1:dy + 1 + rows, p]
                            if f32:
                                acc += _tap_products(
                                    a.reshape(rows * cols, -1), wf[dy, dx, c0:c0 + bk],
                                    fault).reshape(rows, cols, Cout)
                            else:
                                acc += a @ wf[dy, dx, c0:c0 + bk]
                out[b, oh0:oh0 + rows, ow0:ow0 + cols] = acc
    return out if f32 else out.bfloat16()


@pytest.mark.parametrize("fault", [None, "drop_tap", "unmasked_halo_row",
                                   "missing_wrap_column", "tap_crosses_row"])
def test_smoke_conv_bf16_check_catches_faults(fault):
    """chip_smoke.py's bf16 check of the dense conv kernel, at the decoder's
    first shape (15 x 30: M tiles of 4 rows, the last one of 3) with
    1/sqrt(9 Cin)-scaled weights as there: it passes a faithful emulation
    of the kernel's strip loop and fails each injected fault."""
    import chip_smoke

    torch.manual_seed(0)
    x = torch.randn(2, 15, 30, 84).bfloat16()
    w = (torch.randn(3, 3, 84, 40) / (9 * 84) ** 0.5).bfloat16()
    ref = t_dc.dense_conv_plain(x, w, SAME3, True)
    out = _tiled_dense_conv(x, w, 1, fault)
    rec = chip_smoke.compare(
        out, ref, chip_smoke.kernel_tolerance("dense_conv", "bfloat16", ref))
    assert rec["ok"] == (fault is None), rec


@pytest.mark.parametrize("fault", [None, "drop_hi_wmid", "missing_wrap_column",
                                   "truncated_split"])
def test_smoke_conv_f32_check_catches_faults(fault):
    """chip_smoke.py's fp32 check (|d| <= 1e-4, relative L2 <= 1e-4) of the
    dense conv kernel against an emulation of the fp32 kernel's loop (three
    bf16 planes of each value, six plane products a tap, 32-channel steps,
    circular W) at the decoder's first shape with 1/sqrt(9 Cin)-scaled
    weights: it passes the faithful loop and fails a dropped hi.Wmid term
    and a missing wrap column. Planes split by truncation instead of
    rounding still carry every value exactly, and move the result by less
    than 1e-6 relative L2, far inside the check: the test says so, and
    test_split_planes_round_each_plane_to_nearest holds the rounding."""
    import chip_smoke

    torch.manual_seed(0)
    x = torch.randn(2, 15, 30, 84)
    w = torch.randn(3, 3, 84, 40) / (9 * 84) ** 0.5
    ref = t_dc.dense_conv_plain(x, w, SAME3, True)
    out = _tiled_dense_conv(x, w, 1, fault, bk=32)
    rec = chip_smoke.compare(
        out, ref, chip_smoke.kernel_tolerance("dense_conv", "float32", ref))
    if fault == "truncated_split":
        faithful = _tiled_dense_conv(x, w, 1, None, bk=32)
        assert rec["ok"] and rec["rel_l2"] < 1e-6, rec
        assert 0 < ((out - faithful).norm() / faithful.norm()).item() < 1e-6
        return
    assert rec["ok"] == (fault is None), rec
    if fault is None:
        assert rec["rel_l2"] < 1e-6, rec


def _walked_depthwise_conv(x, k, p, fault=None, tc=32, max_rows=16, ahead=2):
    """The K5 kernel's loop, emulated: blocks of ``tc`` output columns walk
    runs of at most ``max_rows`` output rows (the frame split evenly); each
    input row of a walk, with its K - 1 halo columns wrapped, goes once into
    a ring of K + ``ahead`` rows, ``ahead`` rows before it is first used,
    and each output row reads its K rows from the ring. fp32 accumulation,
    circular W, one cast at the store; with an optional fault injected."""
    B, H, W, C = x.shape
    K = k.shape[0]
    walks = -(-H // max_rows)
    rh = -(-H // walks)
    slots = K + ahead
    xf, kf = x.float(), k.float()
    out = torch.empty(B, H, W, C)
    for b in range(B):
        for oh0 in range(0, H, rh):
            n_out = min(rh, H - oh0)
            n_in = n_out + K - 1
            for w0 in range(0, W, tc):
                cols = min(tc, W - w0)
                iw = (w0 - p + torch.arange(cols + K - 1)) % W
                ring = torch.zeros(slots, cols + K - 1, C)

                def stage(r):
                    ih = oh0 - p + r
                    ring[r % slots] = xf[b, ih, iw] if 0 <= ih < H else 0.0

                for r in range(min(K + ahead - 1, n_in)):
                    stage(r)
                for i in range(n_out):
                    r = i + K + ahead - 1
                    if r < n_in and not (fault == "stale_window_row"
                                         and i == n_out // 2):
                        stage(r)
                    acc = torch.zeros(cols, C)
                    for dy in range(K):
                        row = ring[(i + dy) % slots]
                        for dx in range(K):
                            acc += row[dx:dx + cols] * kf[dy, dx]
                    out[b, oh0 + i, w0:w0 + cols] = acc
    return out.bfloat16()


@pytest.mark.parametrize("shape,ksz", [((2, 15, 30, 136), 3), ((1, 30, 60, 40), 5)])
@pytest.mark.parametrize("fault", [None, "stale_window_row"])
def test_smoke_depthwise_bf16_check_catches_faults(shape, ksz, fault):
    """chip_smoke.py's bf16 check of the depthwise kernel, at the DCAE's
    frame sizes with 1/K-scaled taps as there: it passes a faithful
    emulation of the kernel's row walk (one walk of 15 rows, two of 15 at
    30 x 60 with two column tiles) and fails a ring whose window is not
    advanced once."""
    import chip_smoke

    torch.manual_seed(1)
    x = torch.randn(*shape).bfloat16()
    k = (torch.randn(ksz, ksz, shape[-1]) / ksz).bfloat16()
    pads = ((ksz // 2,) * 2,) * 2
    ref = t_dw.depthwise_same_conv_plain(x, k, pads, True)
    out = _walked_depthwise_conv(x, k, ksz // 2, fault)
    rec = chip_smoke.compare(
        out, ref, chip_smoke.kernel_tolerance("depthwise_conv", "bfloat16", ref))
    assert rec["ok"] == (fault is None), rec


def test_smoke_conv_shapes_are_the_shipped_dcae(monkeypatch):
    """chip_smoke.py's tables of conv shapes against the sphere convs that
    the shipped DCAE runs: a shape-only pass on meta tensors (the library
    form, which needs no kernel) with a hook on every ``SphereConv``. The
    kernel counts per encode and decode follow from the same pass."""
    import chip_smoke
    from ladcast_torch.config import DCAEConfig
    from ladcast_torch.models.dcae import AutoencoderDC, SphereConv

    monkeypatch.setattr(t_sphere, "CONV_MODE", "library")
    with torch.device("meta"):
        dcae = AutoencoderDC(DCAEConfig())
    seen = {"encoder": {}, "decoder": {}}

    def record(half):
        def hook(mod, args):
            _, H, W, _ = args[0].shape
            key = ((H, W, mod.in_channels, mod.out_channels) if mod.groups == 1
                   else (H, W, mod.in_channels, mod.kernel_size[0]))
            assert mod.groups in (1, mod.in_channels)
            assert mod.groups > 1 or mod.kernel_size == (3, 3)
            seen[half][mod.groups > 1, key] = seen[half].get(
                (mod.groups > 1, key), 0) + 1
        return hook

    for half in seen:
        for mod in getattr(dcae, half).modules():
            if isinstance(mod, SphereConv):
                mod.register_forward_pre_hook(record(half))
    z = dcae.encode(torch.empty(1, 120, 240, 84, device="meta"),
                    torch.empty(120, 240, 5, device="meta"))
    assert z.shape == (1, 15, 30, 84)
    assert dcae.decode(torch.empty(2, 15, 30, 84, device="meta")).shape == (
        2, 120, 240, 84)
    for half, dense in (("encoder", chip_smoke.ENCODER_DENSE),
                        ("decoder", chip_smoke.DECODER_DENSE)):
        assert {k for dw, k in seen[half] if not dw} == set(dense)
        assert len(set(dense)) == len(dense)
        assert {k for dw, k in seen[half] if dw} == set(chip_smoke.DEPTHWISE_SHAPES)
        counts = chip_smoke.sphere_conv_counts(getattr(dcae, half))
        assert counts == {
            "dense_conv": sum(n for (dw, _), n in seen[half].items() if not dw),
            "depthwise_conv": sum(n for (dw, _), n in seen[half].items() if dw)}
    # the cases of the kernels line are shapes of the decoder
    assert chip_smoke.KERNEL_LINE_CASES["dense_conv"] == ("120x240x252->252", 40)
    assert (120, 240, 252, 252) in chip_smoke.DECODER_DENSE
    assert (30, 60, 4032, 3) in chip_smoke.DEPTHWISE_SHAPES
    assert chip_smoke.KERNEL_LINE_CASES["depthwise_conv"] == ("30x60x4032 k3", 40)


# ------------------------------------------------------------- on a card --

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_conv_and_flash_kernels_match_plain_on_cuda(dtype):
    """K4, K5 and K6 against their plain versions at ragged small shapes,
    with chip_smoke.py's tolerances (which covers the production shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke

    dname = str(dtype).split(".")[-1]
    g = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(dtype)

    x, w = rand(2, 7, 6, 89), rand(3, 3, 89, 21, scale=(9 * 89) ** -0.5)
    xd, kd = rand(2, 7, 6, 130), rand(5, 5, 130, scale=0.2)
    q, k, v = (rand(1, 130, 3, 64) for _ in range(3))
    cases = [
        ("dense_conv", t_dc.dense_conv_forward, t_dc.dense_conv_plain,
         (x, w, SAME3, True)),
        ("dense_conv", t_dc.dense_conv_forward, t_dc.dense_conv_plain,
         (x, w, SAME3, False)),
        ("dense_conv", t_dc.dense_conv_forward, t_dc.dense_conv_plain,
         (x, t_dc.pack_dense_weight(w), SAME3, True)),
        ("depthwise_conv", t_dw.depthwise_same_conv_forward,
         t_dw.depthwise_same_conv_plain, (xd, kd, SAME5, True)),
        ("depthwise_conv", t_dw.depthwise_same_conv_forward,
         t_dw.depthwise_same_conv_plain, (xd, kd, SAME5, False)),
        ("flash_attention", t_fa.flash_attention_forward,
         t_fa.flash_attention_plain, (q, k, v)),
    ]
    for name, fn, plain, args in cases:
        before, f32_before = fn.launches, t_dc.dense_conv_forward.f32_launches
        out, ref = fn(*args), plain(*args)
        assert fn.launches == before + 1
        # fp32 dense convs launch the fp32 kernel (three bf16 planes)
        assert t_dc.dense_conv_forward.f32_launches - f32_before == int(
            fn is t_dc.dense_conv_forward and dtype == torch.float32)
        rec = chip_smoke.compare(out, ref, chip_smoke.kernel_tolerance(name, dname, ref))
        assert rec["ok"], (name, rec)
    with pytest.raises(RuntimeError, match="would carry no gradient"):
        t_dc.dense_conv_forward(x.requires_grad_(), w, SAME3, True)
