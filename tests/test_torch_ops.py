"""PyTorch port ops vs the JAX package, in fp32 on the CPU: norms,
embeddings, RoPE tables, the norm+RoPE pass and the attention composite,
and the fused attention against the Pallas kernel in interpret mode."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ladcast_torch.ops import embeddings as t_emb
from ladcast_torch.ops import flash_attention as t_fa
from ladcast_torch.ops import norms as t_norms
from ladcast_torch.ops import rope as t_rope
from ladcast_torch.ops.attention import norm_rope_attention
from ladcast_tpu.ops import embeddings as j_emb
from ladcast_tpu.ops import norms as j_norms
from ladcast_tpu.ops import rope as j_rope
from ladcast_tpu.ops.pallas import flash_attention as j_fa


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


@pytest.mark.parametrize("with_weight,with_bias", [(True, True), (True, False),
                                                   (False, False)])
def test_rms_norm(with_weight, with_bias):
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 16).astype(np.float32) * 2
    w = rng.rand(16).astype(np.float32) + 0.5 if with_weight else None
    b = rng.randn(16).astype(np.float32) if with_bias else None
    want = j_norms.rms_norm(jnp.asarray(x), None if w is None else jnp.asarray(w),
                            1e-5, None if b is None else jnp.asarray(b))
    got = t_norms.rms_norm(_t(x), None if w is None else _t(w), 1e-5,
                           None if b is None else _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("fp32,affine", [(False, True), (True, True), (False, False)])
def test_layer_norm(fp32, affine):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 7, 32).astype(np.float32) + 0.3
    w = rng.rand(32).astype(np.float32) + 0.5 if affine else None
    b = rng.randn(32).astype(np.float32) if affine else None
    jw = None if w is None else jnp.asarray(w)
    jb = None if b is None else jnp.asarray(b)
    want = j_norms.layer_norm(jnp.asarray(x), jw, jb, 1e-6, fp32=fp32)
    got = t_norms.layer_norm(_t(x), None if w is None else _t(w),
                             None if b is None else _t(b), 1e-6, fp32=fp32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


def test_embeddings():
    t = np.array([-1.3, 0.0, 0.7, 2.5], np.float32)
    want = j_emb.timestep_embedding(jnp.asarray(t), 256, flip_sin_to_cos=True,
                                    downscale_freq_shift=0.0)
    got = t_emb.timestep_embedding(_t(t), 256, flip_sin_to_cos=True,
                                   downscale_freq_shift=0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    yp = np.array([0.0, 0.25, 0.61, 0.999], np.float32)
    want = j_emb.year_sincos_embedding(jnp.asarray(yp), 256)
    got = t_emb.year_sincos_embedding(_t(yp), 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


def test_rope_tables_exact():
    pos = np.arange(-3, 40, dtype=np.float32) * 0.37
    for a, b in zip(t_rope.rotary_tables_1d(16, pos, 256.0),
                    j_rope.rotary_tables_1d(16, pos, 256.0)):
        np.testing.assert_array_equal(a, b)
    kw = dict(lat_start=-8.7, lat_end=6.1, lon_start=0.09, lon_end=6.2)
    for cond in (False, True):
        ct = t_rope.ladcast_axis_coords(2, 3, 6, **kw, conditioning=cond)
        cj = j_rope.ladcast_axis_coords(2, 3, 6, **kw, conditioning=cond)
        for a, b in zip(ct, cj):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(t_rope.multi_axis_rotary_tables((16, 56, 56), ct, 256.0),
                        j_rope.multi_axis_rotary_tables((16, 56, 56), cj, 256.0)):
            np.testing.assert_array_equal(a, b)


def test_apply_rotary_emb():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 9, 32).astype(np.float32)
    cos, sin = j_rope.rotary_tables_1d(32, np.arange(9), 256.0)
    want = j_rope.apply_rotary_emb(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin))
    got = t_rope.apply_rotary_emb(_t(x), _t(cos), _t(sin))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


def _segment_inputs(B, Sq, Sk, H, D, seed, n_ident=20):
    """q/k/v and tables with a rotated head and an un-rotated tail whose
    norm weights differ (the dual-stream conditioning segment)."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, Sq, H, D).astype(np.float32) * 0.3
    k = rng.randn(B, Sk, H, D).astype(np.float32) * 0.3
    v = rng.randn(B, Sk, H, D).astype(np.float32)
    w_a = rng.rand(D).astype(np.float32) + 0.5
    w_b = rng.rand(D).astype(np.float32) + 0.5

    def tables(n):
        n_rot = n - n_ident
        cos, sin = j_rope.rotary_tables_1d(D, np.arange(n_rot), 256.0)
        c = np.concatenate([cos, np.ones((n_ident, D), np.float32)])
        s = np.concatenate([sin, np.zeros((n_ident, D), np.float32)])
        w = np.concatenate([np.broadcast_to(w_a, (n_rot, D)),
                            np.broadcast_to(w_b, (n_ident, D))])
        return c, s, np.ascontiguousarray(w)

    qcos, qsin, qw = tables(Sq)
    kcos, ksin, kw = tables(Sk)
    return q, k, v, qcos, qsin, qw, kcos, ksin, kw


def test_norm_rope_plain_matches_jax():
    q, k, v, qcos, qsin, qw, *_ = _segment_inputs(2, 50, 50, 3, 128, 3)
    want = j_fa._xla_norm_rope(jnp.asarray(q), jnp.asarray(qw)[None, :, None],
                               jnp.asarray(qcos)[None, :, None],
                               jnp.asarray(qsin)[None, :, None], 1e-7)
    got = t_fa.norm_rope(_t(q), _t(qw), _t(qcos), _t(qsin), 1e-7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    # CPU tensors take the plain path and count no launch
    assert t_fa.norm_rope.launches == 0


@pytest.mark.parametrize("with_bias", [False, True])
def test_composite_matches_jax(with_bias):
    args = _segment_inputs(2, 70, 60, 2, 128, 4)
    bias = (np.random.RandomState(5).rand(1, 1, 1, 60).astype(np.float32)
            if with_bias else None)
    want = j_fa.xla_norm_rope_attention(
        *map(jnp.asarray, args), 1e-7,
        bias=None if bias is None else jnp.asarray(bias))
    got = t_fa.composite_norm_rope_attention(
        *map(_t, args), 1e-7, bias=None if bias is None else _t(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("B,Sq,Sk,H", [(1, 130, 130, 2), (2, 75, 150, 1)])
def test_fused_path_matches_pallas_interpret(B, Sq, Sk, H):
    """The composite and the fused path's plain versions vs the Pallas
    fused kernel (interpret mode) at ragged S with identity segments. The
    kernel scales Q before the cast, the composite the logits after it."""
    args = _segment_inputs(B, Sq, Sk, H, 128, 6)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(j_fa.fused_norm_rope_attention(
            *map(jnp.asarray, args), 1e-7))
    targs = list(map(_t, args))
    composite = t_fa.composite_norm_rope_attention(*targs, 1e-7)
    np.testing.assert_allclose(composite.numpy(), want, atol=2e-5, rtol=2e-5)
    fused = norm_rope_attention(*targs)
    np.testing.assert_allclose(fused.numpy(), want, atol=2e-5, rtol=2e-5)
    assert t_fa.fused_attention.launches == 0


def test_fused_plain_bf16_casts_like_kernel():
    """In bf16 the plain K1 casts the scaled Q and P to bf16 and keeps fp32
    sums: it stays within bf16 rounding of the fp32 composite."""
    args = _segment_inputs(1, 40, 40, 2, 128, 7)
    q, k, v, qcos, qsin, qw, kcos, ksin, kw = map(_t, args)
    ref = t_fa.composite_norm_rope_attention(q, k, v, qcos, qsin, qw, kcos,
                                             ksin, kw, 1e-7)
    kn = t_fa.norm_rope(k.bfloat16(), kw, kcos, ksin, 1e-7)
    got = t_fa.fused_attention(q.bfloat16(), kn, v.bfloat16(), qcos, qsin,
                               qw, 1e-7)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref.numpy(), atol=3e-2)


def _kernel_constant(name):
    """A ``constexpr int`` of the CUDA attention kernel's source."""
    src = (Path(__file__).resolve().parent.parent / "ladcast_torch" / "csrc"
           / "fused_attention.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _walk(items, blocks):
    """The items each block of the persistent K1 takes, in its order: block
    i runs items i, i + blocks, i + 2 blocks, ... (the kernel's loop over
    ``item += gridDim.x``)."""
    return [range(i, items, blocks) for i in range(blocks)]


def _persistent_attention(qs, kn, v, fault=None, sms=5):
    """The CUDA kernel emulated in fp32, P cast to bf16 before P.V, with an
    optional fault injected. The blocks of its persistent grid (for a card of
    ``sms`` SMs) walk their (Q tile, b, head) items, each an online softmax
    over key tiles of BN keys. As in the kernel, the ring's kStages slots and
    the staged Q tile carry from one item to the next: the producer fills
    slot ``it % kStages`` with the walk's ``it``-th tile (rows past Sk zero,
    keys >= Sk masked) and stages each item's Q tile (rows past Sq zero)."""
    tile, stages = _kernel_constant("BN"), _kernel_constant("kStages")
    B, Sq, H, D = qs.shape
    Sk = kn.shape[1]
    n = -(-Sk // tile)
    pad = n * tile - Sk
    kp = torch.cat([kn.float(), torch.zeros(B, pad, H, D)], 1)
    vtail = (torch.randn(B, pad, H, D).bfloat16().float()
             if fault == "unmasked_tail_garbage_v" else torch.zeros(B, pad, H, D))
    vp = torch.cat([v.float(), vtail], 1)
    n_qt = -(-Sq // t_fa.ITEM_ROWS)
    qp = torch.cat([qs.float(), torch.zeros(B, n_qt * t_fa.ITEM_ROWS - Sq, H, D)], 1)
    out = torch.empty(B, Sq, H, D, dtype=torch.bfloat16)
    items, blocks = t_fa.persistent_grid(B, Sq, H, sms)
    for walk in _walk(items, blocks):
        ring, it = [None] * stages, 0
        for j, item in enumerate(walk):
            q0 = item % n_qt * t_fa.ITEM_ROWS
            b, h = divmod(item // n_qt, H)
            # an item that does not wait for its staged Q reads the last one
            if not (fault == "stale_q_at_item" and j > 0):
                q = qp[b, q0:q0 + t_fa.ITEM_ROWS, h]
            if not (fault == "state_not_reset" and j > 0):
                m = torch.full((t_fa.ITEM_ROWS, 1), -1e30)
                l = torch.zeros_like(m)
                acc = torch.zeros_like(q)
            for t in range(n):
                slot = it % stages
                # a consumer that does not wait on its stage's "full" barrier
                # reads what the slot held kStages tiles before
                stale = fault == "stale_stage" and t >= 9
                if stale:
                    kt, vt = ring[slot]
                ring[slot] = (kp[b, t * tile:(t + 1) * tile, h],
                              vp[b, t * tile:(t + 1) * tile, h])
                if not stale:
                    kt, vt = ring[slot]
                # an item's first tile read from the slot the last item's
                # last tile filled
                if fault == "stale_stage_at_item" and j > 0 and t == 0:
                    kt, vt = ring[(it - 1) % stages]
                it += 1
                if fault == "drop_tile" and t == 17:
                    continue
                s = q @ kt.T
                if fault not in ("unmasked_tail_zero_v", "unmasked_tail_garbage_v"):
                    s[:, Sk - t * tile:] = -1e30
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new)
                l = l * alpha + p.sum(-1, keepdim=True)
                if not (fault == "stale_rescale" and t == 5):
                    acc = acc * alpha
                acc = acc + p.bfloat16().float() @ vt
                m = m_new
            out[b, q0:q0 + t_fa.ITEM_ROWS, h] = (acc / l)[:Sq - q0].bfloat16()
    return out


@pytest.mark.parametrize("fault", [None, "drop_tile", "unmasked_tail_zero_v",
                                   "unmasked_tail_garbage_v", "stale_rescale",
                                   "stale_stage", "stale_q_at_item",
                                   "state_not_reset", "stale_stage_at_item"])
def test_smoke_attention_bf16_check_catches_faults(fault):
    """chip_smoke.py's bf16 check of the attention kernel, at the main
    path's Sk=2250 (a ragged last tile of 74 keys and 54 padded ones): it
    passes a faithful emulation of the persistent kernel's walk (7 or 8
    items a block) and fails each injected fault."""
    import chip_smoke

    assert (_kernel_constant("BN"), _kernel_constant("kStages")) == (128, 2)
    assert 2 * _kernel_constant("WM") == t_fa.ITEM_ROWS
    torch.manual_seed(0)
    S, H, D = 2250, 2, 128
    q, k, v = (torch.randn(1, S, H, D).bfloat16() for _ in range(3))
    cos, sin = torch.ones(S, D), torch.zeros(S, D)
    w = (1 + 0.1 * torch.randn(D)).expand(S, D).contiguous()
    kn = t_fa.norm_rope_plain(k, w, cos, sin)
    ref = t_fa.fused_attention_plain(q, kn, v, cos, sin, w)
    qs = (t_fa._norm_rope_f32(q, w, cos, sin, 1e-7) / D ** 0.5).bfloat16()
    out = _persistent_attention(qs, kn, v, fault)
    rec = chip_smoke.compare(
        out, ref, chip_smoke.kernel_tolerance("fused_attention", "bfloat16", ref))
    assert rec["ok"] == (fault is None), rec


@pytest.mark.parametrize("B,Sq,H,sms,chained", [
    (2, 130, 12, 132, 0),          # 48 items, fewer than the SMs
    (1, 1536, 11, 132, 0),         # 132 items, as many as the SMs
    (4, 450, 12, 132, 60),         # 192 items (K1-lse at the refiner's S)
    (20, 2250, 12, 132, 4188),     # 4,320 items (the main path)
    (20, 2250, 16, 131, 5629),     # 5,760 items on 131 SMs
])
def test_persistent_grid_walks_every_item_once(B, Sq, H, sms, chained):
    """The bf16 K1's grid is min(items, SMs) blocks; their walks take every
    (Q tile, b, head) item exactly once, and items - blocks of them start on
    a block that has already run one (what ``chained_items`` adds)."""
    items, blocks = t_fa.persistent_grid(B, Sq, H, sms)
    n_qt = -(-Sq // t_fa.ITEM_ROWS)
    assert items == n_qt * B * H and blocks == min(items, sms)
    walks = _walk(items, blocks)
    assert sorted(i for w in walks for i in w) == list(range(items))
    assert all(len(w) >= 1 for w in walks)
    assert sum(len(w) - 1 for w in walks) == items - blocks == chained
    # the kernel's decode of an item: Q tile fastest, then head, then batch
    decoded = {(i % n_qt, i // n_qt // H, i // n_qt % H) for i in range(items)}
    assert decoded == {(t, b, h) for t in range(n_qt) for b in range(B)
                       for h in range(H)}
