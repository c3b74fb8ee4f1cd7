"""K7, the DiT block glue (``ops/adaln_glue.py``, ``csrc/adaln_glue.cu``), on
the CPU: its plain versions against the expressions the blocks ran before,
chip_smoke.py's check against an emulation of the kernel's row loop with
planted faults, and the blocks' dispatch (plain versions without grad,
autograd's expressions with it)."""

import dataclasses
import re
from pathlib import Path

import pytest
import torch

import chip_smoke
from ladcast_torch import config
from ladcast_torch.models import ladcast_dit as dit
from ladcast_torch.ops import adaln_glue as glue
from ladcast_torch.ops.norms import layer_norm

ROOT = Path(__file__).resolve().parent.parent
SRC = (ROOT / "ladcast_torch" / "csrc" / "adaln_glue.cu").read_text()
MODES = ("ln_modulate", "gated_residual_ln_modulate", "gated_residual")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(B, S, D, dtype, seed=0, strided=False):
    """x, y (B, S, D) and gate, shift, scale (B, D) as chunk views of one
    (B, 3 D) tensor, as an AdaLN linear's output gives them. With
    ``strided``, x is the first S tokens of (B, S + 4, D), as the head's
    input is a view of the joint stream."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, S + 4 if strided else S, D, generator=g) * 2 + 0.5
    x = x.to(dtype)[:, :S]
    y = torch.randn(B, S, D, generator=g).to(dtype)
    gate, shift, scale = (torch.randn(B, 3 * D, generator=g) * 0.5).to(dtype).chunk(3, -1)
    return x, y, gate, shift, scale


def _todays(mode, x, y, gate, shift, scale, eps):
    """What the blocks computed before K7, as PyTorch ops in x's dtype."""
    if mode == "ln_modulate":
        return (dit._modulate(layer_norm(x, None, None, eps), shift, scale),)
    xr = x + y * gate[:, None]
    if mode == "gated_residual":
        return (xr,)
    return xr, dit._modulate(layer_norm(xr, None, None, eps), shift, scale)


def _plain(mode, x, y, gate, shift, scale, eps):
    if mode == "ln_modulate":
        return (glue.ln_modulate_plain(x, shift, scale, eps),)
    if mode == "gated_residual":
        return (glue.gated_residual_plain(x, y, gate),)
    return glue.gated_residual_ln_modulate_plain(x, y, gate, shift, scale, eps)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("eps", [1e-6, 1e-7])
def test_plain_versions_equal_todays_expressions(mode, dtype, eps):
    """fp32: within 1e-6 of the output's max; bf16: within 2 bf16 ulps of
    it (the old chain rounds four times, the plain version once)."""
    args = _inputs(3, 13, 256, DTYPES[dtype], seed=1, strided=mode == "ln_modulate")
    for got, want in zip(_plain(mode, *args, eps), _todays(mode, *args, eps)):
        assert got.dtype == want.dtype == DTYPES[dtype]
        top = want.float().abs().max().item()
        tol = 1e-6 * top if dtype == "float32" else 2 * chip_smoke.bf16_ulp(top)
        assert (got.float() - want.float()).abs().max().item() <= tol


# ---------------------------------------------- the kernel's row loop ---

def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def _flat(t):
    """t's storage from its first element on, as a flat view."""
    n = 1 + sum((d - 1) * st for d, st in zip(t.shape, t.stride()))
    return t.as_strided((n,), (1,))


def _warp_sum(p):
    """The kernel's butterfly of __shfl_xor_sync over 32 lane partials."""
    lanes = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        p = p + p[lanes ^ off]
    return p[0]


def _k7_rows(mode, x, y, gate, shift, scale, eps, fault=None):
    """K7's row loop emulated on the CPU in fp32, as the source has it:
    blocks of kRowsPerBlock warps, one warp a row with its bounds check,
    the batch index row / S, each lane's 16-byte chunks (consecutive lanes
    on consecutive chunks, the smallest instance that holds the row), the
    pointers from the strides, the warp's sums as a butterfly. Returns
    what the kernel stores, (x',) and/or h. Faults: "unbiased_variance",
    "batch_off_by_one" (the first row of each batch takes the batch
    before), "tail_chunk_raw" (the row's last chunk stored un-normalised),
    "scale_for_one_plus_scale"."""
    B, S, D = x.shape
    V = 16 // x.element_size()
    chunks = D // V
    need, most = -(-chunks // 32), _const("kLaneVals") // V
    nch = min(n for n in (most * int(a or 1) // int(b or 1) for a, b in re.findall(
        r"run<T, MODE, kMax(?: \* (\d+))?(?: / (\d+))?>", SRC)) if n >= need)
    idx = torch.arange(nch)[:, None] * 32 + torch.arange(32)[None, :]  # chunk of (c, lane)
    valid = (idx < chunks)[..., None]  # (nch, 32, 1)
    offs = idx.clamp(max=chunks - 1)[..., None] * V + torch.arange(V)  # (nch, 32, V)

    def chunk_vals(t, off):
        return torch.where(valid, _flat(t)[off + offs].float(), 0.0)

    def strides(t):
        return [st if n > 1 else 0 for n, st in zip(t.shape[:-1], t.stride()[:-1])]

    x_out = torch.zeros(B * S, D, dtype=x.dtype)
    h_out = torch.zeros(B * S, D, dtype=x.dtype)
    rows, per_block = B * S, _const("kRowsPerBlock")
    for block in range(-(-rows // per_block)):
        for warp in range(per_block):
            row = block * per_block + warp
            if row >= rows:
                continue
            b = (row - 1) // S if fault == "batch_off_by_one" and row else row // S
            s = row - b * S
            xs, (gs,) = strides(x), strides(gate)
            v = chunk_vals(x, b * xs[0] + s * xs[1])
            if mode != "ln_modulate":
                ys = strides(y)
                v = v + chunk_vals(y, b * ys[0] + s * ys[1]) * chunk_vals(gate, b * gs)
                x_out[row, offs[valid[..., 0]].flatten()] = v[valid[..., 0]].flatten().to(x.dtype)
                if mode == "gated_residual":
                    continue
            mean = _warp_sum(v.sum((0, 2))) / D
            d = torch.where(valid, v - mean, 0.0)
            n = D - 1 if fault == "unbiased_variance" else D
            rstd = 1.0 / torch.sqrt(_warp_sum(d.square().sum((0, 2))) / n + eps)
            (shs,), (scs,) = strides(shift), strides(scale)
            sc = chunk_vals(scale, b * scs)
            mod = sc if fault == "scale_for_one_plus_scale" else 1.0 + sc
            h = d * rstd * mod + chunk_vals(shift, b * shs)
            if fault == "tail_chunk_raw":
                h = torch.where(idx[..., None] == chunks - 1, v, h)
            h_out[row, offs[valid[..., 0]].flatten()] = h[valid[..., 0]].flatten().to(x.dtype)
    shaped = lambda t: t.view(B, S, D)  # noqa: E731
    if mode == "ln_modulate":
        return (shaped(h_out),)
    if mode == "gated_residual":
        return (shaped(x_out),)
    return shaped(x_out), shaped(h_out)


LN_FAULTS = ("unbiased_variance", "batch_off_by_one", "tail_chunk_raw",
             "scale_for_one_plus_scale")
CASES = ([(m, f) for m in MODES[:2] for f in (None, *LN_FAULTS)]
         + [("gated_residual", None), ("gated_residual", "batch_off_by_one")])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode,fault", CASES)
def test_smoke_glue_check_catches_faults(mode, fault, dtype):
    """chip_smoke.py's check of K7 passes the emulated row loop as written
    and fails each planted fault, at S = 13, B = 3 (batch boundaries inside
    blocks of rows) and D = 264 (a last chunk held by one lane in bf16, two
    in fp32); ln_modulate reads the head's strided view."""
    eps = 1e-6
    args = _inputs(3, 13, 264, DTYPES[dtype], seed=2, strided=mode == "ln_modulate")
    got = _k7_rows(mode, *args, eps, fault)
    recs = [chip_smoke.compare(o, r, chip_smoke.kernel_tolerance("adaln_glue", dtype, r))
            for o, r in zip(got, _plain(mode, *args, eps))]
    assert all(r["ok"] for r in recs) == (fault is None), recs


# ------------------------------------------------------------ dispatch ---

def _spy(monkeypatch):
    """Counts of the glue entries the blocks call."""
    calls = dict.fromkeys(MODES, 0)
    for name in MODES:
        real = getattr(glue, name)

        def counted(*a, _real=real, _name=name):
            calls[_name] += 1
            return _real(*a)

        monkeypatch.setattr(glue, name, counted)
    return calls


def _dual_todays(blk, x, cond, temb, rope):
    """DualStreamBlock.forward as written before K7."""
    nx, gate_msa, shift_mlp, scale_mlp, gate_mlp = _adaln_todays(blk.norm1, x, temb)
    nc, c_gate_msa, c_shift_mlp, c_scale_mlp, c_gate_mlp = _adaln_todays(
        blk.norm1_context, cond, temb)
    attn_x, attn_c = blk.attn(nx, nc, rope)
    x = x + attn_x * gate_msa[:, None]
    cond = cond + attn_c * c_gate_msa[:, None]
    nx = dit._modulate(layer_norm(x, None, None, 1e-7), shift_mlp, scale_mlp)
    nc = dit._modulate(layer_norm(cond, None, None, 1e-7), c_shift_mlp, c_scale_mlp)
    x = x + blk.ff(nx) * gate_mlp[:, None]
    cond = cond + blk.ff_context(nc) * c_gate_mlp[:, None]
    return x, cond


def _adaln_todays(norm, x, temb):
    (shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp,
     gate_mlp) = norm.linear(torch.nn.functional.silu(temb)).chunk(6, dim=-1)
    h = dit._modulate(layer_norm(x, None, None, 1e-6), shift_msa, scale_msa)
    return h, gate_msa, shift_mlp, scale_mlp, gate_mlp


def _single_todays(blk, h, n_cond, temb, rope, cond_rope):
    """SingleStreamBlock.forward's glue as written before K7, on the joint
    stream and with the block's own ``proj_out``."""
    residual = h
    shift, scale, gate = blk.norm.linear(torch.nn.functional.silu(temb)).chunk(3, dim=-1)
    norm_h = dit._modulate(layer_norm(residual, None, None, 1e-6), shift, scale)
    mlp_h = dit._gelu_tanh(blk.proj_mlp(norm_h))
    attn_out = blk.attn(norm_h, n_cond, rope, cond_rope)
    h = gate[:, None] * blk._proj_out(attn_out, mlp_h)
    return (h + residual,)


def _blocks_and_inputs(seed=0):
    torch.manual_seed(seed)
    heads, hd, D = 2, 128, 256
    dual = dit.DualStreamBlock(heads, hd, 2.0, "auto")
    single = dit.SingleStreamBlock(heads, hd, 2.0, "auto")
    for blk in (dual, single):  # zero-initialised AdaLN weights would hide the gates
        for p in blk.parameters():
            torch.nn.init.normal_(p, std=0.05)
    g = torch.Generator().manual_seed(seed + 1)
    x = torch.randn(2, 12, D, generator=g)
    cond = torch.randn(2, 6, D, generator=g)
    temb = torch.randn(2, D, generator=g)
    rope = tuple(torch.randn(12, hd, generator=g) for _ in range(2))
    cond_rope = tuple(torch.randn(6, hd, generator=g) for _ in range(2))
    return dual, single, (x, cond, temb), rope, cond_rope


def test_blocks_take_the_plain_versions_on_cpu_without_grad(monkeypatch):
    """Without grad the blocks call the three entries, which run their
    plain versions on CPU tensors: the outputs stay within fp32 rounding of
    the old expressions and no launch is counted."""
    dual, single, (x, cond, temb), rope, cond_rope = _blocks_and_inputs()
    calls, before = _spy(monkeypatch), glue.launches()
    h, n_cond = torch.cat([x, cond], dim=1), cond.shape[1]
    with torch.no_grad():
        got = dual(x, cond, temb, rope) + (single(h, n_cond, temb, rope, cond_rope),)
        want = (_dual_todays(dual, x, cond, temb, rope)
                + _single_todays(single, h, n_cond, temb, rope, cond_rope))
    assert calls == {"ln_modulate": 3, "gated_residual_ln_modulate": 2,
                     "gated_residual": 3}
    assert glue.launches() == before
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_blocks_keep_todays_expressions_with_grad(monkeypatch):
    """With grad on, a dual-stream and a single-stream block give the same
    outputs and gradients, bit for bit, as the old expressions, and call no
    glue entry."""
    dual, single, (x, cond, temb), rope, cond_rope = _blocks_and_inputs(3)
    h, n_cond = torch.cat([x, cond], dim=1), cond.shape[1]
    calls, before = _spy(monkeypatch), glue.launches()
    for blk, todays, inputs, call in (
            (dual, _dual_todays, (x, cond, temb), lambda f, x, c, t: f(x, c, t, rope)),
            (single, _single_todays, (h, temb),
             lambda f, h, t: f(h, n_cond, t, rope, cond_rope))):
        outs = []
        for fwd in (blk, lambda *a, _t=todays, _b=blk: _t(_b, *a)):
            xs = [t.clone().requires_grad_(True) for t in inputs]
            out = call(fwd, *xs)
            out = out if isinstance(out, tuple) else (out,)
            loss = sum((o * (i + 1)).square().sum() for i, o in enumerate(out))
            grads = torch.autograd.grad(loss, xs + list(blk.parameters()))
            outs.append((out, grads))
        (o1, g1), (o2, g2) = outs
        assert all(torch.equal(a, b) for a, b in zip(o1, o2))
        assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    assert calls == dict.fromkeys(MODES, 0) and glue.launches() == before


def _tiny_cfg(layers, single_layers):
    """A DiT config with the given block counts at tiny widths."""
    return config.LaDCastDiTConfig(
        in_channels=4, out_channels=4, num_attention_heads=1, attention_head_dim=128,
        num_layers=layers, num_single_layers=single_layers, num_refiner_layers=1,
        mlp_ratio=1.0, conditioning_tensor_in_channels=4)


@pytest.mark.parametrize("layers,single_layers,entries",
                         [(2, 4, 21), (5, 10, 51)], ids=["375m_blocks", "1p6b_blocks"])
def test_dit_call_takes_the_glue_once_per_step(monkeypatch, layers, single_layers,
                                               entries):
    """A DiT call with the 375M's and the 1.6B's block counts, at tiny
    widths on the CPU, calls the glue entries 6 times a dual-stream block,
    twice a single-stream block and once at the head: the launches K7 makes
    on the card (tests/test_torch_rules.py checks those)."""
    model = dit.build_dit(_tiny_cfg(layers, single_layers), device="cpu", seed=0)
    calls = _spy(monkeypatch)
    with torch.inference_mode():
        model(torch.randn(2, 1, 3, 4, 4), torch.ones(2), torch.randn(2, 1, 3, 4, 4))
    assert calls == {"ln_modulate": 2 * layers + single_layers + 1,
                     "gated_residual_ln_modulate": 2 * layers,
                     "gated_residual": 2 * layers + single_layers}
    assert sum(calls.values()) == entries


def test_smoke_plain_dit_call_takes_no_glue(monkeypatch):
    """chip_smoke.py's parity checks hold the kernel DiT against a plain
    copy loaded as they load it (built on the meta device, the state dict
    assigned) and run by plain_dit_call, with grad on: that copy calls no
    glue entry, so K7 runs on one side of the comparison only, and it gives
    the DiT's output within fp32 rounding."""
    cfg = _tiny_cfg(2, 4)
    model = dit.build_dit(cfg, device="cpu", seed=0)
    with torch.device("meta"):
        plain = dit.LaDCastTransformer3D(dataclasses.replace(cfg, attention_impl="plain"))
    plain.load_state_dict(model.state_dict(), strict=True, assign=True)
    plain.eval()
    g = torch.Generator().manual_seed(5)
    args = (torch.randn(2, 1, 3, 4, 4, generator=g), torch.ones(2),
            torch.randn(2, 1, 3, 4, 4, generator=g))
    calls = _spy(monkeypatch)
    got = chip_smoke.plain_dit_call(plain, *args)
    assert calls == dict.fromkeys(MODES, 0) and not got.requires_grad
    with torch.inference_mode():
        want = model(*args)
    assert sum(calls.values()) == 21
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_applies_follows_grad_dtype_and_device():
    """The blocks take the entries wherever no input needs a gradient; on
    the CPU only for one dtype of bf16 or fp32, elsewhere always, and the
    entry raises for a device K7 does not run on."""
    x, y, gate, shift, scale = _inputs(2, 5, 64, torch.float32)
    assert glue.applies((x, y), (gate, shift, scale))
    assert not glue.applies((x.double(), y.double()), (gate.double(),))
    assert not glue.applies((x, y.bfloat16()), (gate,))
    w = gate.clone().requires_grad_(True)
    assert not glue.applies((x, y), (w,))
    with torch.no_grad():
        assert glue.applies((x, y), (w,))
    meta = torch.empty(2, 5, 64, device="meta")
    rows = (torch.empty(2, 64, device="meta"),) * 2
    assert glue.applies((meta,), rows)
    assert not glue.applies((meta.requires_grad_(True),), rows)
    with pytest.raises(ValueError, match="expected cpu or cuda"):
        glue.ln_modulate(meta.detach(), *rows, 1e-6)
