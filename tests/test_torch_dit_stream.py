"""The DiT's single-stream blocks on the whole joint stream, ``proj_out``
split by the column blocks of its weight, and the up-projections' tanh GELU
(``ops.gelu_gemm``), on the CPU: the blocks and the DiT call against the
expressions they ran before (kept here), with grad on and off, in fp32,
bf16 and with int8 products; remat's gradients; and the CPU path's GELU,
which must stay the tanh one (``torch._addmm_activation`` computes the erf
GELU on CPU tensors)."""

import copy
import dataclasses

import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

import chip_smoke
from ladcast_torch import config
from ladcast_torch.models import ladcast_dit as dit
from ladcast_torch.ops import gelu_gemm

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _previous_single(blk, x, cond, temb, rope, cond_rope, attn_bias=None):
    """SingleStreamBlock.forward as it was: the joint stream rebuilt from
    its two parts, ``proj_out`` over the concatenated [attention; MLP]
    features, the GELU after its GEMM, the result split again."""
    n_cond = cond.shape[1]
    residual = torch.cat([x, cond], dim=1)
    norm_h, gate = blk.norm(residual, temb)
    mlp_h = dit._gelu_tanh(blk.proj_mlp(norm_h))
    attn_out = blk.attn(norm_h, n_cond, rope, cond_rope, attn_bias)
    h = dit._gated_residual(residual,
                            blk.proj_out(torch.cat([attn_out, mlp_h], dim=2)), gate)
    return h[:, :-n_cond], h[:, -n_cond:]


def _previous_feed_forward(ff, x):
    """FeedForward.forward as it was: the GEMM, then the activation."""
    return ff.net[2](ff.net[0].act(ff.net[0].proj(x)))


def _previous_dit_call(model, latents, c_noise, conditioning, year_progress=None):
    """LaDCastTransformer3D.forward as it was: the single-stream blocks take
    and return the two streams apart, and every feed-forward applies its
    GELU after its GEMM."""
    cfg = model.cfg
    B, T, H, W, C = latents.shape
    T_in = conditioning.shape[1]
    dev = latents.device
    c_noise = torch.as_tensor(c_noise, device=dev).reshape(-1).expand(B)
    rope_table = model._rope_tables(T, H, W, False, dev)
    cond_rope_table = model._rope_tables(T_in, H, W, True, dev)
    if cfg.scale_attn_by_lat:
        pred_bias = model._lat_attn_bias(T + T_in, H, W, dev)
        cond_bias = model._lat_attn_bias(T_in, H, W, dev)
    else:
        pred_bias = cond_bias = None
    x = model.x_embedder(latents.reshape(B, T * H * W, C))
    cond = model.context_embedder(conditioning.reshape(B, T_in * H * W, -1))
    cond = model.context_refiner(cond, c_noise, cond_rope_table, cond_bias)
    temb = model.time_text_embed(c_noise.float(), cond.mean(dim=1).float())
    if year_progress is not None and cfg.incl_time_elapsed:
        yp = torch.as_tensor(year_progress, device=dev).reshape(-1).expand(B)
        ye = model.time_elapsed_embed(dit.year_sincos_embedding(yp, 256))
        scale, shift = ye.chunk(2, dim=-1)
        temb = temb * (1 + scale) + shift
    for block in model.transformer_blocks:
        temb_b = temb.to(latents.dtype)
        norm_x, gate_msa, shift_mlp, scale_mlp, gate_mlp = block.norm1(x, temb_b)
        norm_c, c_gate_msa, c_shift_mlp, c_scale_mlp, c_gate_mlp = \
            block.norm1_context(cond, temb_b)
        attn_x, attn_c = block.attn(norm_x, norm_c, rope_table, pred_bias)
        x, nx = dit._gated_residual_ln_modulate(x, attn_x, gate_msa, shift_mlp,
                                                scale_mlp, 1e-7)
        cond, nc = dit._gated_residual_ln_modulate(cond, attn_c, c_gate_msa,
                                                   c_shift_mlp, c_scale_mlp, 1e-7)
        x = dit._gated_residual(x, _previous_feed_forward(block.ff, nx), gate_mlp)
        cond = dit._gated_residual(cond, _previous_feed_forward(block.ff_context, nc),
                                   c_gate_mlp)
    for block in model.single_transformer_blocks:
        x, cond = _previous_single(block, x, cond, temb.to(latents.dtype), rope_table,
                                   cond_rope_table, pred_bias)
    scale, shift = model.norm_out(temb.to(latents.dtype)).chunk(2, dim=-1)
    x = dit._ln_modulate(x, shift, scale, 1e-7)
    return model.proj_out(x).reshape(B, T, H, W, cfg.out_channels)


def _tiny_cfg(**kw):
    """The 375M's block counts at tiny widths (1 head of 128, an MLP twice
    as wide, so proj_out's two column blocks differ in width)."""
    return config.LaDCastDiTConfig(
        in_channels=4, out_channels=4, num_attention_heads=1, attention_head_dim=128,
        num_layers=2, num_single_layers=4, num_refiner_layers=1, mlp_ratio=2.0,
        conditioning_tensor_in_channels=4, **kw)


def _seeded(module, seed):
    """Every parameter drawn anew: the flax defaults zero the biases and
    the AdaLN linears' outputs would hide the gates."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    return module


def _model(cfg, seed):
    """The DiT of ``cfg`` on the CPU with :func:`_seeded` weights (built on
    the meta device: the flax-default draws it would replace are slow)."""
    with torch.device("meta"):
        model = dit.LaDCastTransformer3D(cfg)
    return _seeded(model.to_empty(device="cpu"), seed).eval()


def _inputs(dtype, seed=1, B=2):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, 2, 3, 4, 4, generator=g).to(dtype),
            torch.rand(B, generator=g),
            torch.randn(B, 1, 3, 4, 4, generator=g).to(dtype),
            torch.rand(B, generator=g))


def _close(got, want, dtype):
    """fp32: within 1e-6 of want's largest magnitude. bf16: within 2 bf16
    ulps of it: the split ``proj_out`` rounds its first GEMM's output (the
    bias and the attention columns) to bf16 before the second adds the MLP
    columns, one rounding more than the concatenated GEMM, and the sum's
    last rounding may then fall to the neighbouring value."""
    top = want.float().abs().max().item()
    tol = 1e-6 * top if dtype == torch.float32 else 2 * chip_smoke.bf16_ulp(top)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, (err, tol)


def _block_and_inputs(dtype, int8, seed=0):
    heads, hd = 2, 64
    D = heads * hd
    blk = _seeded(dit.SingleStreamBlock(heads, hd, 4.0, "auto", int8), seed).to(dtype)
    g = torch.Generator().manual_seed(seed + 1)
    x = torch.randn(2, 12, D, generator=g).to(dtype)
    cond = torch.randn(2, 6, D, generator=g).to(dtype)
    temb = torch.randn(2, D, generator=g).to(dtype)
    rope = tuple(torch.randn(12, hd, generator=g) for _ in range(2))
    cond_rope = tuple(torch.randn(6, hd, generator=g) for _ in range(2))
    return blk, (x, cond, temb), rope, cond_rope


# (grad, int8): int8 products are inference only (the trainer refuses them)
MODES = pytest.mark.parametrize("grad,int8", [(False, False), (True, False), (False, True)],
                                ids=["no_grad", "grad", "int8"])


@MODES
@pytest.mark.parametrize("dtype", DTYPES)
def test_single_block_on_the_joint_stream_matches_the_previous(dtype, grad, int8):
    """The block on the whole joint stream gives the previous block's two
    streams, and with grad on the same gradients, within _close's limits;
    with int8 products (whose proj_out keeps the concatenation) exactly."""
    dt = DTYPES[dtype]
    blk, (x, cond, temb), rope, cond_rope = _block_and_inputs(dt, int8)
    n_cond = cond.shape[1]
    runs = []
    for new in (True, False):
        xs = [t.clone().requires_grad_(grad) for t in (x, cond, temb)]
        with torch.set_grad_enabled(grad):
            if new:
                h = blk(torch.cat(xs[:2], dim=1), n_cond, xs[2], rope, cond_rope)
                out = (h[:, :-n_cond], h[:, -n_cond:])
            else:
                out = _previous_single(blk, *xs, rope, cond_rope)
            grads = ()
            if grad:
                loss = sum((o.float() * (i + 1)).square().sum() for i, o in enumerate(out))
                grads = torch.autograd.grad(loss, xs + list(blk.parameters()))
        runs.append((out, grads))
    (o1, g1), (o2, g2) = runs
    for a, b in zip(o1 + g1, o2 + g2):
        assert a.dtype == b.dtype and a.shape == b.shape
        if int8:
            assert torch.equal(a, b)
        else:
            _close(a, b, dt)


@MODES
@pytest.mark.parametrize("dtype", DTYPES)
def test_dit_call_on_the_joint_stream_matches_the_previous(dtype, grad, int8):
    """A whole DiT call at the 375M's block counts (tiny widths) against the
    previous forward, and with grad on the gradients of every parameter.

    fp32: the output within 1e-6 of its largest magnitude, the gradients
    within 1e-6 of the largest gradient (not of each tensor's own: the
    keys' biases have a zero gradient in exact arithmetic, a softmax being
    blind to a shift of its logits, so theirs is rounding alone).
    bf16: through six blocks the two paths' roundings part by about half a
    percent (relative L2), which no per-element ulp limit bounds; so each
    is held to an fp32 run of the previous expressions on the same bf16
    weights and inputs: the new path's distance to it at most 1.1 times the
    previous path's, and the two paths no farther apart than that distance.
    int8 products: exactly (the joint stream holds the same values, the
    int8 projections and their GELU are unchanged)."""
    dt = DTYPES[dtype]
    cfg = _tiny_cfg(int8_matmuls=int8)
    model = _model(cfg, 3).to(dt)

    def run(fwd, m, args):
        with torch.set_grad_enabled(grad):
            out = fwd(m, *args)
            grads = (torch.autograd.grad(out.float().square().sum(), list(m.parameters()))
                     if grad else ())
        return out.float(), [g.float() for g in grads]

    args = _inputs(dt)
    new, prev = (run(lambda m, *a: m(*a), model, args),
                 run(_previous_dit_call, model, args))
    if int8:
        assert torch.equal(new[0], prev[0])
    elif dt == torch.float32:
        _close(new[0], prev[0], dt)
        top = max((g.abs().max().item() for g in prev[1]), default=0.0)
        for a, b in zip(new[1], prev[1]):
            assert (a - b).abs().max().item() <= 1e-6 * top
    else:
        ref = run(_previous_dit_call, copy.deepcopy(model).float(),
                  [t.float() for t in args])

        def rel(a, b):
            return ((a - b).norm() / b.norm()).item()

        triples = [(new[0], prev[0], ref[0])]
        if grad:  # every parameter's gradient as one vector
            triples.append(tuple(torch.cat([g.flatten() for g in r[1]])
                                 for r in (new, prev, ref)))
        for got, was, want in triples:
            d_new, d_prev = rel(got, want), rel(was, want)
            assert d_new <= 1.1 * d_prev and rel(got, was) <= d_prev, (d_new, d_prev)


def test_remat_gradients_match_without_remat():
    """With remat each single-stream block (taking the joint stream and the
    conditioning's token count) is a checkpoint; its gradients equal those
    of the same weights without remat."""
    grads = []
    for remat in (False, True):
        model = _model(_tiny_cfg(remat=remat), 4).train()
        out = model(*_inputs(torch.float32, seed=2))
        grads.append(torch.autograd.grad(out.square().sum(), list(model.parameters())))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


class _CountCats(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.cats = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.cats += func is torch.ops.aten.cat.default
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_single_block_concatenates_nothing(int8):
    """Without grad a float single-stream block runs no cat (its attention's
    tables are built at the first call and kept); an int8 block one, the
    input of its proj_out."""
    blk, (x, cond, temb), rope, cond_rope = _block_and_inputs(torch.float32, int8)
    h = torch.cat([x, cond], dim=1)
    with torch.no_grad():
        blk(h, cond.shape[1], temb, rope, cond_rope)
        with _CountCats() as counter:
            blk(h, cond.shape[1], temb, rope, cond_rope)
    assert counter.cats == int(int8)


def test_cpu_gelu_is_the_tanh_gelu():
    """On CPU tensors the up-projection's GELU is F.gelu(approximate="tanh")
    to 1e-6 in fp32, with and without grad, which the erf GELU, what
    torch._addmm_activation computes on the CPU, misses."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(64, 32, generator=g) * 2
    w = torch.randn(48, 32, generator=g) / 32 ** 0.5
    b = torch.randn(48, generator=g) * 0.5
    z = F.linear(x, w, b)
    tanh, erf = F.gelu(z, approximate="tanh"), F.gelu(z)
    assert (torch._addmm_activation(b, x, w.t(), use_gelu=True) - erf).abs().max() <= 1e-6
    assert (erf - tanh).abs().max() > 1e-4
    for grad in (False, True):
        with torch.set_grad_enabled(grad):
            got = gelu_gemm.dense_gelu_tanh(x, w.requires_grad_(grad), b)
        assert (got - tanh).abs().max() <= 1e-6


def test_cpu_dit_call_never_reaches_addmm_activation(monkeypatch):
    """A DiT call on CPU tensors without grad, and its feed-forwards, never
    call torch._addmm_activation and count no launch of the epilogue
    GEMM."""
    def refuse(*a, **k):
        raise AssertionError("torch._addmm_activation on CPU tensors")

    monkeypatch.setattr(torch, "_addmm_activation", refuse)
    model = _model(_tiny_cfg(), 0)
    n0 = gelu_gemm.dense_gelu_tanh.launches
    with torch.inference_mode():
        assert torch.isfinite(model(*_inputs(torch.float32))).all()
    assert gelu_gemm.dense_gelu_tanh.launches == n0


def test_applies_follows_grad_and_device():
    """The epilogue is taken for CUDA tensors none of which needs a
    gradient: never on the CPU or the meta device, never with grad on."""
    cpu = (torch.randn(3, 4), torch.randn(8, 4), torch.randn(8))
    for ts in (cpu, tuple(t.to("meta") for t in cpu)):
        assert not gelu_gemm.applies(*ts)
        with torch.no_grad():
            assert not gelu_gemm.applies(*ts)


def test_proj_out_state_dict_is_unchanged():
    """The split proj_out reads views of its one parameter: the state dict
    keeps one (D, D + mlp) weight and one bias a block, and a state dict
    saved before loads strictly."""
    cfg = _tiny_cfg()
    model = _model(cfg, 0)
    sd = model.state_dict()
    D = cfg.inner_dim
    for i in range(cfg.num_single_layers):
        assert sd[f"single_transformer_blocks.{i}.proj_out.weight"].shape == (D, 3 * D)
        assert f"single_transformer_blocks.{i}.proj_out.bias" in sd
    with torch.device("meta"):
        plain = dit.LaDCastTransformer3D(dataclasses.replace(cfg, attention_impl="plain"))
    plain.load_state_dict(sd, strict=True, assign=True)
