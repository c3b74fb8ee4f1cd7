"""The port's sphere convs, pixel (un)shuffle and DCAE vs the JAX package,
in fp32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladcast_torch import config as t_config
from ladcast_torch.models.dcae import AutoencoderDC as TorchAE
from ladcast_torch.models.weight_import import state_dict_from_flax
from ladcast_torch.ops import pixel_shuffle as t_ps
from ladcast_torch.ops import sphere as t_sphere
from ladcast_tpu import config as j_config
from ladcast_tpu.models.dcae import AutoencoderDC as JaxAE
from ladcast_tpu.models.weight_import import export_reference_state_dict
from ladcast_tpu.ops import pixel_shuffle as j_ps
from ladcast_tpu.ops import sphere as j_sphere

TINY = dict(in_channels=9, out_channels=9, latent_channels=4,
            attention_head_dim=4,
            encoder_block_out_channels=(8, 16, 16, 32),
            decoder_block_out_channels=(8, 16, 16, 32),
            encoder_layers_per_block=(1, 1, 1, 1),
            decoder_layers_per_block=(1, 1, 1, 1),
            static_channels=1)


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """The test suite runs files in parallel workers on a shared CPU; two
    intra-op threads per worker keep them from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("k,cin,cout,groups", [(3, 5, 7, 1), (5, 6, 6, 6),
                                               (3, 6, 6, 6)])
def test_sphere_conv2d_matches_jax(k, cin, cout, groups):
    rng = np.random.RandomState(k + groups)
    x = rng.randn(2, 8, 12, cin).astype(np.float32)
    w_hwio = rng.randn(k, k, cin // groups, cout).astype(np.float32)
    b = rng.randn(cout).astype(np.float32)
    want = j_sphere.sphere_conv2d(jnp.asarray(x), jnp.asarray(w_hwio),
                                  jnp.asarray(b), groups=groups)
    got = t_sphere.sphere_conv2d(
        torch.from_numpy(x),
        torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1))),
        torch.from_numpy(b), groups=groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_pixel_shuffle_exact_and_torch_order():
    x = np.random.RandomState(0).randn(2, 6, 8, 12).astype(np.float32)
    tx = torch.from_numpy(x)
    un = t_ps.pixel_unshuffle(tx, 2)
    np.testing.assert_array_equal(un.numpy(),
                                  np.asarray(j_ps.pixel_unshuffle(jnp.asarray(x), 2)))
    sh = t_ps.pixel_shuffle(tx, 2)
    np.testing.assert_array_equal(sh.numpy(),
                                  np.asarray(j_ps.pixel_shuffle(jnp.asarray(x), 2)))
    # channel order of torch's NCHW pixel_unshuffle
    ref = torch.nn.functional.pixel_unshuffle(tx.permute(0, 3, 1, 2), 2)
    np.testing.assert_array_equal(un.numpy(), ref.permute(0, 2, 3, 1).numpy())


def _models():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 16, 32, 8).astype(np.float32)
    static = rng.randn(16, 32, 1).astype(np.float32)
    jmodel = JaxAE(j_config.DCAEConfig(**TINY))
    params = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(static)))
    tmodel = TorchAE(t_config.DCAEConfig(**TINY))
    tmodel.load_state_dict(state_dict_from_flax(params, "dcae"), strict=True)
    return jmodel, params, tmodel.eval(), x, static


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_tiny_encode_decode_match_jax(monkeypatch):
    """Under both conv modes: the kernels' plain versions in the
    fused-boundary form (the default) and ``F.conv2d`` in the 3-slice form."""
    jmodel, params, tmodel, x, static = _models()
    z_j = np.asarray(jmodel.apply(params, jnp.asarray(x), jnp.asarray(static),
                                  method=JaxAE.encode))
    y_js = {rs: np.asarray(jmodel.apply(params, jnp.asarray(z_j), rs,
                                        method=JaxAE.decode))
            for rs in (False, True)}
    assert t_sphere.CONV_MODE == "kernel"
    for mode in ("kernel", "library"):
        monkeypatch.setattr(t_sphere, "CONV_MODE", mode)
        with torch.no_grad():
            z_t = tmodel.encode(torch.from_numpy(x), torch.from_numpy(static)).numpy()
        assert z_t.shape == (2, 2, 4, 4)
        assert _rel(z_t, z_j) <= 1e-4, (mode, _rel(z_t, z_j))
        for return_static, y_j in y_js.items():
            with torch.no_grad():
                y_t = tmodel.decode(torch.tensor(z_j), return_static).numpy()
            assert y_t.shape == y_j.shape == (2, 16, 32, 9 if return_static else 8)
            assert _rel(y_t, y_j) <= 1e-4, (mode, _rel(y_t, y_j))


def test_sphere_conv_layer_keeps_its_repacked_weight():
    """Outside grad mode the layer repacks once per weight, and again when
    the weight changes; under grad mode the weight's gradient flows."""
    from ladcast_torch.models.dcae import SphereConv

    torch.manual_seed(0)
    conv = SphereConv(4, 6)
    x = torch.randn(1, 6, 8, 4)
    with torch.no_grad():
        a = conv(x)
        kept = conv._packed[1]
        assert conv(x) is not a and conv._packed[1] is kept
        conv.weight.mul_(2.0)
        b = conv(x)
    assert conv._packed[1] is not kept
    torch.testing.assert_close(b - conv.bias, 2 * (a - conv.bias))
    conv(x).sum().backward()
    assert conv.weight.grad is not None and conv.weight.grad.abs().max() > 0


def test_state_dict_from_flax_equals_export():
    _, params, _, _, _ = _models()
    ours = state_dict_from_flax(params, "dcae")
    ref = export_reference_state_dict(params, "dcae")
    assert list(ours) == list(ref)
    for name, w in ref.items():
        np.testing.assert_array_equal(ours[name].numpy(), w)


def test_production_config_names_and_shapes():
    cfg = j_config.DCAEConfig()
    x = jax.ShapeDtypeStruct((1, 120, 240, 84), jnp.float32)
    static = jax.ShapeDtypeStruct((120, 240, 5), jnp.float32)
    shapes = jax.eval_shape(JaxAE(cfg).init, jax.random.PRNGKey(0), x, static)
    with torch.device("meta"):
        model = TorchAE(t_config.DCAEConfig())
    params = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = state_dict_from_flax(params, "dcae")
    model.load_state_dict(sd, strict=True, assign=True)
    assert tuple(sd["encoder.conv_in.weight"].shape) == (252, 89, 3, 3)


def test_temb_encode_decode_forward_match_jax():
    """The timestep-conditioned DCAE (``temb_channels``) with the JAX
    weights through ``state_dict_from_flax``, every parameter moved off
    its initial value: encode, decode and the full forward (one embedding
    for both halves) agree in fp32 to 1e-5 relative L2."""
    cfg = dict(TINY, temb_channels=12)
    rng = np.random.RandomState(3)
    x = rng.randn(2, 16, 32, 8).astype(np.float32)
    static = rng.randn(16, 32, 1).astype(np.float32)
    t = np.asarray([6.0, 240.0], np.float32)
    jmodel = JaxAE(j_config.DCAEConfig(**cfg))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.asarray(x),
                            jnp.asarray(static), time_elapsed=jnp.asarray(t))

    def draw(path, leaf):  # seeded weights, none at its initial value
        name, shape = path[-1].key, leaf.shape
        if name.endswith("kernel"):
            w = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        else:
            w = (name == "weight") + 0.05 * rng.randn(*shape)
        return w.astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    sd = state_dict_from_flax(params, "dcae")
    for name in ("timestep_embedder.linear_1.weight",
                 "encoder.down_blocks.0.time_emb_porj.weight",
                 "decoder.up_blocks.0.attn.time_emb_porj.weight",
                 "decoder.up_blocks.0.attn.norm_in.linear.weight"):
        assert name in sd, name
    tmodel = TorchAE(t_config.DCAEConfig(**cfg))
    tmodel.load_state_dict(sd, strict=True)
    tmodel.eval()
    jx, js, jt = jnp.asarray(x), jnp.asarray(static), jnp.asarray(t)

    def run(p):  # one compile: encode, decode of that latent, forward
        z = jmodel.apply(p, jx, js, time_elapsed=jt, method=JaxAE.encode)
        return z, jmodel.apply(p, z, time_elapsed=jt, method=JaxAE.decode), \
            jmodel.apply(p, jx, js, time_elapsed=jt)

    z_j, y_j, f_j = map(np.asarray, jax.jit(run)(params))
    with torch.no_grad():
        tx, ts, tt = map(torch.from_numpy, (x, static, t))
        z_t = tmodel.encode(tx, ts, time_elapsed=tt).numpy()
        y_t = tmodel.decode(torch.from_numpy(z_j), time_elapsed=tt).numpy()
        f_t = tmodel(tx, ts, time_elapsed=tt).numpy()
        plain = tmodel(tx, ts).numpy()  # no time_elapsed: no modulation
    for got, want in ((z_t, z_j), (y_t, y_j), (f_t, f_j)):
        assert got.shape == want.shape
        assert _rel(got, want) <= 1e-5, _rel(got, want)
    assert _rel(plain, f_j) > 1e-2
    with pytest.raises(ValueError, match="temb_channels"):
        TorchAE(t_config.DCAEConfig(**TINY)).encode(tx, ts, time_elapsed=tt)
    # unset, the model has the unconditioned parameters
    assert not any("time_emb" in n or "timestep_embedder" in n or "norm_in" in n
                   for n in TorchAE(t_config.DCAEConfig(**TINY)).state_dict())
