"""The port's DiT vs the JAX DiT in fp32 on the CPU, with the JAX weights
converted by the port's ``state_dict_from_flax`` and loaded strictly; and
the 375M parameter names and shapes."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladcast_torch import config as t_config
from ladcast_torch.models.ladcast_dit import LaDCastTransformer3D as TorchDiT
from ladcast_torch.models.weight_import import state_dict_from_flax
from ladcast_tpu import config as j_config
from ladcast_tpu.models.ladcast_dit import LaDCastTransformer3D as JaxDiT
from ladcast_tpu.models.weight_import import export_reference_state_dict

TINY = dict(in_channels=6, out_channels=6, num_attention_heads=2,
            attention_head_dim=128, num_layers=1, num_single_layers=1,
            num_refiner_layers=1, mlp_ratio=2.0,
            conditioning_tensor_in_channels=6)


def _inputs(B=2, T=2, Tin=1, H=3, W=6, C=6, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, T, H, W, C).astype(np.float32),
            rng.randn(B).astype(np.float32),
            rng.randn(B, Tin, H, W, C).astype(np.float32),
            rng.rand(B).astype(np.float32))


def _jax_model_and_params(cfg_kw, inputs, seed=0):
    model = JaxDiT(j_config.LaDCastDiTConfig(**cfg_kw, attention_impl="xla"))
    params = model.init(jax.random.PRNGKey(seed), *map(jnp.asarray, inputs))
    return model, jax.tree.map(np.asarray, params)


def _torch_model(cfg_kw, params):
    model = TorchDiT(t_config.LaDCastDiTConfig(**cfg_kw))
    model.load_state_dict(state_dict_from_flax(params, "dit"), strict=True)
    return model.eval()


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("extra", [{}, {"nope": True},
                                   {"scale_attn_by_lat": True}],
                         ids=["default", "nope", "scale_attn_by_lat"])
def test_tiny_forward_matches_jax(extra):
    cfg_kw = {**TINY, **extra}
    inputs = _inputs()
    jmodel, params = _jax_model_and_params(cfg_kw, inputs)
    want = np.asarray(jmodel.apply(params, *map(jnp.asarray, inputs)))
    tmodel = _torch_model(cfg_kw, params)
    with torch.no_grad():
        got = tmodel(*map(torch.from_numpy, inputs)).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-4, _rel(got, want)


def test_tiny_forward_no_year_progress_and_scalar_cnoise():
    inputs = _inputs(seed=1)
    jmodel, params = _jax_model_and_params(TINY, inputs)
    lat, cn, cond, _ = inputs
    want = np.asarray(jmodel.apply(params, jnp.asarray(lat),
                                   jnp.asarray(cn[:1]), jnp.asarray(cond)))
    tmodel = _torch_model(TINY, params)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(lat), torch.from_numpy(cn[:1]),
                     torch.from_numpy(cond)).numpy()
    assert _rel(got, want) <= 1e-4


def test_plain_impl_matches_auto_on_cpu():
    """attention_impl='plain' (the composite) and 'auto' (the kernels'
    plain versions here) give the same network."""
    inputs = _inputs(seed=2)
    _, params = _jax_model_and_params(TINY, inputs)
    auto = _torch_model(TINY, params)
    plain = _torch_model({**TINY, "attention_impl": "plain"}, params)
    x = list(map(torch.from_numpy, inputs))
    with torch.no_grad():
        a, p = auto(*x).numpy(), plain(*x).numpy()
    assert _rel(a, p) <= 1e-5


def test_attention_tables_follow_the_norm_weights():
    """Each attention keeps its (S, D) tables between calls without grad,
    and rebuilds them once load_state_dict changes a norm weight."""
    inputs = _inputs(seed=3)
    _, params = _jax_model_and_params(TINY, inputs)
    model = _torch_model(TINY, params)
    x = list(map(torch.from_numpy, inputs))
    attn = model.transformer_blocks[0].attn
    with torch.inference_mode():
        first = model(*x)
        kept = attn._tables["q"][1]
        model(*x)
        assert attn._tables["q"][1] is kept
    sd = model.state_dict()
    sd["transformer_blocks.0.attn.norm_added_q.weight"] = torch.linspace(0.5, 2, 128)
    model.load_state_dict(sd)
    fresh = _torch_model(TINY, params)
    fresh.load_state_dict(sd)
    with torch.inference_mode():
        got, want = model(*x), fresh(*x)
    assert attn._tables["q"][1] is not kept
    assert not torch.equal(got, first)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_state_dict_from_flax_equals_export():
    inputs = _inputs()
    _, params = _jax_model_and_params(TINY, inputs)
    ours = state_dict_from_flax(params, "dit")
    ref = export_reference_state_dict(params, "dit")
    assert list(ours) == list(ref)
    for name, w in ref.items():
        np.testing.assert_array_equal(ours[name].numpy(), w)


def test_375m_names_and_shapes_load_strict():
    cfg = j_config.ladcast_375m_config()
    lat = jax.ShapeDtypeStruct((1, 4, 15, 30, 84), jnp.float32)
    cond = jax.ShapeDtypeStruct((1, 1, 15, 30, 84), jnp.float32)
    vec = jax.ShapeDtypeStruct((1,), jnp.float32)
    shapes = jax.eval_shape(JaxDiT(cfg).init, jax.random.PRNGKey(0), lat,
                            vec, cond, vec)
    params = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    ours = state_dict_from_flax(params, "dit")
    ref = export_reference_state_dict(params, "dit")
    assert list(ours) == list(ref)
    assert all(tuple(ours[k].shape) == ref[k].shape for k in ref)
    del ref
    with torch.device("meta"):
        model = TorchDiT(t_config.ladcast_375m_config())
    model.load_state_dict(ours, strict=True, assign=True)
    n = sum(p.numel() for p in model.parameters())
    assert 3.0e8 < n < 4.5e8, n


def test_config_copy_matches_jax_defaults():
    for t_cls, j_cls in [(t_config.DCAEConfig, j_config.DCAEConfig),
                         (t_config.EDMSchedulerConfig, j_config.EDMSchedulerConfig),
                         (t_config.RolloutConfig, j_config.RolloutConfig),
                         (t_config.LaDCastDiTConfig, j_config.LaDCastDiTConfig)]:
        j_fields = {f.name: getattr(j_cls(), f.name)
                    for f in dataclasses.fields(j_cls)}
        for f in dataclasses.fields(t_cls):
            if f.name != "attention_impl":
                assert getattr(t_cls(), f.name) == j_fields[f.name], f.name
    # the int8 path is ported: the config takes it, as the JAX one does
    assert t_config.ladcast_375m_config(int8_matmuls=True).int8_matmuls
