"""The port's samplers (Heun with churn and correction skipping, DPM 2M)
and its single-call ensemble rollout against the JAX package, in fp32 on
the CPU, with every random draw made by numpy and injected into both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladcast_torch import config as t_config
from ladcast_torch.diffusion import samplers as t_samplers
from ladcast_torch.models.ladcast_dit import LaDCastTransformer3D as TorchDiT
from ladcast_torch.models.weight_import import state_dict_from_flax
from ladcast_torch.rollout import engine as t_engine
from ladcast_tpu import config as j_config
from ladcast_tpu.diffusion import samplers as j_samplers
from ladcast_tpu.models.ladcast_dit import LaDCastTransformer3D as JaxDiT
from ladcast_tpu.rollout import engine as j_engine

T_SCHED = t_config.EDMSchedulerConfig()
J_SCHED = j_config.EDMSchedulerConfig()
SD2 = J_SCHED.sigma_data ** 2


def _toy(x, s, tanh):
    """D(x; s) of Gaussian data with a nonlinear wobble."""
    return x * (SD2 / (s**2 + SD2)) + 0.1 * tanh(x) / (1 + s)


def _j_toy(x, s):
    return _toy(x, s, jnp.tanh)


def _t_toy(x, s):
    return _toy(x, s, torch.tanh)


@pytest.mark.parametrize("n,s_churn,s_min,s_max", [
    (5, 10.0, 0.0, float("inf")),  # gamma capped at sqrt(2) - 1
    (8, 2.0, 0.0, 100.0),          # gamma = s_churn / N
    (1, 1.0, 0.0, float("inf")),   # the final Euler step alone, churned
])
def test_heun_with_churn_matches_jax(n, s_churn, s_min, s_max):
    """The same injected churn noise through both samplers; the 5- and
    8-step schedules keep fp32 rounding below 1e-4 (see
    test_heun_trajectory_toy_denoiser)."""
    rng = np.random.RandomState(n)
    noise = rng.randn(3, 4).astype(np.float32)
    churn = rng.randn(n, 3, 4).astype(np.float32)
    kw = dict(s_churn=s_churn, s_min=s_min, s_max=s_max, s_noise=1.003)
    want = np.asarray(j_samplers.edm_heun_sample(
        J_SCHED, _j_toy, jnp.asarray(noise), n,
        churn_noise=jnp.asarray(churn), **kw))
    got = t_samplers.edm_heun_sample(
        T_SCHED, _t_toy, torch.from_numpy(noise), n,
        churn_noise=torch.from_numpy(churn), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    plain = t_samplers.edm_heun_sample(T_SCHED, _t_toy, torch.from_numpy(noise), n)
    assert not np.allclose(got, plain.numpy(), atol=1e-3)  # the churn acted


def test_heun_churn_window():
    """Sigmas outside [s_min, s_max] are not churned: a window that holds
    no sigma gives the deterministic trajectory, one that holds some does
    not. (Held to the port alone: where gamma is 0 the JAX sampler takes
    sqrt(t_hat^2 - t_cur^2) of two equal numbers, which XLA's fused
    multiply-add makes a NaN on the CPU.)"""
    noise = torch.randn(3, 4, generator=torch.Generator().manual_seed(3))
    churn = torch.randn(8, 3, 4, generator=torch.Generator().manual_seed(4))
    plain = t_samplers.edm_heun_sample(T_SCHED, _t_toy, noise, 8)

    def run(s_min, s_max):
        return t_samplers.edm_heun_sample(
            T_SCHED, _t_toy, noise, 8, s_churn=2.0, s_min=s_min, s_max=s_max,
            s_noise=1.0, churn_noise=churn)

    torch.testing.assert_close(run(100.0, 200.0), plain, rtol=0, atol=0)
    inside = run(0.05, 50.0)
    assert torch.isfinite(inside).all() and not torch.equal(inside, plain)


def test_heun_churn_from_a_generator_is_seeded():
    noise = torch.randn(2, 3, generator=torch.Generator().manual_seed(0))

    def run(seed):
        return t_samplers.edm_heun_sample(
            T_SCHED, _t_toy, noise, 6, s_churn=5.0, s_noise=1.0,
            churn_generator=torch.Generator().manual_seed(seed))

    torch.testing.assert_close(run(1), run(1), rtol=0, atol=0)
    assert not torch.equal(run(1), run(2))


@pytest.mark.parametrize("period,warmup,n", [(2, 2, 10), (3, 2, 12), (2, 0, 7),
                                             (1, 2, 6)])
def test_heun_correction_skipping_matches_jax(period, warmup, n):
    """Which correction calls are dropped (counted) and what replaces them."""
    noise = np.random.RandomState(period).randn(3, 4).astype(np.float32)
    calls = []

    def counted(x, s):
        calls.append(float(s))
        return _t_toy(x, s)

    kw = dict(correction_skip_period=period, correction_skip_warmup=warmup)
    want = np.asarray(j_samplers.edm_heun_sample(
        J_SCHED, _j_toy, jnp.asarray(noise), n, **kw))
    got = t_samplers.edm_heun_sample(T_SCHED, counted, torch.from_numpy(noise),
                                     n, **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    skipped = [i for i in range(n - 1) if period > 1 and warmup <= i < n - 2
               and (i - warmup) % period]
    assert len(calls) == 2 * n - 1 - len(skipped)
    if period > 1:
        assert skipped
        exact = t_samplers.edm_heun_sample(T_SCHED, _t_toy,
                                           torch.from_numpy(noise), n).numpy()
        assert not np.array_equal(got, exact)


@pytest.mark.parametrize("n", [1, 2, 5, 20])
@pytest.mark.parametrize("init_scale", [None, 1.0])
def test_dpm_multistep_matches_jax(n, init_scale):
    noise = np.random.RandomState(n).randn(3, 4).astype(np.float32)
    calls = []

    def counted(x, s):
        calls.append(float(s))
        return _t_toy(x, s)

    want = np.asarray(j_samplers.dpm_multistep_sample(
        J_SCHED, _j_toy, jnp.asarray(noise), n, init_scale=init_scale))
    got = t_samplers.dpm_multistep_sample(
        T_SCHED, counted, torch.from_numpy(noise), n, init_scale=init_scale).numpy()
    assert len(calls) == n and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_make_denoised_fn_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(4, 5).astype(np.float32)
    sigma = np.float32(1.7)
    want = j_samplers.make_denoised_fn(J_SCHED, lambda xi, cn: jnp.tanh(xi) * cn)(
        jnp.asarray(x), jnp.asarray(sigma))
    got = t_samplers.make_denoised_fn(T_SCHED, lambda xi, cn: torch.tanh(xi) * cn)(
        torch.from_numpy(x), torch.tensor(sigma))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------- the tiny DiT -----

TINY = dict(in_channels=6, out_channels=6, num_attention_heads=2,
            attention_head_dim=128, num_layers=1, num_single_layers=1,
            num_refiner_layers=1, mlp_ratio=2.0,
            conditioning_tensor_in_channels=6)
H, W, C, E = 3, 6, 6, 3


@pytest.fixture(scope="module")
def tiny_models():
    jmodel = JaxDiT(j_config.LaDCastDiTConfig(**TINY, attention_impl="xla"))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, H, W, C)),
                         jnp.zeros((1,)), jnp.zeros((1, 1, H, W, C)),
                         jnp.zeros((1,)))
    tmodel = TorchDiT(t_config.LaDCastDiTConfig(**TINY)).eval()
    tmodel.load_state_dict(state_dict_from_flax(
        jax.tree.map(np.asarray, params), "dit"), strict=True)
    return jmodel, params, tmodel


@pytest.mark.parametrize("which", ["heun_churn", "heun_skip3", "dpm_unit_scale"])
def test_samplers_on_the_tiny_dit_match_jax(tiny_models, which):
    """The samplers around the tiny DiT as the denoiser (5 steps, batch 2),
    through ``make_denoised_fn`` on both sides: churned Heun with injected
    noise, Heun with every third correction kept, and the DPM sampler from
    unscaled noise (``init_scale=1.0``, the reference's start)."""
    jmodel, params, tmodel = tiny_models
    rng = np.random.RandomState(11)
    noise = rng.randn(2, 2, H, W, C).astype(np.float32)
    cond = 0.5 * rng.randn(2, 1, H, W, C).astype(np.float32)
    churn = rng.randn(5, 2, 2, H, W, C).astype(np.float32)
    yp = np.array([0.3, 0.3], np.float32)
    j_den = j_samplers.make_denoised_fn(J_SCHED, lambda x, cn: jmodel.apply(
        params, x, jnp.broadcast_to(cn, (2,)), jnp.asarray(cond), jnp.asarray(yp)))
    t_den = t_samplers.make_denoised_fn(T_SCHED, lambda x, cn: tmodel(
        x, cn.expand(2), torch.from_numpy(cond), torch.from_numpy(yp)))
    if which == "dpm_unit_scale":
        want = j_samplers.dpm_multistep_sample(J_SCHED, j_den, jnp.asarray(noise), 5,
                                               init_scale=1.0)
        with torch.no_grad():
            got = t_samplers.dpm_multistep_sample(T_SCHED, t_den,
                                                  torch.from_numpy(noise), 5,
                                                  init_scale=1.0)
    else:
        kw = (dict(s_churn=3.0, s_noise=1.0) if which == "heun_churn"
              else dict(correction_skip_period=3, correction_skip_warmup=0))
        j_kw = dict(kw, churn_noise=jnp.asarray(churn)) if which == "heun_churn" else kw
        t_kw = dict(kw, churn_noise=torch.from_numpy(churn)) if which == "heun_churn" else kw
        want = j_samplers.edm_heun_sample(J_SCHED, j_den, jnp.asarray(noise), 5, **j_kw)
        with torch.no_grad():
            got = t_samplers.edm_heun_sample(T_SCHED, t_den, torch.from_numpy(noise),
                                             5, **t_kw)
    want = np.asarray(want)
    assert np.isfinite(want).all()
    rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert rel <= 1e-4, rel


@pytest.mark.parametrize("sampler,noise_level,skip", [
    ("edm", 0.0, 0), ("edm", 0.3, 2), ("dpm", 0.3, 0)])
def test_ensemble_rollout_matches_jax_and_hostloop(tiny_models, sampler,
                                                   noise_level, skip):
    """The single-call rollout against the JAX scanned engine (5 sampler
    steps, two repetitions, frame feedback), both samplers, with the
    initial-latent perturbation; and bit-equal to the host loop."""
    jmodel, params, tmodel = tiny_models
    kw = dict(ensemble_size=E, num_inference_steps=5, return_seq_len=2,
              input_seq_len=1, total_lead_time_hour=18, step_size_hour=6,
              noise_level=noise_level, sampler_type=sampler,
              correction_skip_period=skip)
    j_rcfg, t_rcfg = j_config.RolloutConfig(**kw), t_config.RolloutConfig(**kw)
    assert t_rcfg.num_repetitions == 2 and t_rcfg.total_num_steps == 3
    rng = np.random.RandomState(1)
    known = np.broadcast_to(0.5 * rng.randn(1, 1, H, W, C).astype(np.float32),
                            (E, 1, H, W, C)).copy()
    rep_noise = rng.randn(2, E, 2, H, W, C).astype(np.float32)
    pert = rng.randn(1, H, W, C).astype(np.float32)
    std = rng.rand(C).astype(np.float32) + 0.5
    yp = np.array([0.2, 0.25], np.float32)

    want = np.asarray(j_engine.make_rollout_fn(
        lambda *a: jmodel.apply(params, *a), J_SCHED, j_rcfg)(
            jnp.asarray(known), jnp.asarray(yp), jax.random.PRNGKey(1),
            latent_std=jnp.asarray(std), rep_noise=jnp.asarray(rep_noise),
            pert_noise=jnp.asarray(pert)))
    noise = dict(latent_std=torch.from_numpy(std),
                 rep_noise=torch.from_numpy(rep_noise),
                 pert_noise=torch.from_numpy(pert))
    with torch.no_grad():
        got = t_engine.make_rollout_fn(tmodel, T_SCHED, t_rcfg)(
            torch.from_numpy(known), list(yp), 1, **noise)
        host = t_engine.ensemble_rollout_hostloop(
            t_engine.make_repetition_fn(T_SCHED, t_rcfg), tmodel,
            torch.from_numpy(known), list(yp), 1, t_rcfg, **noise)
    assert got.shape == want.shape == (E, 3, H, W, C)
    torch.testing.assert_close(got, host, rtol=0, atol=0)
    rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert rel <= 1e-4, rel


def test_ensemble_rollout_seeded_draws_equal_the_hostloop(tiny_models):
    """Without injected noise the single call draws what the host loop
    draws from the same seed, members differ, and the noise shape is held."""
    _, _, tmodel = tiny_models
    rcfg = t_config.RolloutConfig(
        ensemble_size=2, num_inference_steps=2, return_seq_len=2,
        total_lead_time_hour=24, noise_level=0.1, sampler_type="dpm")
    known = torch.randn(2, 1, H, W, C, generator=torch.Generator().manual_seed(0))
    std = torch.ones(C)
    with torch.no_grad():
        a = t_engine.ensemble_rollout(tmodel, known, [0.1, 0.2], 5, T_SCHED, rcfg,
                                      latent_std=std)
        b = t_engine.ensemble_rollout_hostloop(
            t_engine.make_repetition_fn(T_SCHED, rcfg), tmodel, known,
            [0.1, 0.2], 5, rcfg, latent_std=std)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert a.shape == (2, 4, H, W, C) and not torch.equal(a[0], a[1])
    with pytest.raises(ValueError, match="rep_noise"):
        t_engine.ensemble_rollout(tmodel, known, [0.1, 0.2], 5, T_SCHED, rcfg,
                                  latent_std=std, rep_noise=torch.zeros(1, 2, 2, H, W, C))
