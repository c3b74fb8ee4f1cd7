"""The port's EDM schedule, Heun sampler and rollout engine vs the JAX
package in fp32 on the CPU, with the noise injected into both; and the
port's own member-noise contract."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladcast_torch import config as t_config
from ladcast_torch.diffusion import edm as t_edm
from ladcast_torch.diffusion.samplers import edm_heun_sample as t_heun
from ladcast_torch.models.ladcast_dit import LaDCastTransformer3D as TorchDiT
from ladcast_torch.models.weight_import import state_dict_from_flax
from ladcast_torch.rollout import engine as t_engine
from ladcast_tpu import config as j_config
from ladcast_tpu.diffusion import edm as j_edm
from ladcast_tpu.diffusion.samplers import edm_heun_sample as j_heun
from ladcast_tpu.models.ladcast_dit import LaDCastTransformer3D as JaxDiT
from ladcast_tpu.rollout.engine import ensemble_rollout

T_SCHED = t_config.EDMSchedulerConfig()
J_SCHED = j_config.EDMSchedulerConfig()


@pytest.mark.parametrize("n", [1, 3, 20])
def test_sigmas_and_preconditioning(n):
    want = np.asarray(j_edm.inference_sigmas(J_SCHED, n))
    got = t_edm.inference_sigmas(T_SCHED, n).numpy()
    assert got[-1] == 0.0 and len(got) == n + 1
    # fp32 linspace ramps may differ by an ulp, which the power rho = 7
    # amplifies to ~1e-6 relative
    np.testing.assert_allclose(got, want, rtol=5e-6)
    sig = np.array(want[:-1])
    x = np.random.RandomState(n).randn(n, 5).astype(np.float32)
    f = np.random.RandomState(n + 1).randn(n, 5).astype(np.float32)
    ts, tx, tf = torch.from_numpy(sig)[:, None], torch.from_numpy(x), torch.from_numpy(f)
    js, jx, jf = jnp.asarray(sig)[:, None], jnp.asarray(x), jnp.asarray(f)
    np.testing.assert_allclose(t_edm.precondition_inputs(T_SCHED, tx, ts).numpy(),
                               np.asarray(j_edm.precondition_inputs(J_SCHED, jx, js)),
                               rtol=1e-6)
    np.testing.assert_allclose(t_edm.precondition_noise(ts).numpy(),
                               np.asarray(j_edm.precondition_noise(js)),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        t_edm.precondition_outputs(T_SCHED, tx, tf, ts).numpy(),
        np.asarray(j_edm.precondition_outputs(J_SCHED, jx, jf, js)),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", [1, 5, 7, 20])
def test_heun_trajectory_toy_denoiser(n):
    """D(x; s) of Gaussian data with a nonlinear wobble: the port's Heun
    loop against the JAX scan, step for step. (Schedules of 2-3 steps jump
    from sigma 80 to ~1e-3 in one step; the correction divides by that
    sigma, which amplifies fp32 rounding beyond any fixed tolerance.)"""
    noise = np.random.RandomState(n).randn(3, 4).astype(np.float32)
    sd2 = J_SCHED.sigma_data ** 2

    def toy(x, s, tanh):
        return x * (sd2 / (s**2 + sd2)) + 0.1 * tanh(x) / (1 + s)

    want = np.asarray(j_heun(J_SCHED, lambda x, s: toy(x, s, jnp.tanh),
                             jnp.asarray(noise), n))
    got = t_heun(T_SCHED, lambda x, s: toy(x, s, torch.tanh),
                 torch.from_numpy(noise), n).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_sampler_options_not_ported_raise():
    """Churn, correction skipping and the DPM sampler are ported
    (tests/test_torch_samplers.py); what still raises is a churned run
    without its noise, noise of the wrong shape, and an unknown sampler."""
    with pytest.raises(ValueError, match="churn_generator"):
        t_heun(T_SCHED, lambda x, s: x, torch.zeros(2), 3, s_churn=1.0)
    with pytest.raises(ValueError, match="churn_noise"):
        t_heun(T_SCHED, lambda x, s: x, torch.zeros(2), 3, s_churn=1.0,
               churn_noise=torch.zeros(2, 2))
    t_heun(T_SCHED, lambda x, s: x * 0, torch.zeros(2), 3,
           correction_skip_period=2)
    t_engine.make_repetition_fn(T_SCHED, t_config.RolloutConfig(sampler_type="dpm"))
    with pytest.raises(ValueError, match="expected 'edm' or 'dpm'"):
        t_engine.make_repetition_fn(T_SCHED, t_config.RolloutConfig(sampler_type="ddim"))


TINY = dict(in_channels=6, out_channels=6, num_attention_heads=2,
            attention_head_dim=128, num_layers=1, num_single_layers=1,
            num_refiner_layers=1, mlp_ratio=2.0,
            conditioning_tensor_in_channels=6)
H, W, C, E = 3, 6, 6, 3


@pytest.mark.parametrize("noise_level", [0.0, 0.3])
def test_tiny_rollout_matches_jax_with_injected_noise(noise_level):
    rcfg_kw = dict(ensemble_size=E, num_inference_steps=3, return_seq_len=2,
                   input_seq_len=1, total_lead_time_hour=24, step_size_hour=6,
                   noise_level=noise_level)
    j_rcfg = j_config.RolloutConfig(**rcfg_kw)
    t_rcfg = t_config.RolloutConfig(**rcfg_kw)
    assert t_rcfg.num_repetitions == 2

    jmodel = JaxDiT(j_config.LaDCastDiTConfig(**TINY, attention_impl="xla"))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, H, W, C)),
                         jnp.zeros((1,)), jnp.zeros((1, 1, H, W, C)),
                         jnp.zeros((1,)))
    tmodel = TorchDiT(t_config.LaDCastDiTConfig(**TINY)).eval()
    tmodel.load_state_dict(state_dict_from_flax(
        jax.tree.map(np.asarray, params), "dit"), strict=True)

    rng = np.random.RandomState(0)
    known = np.broadcast_to(rng.randn(1, 1, H, W, C).astype(np.float32),
                            (E, 1, H, W, C)).copy()
    rep_noise = rng.randn(2, E, 2, H, W, C).astype(np.float32)
    pert = rng.randn(1, H, W, C).astype(np.float32)
    std = (rng.rand(C).astype(np.float32) + 0.5)
    yp = np.array([0.2, 0.25], np.float32)

    want = np.asarray(ensemble_rollout(
        lambda *a: jmodel.apply(params, *a), jnp.asarray(known),
        jnp.asarray(yp), jax.random.PRNGKey(1), J_SCHED, j_rcfg,
        latent_std=jnp.asarray(std), rep_noise=jnp.asarray(rep_noise),
        pert_noise=jnp.asarray(pert)))

    rep_fn = t_engine.make_repetition_fn(T_SCHED, t_rcfg)
    with torch.no_grad():
        got = t_engine.ensemble_rollout_hostloop(
            rep_fn, tmodel, torch.from_numpy(known), list(yp), 1, t_rcfg,
            latent_std=torch.from_numpy(std),
            rep_noise=torch.from_numpy(rep_noise),
            pert_noise=torch.from_numpy(pert)).numpy()
    assert got.shape == want.shape == (E, 4, H, W, C)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 1e-4, rel


def test_member_noise_independent_of_ensemble_size():
    small = t_engine.member_noise(11, 3, (2, 4), "cpu")
    large = t_engine.member_noise(11, 6, (2, 4), "cpu")
    torch.testing.assert_close(small, large[:3], rtol=0, atol=0)
    assert not torch.equal(large[0], large[1])
    other = t_engine.member_noise(12, 3, (2, 4), "cpu")
    assert not torch.equal(small, other)


def test_seeded_rollout_is_deterministic():
    rcfg = t_config.RolloutConfig(ensemble_size=2, num_inference_steps=2,
                                  return_seq_len=1, total_lead_time_hour=12)
    rep_fn = t_engine.make_repetition_fn(T_SCHED, rcfg)

    def net_fn(x, cn, known, yp):
        return torch.tanh(x) + known.mean() + yp[:, None, None, None, None]

    known = torch.randn(2, 1, 2, 3, 4, generator=torch.Generator().manual_seed(0))
    a = t_engine.ensemble_rollout_hostloop(rep_fn, net_fn, known, [0.1, 0.2],
                                           5, rcfg)
    b = t_engine.ensemble_rollout_hostloop(rep_fn, net_fn, known, [0.1, 0.2],
                                           5, rcfg)
    assert a.shape == (2, 2, 2, 3, 4)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a[0], a[1])
