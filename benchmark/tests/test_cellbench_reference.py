"""The plain reference against the program's plain path in float32 at tiny
sizes on the CPU. The test imports both; the reference imports nothing of
the program."""

import numpy as np
import pytest
import torch

from benchmark import harness, weights
from benchmark.reference import dcae as ref_dcae
from benchmark.reference import dit as ref_dit
from benchmark.reference import sampler as ref_sampler
from benchmark.tests import cellbench_tiny
from ladcast_torch import static_data
from ladcast_torch.config import DCAEConfig, EDMSchedulerConfig, LaDCastDiTConfig
from ladcast_torch.diffusion import edm
from ladcast_torch.diffusion.samplers import edm_heun_sample
from ladcast_torch.models import hub

REG = harness.Registry()


def rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.fixture(scope="module")
def cfg():
    c = REG.config("ladcast-375m")
    c["dit"].update(cellbench_tiny.TINY_DIT)
    c["dcae"].update(cellbench_tiny.TINY_DCAE)
    return c


@pytest.mark.parametrize("name", ["ladcast-375m", "ladcast-1.6b"])
def test_parameter_specs_are_the_programs_state_dicts(name):
    from ladcast_torch.models.dcae import AutoencoderDC
    from ladcast_torch.models.ladcast_dit import LaDCastTransformer3D

    c = REG.config(name)
    with torch.device("meta"):
        dit = LaDCastTransformer3D(LaDCastDiTConfig(**c["dit"]))
        ae = AutoencoderDC(DCAEConfig(**c["dcae"]))
    for model, spec in ((dit, ref_dit.param_spec(c["dit"])), (ae, ref_dcae.param_spec(c["dcae"]))):
        assert {n: tuple(t.shape) for n, t in model.state_dict().items()} == {
            n: tuple(s) for n, s, _, _ in spec}
    assert sum(p.numel() for p in dit.parameters()) == pytest.approx(c["dit_parameters"], rel=1e-3)


def test_dit_matches_the_programs_plain_path(cfg):
    p = weights.make(ref_dit.param_spec(cfg["dit"]), 3, 1, "cpu")
    prog = hub.build_model("dit", LaDCastDiTConfig(**cfg["dit"], attention_impl="plain"), p,
                           "cpu", torch.float32)
    g = torch.Generator().manual_seed(0)
    x, cond = torch.randn(2, 2, 15, 30, 84, generator=g), torch.randn(2, 1, 15, 30, 84, generator=g)
    cn, yp = torch.randn(2, generator=g), torch.rand(2, generator=g)
    with torch.no_grad():
        assert rel(prog(x, cn, cond, yp), ref_dit.DiT(cfg["dit"], p)(x, cn, cond, yp)) < 1e-5


def test_dcae_and_statics_match_the_programs(cfg):
    p = weights.make(ref_dcae.param_spec(cfg["dcae"]), 3, 2, "cpu")
    prog = hub.build_model("dcae", DCAEConfig(**cfg["dcae"]), p, "cpu", torch.float32)
    ref = ref_dcae.DCAE(cfg["dcae"], p)
    static = static_data.static_conditioning_tensor(layout="HWC")
    np.testing.assert_allclose(ref_sampler.static_fields(), static, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ref_sampler.field_stats()[1], static_data.era5_mean_std()[1])
    np.testing.assert_array_equal(ref_sampler.latent_stats()[0], static_data.latent_mean_std()[0])
    f = torch.randn(1, 120, 240, 84, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        z = prog.encode(f, torch.from_numpy(static))
        assert rel(z, ref.encode(f, torch.from_numpy(ref_sampler.static_fields()))) < 1e-5
        assert rel(prog.decode(z), ref.decode(z)) < 1e-5


def test_heun_matches_the_programs_sampler():
    sched = EDMSchedulerConfig()
    w = torch.randn(84, 84, generator=torch.Generator().manual_seed(2)) / 10

    def net(x, c_noise, cond, yp):  # a smooth stand-in for the DiT
        return torch.tanh(x @ w + cond.mean(1, keepdim=True) * c_noise.reshape(-1, 1, 1, 1, 1))

    noise = torch.randn(3, 2, 15, 30, 84, generator=torch.Generator().manual_seed(3))
    cond = torch.randn(3, 1, 15, 30, 84, generator=torch.Generator().manual_seed(4))

    def denoised(x, sigma):
        f = net(edm.precondition_inputs(sched, x, sigma),
                edm.precondition_noise(sigma).expand(3), cond, None)
        return edm.precondition_outputs(sched, x, f, sigma)

    prog = edm_heun_sample(sched, denoised, noise, 5)
    assert rel(prog, ref_sampler.heun(net, noise, cond, None, 5)) < 1e-6
