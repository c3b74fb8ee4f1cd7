"""The port's bench (``ladcast_torch/bench.py``, the port of the root
``bench.py``) on the CPU: its member-sharded forecast over two gloo ranks
against one process (the port of ``tests/test_bench_mesh.py``), its FLOP
count (each kernel's formula against ``FlopCounterMode``'s count of the
kernel's plain version; the forecast's components against the JAX bench's
XLA cost analysis), the JSON line that ``run`` builds, and ``main``'s
refusals.

The two ranks run in one spawn for the file, started by a module fixture
without waiting (``test_torch_parallel``'s ``_entry``, a ``file://`` store),
so the JAX bench's build and cost analysis, the slowest part of the file,
run while the ranks work. The job is a module-level function of this
module, which imports no JAX at module level (the ranks import it).

Tolerances: the two ranks' trajectory equals one process's to the JAX
test's 2e-4, relative to each element and, as the absolute term, to the
trajectory's largest magnitude: the same member draws and fp32 products,
the batch split the only difference. The CPU's fp32 GEMMs block by the
row count, so a member's DiT output differs in its last bits between a
batch of 4 and of 2 (7e-7 on outputs of 3.3), and two repetitions of Heun
steps over random weights carry that to 1e-2 on a trajectory whose
largest element is 3.1e3 (3e-6 of it; a fixed atol of 2e-4 failed 10 of
6,144 elements). A member given another member's noise moves by the
trajectory's own scale. The FLOP formulas equal the plain versions' counts
exactly. The port's components lie within FLOPS_BAND of XLA's counts:
``FlopCounterMode`` counts products only, XLA also the elementwise work and
the reductions.
"""

import os
import time
import uuid

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from ladcast_torch import bench
from ladcast_torch.config import DCAEConfig, EDMSchedulerConfig, LaDCastDiTConfig, RolloutConfig
from ladcast_torch.ops import dense_conv as t_dc
from ladcast_torch.ops import depthwise_conv as t_dw
from ladcast_torch.ops import flash_attention as t_fa
from ladcast_torch.ops import gelu_gemm as t_gelu
from ladcast_torch.ops import quant as t_quant
from test_torch_parallel import SPAWN_TIMEOUT_S, _entry

DIT_KW = dict(in_channels=8, out_channels=8, num_attention_heads=2,
              attention_head_dim=16, num_layers=1, num_single_layers=1,
              num_refiner_layers=1, mlp_ratio=2.0, rope_axes_dim=(4, 6, 6),
              conditioning_tensor_rope_axes_dim=(4, 6, 6),
              conditioning_tensor_in_channels=8)
DCAE_KW = dict(in_channels=13, out_channels=13, latent_channels=8, attention_head_dim=4,
               encoder_block_types=("ResBlock", "EfficientViTBlock"),
               decoder_block_types=("ResBlock", "EfficientViTBlock"),
               encoder_block_out_channels=(8, 16), decoder_block_out_channels=(8, 16),
               encoder_layers_per_block=(1, 1), decoder_layers_per_block=(1, 1),
               encoder_qkv_multiscales=((), (5,)), decoder_qkv_multiscales=((), (5,)),
               static_channels=5)
SHAPES = dict(latent_hw=(4, 6), grid_hw=(8, 12))
SAMPLERS = ("edm", "dpm")
MEMBERS = 4  # two a rank
SEED = 7
# The port's (f_net, f_dec, f_enc) over the JAX bench's XLA counts at this
# file's configuration read 0.904, 0.980 and 0.966 (the DiT's layer norms,
# softmax and modulations are elementwise work XLA counts and
# FlopCounterMode does not).
FLOPS_BAND = (0.85, 1.05)


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """The test suite runs files in parallel workers on a shared CPU; two
    intra-op threads per worker keep them from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rcfg(sampler, members=MEMBERS, nfe=2, hours=48, **kw):
    return RolloutConfig(ensemble_size=members, num_inference_steps=nfe,
                         total_lead_time_hour=hours, sampler_type=sampler, **kw)


def _bench(sampler, **kw):
    return bench.make_bench(LaDCastDiTConfig(**DIT_KW), DCAEConfig(**DCAE_KW),
                            EDMSchedulerConfig(), _rcfg(sampler, **kw), device="cpu",
                            compute_dtype=torch.float32, **SHAPES)


def bench_job():
    """Each rank: both samplers' trajectories, gathered to every rank, and
    scalars, and the members the rank rolled out."""
    out = {}
    for sampler in SAMPLERS:
        b = _bench(sampler)
        out[sampler] = {"traj": b["full_forecast_traj"](SEED),
                        "scalars": b["full_forecast"](SEED),
                        "members": (b["member_offset"], b["members"])}
    return out


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The two ranks of :func:`bench_job`, started and not waited for:
    ``ranks()`` waits (within SPAWN_TIMEOUT_S) and gives each rank's result."""
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("bench_ranks")
    tag = uuid.uuid4().hex[:8]
    out = tmp / f"ranks_{tag}"
    out.mkdir()
    ctx = mp.start_processes(
        _entry, args=(2, str(tmp / f"store_{tag}"), bench_job.__module__,
                      bench_job.__name__, (), str(out)),
        nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S

    def ranks():
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise AssertionError(f"the bench over two ranks outlived "
                                     f"{SPAWN_TIMEOUT_S} s")
        return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)]

    try:
        yield ranks
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


# -- the FLOP count -----------------------------------------------------------

def test_flop_components_within_band_of_jax(two_ranks):
    """(f_net, f_dec, f_enc) of the port's make_bench against the JAX
    make_bench's flops_components at one tiny configuration (fp32, the XLA
    attention). It asks for ``two_ranks`` so that the ranks work while the
    JAX bench builds and costs its programs."""
    import dataclasses

    import jax.numpy as jnp

    from bench import make_bench as jax_make_bench
    from ladcast_tpu import config as j_config

    rcfg = _rcfg("edm", members=2, hours=24)
    want = jax_make_bench(
        j_config.LaDCastDiTConfig(**DIT_KW, attention_impl="xla"),
        j_config.DCAEConfig(**DCAE_KW), j_config.EDMSchedulerConfig(),
        j_config.RolloutConfig(**dataclasses.asdict(rcfg)),
        compute_dtype=jnp.float32, **SHAPES)["flops_components"]()
    got = _bench("edm", members=2, hours=24)["flops_components"]()
    ratios = [g / w for g, w in zip(got, want)]
    assert all(FLOPS_BAND[0] <= r <= FLOPS_BAND[1] for r in ratios), (ratios, got, want)


@pytest.mark.parametrize("sampler", SAMPLERS)
def test_flops_per_forecast_is_calls_times_components(sampler):
    b = _bench(sampler, members=2)
    f_net, f_dec, f_enc = b["flops_components"]()
    assert min(f_net, f_dec, f_enc) > 0
    ncalls = 3 if sampler == "edm" else 2  # Heun 2N-1, DPM N, at N = 2
    assert b["flops_per_forecast"]() == 2 * (ncalls * f_net + f_dec) + f_enc


def test_flops_refuse_skipped_corrections():
    b = _bench("edm", members=2, correction_skip_period=2)
    with pytest.raises(ValueError, match="exact Heun only"):
        b["flops_per_forecast"]()


def _attention_inputs(B, Sq, Sk, H, D):
    g = torch.Generator().manual_seed(B * Sq + Sk)
    q = torch.randn(B, Sq, H, D, generator=g)
    k, v = (torch.randn(B, Sk, H, D, generator=g) for _ in range(2))
    cos, sin = (torch.randn(Sq, D, generator=g) for _ in range(2))
    w = torch.rand(Sq, D, generator=g) + 0.5
    lse, delta = (torch.randn(B, H, Sq, generator=g) for _ in range(2))
    return q, k, v, cos, sin, w, lse, delta


def _kernel_cases(shape):
    """(name, the plain version's call, the kernel's formula) of every kernel
    entry at one of two shape sets."""
    B, Sq, Sk, H, D, hw, cin, cout, kk = shape
    q, k, v, cos, sin, w, lse, delta = _attention_inputs(B, Sq, Sk, H, D)
    x = torch.randn(B, *hw, cin)
    wt = torch.randn(kk, kk, cin, cout)
    dk = torch.randn(kk, kk, cin)
    pads = ((kk // 2, kk // 2), (kk // 2, kk // 2))
    a = torch.randint(-9, 9, (B * Sq, cin), dtype=torch.int8)
    b = torch.randint(-9, 9, (cin, cout), dtype=torch.int8)
    return [
        ("norm_rope", lambda: t_fa.norm_rope_plain(k, w[:1].expand(Sk, D), cos[:1].expand(Sk, D),
                                                   sin[:1].expand(Sk, D)), 0),
        ("fused_attention", lambda: t_fa.fused_attention_plain(q, k, v, cos, sin, w),
         t_fa.attention_flops(q, k, 2)),
        ("fused_attention_lse",
         lambda: t_fa.fused_attention_plain(q, k, v, cos, sin, w, return_lse=True),
         t_fa.attention_flops(q, k, 2)),
        ("flash_bwd_dq", lambda: t_fa.flash_bwd_dq_plain(q, k, v, q, lse, delta, 0.3),
         t_fa.attention_flops(q, k, 3)),
        ("flash_bwd_dkv", lambda: t_fa.flash_bwd_dkv_plain(q, k, v, q, lse, delta, 0.3),
         t_fa.attention_flops(q, k, 4)),
        ("flash_attention", lambda: t_fa.flash_attention_plain(q, k, v),
         t_fa.attention_flops(q, k, 2)),
        ("dense_conv", lambda: t_dc.dense_conv_plain(x, wt, pads, True),
         t_dc.conv_flops(t_dc.dense_conv_plain(x, wt, pads, True), cin, kk, kk)),
        ("depthwise_conv", lambda: t_dw.depthwise_same_conv_plain(x, dk, pads),
         t_dc.conv_flops(x, 1, kk, kk)),
        ("int8_mm", lambda: t_quant.int8_mm(a, b), 2 * a.shape[0] * cin * cout),
        ("dense_gelu_tanh", lambda: t_gelu.dense_gelu_tanh_plain(x, wt[0, 0].t(), wt[0, 0, 0]),
         t_gelu.gelu_gemm_flops(x[..., 0].numel(), cin, cout)),
    ]


KERNEL_SHAPES = {"small": (1, 5, 7, 2, 16, (4, 6), 3, 5, 3),
                 "ragged": (2, 33, 17, 3, 128, (5, 9), 12, 7, 5)}
KERNELS = [c[0] for c in _kernel_cases(KERNEL_SHAPES["small"])]


@pytest.mark.parametrize("shape", KERNEL_SHAPES)
@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_formula_is_the_plain_versions_count(kernel, shape):
    """Each kernel's FLOP formula, the count its wrapper reports when the
    kernel launches, equals what FlopCounterMode counts of its plain
    version: a call counts the same on the card and on the CPU."""
    _, call, formula = next(c for c in _kernel_cases(KERNEL_SHAPES[shape]) if c[0] == kernel)
    with FlopCounterMode(display=False) as counter:
        call()
    assert counter.get_total_flops() == formula
    if kernel == "int8_mm":  # what the wrapper reports beside aten's count
        a, b = torch.zeros(40, 16, dtype=torch.int8), torch.zeros(16, 8, dtype=torch.int8)
        assert t_quant.int8_mm_flops(a, b) == 2 * 40 * 16 * 8
    if kernel == "dense_gelu_tanh":  # likewise
        assert t_gelu.gelu_gemm_flops(40, 16, 8) == 2 * 40 * 16 * 8


# -- the trajectory over two ranks ----------------------------------------------

@pytest.mark.parametrize("sampler", SAMPLERS)
def test_two_ranks_reproduce_one_process(two_ranks, sampler):
    """Rank r rolls out members 2r and 2r+1; the gathered trajectory and
    the ensemble's scalars equal one process's, on both ranks."""
    one = _bench(sampler)
    want = one["full_forecast_traj"](SEED)
    acc, mean = one["full_forecast"](SEED)
    assert want.shape == (MEMBERS, 8, 4, 6, 8)
    for rank, res in enumerate(two_ranks()):
        got = res[sampler]
        assert got["members"] == (2 * rank, 2)
        np.testing.assert_allclose(got["traj"], want, rtol=2e-4,
                                   atol=2e-4 * np.abs(want).max())
        np.testing.assert_allclose(got["scalars"], (acc, mean), rtol=2e-4, atol=2e-4)


def test_members_must_divide_over_ranks(monkeypatch):
    monkeypatch.setattr(bench.dist, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="3 members do not divide over 2 ranks"):
        _bench("edm", members=3)


# -- the JSON line and main ----------------------------------------------------

@pytest.mark.parametrize("sampler,nfe,suffix", [("edm", 20, ""),
                                                ("dpm", 2, " [sampler=dpm nfe=2]")])
def test_run_builds_the_line(tmp_path, sampler, nfe, suffix):
    stats = []
    line = bench.run(LaDCastDiTConfig(**DIT_KW), DCAEConfig(**DCAE_KW),
                     _rcfg(sampler, members=2, nfe=nfe, hours=24), device="cpu",
                     peak=1e12, compute_dtype=torch.float32,
                     profile_dir=str(tmp_path / "trace"), dispatch_stats=stats, **SHAPES)
    assert set(line) == {"metric", "value", "unit", "member_denoise_steps_per_s",
                         "denoiser_mfu", "forecast_tflops"}
    assert line["metric"] == ("375M 20-member 240h ensemble rollout wall-clock "
                              "(1 card, 2 members incl. encode+decode)" + suffix)
    assert line["unit"] == "s" and line["value"] > 0 and line["denoiser_mfu"] > 0
    steps = nfe * 2  # one repetition of two members
    assert (round(steps / (line["value"] + 5e-4), 1) <= line["member_denoise_steps_per_s"]
            <= round(steps / (line["value"] - 5e-4), 1))  # value is rounded to 1 ms
    assert len(stats) == 2 and all(set(s) == {"issue_s", "sync_s", "launches"}
                                   and s["launches"] == {} for s in stats)
    assert os.path.isfile(tmp_path / "trace" / "trace.json")


@pytest.mark.parametrize("argv,message", [
    (["--sampler", "heun"], "--sampler must be edm or dpm"),
    (["--nfe", "two"], "--nfe must be an integer"),
    (["--nfe", "0"], "--nfe must be >= 1"),
    (["--nfe"], "--nfe requires a value"),
    (["--profile"], "--profile requires a value")])
def test_main_refuses_bad_flags(argv, message):
    with pytest.raises(SystemExit, match=message):
        bench.main(argv)


def test_main_needs_cuda(monkeypatch):
    """No CPU fallback: without CUDA, main raises before any probe or work."""
    if torch.cuda.is_available():
        pytest.skip("the refusal is for hosts without CUDA")
    monkeypatch.delenv("LADCAST_BENCH_NO_WAIT", raising=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--sampler", "dpm", "--nfe", "2"])
