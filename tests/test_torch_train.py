"""The PyTorch port's AR training path against the JAX package, in fp32 on
the CPU: the loss and every parameter's gradient of ``loss_given_noise``
(injected sigma indices and noise, the JAX gradient tree mapped with the
port's ``state_dict_from_flax``), the sigma sampler, EMA, the LR schedules
and three optimizer steps against optax; then remat, checkpoints, the CLI
and its resume, and chip_smoke.py's copy of the 375M training config.

Tolerances: fp32 through the tiny DiT and its backward, the sums taken in
another order by XLA and by torch. The loss agrees to 1e-5 relative, the
concatenated gradient to 1e-5 relative L2, each parameter's to 1e-4
(small gradients, such as those of the last block's biases, carry more
relative rounding). Schedules and EMA decays are host scalars, equal to
1e-6 (JAX evaluates them in fp32); optimizer steps 1e-6 relative.
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from ladcast_torch import config as t_config
from ladcast_torch.cli import train_ar as t_cli
from ladcast_torch.data.time_utils import add_hours_int
from ladcast_torch.diffusion import noise_sampler as t_ns
from ladcast_torch.models.ladcast_dit import LaDCastTransformer3D as TorchDiT
from ladcast_torch.models.weight_import import state_dict_from_flax
from ladcast_torch.ops import flash_attention as t_fa
from ladcast_torch.train import checkpoint as t_ckpt
from ladcast_torch.train import ema as t_ema
from ladcast_torch.train import optim as t_optim
from ladcast_torch.train.trainer_ar import ARTrainConfig as TorchARConfig
from ladcast_torch.train.trainer_ar import make_ar_train_step as t_make_step
from ladcast_tpu import config as j_config
from ladcast_tpu.diffusion import noise_sampler as j_ns
from ladcast_tpu.models.ladcast_dit import LaDCastTransformer3D as JaxDiT
from ladcast_tpu.train import ema as j_ema
from ladcast_tpu.train import optim as j_optim
from ladcast_tpu.train.trainer_ar import ARTrainConfig as JaxARConfig
from ladcast_tpu.train.trainer_ar import make_ar_train_step as j_make_step
from tests.test_torch_dit import TINY

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """The test suite runs files in parallel workers on a shared CPU; two
    intra-op threads per worker keep them from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(B=2, T_out=2, H=3, W=6, C=6, seed=0):
    rng = np.random.RandomState(seed)
    batch = (rng.randn(B, 1, H, W, C).astype(np.float32),
             rng.randn(B, T_out, H, W, C).astype(np.float32),
             rng.rand(B, 2).astype(np.float32))
    indices = rng.randint(0, 1000, size=B).astype(np.int32)
    noise = rng.randn(B, T_out, H, W, C).astype(np.float32)
    return batch, indices, noise


def _torch_loss_and_grads(tcfg_kw, params, batch, indices, noise,
                          cfg_kw=TINY):
    _, step = t_make_step(t_config.LaDCastDiTConfig(**cfg_kw),
                          t_config.EDMSchedulerConfig(),
                          t_config.NoiseSamplerConfig(),
                          TorchARConfig(compute_dtype="float32", **tcfg_kw),
                          t_optim.make_optimizer(), device="cpu")
    model = TorchDiT(t_config.LaDCastDiTConfig(**cfg_kw))
    model.load_state_dict(state_dict_from_flax(params, "dit"), strict=True)
    loss, _ = step.loss_given_noise(model, [torch.from_numpy(x) for x in batch],
                                    torch.from_numpy(indices).long(),
                                    torch.from_numpy(noise))
    names, ps = zip(*model.named_parameters())
    return loss.item(), dict(zip(names, torch.autograd.grad(loss, ps)))


@functools.lru_cache(maxsize=None)
def _jax_params(seed):
    """Seeded tiny-DiT params (numpy tree), from one jitted flax init."""
    lat, cond, yp = _batch()[0]
    model = JaxDiT(j_config.LaDCastDiTConfig(**TINY))
    return jax.tree.map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(seed), lat, np.zeros(len(lat), np.float32), cond,
        yp[:, 0]))


CASES = {"pf1": {}, "pf2_lat_weighted": {"num_push_forward_steps": 2,
                                         "lat_weighted_loss": True},
         "snr_gamma": {"snr_gamma": 5.0}}


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(case):
    batch, indices, noise = _batch()
    _, j_step = j_make_step(
        j_config.LaDCastDiTConfig(**TINY), j_config.EDMSchedulerConfig(),
        j_config.NoiseSamplerConfig(),
        JaxARConfig(compute_dtype="float32", **CASES[case]),
        j_optim.make_optimizer())
    (loss, _), grads = jax.jit(jax.value_and_grad(
        j_step.loss_given_noise, has_aux=True))(
            _jax_params(3), tuple(map(jnp.asarray, batch)),
            jnp.asarray(indices), jnp.asarray(noise))
    return float(loss), state_dict_from_flax(jax.tree.map(np.asarray, grads), "dit")


@pytest.mark.parametrize("case,bwd_mode", [("pf1", "composite"), ("pf1", "kernel"),
                                           ("pf2_lat_weighted", "default"),
                                           ("snr_gamma", "default")])
def test_loss_given_noise_matches_jax(case, bwd_mode):
    """Push-forward 1 and 2, the lat-weighted loss and min-SNR-gamma; pf1
    under both backward modes of the attention, the others under the
    default one."""
    tcfg_kw = CASES[case]
    batch, indices, noise = _batch()
    j_loss, want = _jax_loss_and_grads(case)
    params = _jax_params(3)

    prev = t_fa.BWD_MODE
    if bwd_mode != "default":
        t_fa.BWD_MODE = bwd_mode
    try:
        loss, got = _torch_loss_and_grads(tcfg_kw, params, batch, indices, noise)
    finally:
        t_fa.BWD_MODE = prev
    assert abs(loss - j_loss) <= 1e-5 * abs(j_loss)
    assert sorted(got) == sorted(want)
    got = {k: got[k] for k in want}
    cat = lambda d: torch.cat([t.flatten() for t in d.values()])  # noqa: E731
    assert (cat(got) - cat(want)).norm() <= 1e-5 * cat(want).norm()
    for name, g in want.items():
        err = (got[name] - g).norm() / g.norm().clamp_min(1e-30)
        assert err <= 1e-4, (name, float(err))
    # the attention's projections and qk-norm weights get their gradients
    attn = "transformer_blocks.0.attn."
    for leaf in ("to_q.weight", "add_k_proj.weight", "norm_q.weight",
                 "norm_added_k.weight"):
        assert got[attn + leaf].abs().max() > 0, leaf


def test_indices_from_normals_matches_jax():
    ns = t_config.NoiseSamplerConfig(P_mean_start=-1.2, P_std_start=1.2,
                                     P_mean_end=0.4, P_std_end=1.6,
                                     num_max_steps=11)
    sched = t_config.EDMSchedulerConfig()
    rnd = np.random.RandomState(4).randn(64).astype(np.float32)
    for step in (0, 3, 10, 25):
        want = j_ns.indices_from_normals(
            jnp.asarray(rnd), step,
            j_config.NoiseSamplerConfig(**dataclasses.asdict(ns)),
            j_config.EDMSchedulerConfig())
        got = t_ns.indices_from_normals(torch.from_numpy(rnd), step, ns, sched)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    g = torch.Generator().manual_seed(0)
    idx = t_ns.sample_sigma_indices(g, 8, 0, ns, sched)
    assert idx.shape == (8,) and int(idx.min()) >= 0 and int(idx.max()) < 1000


def test_ema_matches_jax():
    kw = dict(inv_gamma=1.0, power=2 / 3, max_decay=0.9999, update_after_step=3)
    for step in (0, 3, 4, 5, 10, 10**6):
        assert abs(t_ema.ema_decay(step, **kw)
                   - float(j_ema.ema_decay(step, **kw))) <= 1e-6
    rng = np.random.RandomState(5)
    p0 = [rng.randn(3, 4).astype(np.float32), rng.randn(7).astype(np.float32)]
    j_state = j_ema.ema_init(list(map(jnp.asarray, p0)))
    t_state = t_ema.ema_init([torch.from_numpy(p) for p in p0])
    for _ in range(6):
        new = [rng.randn(*p.shape).astype(np.float32) for p in p0]
        j_state = j_ema.ema_update(j_state, list(map(jnp.asarray, new)), **kw)
        t_ema.ema_update(t_state, [torch.from_numpy(p) for p in new], **kw)
    assert t_state.step == int(j_state.step) == 6
    for a, b in zip(t_state.params, j_state.params):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


def test_lr_schedules_match_jax():
    for t_fn, j_fn in [
            (t_optim.cosine_with_min_lr(1e-3, 1e-5, 10, 50),
             j_optim.cosine_with_min_lr(1e-3, 1e-5, 10, 50)),
            (t_optim.polynomial_with_min_lr(1e-3, 1e-5, 10, 50),
             j_optim.polynomial_with_min_lr(1e-3, 1e-5, 10, 50))]:
        for step in range(0, 60, 3):
            assert abs(t_fn(step) - float(j_fn(step))) <= 1e-6 * 1e-3, step
    # constant: the optimizer's LR at every step is the base LR
    p = torch.zeros(3)
    opt = t_optim.make_optimizer(2e-3, schedule="constant", weight_decay=0.0)(
        [("p", p)])
    opt.step([torch.ones(3) * 0.1])
    np.testing.assert_allclose(p.numpy(), -2e-3, rtol=1e-5)
    with pytest.raises(ValueError, match="schedule"):
        t_optim.make_optimizer(schedule="linear")


@pytest.mark.parametrize("masked", [False, True])
def test_three_optimizer_steps_match_optax(masked):
    """Clip (over and under the limit), Adam, decoupled weight decay and
    the warmup-cosine LR at the pre-increment count, with and without a
    frozen parameter."""
    rng = np.random.RandomState(6)
    p0 = {"a": rng.randn(3, 4).astype(np.float32),
          "b": rng.randn(5).astype(np.float32)}
    kw = dict(lr=1e-2, weight_decay=0.1, num_warmup_steps=2,
              num_training_steps=10)
    j_opt = j_optim.make_optimizer(
        **kw, trainable_mask={"a": True, "b": False} if masked else None)
    j_params = jax.tree.map(jnp.asarray, p0)
    j_state = j_opt.init(j_params)
    t_params = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    t_opt = t_optim.make_optimizer(
        **kw, trainable_mask=(lambda n: n == "a") if masked else None)(
            t_params.items())
    for scale in (3.0, 0.05, 2.0):  # global norms around and over 1.0
        grads = {k: (rng.randn(*v.shape) * scale).astype(np.float32)
                 for k, v in p0.items()}
        upd, j_state = j_opt.update(jax.tree.map(jnp.asarray, grads), j_state,
                                    j_params)
        j_params = optax.apply_updates(j_params, upd)
        g_norm = t_opt.step([torch.from_numpy(grads[k]) for k in t_params])
        # the trainer's grad_norm metric: optax.global_norm of the raw
        # gradients, frozen ones included
        np.testing.assert_allclose(float(g_norm), float(optax.global_norm(grads)),
                                   rtol=1e-6)
        for k in p0:
            np.testing.assert_allclose(t_params[k].numpy(), np.asarray(j_params[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    if masked:
        np.testing.assert_array_equal(t_params["b"].numpy(), p0["b"])


def test_remat_gives_equal_gradients():
    batch, indices, noise = _batch(seed=7)
    params = _jax_params(3)
    plain = _torch_loss_and_grads({}, params, batch, indices, noise)
    remat = _torch_loss_and_grads({"remat": True}, params, batch, indices, noise)
    assert plain[0] == remat[0]
    for name, g in plain[1].items():
        torch.testing.assert_close(remat[1][name], g, rtol=1e-6, atol=1e-7)


TINY_AR_CFG = {
    "ar_model": {"num_attention_heads": 2, "attention_head_dim": 128,
                 "num_layers": 1, "num_single_layers": 1,
                 "num_refiner_layers": 1, "mlp_ratio": 1},
    "general": {"checkpointing_steps": 2, "checkpoints_total_limit": 2},
    "train_dataloader": {"batch_size": 2, "input_seq_len": 1,
                         "return_seq_len": 4},
    "lr_scheduler": {"num_warmup_steps": 1},
    "ema": {"ema_update_after_step": 0},
}


def _cli_fixtures(tmp_path):
    rng = np.random.RandomState(8)
    n = 40
    lat = rng.randn(n, 3, 6, 84).astype(np.float32)
    ts = np.asarray([add_hours_int(2018010100, i) for i in range(n)], np.int64)
    np.savez(tmp_path / "latents.npz", latents=lat, timestamps=ts)
    (tmp_path / "tiny.yaml").write_text(yaml.safe_dump(TINY_AR_CFG))
    return str(tmp_path / "tiny.yaml"), str(tmp_path / "latents.npz")


def test_cli_trains_checkpoints_and_resumes(tmp_path):
    cfg, lat = _cli_fixtures(tmp_path)
    out = str(tmp_path / "run")
    argv = ["--config", cfg, "--latents", lat, "--output_dir", out,
            "--device", "cpu", "--log_every", "1"]
    first = t_cli.main(argv + ["--num_steps", "3"])
    assert first["state"].step == 3
    mgr = t_ckpt.make_manager(os.path.join(out, "ckpts"), max_to_keep=2)
    assert mgr.all_steps() == [2, 3]
    resumed = t_cli.main(argv + ["--num_steps", "5", "--resume", "latest"])
    assert resumed["state"].step == 5 and resumed["state"].optimizer.count == 5
    assert mgr.all_steps() == [4, 5]  # rotation keeps the newest two
    recs = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    assert [r["step"] for r in recs] == [1, 2, 3, 4, 5]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in recs)
    # the resumed run restored step 3: its state differs from a fresh one
    fresh = t_cli.run(yaml.safe_load(open(cfg)), t_cli.build_parser().parse_args(
        argv[2:] + ["--num_steps", "0", "--output_dir", str(tmp_path / "fresh")]))
    restored = t_ckpt.restore_state(mgr, fresh["state"], 5)
    for a, b in zip(restored.model.parameters(), resumed["state"].model.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(restored.ema.params, resumed["state"].ema.params):
        assert torch.equal(a, b)
    assert restored.step == 5
    # chip_smoke.py's check of a restore: the whole state, both moments
    # included; a lost first moment fails it
    import chip_smoke

    assert chip_smoke.same_tree(restored.state_dict(), resumed["state"].state_dict())
    restored.optimizer.mu[0].add_(1.0)
    assert not chip_smoke.same_tree(restored.state_dict(),
                                    resumed["state"].state_dict())


def test_cli_refuses_what_is_not_ported(tmp_path):
    cfg, lat = _cli_fixtures(tmp_path)
    base = ["--config", cfg, "--latents", lat, "--device", "cpu",
            "--output_dir", str(tmp_path / "x")]
    for extra, item in ((["--mesh", "data=-1"], "M12"), (["--hub_export"], "M9"),
                        (["--init_weights", "w"], "M9"),
                        (["--reader", "native"], "M13"),
                        (["--val_every", "2", "--val_latents", lat], "M11")):
        with pytest.raises(NotImplementedError, match=item):
            t_cli.main(base + extra)
    with pytest.raises(NotImplementedError, match="M13"):
        t_cli.main(["--config", cfg, "--latents", str(tmp_path), "--device",
                    "cpu", "--output_dir", str(tmp_path / "x")])


def test_checkpoint_params_round_trip(tmp_path):
    sd = {"w": torch.randn(3, 4), "b": torch.arange(5.0)}
    path = str(tmp_path / "w" / "params.pt")
    t_ckpt.save_params(path, sd)
    back = t_ckpt.load_params(path)
    assert list(back) == list(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    with pytest.raises(FileNotFoundError):
        t_ckpt.make_manager(str(tmp_path / "empty")).restore()


def test_chip_smoke_train_config_is_the_yaml():
    import chip_smoke

    with open(os.path.join(ROOT, "configs", "ladcast_375m.yaml")) as f:
        assert chip_smoke.LADCAST_375M_YAML == yaml.safe_load(f)


def test_config_copies_match_jax_defaults():
    for t_cls, j_cls in [(t_config.NoiseSamplerConfig, j_config.NoiseSamplerConfig),
                         (TorchARConfig, JaxARConfig)]:
        assert ([(f.name, f.default) for f in dataclasses.fields(t_cls)]
                == [(f.name, f.default) for f in dataclasses.fields(j_cls)])
    assert t_config.LaDCastDiTConfig().remat is j_config.LaDCastDiTConfig().remat
    got = t_config.config_from_dict(t_config.NoiseSamplerConfig,
                                    {"P_mean_end": 0.3, "target": "ignored"})
    assert got == t_config.NoiseSamplerConfig(P_mean_end=0.3)


def test_latent_dataset_and_batches_match_jax():
    """The same windows and the same seeded batches as the JAX dataset; a
    closed iterator stops its reader thread, and a reader error is raised
    to the consumer."""
    import threading

    from ladcast_torch.data import latent_dataset as t_ds
    from ladcast_tpu.data import latent_dataset as j_ds

    rng = np.random.RandomState(9)
    lat = rng.randn(40, 2, 3, 4).astype(np.float32)
    ts = [add_hours_int(2018123100, i) for i in range(40)]
    mean, std = rng.randn(4).astype(np.float32), rng.rand(4).astype(np.float32) + 0.5
    wkw = dict(input_seq_len=2, return_seq_len=3, interval_between_pred=3,
               sampling_interval=2)
    t_set = t_ds.ARLatentDataset(t_ds.ArrayLatentSource(lat, ts),
                                 t_ds.ARWindowConfig(**wkw), mean, std)
    j_set = j_ds.ARLatentDataset(j_ds.ArrayLatentSource(lat, ts),
                                 j_ds.ARWindowConfig(**wkw), mean, std)
    assert len(t_set) == len(j_set) > 0
    for i in (0, len(t_set) - 1):
        for a, b in zip(t_set[i], j_set[i]):
            np.testing.assert_array_equal(a, b)
    got = list(t_ds.batch_iterator(t_set, 3, seed=5, num_push_forward_steps=2))
    want = list(j_ds.batch_iterator(j_set, 3, seed=5, num_push_forward_steps=2))
    assert len(got) == len(want) == len(t_set) // 3
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)

    before = threading.active_count()
    it = t_ds.batch_iterator(t_set, 1, seed=0)
    next(it)
    it.close()
    for _ in range(50):
        if threading.active_count() == before:
            break
        threading.Event().wait(0.1)
    assert threading.active_count() == before

    class Broken(t_ds.ArrayLatentSource):
        def frames(self, idx):
            raise OSError("unreadable shard")

    broken = t_ds.ARLatentDataset(Broken(lat, ts), t_ds.ARWindowConfig(**wkw))
    with pytest.raises(OSError, match="unreadable"):
        next(t_ds.batch_iterator(broken, 2))


def test_trainer_entry_points_refuse_cpu_fallback(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the refusal is for hosts without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_make_step(t_config.LaDCastDiTConfig(**TINY), t_config.EDMSchedulerConfig(),
                    t_config.NoiseSamplerConfig(), TorchARConfig(),
                    t_optim.make_optimizer())
    cfg, lat = _cli_fixtures(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_cli.main(["--config", cfg, "--latents", lat, "--output_dir",
                    str(tmp_path / "x")])
